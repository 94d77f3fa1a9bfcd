// Sparse Schur accumulation for Hopper (sm_90a): output-stationary,
// deterministic, one launch.
//
// Replaces the Pallas TPU kernel scanner_colmap_tpu/ops/pallas_ba.py
// ::_schur_kernel (driven by schur_accumulate), the point-block part of the
// dense-Schur reduced camera system in ops/ba._build_normal_eqs:
//     S = sum_p B_p Vinv_p B_p^T,   B_p = scatter-by-camera of Wc[p, t].
// The TPU kernel takes the dense (P, M*8, 3) B; here B is never built: the
// kernel reads the unscattered cam_idx (P, T), Wc (P, T, 8, 3), Vinv (P, 3, 3).
//
// Design. The cameras are cut into windows of 16 (128 rows of S). A block
// of 512 threads owns one 128 x 128 output tile (row window R1 <= column
// window R2) and holds it in registers: thread t owns rows half*4..+4 and
// columns 0..8 of the 8 x 8 block of camera pair (c1, c2) = (t >> 5,
// (t >> 1) & 15), half = t & 1, so a warp shares its row camera. The block
// walks a contiguous range of points in order:
//   scan: read cam_idx 2048 slots at a time (the next step's already in
//      flight) and queue, in slot order, the slots whose camera lies in
//      one of the tile's two windows; at M = 256 that is 1 slot in 8 (with
//      one window, M <= 16, every slot is queued without reading cam_idx);
//   then, for up to 512 queued slots at a time, ending at a point boundary:
//   stage: one thread per slot loads its camera and Wc (and Vinv for the
//      row window) and drops dead slots (Wc == 0) and foreign cameras;
//   merge: sums the live slots of one point that see the same camera in
//      slot order (the one-hot B block of the plain version and of the
//      Pallas kernel), computes B Vinv for the row window, and builds two
//      lookups per point, camera -> merged slot;
//   accumulate: each warp takes the points where its row camera is
//      present, and each lane adds its 32 elements where its column camera
//      is too, as a fixed chain of fmaf.
// No float atomics touch S or shared memory, and every sum has a fixed
// order, so S is bitwise the same from run to run. Cameras outside [0, M)
// match no window: they are ignored and cannot write out of bounds.
//
// When tiles alone cannot fill the card (M = 16 is one tile), the point
// range is split over `splits` blocks per tile (up to 128 in all, 8 points
// a block at least; the plan is a function of (M, P) only, computed by the
// wrapper). Such a launch is cooperative: every block is resident at once.
// Each block writes its partial tile to a workspace, all pass one grid-wide
// barrier, and block x then sums its 1/splits of the tile's elements over
// the splits in split order (in a fixed number of interleaved groups, the
// groups' sums added in order) and writes them into S. A tile that is not
// split is written row by row through shared memory. Tiles below the
// diagonal are mirrors of those above; every element of S is written
// exactly once, so S needs no memset.
//
// What bounds it: not bytes or operations but latency. At the main path's
// sizes (M = 8 or 16, 1024 or 2048 points of which 20-80% hold a live
// slot) a block stages one batch of 8 or 16 points, merges, accumulates,
// writes its partial, waits at the barrier and sums its share of 128
// partials: a chain of dependent global loads and barriers, 12-15 us a
// call on an H100 (PERF.md), where the bytes and the f32 FMAs would take
// under 1 us spread over the card. At
// M = 256 every one of the 136 tiles' blocks scans all points' cam_idx and
// stages its own 1/8 of the slots, 32 batches each, and the tiles take two
// waves on 132 SMs.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

#define NC 8            // camera parameters per slot
#define WIN 16          // cameras per window
#define TILE 128        // WIN * NC
#define TILE_ELEMS (TILE * TILE)
#define THREADS 512
#define WARPS (THREADS / 32)
#define PER_THREAD 32   // tile elements per thread
#define SLOTS THREADS   // queue entries per sub-batch, one per thread
#define SCAN_K 4        // raw slots per thread in one scan step
#define QCAP (SLOTS + SCAN_K * THREADS)  // ring capacity
#define WC_FLOATS (NC * 3)
#define FULL 0xffffffffu
#define LD (TILE + 1)   // row stride of the tile in shared memory

// dynamic shared memory layout, in 4-byte words
#define OFF_W 0                                 // float [SLOTS][24] raw, then merged Wc
#define OFF_BV (OFF_W + SLOTS * WC_FLOATS)      // float [SLOTS][24] merged Wc Vinv
#define OFF_QSLOT (OFF_BV + SLOTS * WC_FLOATS)  // int [QCAP] queued slot p * T + t
#define OFF_SCAM (OFF_QSLOT + QCAP)             // int [SLOTS] camera of a live entry, else -1
#define OFF_SPT (OFF_SCAM + SLOTS)              // int [SLOTS] point of an entry, else -1
#define OFF_RMAP (OFF_SPT + SLOTS)              // short [SLOTS][16] row camera -> entry
#define OFF_CMAP (OFF_RMAP + SLOTS * WIN / 2)   // short [SLOTS][16] column camera -> entry
#define OFF_CNT (OFF_CMAP + SLOTS * WIN / 2)    // int [WARPS] per-warp counts
#define SMEM_BYTES ((OFF_CNT + WARPS) * 4)

static_assert(2 * SLOTS * WC_FLOATS >= TILE * LD, "the tile must fit over sW, sBV");

// the tile (held in sT, row-major with stride LD) into S, coalesced along
// its columns; for a tile above the diagonal also its mirror below it,
// coalesced along the rows
__device__ __forceinline__ void write_rows(float* __restrict__ S, const float* sT,
                                           int MC, int R1, int R2, int tid) {
  for (int e = tid; e < TILE_ELEMS; e += THREADS) {
    const int r = e / TILE, c = e % TILE;
    const int gr = R1 * TILE + r, gc = R2 * TILE + c;
    if (gr < MC && gc < MC) S[(size_t)gr * MC + gc] = sT[r * LD + c];
  }
  if (R1 == R2) return;
  for (int e = tid; e < TILE_ELEMS; e += THREADS) {
    const int c = e / TILE, r = e % TILE;
    const int gr = R1 * TILE + r, gc = R2 * TILE + c;
    if (gr < MC && gc < MC) S[(size_t)gc * MC + gr] = sT[r * LD + c];
  }
}

// camera c lies in the row window R1 or the column window R2 (and in [0, M))
__device__ __forceinline__ bool in_tile(int c, int M, int R1, int R2) {
  return c >= 0 && c < M && ((c >> 4) == R1 || (c >> 4) == R2);
}

__device__ __forceinline__ void load24(const float* src, float* w) {
  const float4* s4 = reinterpret_cast<const float4*>(src);
#pragma unroll
  for (int k = 0; k < WC_FLOATS / 4; ++k) {
    const float4 v = __ldg(s4 + k);
    w[4 * k] = v.x, w[4 * k + 1] = v.y, w[4 * k + 2] = v.z, w[4 * k + 3] = v.w;
  }
}

__device__ __forceinline__ void store24(float* dst, const float* w) {
  float4* d4 = reinterpret_cast<float4*>(dst);
#pragma unroll
  for (int k = 0; k < WC_FLOATS / 4; ++k)
    d4[k] = make_float4(w[4 * k], w[4 * k + 1], w[4 * k + 2], w[4 * k + 3]);
}

__global__ void __launch_bounds__(THREADS, 1)
schur_kernel(const int* __restrict__ cam_idx, const float* __restrict__ Wc,
             const float* __restrict__ Vinv, int P, int T, int M, int windows,
             float* __restrict__ S, float* __restrict__ ws) {
  extern __shared__ __align__(16) float smem[];
  float* sW = smem + OFF_W;
  float* sBV = smem + OFF_BV;
  float* sT = smem;   // the tile at the end, over sW and sBV
  int* qslot = reinterpret_cast<int*>(smem + OFF_QSLOT);
  int* scam = reinterpret_cast<int*>(smem + OFF_SCAM);
  int* spt = reinterpret_cast<int*>(smem + OFF_SPT);
  short* rmap = reinterpret_cast<short*>(smem + OFF_RMAP);
  short* cmap = reinterpret_cast<short*>(smem + OFF_CMAP);
  int* cnt = reinterpret_cast<int*>(smem + OFF_CNT);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned below = (1u << lane) - 1u;
  const int MC = M * NC;
  // tile -> (R1, R2), R1 <= R2, row by row of the upper triangle
  int R1 = 0, rest = blockIdx.y;
  while (rest >= windows - R1) {
    rest -= windows - R1;
    ++R1;
  }
  const int R2 = R1 + rest;

  // this block's contiguous point range, scanned step_pts points at a time
  const int splits = gridDim.x;
  const int chunk = (P + splits - 1) / splits;
  const int p_begin = min(P, (int)blockIdx.x * chunk);
  const int p_end = min(P, p_begin + chunk);
  const int step_pts = SCAN_K * THREADS / T;

  const int c1 = warp, c2 = lane >> 1, half = lane & 1;
  float acc[PER_THREAD];
#pragma unroll
  for (int j = 0; j < PER_THREAD; ++j) acc[j] = 0.f;

  // the next scan step's cameras, loaded one step ahead (with one window
  // every slot is queued, and its camera is read with its Wc)
  int next_cam[SCAN_K];
  auto load_cams = [&](int q0) {
    const int n = q0 < p_end ? min(step_pts, p_end - q0) * T : 0;
#pragma unroll
    for (int k = 0; k < SCAN_K; ++k) {
      const int s = tid * SCAN_K + k;
      next_cam[k] = s >= n ? -1 : windows == 1 ? 0 : __ldg(cam_idx + (size_t)q0 * T + s);
    }
  };
  load_cams(p_begin);

  // queue of the slots whose camera lies in one of the tile's windows, a
  // ring of entries [head, head + qn) in slot order
  int q0 = p_begin, head = 0, qn = 0;
  while (true) {
    if (qn >= SLOTS || (q0 >= p_end && qn > 0)) {
      // ---- process up to SLOTS entries, ending at a point boundary
      int n = min(qn, SLOTS);
      if (n < qn) {
        const int pp = qslot[(head + n) % QCAP] / T;
        while (qslot[(head + n - 1) % QCAP] / T == pp) --n;
      }
      // A. one thread per entry: Wc, liveness, the point's Vinv
      const int i = tid;
      int cam = -1, pt = -1;
      bool first = false;
      float w[WC_FLOATS], V[9];
      if (i < n) {
        const int e = (head + i) % QCAP;
        const int g = qslot[e];
        pt = g / T;
        first = i == 0 || qslot[(e + QCAP - 1) % QCAP] / T != pt;
        const int c = __ldg(cam_idx + g);
        load24(Wc + (size_t)g * WC_FLOATS, w);
        bool nonzero = false;
#pragma unroll
        for (int k = 0; k < WC_FLOATS; ++k) nonzero |= w[k] != 0.f;
        if (nonzero && in_tile(c, M, R1, R2)) {
          cam = c;
          store24(sW + i * WC_FLOATS, w);
          if ((c >> 4) == R1) {
#pragma unroll
            for (int k = 0; k < 9; ++k) V[k] = __ldg(Vinv + (size_t)pt * 9 + k);
          }
        }
      }
      scam[i] = cam;
      spt[i] = pt;
      const unsigned firsts = __ballot_sync(FULL, first);
      if (lane == 0) cnt[warp] = __popc(firsts);
      for (int e = tid; e < n * WIN; e += THREADS) rmap[e] = cmap[e] = -1;
      __syncthreads();

      // B. merge the live entries of one point and camera (slot order),
      //    B Vinv for the row window, the two lookups of the entry's local
      //    point (the point starts up to and including the entry, minus 1)
      int lp = __popc(firsts & below) + (first ? 1 : 0) - 1, np = 0;
      for (int v = 0; v < WARPS; ++v) {
        const int c = cnt[v];
        lp += v < warp ? c : 0;
        np += c;
      }
      if (cam >= 0) {
        bool leader = true;
        for (int u = i - 1; u >= 0 && spt[u] == pt; --u) leader &= scam[u] != cam;
        if (leader) {
          for (int u = i + 1; u < n && spt[u] == pt; ++u) {
            if (scam[u] != cam) continue;
            const float* o = sW + u * WC_FLOATS;
#pragma unroll
            for (int k = 0; k < WC_FLOATS; ++k) w[k] += o[k];
          }
          const int lc = cam & (WIN - 1);
          if ((cam >> 4) == R2) {
            store24(sW + i * WC_FLOATS, w);
            cmap[lp * WIN + lc] = (short)i;
          }
          if ((cam >> 4) == R1) {
            float bv[WC_FLOATS];
#pragma unroll
            for (int a = 0; a < NC; ++a)
#pragma unroll
              for (int k = 0; k < 3; ++k)
                bv[a * 3 + k] = w[a * 3] * V[k] + w[a * 3 + 1] * V[3 + k] +
                                w[a * 3 + 2] * V[6 + k];
            store24(sBV + i * WC_FLOATS, bv);
            rmap[lp * WIN + lc] = (short)i;
          }
        }
      }
      __syncthreads();

      // C. each warp takes the local points where its row camera is present,
      //    in order; each lane adds its elements where its column camera is
      for (int p0 = 0; p0 < np; p0 += 32) {
        const int s1 = p0 + lane < np ? rmap[(p0 + lane) * WIN + c1] : -1;
        unsigned present = __ballot_sync(FULL, s1 >= 0);
        while (present) {
          const int b = __ffs(present) - 1;
          present &= present - 1;
          const int r = __shfl_sync(FULL, s1, b);
          const int s2 = cmap[(p0 + b) * WIN + c2];
          if (s2 < 0) continue;
          const float4* X = reinterpret_cast<const float4*>(sBV + r * WC_FLOATS + half * 12);
          const float4* Y = reinterpret_cast<const float4*>(sW + s2 * WC_FLOATS);
          float x[12], y[WC_FLOATS];
#pragma unroll
          for (int k = 0; k < 3; ++k) {
            const float4 v = X[k];
            x[4 * k] = v.x, x[4 * k + 1] = v.y, x[4 * k + 2] = v.z, x[4 * k + 3] = v.w;
          }
#pragma unroll
          for (int k = 0; k < WC_FLOATS / 4; ++k) {
            const float4 v = Y[k];
            y[4 * k] = v.x, y[4 * k + 1] = v.y, y[4 * k + 2] = v.z, y[4 * k + 3] = v.w;
          }
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int bb = 0; bb < NC; ++bb) {
              float v = acc[a * NC + bb];
              v = fmaf(x[a * 3], y[bb * 3], v);
              v = fmaf(x[a * 3 + 1], y[bb * 3 + 1], v);
              acc[a * NC + bb] = fmaf(x[a * 3 + 2], y[bb * 3 + 2], v);
            }
        }
      }
      __syncthreads();
      head = (head + n) % QCAP;
      qn -= n;
      continue;
    }
    if (q0 >= p_end) break;

    // ---- scan step: queue the slots of step_pts points that fall in a
    //      window (thread tid takes slots tid * SCAN_K + k), in slot order
    bool want[SCAN_K];
    int count = 0;
#pragma unroll
    for (int k = 0; k < SCAN_K; ++k) {
      want[k] = in_tile(next_cam[k], M, R1, R2);
      count += want[k];
    }
    load_cams(q0 + step_pts);
    int incl = count;  // inclusive scan of the counts over the warp
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(FULL, incl, d);
      if (lane >= d) incl += y;
    }
    if (lane == 31) cnt[warp] = incl;
    __syncthreads();
    int pos = head + qn + incl - count, total = 0;
    for (int v = 0; v < WARPS; ++v) {
      const int c = cnt[v];
      pos += v < warp ? c : 0;
      total += c;
    }
#pragma unroll
    for (int k = 0; k < SCAN_K; ++k) {
      if (!want[k]) continue;
      const int e = pos++ % QCAP;
      qslot[e] = q0 * T + tid * SCAN_K + k;
    }
    qn += total;
    q0 += step_pts;
    __syncthreads();
  }

  if (gridDim.x == 1) {  // one block per tile: the tile -> S through shared memory
    __syncthreads();
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int bb = 0; bb < NC; ++bb)
        sT[(c1 * NC + half * 4 + a) * LD + c2 * NC + bb] = acc[a * NC + bb];
    __syncthreads();
    write_rows(S, sT, MC, R1, R2, tid);
    return;
  }

  // split tile: the partial goes to the workspace in the threads' own order
  // (element f = j * THREADS + tid holds acc[j] of thread tid), then, after
  // a grid-wide barrier, block x sums elements [x * per, x * per + per) of
  // the tile over the splits 0..splits-1 in order and writes them into S
  const size_t tile_ws = (size_t)blockIdx.y * splits * TILE_ELEMS;
  float* mine = ws + tile_ws + (size_t)blockIdx.x * TILE_ELEMS;
#pragma unroll
  for (int j = 0; j < PER_THREAD; ++j) mine[j * THREADS + tid] = acc[j];
  cg::this_grid().sync();

  const int per = (TILE_ELEMS + splits - 1) / splits;
  const int f0 = blockIdx.x * per;
  const int nf = min(per, TILE_ELEMS - f0);
  if (nf <= 0) return;
  const float* src = ws + tile_ws + f0;
  // element f0 + k -> S, at the (row, column) its owner thread held
  auto store = [&](int k, float v) {
    const int f = f0 + k, j = f / THREADS, t = f % THREADS;
    const int r = (t >> 5) * NC + (t & 1) * 4 + j / NC;
    const int c = ((t >> 1) & (WIN - 1)) * NC + j % NC;
    const int gr = R1 * TILE + r, gc = R2 * TILE + c;
    if (gr < MC && gc < MC) {
      S[(size_t)gr * MC + gc] = v;
      if (R1 != R2) S[(size_t)gc * MC + gr] = v;
    }
  };
  // groups of nf threads: group g sums splits g, g + groups, ... in order,
  // its reads contiguous; the groups' sums are then added in group order
  const int groups = max(1, min(THREADS / nf, splits));
  float* red = smem;  // [groups][nf], over sW
  for (int k = tid % nf; k < nf && tid / nf < groups; k += THREADS) {
    const int g = tid / nf;
    float v = 0.f;
    int s = g;
    for (; s + 3 * groups < splits; s += 4 * groups) {  // four loads in flight
      const float x0 = __ldcg(src + (size_t)s * TILE_ELEMS + k);
      const float x1 = __ldcg(src + (size_t)(s + groups) * TILE_ELEMS + k);
      const float x2 = __ldcg(src + (size_t)(s + 2 * groups) * TILE_ELEMS + k);
      const float x3 = __ldcg(src + (size_t)(s + 3 * groups) * TILE_ELEMS + k);
      v = (((v + x0) + x1) + x2) + x3;
    }
    for (; s < splits; s += groups) v += __ldcg(src + (size_t)s * TILE_ELEMS + k);
    if (groups == 1)
      store(k, v);
    else
      red[g * nf + k] = v;
  }
  if (groups == 1) return;
  __syncthreads();
  for (int k = tid; k < nf; k += THREADS) {
    float v = red[k];
    for (int q = 1; q < groups; ++q) v += red[q * nf + k];
    store(k, v);
  }
}

// windows = ceil(M / 16); splits = blocks per tile. With splits > 1 the
// launch is cooperative (every block resident at once, for the grid-wide
// barrier) and ws holds tiles * splits * 128 * 128 floats.
extern "C" int schur_launch(const void* cam_idx, const void* Wc,
                            const void* Vinv, int P, int T, int M, int windows,
                            int splits, void* S, void* ws, void* stream) {
  static bool smem_set[64] = {};  // per device, set once
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= 64 || !smem_set[dev]) {
    e = cudaFuncSetAttribute(schur_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (e != cudaSuccess) return (int)e;
    if (dev < 64) smem_set[dev] = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, windows * (windows + 1) / 2, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = SMEM_BYTES;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = splits > 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, schur_kernel, (const int*)cam_idx,
                         (const float*)Wc, (const float*)Vinv, P, T, M, windows,
                         (float*)S, (float*)ws);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
