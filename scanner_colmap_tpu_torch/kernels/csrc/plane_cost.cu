// Kernel 4: PatchMatch's bilateral-NCC plane cost of a Jacobi sweep's
// candidate fields, with the sweep's "keep if strictly better" update, for
// Hopper (sm_90a).
//
// Replaces no Pallas kernel. On the TPU the JAX package leaves this cost to
// XLA's fusion: scanner_colmap_tpu/ops/patch_match.py::_plane_costs_field
// (with _ncc_finish and the candidate scan of patch_match). Run eagerly in
// PyTorch that is ~70 tensor operations per window offset, 121 offsets per
// candidate and ten candidates a sweep; here one wrapper call does a sweep
// in two launches.
//
// What bounds it: operations. Per (ref pixel, candidate, source, tap) the
// tap costs ~50 f32 operations with two IEEE divisions, against ~12 bytes
// of (S, H, W, 3) source pack per (pixel, source) that every tap reuses.
// Every product and sum is rounded as the plain PyTorch version rounds it
// (__fmul_rn and friends: nvcc never contracts them into an FMA), so each
// add and multiply issues alone and the kernel can reach about half of an
// FMA-rated bound at best. The design:
// - the cost pass (plane_cost_pass) is one launch over (candidate x source,
//   pixel tile): a block owns one tile of ref pixels for one candidate and
//   one source, one thread a pixel, so a sweep at 96x96 with 4 sources is
//   1,440 blocks, not 36. The (candidate, source) index runs fastest in the
//   grid, so the blocks of one tile run together and share its reads in L2;
// - the neighbour candidates are read in place from the sweep-start state
//   through torch.roll's wraparound index (candidate c < n_shift at p is
//   state[(y - dy) mod H, (x - dx) mod W]); the others are given fields;
// - per block, the tile plus an R-pixel halo is warped once through each
//   halo pixel's own candidate plane into the block's source (warp
//   coordinates, the corrected warped value, the gradient, the ok flag)
//   into shared memory, and each tap's pixel-independent products (its
//   offset over the focal length, times the rotation's columns) too; every
//   tap of every pixel then reads shared memory;
// - the tap weight wsp * exp(-dr^2 / 2 sigma_c^2) depends on the ref image
//   alone: it is read from a table built once per problem
//   (plane_weight_kernel, (nw, H, W)), not computed per candidate and source;
// - each pixel keeps its six moments in registers and sums them in the
//   window's scan order, with no atomics: the result is bitwise
//   reproducible; per-source costs go to a (C, S, H, W) scratch;
// - the finish (plane_cost_finish), stream-ordered after the cost pass,
//   takes per pixel and candidate the mean of the best max(1, S/2) sources,
//   summed in ascending order, then applies the sweep's update over the
//   candidates in order. The neighbour candidates' planes come from a
//   snapshot of the state that the cost pass wrote, since the update
//   overwrites the state that its neighbours' candidates read.
//
// A tap at p + o outside the canvas has weight 0 (the JAX version's
// wraparound rolls are masked by the same bounds test), so it is skipped.
// Rounding to the nearest sample is rintf (half to even, as jnp.round).

#include <cuda_runtime.h>
#include <stdint.h>

// The pixel tile of a cost-pass block; another (-DTILE_W=16 -DTILE_H=8)
// builds only for measurements.
#ifndef TILE_W
#define TILE_W 16
#endif
#ifndef TILE_H
#define TILE_H 16
#endif
#define MAX_THREADS 256
#define MIN_BLOCKS 4     // cost-pass blocks an SM: at 16x16, 64 registers a thread
#define GRID_MAX 65535   // blocks along y or z: tile columns, tile rows
#define S_MAX 16
#define R_MAX 16
#define SHIFT_MAX 8
#define C_MAX 16

static_assert(TILE_W * TILE_H <= MAX_THREADS, "one thread a tile pixel");

struct CostArgs {
  const float *ref, *pack, *kref, *ksrc, *Rm, *tm;
  const unsigned char* valid;
  const int *tap_du, *tap_dv;
  const float* wtab;
  const float *depth, *normal, *extra_d, *extra_n, *geom;
  float *costs, *snap;
  int n_shift, dy[SHIFT_MAX], dx[SHIFT_MAX];
  int H, W, S, Hs, Ws, nw, R, step;
  float support, bad;
};

struct FinishArgs {
  const float *costs, *snap, *extra_d, *extra_n;
  float *depth, *normal, *cost, *means;
  int n_shift, dy[SHIFT_MAX], dx[SHIFT_MAX];
  int C, S, H, W, update;
};

__device__ __forceinline__ float fadd(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float fsub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float fmul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float fdiv(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ float keep_off_zero(float z) {
  return fabsf(z) < 1e-9f ? 1e-9f : z;
}
__device__ __forceinline__ int wrap(int v, int n) {
  v %= n;
  return v < 0 ? v + n : v;
}

// A candidate field: its depth and normal, and the shift at which it is read.
struct Field {
  const float *d, *n;
  int dy, dx;
  __device__ __forceinline__ int at(int gy, int gx, int H, int W) const {
    return wrap(gy - dy, H) * W + wrap(gx - dx, W);
  }
};

__device__ __forceinline__ Field field_of(const CostArgs& a, int c) {
  if (c < a.n_shift) return {a.depth, a.normal, a.dy[c], a.dx[c]};
  const size_t off = (size_t)(c - a.n_shift) * a.H * a.W;
  return {a.extra_d + off, a.extra_n + 3 * off, 0, 0};
}

// n / (n.X) of the plane (d, n) at the normalised ray (xn, yn), X = d [xn, yn, 1]
__device__ __forceinline__ void plane_terms(const Field& f, int q, float xn, float yn,
                                            float no[3]) {
  const float d = f.d[q];
  const float n0 = f.n[3 * q], n1 = f.n[3 * q + 1], n2 = f.n[3 * q + 2];
  const float ndotX = keep_off_zero(
      fadd(fadd(fmul(n0, fmul(xn, d)), fmul(n1, fmul(yn, d))), fmul(n2, d)));
  no[0] = fdiv(n0, ndotX);
  no[1] = fdiv(n1, ndotX);
  no[2] = fdiv(n2, ndotX);
}

// h = R [xn, yn, 1] + t ndq: the center warp of one pixel into one source
__device__ __forceinline__ void warp_center(const float* Rs, const float* ts, float xn,
                                            float yn, float ndq, float h[3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
    h[i] = fadd(fadd(fadd(fmul(Rs[3 * i], xn), fmul(Rs[3 * i + 1], yn)), Rs[3 * i + 2]),
                fmul(ts[i], ndq));
}

// One block: one candidate c, one source s (blockIdx.x = c * S + s), one
// TILE_W x TILE_H tile of ref pixels (tile column blockIdx.y, row
// blockIdx.z). Writes costs[c, s, tile].
__global__ void __launch_bounds__(MAX_THREADS, MIN_BLOCKS)
plane_cost_pass(const CostArgs a) {
  extern __shared__ float4 smem[];
  const int HWD = TILE_W + 2 * a.R;
  const int NH = HWD * (TILE_H + 2 * a.R);
  float4* s_warp = smem;            // per halo pixel: px, py, gx, gy
  float4* s_val = s_warp + NH;      // warped value, ok, ref value
  float4* s_ta = s_val + NH;        // per tap: du/fx, dv/fy, their products
  float4* s_tb = s_ta + a.nw;       //   with R's first two columns, by row

  const int c = blockIdx.x / a.S, s = blockIdx.x % a.S;
  const int tid = threadIdx.x;
  const int tx = tid % TILE_W, ty = tid / TILE_W;
  const int x0 = blockIdx.y * TILE_W, y0 = blockIdx.z * TILE_H;
  const int x = x0 + tx, y = y0 + ty;
  const int H = a.H, W = a.W;
  const size_t HW = (size_t)H * W;
  const bool live = x < W && y < H;
  const int g = live ? y * W + x : 0;
  float* out = a.costs + (size_t)blockIdx.x * HW;

  if (a.snap && blockIdx.x == 0 && live) {       // the sweep-start state
    a.snap[4 * g] = a.depth[g];
    a.snap[4 * g + 1] = a.normal[3 * g];
    a.snap[4 * g + 2] = a.normal[3 * g + 1];
    a.snap[4 * g + 3] = a.normal[3 * g + 2];
  }
  if (!a.valid[s]) {              // a padded slot: cost bad, nothing to sum
    if (live) out[g] = a.bad;
    return;
  }
  const float fx = a.kref[0], fy = a.kref[1], cx = a.kref[2], cy = a.kref[3];
  const float sfx = a.ksrc[4 * s], sfy = a.ksrc[4 * s + 1];
  const float scx = a.ksrc[4 * s + 2], scy = a.ksrc[4 * s + 3];
  float Rs[9], ts[3];
#pragma unroll
  for (int i = 0; i < 9; ++i) Rs[i] = a.Rm[9 * s + i];
#pragma unroll
  for (int i = 0; i < 3; ++i) ts[i] = a.tm[3 * s + i];
  const Field f = field_of(a, c);

  for (int k = tid; k < a.nw; k += blockDim.x) {
    const int du = a.tap_du[k], dv = a.tap_dv[k];
    const float dun = fdiv((float)du, fx), dvn = fdiv((float)dv, fy);
    s_ta[k] = make_float4(dun, dvn, fmul(dun, Rs[0]), fmul(dvn, Rs[1]));
    s_tb[k] = make_float4(fmul(dun, Rs[3]), fmul(dvn, Rs[4]), fmul(dun, Rs[6]),
                          fmul(dvn, Rs[7]));
  }
  // the tile and its halo, each pixel warped through its own candidate plane
  for (int i = tid; i < NH; i += blockDim.x) {
    const int gy = y0 - a.R + i / HWD, gx = x0 - a.R + i % HWD;
    if (gy < 0 || gy >= H || gx < 0 || gx >= W) continue;   // never read
    const float hxn = fdiv(fsub((float)gx, cx), fx), hyn = fdiv(fsub((float)gy, cy), fy);
    float no[3], h[3];
    plane_terms(f, f.at(gy, gx, H, W), hxn, hyn, no);
    warp_center(Rs, ts, hxn, hyn, fadd(fadd(fmul(no[0], hxn), fmul(no[1], hyn)), no[2]), h);
    const float hz = keep_off_zero(h[2]);
    const float px = fadd(fmul(sfx, fdiv(h[0], hz)), scx);
    const float py = fadd(fmul(sfy, fdiv(h[1], hz)), scy);
    const float xr = fminf(fmaxf(rintf(px), 0.f), (float)(a.Ws - 1));
    const float yr = fminf(fmaxf(rintf(py), 0.f), (float)(a.Hs - 1));
    const bool inb = px >= 0.f && px <= (float)(a.Ws - 1) && py >= 0.f
                     && py <= (float)(a.Hs - 1);
    const float* smp = a.pack + (((size_t)s * a.Hs + (int)yr) * a.Ws + (int)xr) * 3;
    const float gxv = smp[1], gyv = smp[2];
    s_warp[i] = make_float4(px, py, gxv, gyv);
    s_val[i] = make_float4(fadd(fadd(smp[0], fmul(gxv, fsub(px, xr))), fmul(gyv, fsub(py, yr))),
                           (inb && hz > 1e-9f) ? 1.f : 0.f, a.ref[gy * W + gx], 0.f);
  }
  float no[3] = {0.f, 0.f, 0.f};
  const float xn = fdiv(fsub((float)x, cx), fx), yn = fdiv(fsub((float)y, cy), fy);
  if (live) plane_terms(f, f.at(y, x, H, W), xn, yn, no);
  __syncthreads();
  if (!live) return;

  const int hc = (ty + a.R) * HWD + (tx + a.R);
  float h[3];
  warp_center(Rs, ts, xn, yn, fadd(fadd(fmul(no[0], xn), fmul(no[1], yn)), no[2]), h);
  // the taps are a grid, offsets -R + step j: the rows and columns whose
  // taps stay in the canvas, in scan order (the others have weight 0)
  const int ncol = 2 * a.R / a.step + 1;
  const int j0 = a.R > x ? (a.R - x + a.step - 1) / a.step : 0;
  const int j1 = min(ncol - 1, (W - 1 - x + a.R) / a.step);
  const int i0 = a.R > y ? (a.R - y + a.step - 1) / a.step : 0;
  const int i1 = min(ncol - 1, (H - 1 - y + a.R) / a.step);
  float sw = 0.f, sr = 0.f, ss = 0.f, srr = 0.f, sss = 0.f, srs = 0.f;
  for (int i = i0; i <= i1; ++i) {
    const int row = hc + (a.step * i - a.R) * HWD - a.R;
    const float* wk = a.wtab + (size_t)(i * ncol + j0) * HW + g;
    for (int j = j0; j <= j1; ++j, wk += HW) {
      const int k = i * ncol + j, hi = row + a.step * j;
      const float4 ta = s_ta[k], tb = s_tb[k];
      const float4 hw = s_warp[hi], hv = s_val[hi];
      const float r = hv.z;
      const float w = __ldg(wk);
      const float nn = fadd(fmul(no[0], ta.x), fmul(no[1], ta.y));
      const float ho0 = fadd(fadd(fadd(h[0], ta.z), ta.w), fmul(ts[0], nn));
      const float ho1 = fadd(fadd(fadd(h[1], tb.x), tb.y), fmul(ts[1], nn));
      const float ho2 = fadd(fadd(fadd(h[2], tb.z), tb.w), fmul(ts[2], nn));
      const float hzo = keep_off_zero(ho2);
      const float dx = fsub(fadd(fmul(sfx, fdiv(ho0, hzo)), scx), hw.x);
      const float dy = fsub(fadd(fmul(sfy, fdiv(ho1, hzo)), scy), hw.y);
      const float sv = fadd(fadd(hv.x, fmul(hw.z, dx)), fmul(hw.w, dy));
      const float ok = (hv.y != 0.f && fabsf(dx) < 2.f && fabsf(dy) < 2.f && hzo > 1e-9f)
                           ? 1.f : 0.f;
      const float ws = fmul(w, ok);
      sw = fadd(sw, ws);
      sr = fadd(sr, fmul(ws, r));
      ss = fadd(ss, fmul(ws, sv));
      srr = fadd(srr, fmul(ws, fmul(r, r)));
      sss = fadd(sss, fmul(ws, fmul(sv, sv)));
      srs = fadd(srs, fmul(fmul(ws, r), sv));
    }
  }
  const float wsafe = fmaxf(sw, 1e-6f);
  const float mr = fdiv(sr, wsafe), ms = fdiv(ss, wsafe);
  const float var_r = fsub(fdiv(srr, wsafe), fmul(mr, mr));
  const float var_s = fsub(fdiv(sss, wsafe), fmul(ms, ms));
  const float cov = fsub(fdiv(srs, wsafe), fmul(mr, ms));
  const float ncc = fdiv(cov, __fsqrt_rn(fmaxf(fmul(var_r, var_s), 1e-12f)));
  float cst = fsub(1.f, fminf(fmaxf(ncc, -1.f), 1.f));
  if (a.geom) cst = fadd(cst, a.geom[(size_t)blockIdx.x * HW + g]);
  if (!(sw > a.support)) cst = a.bad;
  out[g] = cst;
}

// One thread a pixel: each candidate's mean of its best max(1, S/2)
// sources, summed in ascending order; then, in update mode, the candidates
// in order, each taken where its cost is strictly below the running cost.
__global__ void __launch_bounds__(MAX_THREADS)
plane_cost_finish(const FinishArgs a) {
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  const size_t HW = (size_t)a.H * a.W;
  if (g >= (int)HW) return;
  const int kbest = a.S / 2 > 1 ? a.S / 2 : 1;
  float best = a.update ? a.cost[g] : 0.f;
  int win = -1;
  for (int c = 0; c < a.C; ++c) {
    const float* v = a.costs + (size_t)c * a.S * HW + g;
    unsigned used = 0u;
    float acc = 0.f;
    for (int j = 0; j < kbest; ++j) {
      int bi = -1;
      float bv = 0.f;
      for (int s = 0; s < a.S; ++s) {
        if (used >> s & 1u) continue;
        const float u = v[(size_t)s * HW];
        if (bi < 0 || u < bv) { bi = s; bv = u; }
      }
      used |= 1u << bi;
      acc = j == 0 ? bv : fadd(acc, bv);
    }
    const float m = fdiv(acc, (float)kbest);
    if (a.means) a.means[(size_t)c * HW + g] = m;
    if (!a.update) {
      a.cost[g] = m;
    } else if (m < best) {
      best = m;
      win = c;
    }
  }
  if (win < 0) return;
  a.cost[g] = best;
  if (win < a.n_shift) {
    const int q = wrap(g / a.W - a.dy[win], a.H) * a.W + wrap(g % a.W - a.dx[win], a.W);
    a.depth[g] = a.snap[4 * q];
    a.normal[3 * g] = a.snap[4 * q + 1];
    a.normal[3 * g + 1] = a.snap[4 * q + 2];
    a.normal[3 * g + 2] = a.snap[4 * q + 3];
  } else {
    const size_t e = (size_t)(win - a.n_shift) * HW + g;
    a.depth[g] = a.extra_d[e];
    a.normal[3 * g] = a.extra_n[3 * e];
    a.normal[3 * g + 1] = a.extra_n[3 * e + 1];
    a.normal[3 * g + 2] = a.extra_n[3 * e + 2];
  }
}

// The tap weights of one problem, (nw, H, W): 0 where p + o leaves the canvas.
__global__ void __launch_bounds__(MAX_THREADS)
plane_weight_kernel(const float* __restrict__ ref, const int* __restrict__ du,
                    const int* __restrict__ dv, const float* __restrict__ wsp,
                    float* __restrict__ wtab, int H, int W, float two_sc2) {
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  const int k = blockIdx.y;
  if (g >= H * W) return;
  const int xb = g % W + du[k], yb = g / W + dv[k];
  float w = 0.f;
  if (xb >= 0 && xb < W && yb >= 0 && yb < H) {
    const float dr = fsub(ref[yb * W + xb], ref[g]);
    w = fmul(wsp[k], expf(fdiv(-fmul(dr, dr), two_sc2)));
  }
  wtab[(size_t)k * H * W + g] = w;
}

static size_t pass_smem(int R, int nw) {
  const size_t NH = (size_t)(TILE_W + 2 * R) * (TILE_H + 2 * R);
  return (2 * NH + 2 * (size_t)nw) * 16;
}

static cudaError_t allow_smem(size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(plane_cost_pass, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// One wrapper call: the cost pass over C = n_shift + n_extra candidates, then
// the finish. shifts (host, 2 * n_shift ints: dy, dx per shifted candidate);
// wtab (nw, H, W) the tap weights; geom (C, S, H, W), snap (H, W, 4) and
// means (C, H, W) may be null (snap is required when n_shift > 0 in update
// mode). The canvas spans at most GRID_MAX tiles each way.
extern "C" int plane_cost_launch(
    const float* ref, const float* pack, const float* kref, const float* ksrc,
    const float* Rm, const float* tm, const unsigned char* valid, const int* du,
    const int* dv, const float* wtab, float* depth, float* normal, const float* extra_d,
    const float* extra_n, const float* geom, float* costs, float* snap, float* cost,
    float* means, const int* shifts, int n_shift, int n_extra, int H, int W, int S, int Hs,
    int Ws, int nw, int R, int step, float support, float bad, int update, void* stream) {
  const int C = n_shift + n_extra;
  const int tiles_x = (W + TILE_W - 1) / TILE_W, tiles_y = (H + TILE_H - 1) / TILE_H;
  if (S < 1 || S > S_MAX || R < 0 || R > R_MAX || step < 1
      || nw != (2 * R / step + 1) * (2 * R / step + 1) || n_shift < 0 || n_shift > SHIFT_MAX
      || n_extra < 0 || C < 1 || C > C_MAX || H < 1 || W < 1 || tiles_x > GRID_MAX
      || tiles_y > GRID_MAX || !wtab || (!update && C != 1) || (update && n_shift > 0 && !snap))
    return (int)cudaErrorInvalidValue;
  CostArgs a = {ref, pack, kref, ksrc, Rm, tm, valid, du, dv, wtab, depth, normal,
                extra_d, extra_n, geom, costs, update && n_shift > 0 ? snap : nullptr};
  FinishArgs b = {costs, snap, extra_d, extra_n, depth, normal, cost, means};
  a.n_shift = b.n_shift = n_shift;
  for (int i = 0; i < n_shift; ++i) {
    a.dy[i] = b.dy[i] = shifts[2 * i];
    a.dx[i] = b.dx[i] = shifts[2 * i + 1];
  }
  a.H = H; a.W = W; a.S = S; a.Hs = Hs; a.Ws = Ws; a.nw = nw; a.R = R; a.step = step;
  a.support = support; a.bad = bad;
  b.C = C; b.S = S; b.H = H; b.W = W; b.update = update;
  cudaStream_t st = (cudaStream_t)stream;
  const size_t bytes = pass_smem(R, nw);
  cudaError_t e = allow_smem(bytes);
  if (e != cudaSuccess) return (int)e;
  plane_cost_pass<<<dim3(C * S, tiles_x, tiles_y), TILE_W * TILE_H, bytes, st>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  plane_cost_finish<<<(H * W + MAX_THREADS - 1) / MAX_THREADS, MAX_THREADS, 0, st>>>(b);
  return (int)cudaGetLastError();
}

extern "C" int plane_weight_launch(const float* ref, const int* du, const int* dv,
                                   const float* wsp, float* wtab, int H, int W, int nw,
                                   float two_sc2, void* stream) {
  if (nw < 1 || nw > (2 * R_MAX + 1) * (2 * R_MAX + 1)) return (int)cudaErrorInvalidValue;
  plane_weight_kernel<<<dim3((H * W + MAX_THREADS - 1) / MAX_THREADS, nw), MAX_THREADS, 0,
                        (cudaStream_t)stream>>>(ref, du, dv, wsp, wtab, H, W, two_sc2);
  return (int)cudaGetLastError();
}

// The tile (tile[0] = TILE_W, tile[1] = TILE_H) and the cost pass's resident
// blocks per SM at a window (for reports).
extern "C" int plane_cost_occupancy(int R, int nw, int* blocks, int* tile) {
  tile[0] = TILE_W;
  tile[1] = TILE_H;
  const size_t bytes = pass_smem(R, nw);
  cudaError_t e = allow_smem(bytes);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, plane_cost_pass,
                                                            TILE_W * TILE_H, bytes);
}
