"""What the harness records around the program: a span for each stage
call, with the device's peak memory in it, and, in a tapped pass, each
hand kernel's calls with the work their inputs need.

Both are wrappers the benchmark puts in place of the program's own names
for the length of a run: ``stages.<stage>`` (``run_all`` looks them up when
it calls them) and the kernel wrappers at their call sites
(``ops.matching.pair_match``, ``ops.ba.schur_accumulate``, and
``ops.patch_match.pc``'s ``plane_cost`` and ``plane_cost_sweep``), as
``chip_smoke.py``'s ``KernelTap`` does. The tap's own device work (the live
counts of kernels 1 and 2) would show in a trace, so the harness taps the
set-up's pass, which does the same work on the same collection, and not
the traced one.
"""

from __future__ import annotations

import contextlib
import time

import torch

from benchmark.roofline import pair_match as k1
from benchmark.roofline import plane_cost as k4
from benchmark.roofline import schur as k2

STAGES = ("prepare_images", "run_extraction", "run_matching", "run_mapping", "run_merge",
          "run_prepare_patch_match", "run_patch_match", "run_fusion", "run_meshing")
SPAN_PREFIX = "bench."


class _Module:
    """A module seen through a few replaced attributes."""

    def __init__(self, module, **attrs):
        self._module = module
        self.__dict__.update(attrs)

    def __getattr__(self, name):
        return getattr(self._module, name)


class Recorder:
    """Stage spans of the current pass, the peak device memory over the
    run, and (while ``tapping``) the kernel calls of the current pass."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.spans = []            # (stage, seconds) of the current pass
        self.peak_bytes = 0
        self.calls = {"pair_match": [], "schur": [], "plane_cost": []}
        self.tapping = False
        self._undo = []

    def _sync(self):
        if self.cuda:
            torch.cuda.synchronize(self.device)

    def _stage(self, name, fn):
        def timed(*args, **kw):
            self._sync()
            t0 = time.perf_counter()
            with torch.profiler.record_function(SPAN_PREFIX + name):
                out = fn(*args, **kw)
                self._sync()
            self.spans.append((name, time.perf_counter() - t0))
            if self.cuda:
                self.peak_bytes = max(self.peak_bytes,
                                      torch.cuda.max_memory_allocated(self.device))
            return out
        return timed

    def _tap_pair_match(self, fn):
        def tapped(pool, vb, ai, bi, *rest, **kw):
            if self.tapping:
                n = vb.sum(-1)
                products = (n[ai.long()] * n[bi.long()]).sum(dtype=torch.float64)
                self.calls["pair_match"].append((products, (
                    pool.numel(), vb.numel(), int(ai.numel()), int(pool.shape[-2]))))
            return fn(pool, vb, ai, bi, *rest, **kw)
        return tapped

    def _tap_schur(self, fn):
        def tapped(cam_idx, Wc, Vinv, M, *rest, **kw):
            if self.tapping:
                L = (Wc != 0).flatten(-2).any(-1).sum(-1).to(torch.float64)
                MC = M * 8
                lanes = Wc.shape[0] if Wc.dim() == 5 else 1
                self.calls["schur"].append((torch.stack(
                    [L.sum(), (L * L).sum(), (L > 0).sum()]), lanes * MC * MC))
            return fn(cam_idx, Wc, Vinv, M, *rest, **kw)
        return tapped

    def _tap_k4(self, fn, sweep):
        def tapped(ref, pack, k_ref, k_src, R, t, src_valid, taps, *rest, **kw):
            if self.tapping:
                H, W = ref.shape
                S, Hs, Ws = pack.shape[0], pack.shape[1], pack.shape[2]
                geom = kw.get("geom") is not None
                work = (k4.sweep_work if sweep else k4.initial_work)(
                    H, W, S, taps.offsets, Hs, Ws, geom)
                self.calls["plane_cost"].append((None, work))
            return fn(ref, pack, k_ref, k_src, R, t, src_valid, taps, *rest, **kw)
        return tapped

    def work(self):
        """{kernel: [(operations, bytes), ...]} of the calls tapped in the
        current pass."""
        out = {}
        for (v, (pool_n, vb_n, pairs, slots)) in self.calls["pair_match"]:
            out.setdefault("pair_match", []).append(
                k1.work(float(v), pool_n, vb_n, pairs, slots))
        for (v, s_elements) in self.calls["schur"]:
            s, sq, pts = (float(x) for x in v.cpu())
            out.setdefault("schur", []).append(k2.work(s, sq, pts, s_elements))
        for (_, w) in self.calls["plane_cost"]:
            out.setdefault("plane_cost", []).append(w)
        return out

    def begin_pass(self, tapping: bool = False):
        self.spans = []
        self.calls = {k: [] for k in self.calls}
        self.tapping = tapping

    @contextlib.contextmanager
    def installed(self):
        """The wrappers in place of the program's names, for the block."""
        from scanner_colmap_tpu_torch.kernels import plane_cost as pc
        from scanner_colmap_tpu_torch.ops import ba, matching, patch_match
        from scanner_colmap_tpu_torch.pipeline import stages

        swaps = [(stages, name, self._stage(name, getattr(stages, name))) for name in STAGES]
        swaps += [(matching, "pair_match", self._tap_pair_match(matching.pair_match)),
                  (ba, "schur_accumulate", self._tap_schur(ba.schur_accumulate)),
                  (patch_match, "pc", _Module(
                      pc, plane_cost=self._tap_k4(pc.plane_cost, False),
                      plane_cost_sweep=self._tap_k4(pc.plane_cost_sweep, True)))]
        for mod, attr, new in swaps:
            self._undo.append((mod, attr, getattr(mod, attr)))
            setattr(mod, attr, new)
        try:
            yield self
        finally:
            for mod, attr, old in reversed(self._undo):
                setattr(mod, attr, old)
            self._undo.clear()
