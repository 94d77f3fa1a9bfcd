"""Rank functions for the port's multi-process tests (the counterpart of
tests/dist_worker.py; not a test module, and it imports no jax).

``run_ranks`` starts ``world`` processes (spawn) that join one gloo process
group through a ``file://`` rendezvous in a test's tmp directory (no port
needed), each on one intra-op thread, and runs a rank function in each. A
rank that raises fails the call; so does a run past its timeout. Rank
functions take (rank, world, *args) and write what they compute into the
directory they are given as ``rank<r>.npz`` (or into an artifact store).
"""

from __future__ import annotations

import importlib.abc
import os
import sys
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

CPU = torch.device("cpu")


class RefuseJax(importlib.abc.MetaPathFinder):
    """A meta-path finder that refuses jax and the JAX package."""

    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "scanner_colmap_tpu"):
            raise ImportError(f"the port imported {name}")
        return None


def _entry(rank, fn, world, init, refuse_jax, args):
    if refuse_jax:
        sys.meta_path.insert(0, RefuseJax())
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, world_size=world, rank=rank)
    try:
        fn(rank, world, *args)
    finally:
        dist.destroy_process_group()
    if refuse_jax:
        loaded = sorted(m for m in sys.modules
                        if m.split(".")[0] in ("jax", "jaxlib", "scanner_colmap_tpu"))
        if loaded:
            raise AssertionError(f"rank {rank} loaded {loaded}")


def run_ranks(fn, world: int, tmp_dir, *args, refuse_jax: bool = False,
              timeout_s: float = 300.0):
    """Run fn(rank, world, *args) in ``world`` gloo ranks; raise if a rank
    fails or the run passes ``timeout_s``."""
    init = f"file://{os.path.join(str(tmp_dir), 'pg_init')}"
    ctx = mp.start_processes(_entry, args=(fn, world, init, refuse_jax, args),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.time() + timeout_s
    while not ctx.join(timeout=max(deadline - time.time(), 0.1)):
        if time.time() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"{world} ranks of {fn.__name__} ran past {timeout_s} s")


def load_ranks(out_dir, world: int):
    """Every rank's saved arrays, in rank order."""
    return [dict(np.load(os.path.join(str(out_dir), f"rank{r}.npz"))) for r in range(world)]


# ---------------------------------------------------------------------------
# the scale-out layer: halo, sharded BA, the fused step
# ---------------------------------------------------------------------------

BA_FIELDS = {"params": ("qvec", "tvec", "log_f", "k1", "xyz"),
             "obs": ("cam_idx", "uv", "valid"),
             "cfg": ("cc", "cam_valid", "pose_free", "pt_valid", "refine_focal",
                     "refine_distortion", "loss_scale", "prior_log_f", "prior_k1",
                     "prior_weight_f", "prior_weight_k", "cam_group")}


def bundle_from_arrays(arrays: dict, prefix: str = ""):
    """(BundleParams, BundleObs, BundleConfig) on the CPU from flat arrays
    named ``<prefix><group>.<field>``, floats in their own dtype."""
    from scanner_colmap_tpu_torch.ops import ba

    out = []
    for group, cls in (("params", ba.BundleParams), ("obs", ba.BundleObs),
                       ("cfg", ba.BundleConfig)):
        kw = {}
        for f in BA_FIELDS[group]:
            key = f"{prefix}{group}.{f}"
            if key in arrays:
                kw[f] = torch.from_numpy(np.array(arrays[key]))
        out.append(cls(**kw))
    return tuple(out)


def _ba_result(p, info):
    return {"qvec": p.qvec.numpy(), "tvec": p.tvec.numpy(), "log_f": p.log_f.numpy(),
            "k1": p.k1.numpy(), "xyz": p.xyz.numpy(),
            **{k: np.asarray(float(info[k])) for k in ("initial_cost", "final_cost",
                                                       "iterations", "num_obs")}}


def parallel_rank(rank, world, src, out_dir):
    """The halo, the sharded BA's variants (and dense and CG on the problem
    padded with invalid points to twice its size) and the fused step, on
    the problems of ``src`` (an npz the test wrote)."""
    from scanner_colmap_tpu_torch.parallel.dist_ba import distributed_bundle_adjust
    from scanner_colmap_tpu_torch.parallel.halo import ring_halo_append, windowed_gather
    from scanner_colmap_tpu_torch.parallel.mesh import make_mesh, shard_rows
    from scanner_colmap_tpu_torch.parallel.step import make_distributed_step

    arrays = dict(np.load(src))
    mesh = make_mesh(device=CPU)
    res = {}
    x = torch.arange(32.0).reshape(32, 1)
    res["halo.gather"] = windowed_gather(mesh, x, 2).numpy()
    for name, t in (("f32", x), ("bool", x[:, 0] % 3 == 0),
                    ("u8", torch.arange(32 * 5, dtype=torch.uint8).reshape(32, 5))):
        res[f"halo.append.{name}"] = ring_halo_append(shard_rows(mesh, t), 2, mesh).numpy()
    p, o, c = bundle_from_arrays(arrays, "ba.")
    variants = {"dense": (c, "dense"), "cg": (c, "cg"),
                "tied_dense": (_tied(c), "dense"), "tied_cg": (_tied(c), "cg")}
    for name, (cfg, solver) in variants.items():
        q, info = distributed_bundle_adjust(mesh, p, o, cfg, max_iterations=10,
                                            solver=solver, cg_iters=64)
        res.update({f"ba.{name}.{k}": v for k, v in _ba_result(q, info).items()})
    # padded to twice its points: at 2 ranks the second shard, at 4 the
    # last two, hold only padding
    pp, po, pc = padded_bundle(p, o, c, 2 * p.xyz.shape[0])
    for solver in ("dense", "cg"):
        q, info = distributed_bundle_adjust(mesh, pp, po, pc, max_iterations=10,
                                            solver=solver, cg_iters=64)
        res.update({f"ba.padded_{solver}.{k}": v for k, v in _ba_result(q, info).items()})
    sp, so, sc = bundle_from_arrays(arrays, "step.")
    step = make_distributed_step(mesh, overlap=2, ba_iterations=2)
    for name, cfg in (("untied", sc), ("tied", _tied(sc))):
        idx, ok, q, info = step(torch.from_numpy(arrays["step.desc"]),
                                torch.from_numpy(arrays["step.valid"]), sp, so, cfg)
        res[f"step.{name}.idx"], res[f"step.{name}.ok"] = idx.numpy(), ok.numpy()
        res.update({f"step.{name}.{k}": v for k, v in _ba_result(q, info).items()})
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **res)


def padded_bundle(params, obs, cfg, n: int):
    """The problem with its points padded to a multiple of n by invalid
    ones (``pad_to_shards``: zero xyz, no observation, pt_valid False)."""
    import dataclasses

    from scanner_colmap_tpu_torch.parallel.mesh import pad_to_shards

    def pad(t):
        return torch.from_numpy(pad_to_shards(t.numpy(), n)[0])

    return (dataclasses.replace(params, xyz=pad(params.xyz)),
            dataclasses.replace(obs, cam_idx=pad(obs.cam_idx), uv=pad(obs.uv),
                                valid=pad(obs.valid)),
            dataclasses.replace(cfg, pt_valid=pad(cfg.pt_valid)))


def _tied(cfg):
    """The shared-camera form of tests/test_parallel.py: every slot tied to
    slot 0, focal refined."""
    import dataclasses

    M = cfg.cc.shape[0]
    return dataclasses.replace(cfg, cam_group=torch.zeros(M, dtype=torch.int32),
                               refine_focal=torch.tensor(True))


# ---------------------------------------------------------------------------
# the multi-host stages
# ---------------------------------------------------------------------------

def stages_rank(rank, world, jobs):
    """Run the distributed stages of each job (store root, config json,
    in-memory frames npz or None, stage names) in turn."""
    from scanner_colmap_tpu_torch.parallel import dist as pdist
    from scanner_colmap_tpu_torch.pipeline import ArtifactStore, PipelineConfig, stages

    for root, cfg_json, frames_npz, steps in jobs:
        cfg = PipelineConfig.from_json(cfg_json)
        store = ArtifactStore(root)
        if rank == 0 and not store.has_table("frames"):
            if frames_npz is None:
                stages.prepare_images(cfg, store)
            else:
                f = np.load(frames_npz)
                stages.prepare_images(cfg, store, frames=[
                    (f[k], float(f["focal"])) for k in sorted(f) if k.startswith("frame")])
        pdist.barrier_via_store(store, "frames_ready", timeout_s=120, poll_s=0.2)
        for name in steps:
            getattr(pdist, f"run_{name}_distributed")(cfg, store, device=CPU)
