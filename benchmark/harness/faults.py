"""Faults a cell can have, planted underneath the timed path, each of which
the check has to catch: a step that returns its state unchanged (every LM
trial of the bundle adjustment; every PatchMatch sweep), half of each
extraction batch left out, and an answer altered where it is produced (one
pose of the merged model). A one-chip cell has no exchange between chips
to leave out.

    with planted("half_batch"):
        ...   # install the Recorder inside, so that it wraps the fault

``benchmark/tests/test_bench_check.py`` runs each at a test's size;
``benchmark/calibrate.py --faults`` reads each at a cell's own size.
"""

from __future__ import annotations

import contextlib


def _state_unchanged_sparse():
    from scanner_colmap_tpu_torch.ops import ba

    return ba, "_lm_trial", lambda params, *a, **k: params


def _state_unchanged_dense():
    from scanner_colmap_tpu_torch.kernels import plane_cost as pc

    return pc, "plane_cost_sweep", lambda *a, **k: None


def _half_batch():
    from scanner_colmap_tpu_torch.ops import sift

    extract = sift.extract_batch

    def half(*a, **k):
        feats = extract(*a, **k)
        feats.valid[1::2] = False
        return feats

    return sift, "extract_batch", half


def _answer_altered():
    from scanner_colmap_tpu_torch.pipeline import stages

    merge = stages.run_merge

    def altered(*a, **k):
        model = merge(*a, **k)
        iid = sorted(model.registered_image_ids)[3]
        model.images[iid].tvec = model.images[iid].tvec + 0.2
        return model

    return stages, "run_merge", altered


FAULTS = {"state_unchanged_sparse": _state_unchanged_sparse,
          "state_unchanged_dense": _state_unchanged_dense,
          "half_batch": _half_batch,
          "answer_altered": _answer_altered}
DENSE_ONLY = ("state_unchanged_dense",)


def applicable(traffic: dict) -> list:
    """The faults a cell of this traffic can have."""
    return [f for f in FAULTS if traffic.get("dense", False) or f not in DENSE_ONLY]


@contextlib.contextmanager
def planted(name: str):
    """The fault ``name`` in place of the program's own code, for the block."""
    module, attr, fault = FAULTS[name]()
    old = getattr(module, attr)
    setattr(module, attr, fault)
    try:
        yield
    finally:
        setattr(module, attr, old)
