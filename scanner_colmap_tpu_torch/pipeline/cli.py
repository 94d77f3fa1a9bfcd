"""Command line of the port (port of ``pipeline/cli.py``): one program with a
subcommand per stage, ``all``, the COLMAP database interchange and ``set``.

The subcommands, their flags and the config they build are the JAX CLI's;
the shared flags work before or after the subcommand. One flag is the
port's own: ``--device`` (default ``cuda``), the device every stage runs
on; ``--device cpu`` runs on the CPU. Without a card and without
``--device cpu`` a stage raises.

    python -m scanner_colmap_tpu_torch.pipeline.cli all \\
        --image_path imgs/ --store_path artifacts/ --export_path sparse/ \\
        --ply_path fused.ply --mesh_path mesh.ply
    python -m scanner_colmap_tpu_torch.pipeline.cli all --sparse_only --resume \\
        --store_path artifacts/            # skip the stages whose tables exist
    python -m scanner_colmap_tpu_torch.pipeline.cli extraction --store_path artifacts/
    python -m scanner_colmap_tpu_torch.pipeline.cli set matching.overlap=5 \\
        --out cfg.json                     # a config file for --config

``--profile_dir DIR`` records a ``torch.profiler`` trace: one per stage
under ``DIR/<stage>/`` for ``all``, else one for the subcommand; a stage
that raises still writes its trace. It also turns the program's spans and
counters on (``utils/metrics``): each span is a range of the trace,
named ``scanner.<span>``. ``all`` writes each stage's time, launches and
peak memory to ``<store>/metrics.json``, and with ``--profile_dir`` the
stage's spans (``span.<name>.n``, ``.s``, ``.self_s``) and counters
(``count.<name>``) beside them.
"""

from __future__ import annotations

import argparse
import ast
import logging
import os
import sys

from scanner_colmap_tpu_torch.utils.config import PipelineConfig


def build_parser() -> argparse.ArgumentParser:
    # the shared flags sit on a parent parser, so that they work before and
    # after the subcommand; their defaults are SUPPRESS, because a subparser
    # writes its defaults into the shared namespace after the main parser
    # ran and would clobber a flag given before the subcommand
    common = argparse.ArgumentParser(add_help=False, argument_default=argparse.SUPPRESS)
    common.add_argument("--config", help="JSON config file (serialized PipelineConfig)")
    common.add_argument("--store_path", help="artifact store directory")
    common.add_argument("--image_path", help="input image directory")
    common.add_argument("--profile_dir",
                        help="record a torch.profiler trace of the run into this "
                             "directory (one per stage for 'all')")
    common.add_argument("--device",
                        help="device of every stage: cuda (default) or cpu")
    common.add_argument("-v", "--verbose", action="store_true")

    p = argparse.ArgumentParser(
        prog="scanner_colmap_tpu_torch",
        description="the SfM and MVS pipeline on PyTorch and CUDA",
        parents=[common])
    sub = p.add_subparsers(dest="stage", required=True)

    pi = sub.add_parser("prepare_images", parents=[common], help="stage 1: ingest + id assignment")
    pi.add_argument("--stride", type=int, default=1, help="sample every Nth frame")
    pi.add_argument("--range", type=int, nargs=2, metavar=("START", "END"),
                    help="frame index range [START, END)")

    e = sub.add_parser("extraction", parents=[common], help="stage 2: SIFT features")
    e.add_argument("--max_image_size", type=int)
    e.add_argument("--max_num_features", type=int)

    m = sub.add_parser("feature_matching", parents=[common], help="stage 3: windowed matching")
    m.add_argument("--overlap", type=int, help="match window size (ref default 10)")

    mp = sub.add_parser("incremental_mapping", parents=[common], help="stage 4: clustered SfM")
    mp.add_argument("--cluster_size", type=int)
    mp.add_argument("--cluster_overlap", type=int)

    mg = sub.add_parser("merge_mapping", parents=[common], help="stage 5: merge submodels")
    mg.add_argument("--export_path", help="COLMAP-binary export directory")

    ud = sub.add_parser("undistort", parents=[common],
                        help="stage 5b: undistort registered images to pinhole "
                             "(dense-ready workspace)")
    ud.add_argument("--output_path", help="workspace dir (default <store>/undistort_ws)")
    sub.add_parser("prepare_patch_match", parents=[common],
                   help="stage 6: MVS problem prep")
    pm = sub.add_parser("patch_match", parents=[common],
                        help="stage 7: PatchMatch depth/normals")
    pm.add_argument("--pm_overlap", type=int, help="source view count")
    f = sub.add_parser("stereo_fusion", parents=[common],
                       help="stage 8: fuse depth maps")
    f.add_argument("--ply_path", help="write fused cloud as PLY")
    msh = sub.add_parser("meshing", parents=[common],
                         help="stage 9: TSDF + marching tetrahedra mesh")
    msh.add_argument("--mesh_path", help="write triangle mesh as PLY")

    idb = sub.add_parser("import_colmap_db", parents=[common],
                         help="import a COLMAP SQLite database.db as the frames, "
                              "extraction and matching tables")
    idb.add_argument("--database_path", required=True)
    idb.add_argument("--no_pose_rebuild", action="store_true",
                     help="skip rebuilding pose/tri_angle from E")

    edb = sub.add_parser("export_colmap_db", parents=[common],
                         help="export the store's features and matches as a COLMAP "
                              "database.db")
    edb.add_argument("--database_path", required=True)

    st = sub.add_parser("set", parents=[common],
                        help="write dotted-key config overrides into a JSON config file "
                             "(e.g. matching.overlap=5 sift.upright=true)")
    st.add_argument("overrides", nargs="+", metavar="KEY=VALUE")
    st.add_argument("--out", help="output config path (default: --config path, or "
                                  "<store_path>/pipeline_config.json)")

    a = sub.add_parser("all", parents=[common], help="run the full pipeline")
    a.add_argument("--export_path")
    a.add_argument("--ply_path")
    a.add_argument("--mesh_path", help="write triangle mesh as PLY")
    a.add_argument("--no_mesh", action="store_true", help="skip the meshing stage")
    a.add_argument("--sparse_only", action="store_true")
    a.add_argument("--resume", action="store_true",
                   help="skip stages whose output table already exists")
    a.add_argument("--max_image_size", type=int)
    a.add_argument("--max_num_features", type=int)
    a.add_argument("--overlap", type=int)
    a.add_argument("--cluster_size", type=int)
    a.add_argument("--cluster_overlap", type=int)
    a.add_argument("--pm_overlap", type=int)
    return p


def config_from_args(args) -> PipelineConfig:
    if args.config:
        with open(args.config) as f:
            cfg = PipelineConfig.from_json(f.read())
    else:
        cfg = PipelineConfig()
    if args.store_path:
        cfg.store_path = args.store_path
    if args.image_path:
        cfg.image_path = args.image_path
    for name, target in [
        ("max_image_size", "sift.max_image_size"),
        ("max_num_features", "sift.max_num_features"),
        ("overlap", "matching.overlap"),
        ("cluster_size", "mapper.cluster_size"),
        ("cluster_overlap", "mapper.cluster_overlap"),
        ("pm_overlap", "patch_match.overlap"),
    ]:
        v = getattr(args, name, None)
        if v is not None:
            cfg.apply_overrides({target: v})
    return cfg


def parse_args(argv=None):
    args = build_parser().parse_args(argv)
    # the shared flags have SUPPRESS defaults (see build_parser): fill in the
    # real defaults of those never given
    for key, dflt in (("config", None), ("store_path", None), ("image_path", None),
                      ("verbose", False), ("profile_dir", None), ("device", "cuda")):
        if not hasattr(args, key):
            setattr(args, key, dflt)
    return args


def _set_config(args, cfg) -> int:
    for kv in args.overrides:
        key, sep, val = kv.partition("=")
        if not sep:
            raise SystemExit(f"expected KEY=VALUE, got {kv!r}")
        try:
            val = ast.literal_eval(val)
        except (ValueError, SyntaxError):
            if val.lower() in ("true", "false"):
                val = val.lower() == "true"
        cfg.apply_overrides({key.strip(): val})
    out = args.out or args.config or os.path.join(cfg.store_path, "pipeline_config.json")
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    with open(out, "w") as f:
        f.write(cfg.to_json())
    print(f"wrote {out}")
    return 0


def main(argv=None):
    args = parse_args(argv)
    logging.basicConfig(level=logging.DEBUG if args.verbose else logging.INFO,
                        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    cfg = config_from_args(args)
    if args.stage == "set":
        return _set_config(args, cfg)
    from scanner_colmap_tpu_torch.pipeline import stages
    from scanner_colmap_tpu_torch.utils.metrics import device_trace
    from scanner_colmap_tpu_torch.utils.store import ArtifactStore

    store = ArtifactStore(cfg.store_path)
    with open(os.path.join(cfg.store_path, "pipeline_config.json"), "w") as f:
        f.write(cfg.to_json())         # the effective config beside the artifacts
    if args.stage == "all":            # one trace per stage
        stages.run_all(cfg, export_path=args.export_path, ply_path=args.ply_path,
                       dense=not args.sparse_only, resume=args.resume,
                       mesh_path=args.mesh_path, mesh=not args.no_mesh,
                       device=args.device, profile_dir=args.profile_dir)
    else:
        with device_trace(args.profile_dir):
            _dispatch_stage(args, cfg, stages, store)
    if args.profile_dir:
        logging.getLogger(__name__).info("profile trace written to %s", args.profile_dir)
    return 0


def _dispatch_stage(args, cfg, stages, store):
    dev = args.device
    if args.stage == "prepare_images":
        stages.prepare_images(cfg, store, stride=args.stride,
                              frame_range=tuple(args.range) if args.range else None)
    elif args.stage == "extraction":
        stages.run_extraction(cfg, store, device=dev)
    elif args.stage == "feature_matching":
        stages.run_matching(cfg, store, device=dev)
    elif args.stage == "incremental_mapping":
        stages.run_mapping(cfg, store, device=dev)
    elif args.stage == "merge_mapping":
        stages.run_merge(cfg, store, export_path=args.export_path, device=dev)
    elif args.stage == "undistort":
        stages.run_undistort(cfg, store, output_path=args.output_path, device=dev)
    elif args.stage == "prepare_patch_match":
        stages.run_prepare_patch_match(cfg, store)
    elif args.stage == "patch_match":
        stages.run_patch_match(cfg, store, device=dev)
    elif args.stage == "stereo_fusion":
        stages.run_fusion(cfg, store, ply_path=args.ply_path, device=dev)
    elif args.stage == "meshing":
        stages.run_meshing(cfg, store, mesh_path=args.mesh_path, device=dev)
    elif args.stage == "import_colmap_db":
        stages.import_colmap_db(cfg, store, database_path=args.database_path,
                                recompute_pose=not args.no_pose_rebuild, device=dev)
    elif args.stage == "export_colmap_db":
        stages.export_colmap_db(cfg, store, database_path=args.database_path)


if __name__ == "__main__":
    sys.exit(main())
