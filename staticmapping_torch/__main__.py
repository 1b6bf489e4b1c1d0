"""Command-line entry point — the PyTorch counterpart of
``python -m staticmapping_tpu`` (the ``static_mapping_node`` role,
ros_node/static_mapping_node.cpp:92-455, without ROS): run a whole dataset
through the pipeline and write every output.

    python -m staticmapping_torch --cfg config/lidar_only_kitti.xml \\
        --kitti /data/kitti/00/velodyne --out out/
    python -m staticmapping_torch --synthetic square --scans 0 --out out/ \\
        --device cpu

Inputs: a KITTI velodyne ``.bin`` directory (KittiReader,
ros_node/kitti_reader.cc:87-121) or the built-in synthetic world.  Outputs
(SaveMaps, map_builder.cc:825-911): ``kitti_pose.txt``, ``path.csv``,
``static_map.pcd``, ``whole_map.pcd``, and ``gt_pose.txt`` for the synthetic
world.  The pose-graph back end (loop closing and optimization) is on
unless ``--no-backend`` is given.  Work runs on ``--device`` (``cuda`` by
default).
"""
from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="staticmapping_torch",
        description="LiDAR SLAM on PyTorch/CUDA (StaticMapping capability "
                    "parity)")
    p.add_argument("--cfg", default=None,
                   help="XML config file (reference vocabulary, "
                        "config/static_mapping_default.xml names)")
    src = p.add_mutually_exclusive_group()
    src.add_argument("--kitti", default=None, metavar="VELODYNE_DIR",
                     help="KITTI odometry velodyne .bin directory")
    src.add_argument("--synthetic", default=None, nargs="?", const="square",
                     choices=["square", "straight", "figure_eight"],
                     help="drive the built-in synthetic world")
    p.add_argument("--scans", type=int, default=0,
                   help="max scans (0 = trajectory default / all files)")
    p.add_argument("--out", default=None, help="output directory "
                   "(overrides whole_options.export_file_path)")
    p.add_argument("--no-backend", action="store_true",
                   help="front-end odometry only (no loop closing/opt)")
    p.add_argument("--pipelined", action="store_true",
                   help="chunked device-resident front end (one chunk of "
                        "scans at a time)")
    p.add_argument("--chunk", type=int, default=16,
                   help="pipeline chunk size (scans per chunk)")
    p.add_argument("--rate", type=float, default=10.0,
                   help="nominal sensor rate in Hz for scan stamps")
    p.add_argument("--gt", default=None, metavar="POSES_TXT",
                   help="KITTI-format ground-truth poses; prints ATE/RPE "
                        "after the run (doc/kitti_evaluation.md protocol)")
    p.add_argument("--urdf", default=None,
                   help="URDF file for static sensor extrinsics "
                        "(-urdf role, static_mapping_node.cpp:319-356)")
    p.add_argument("--track", default="base_link",
                   help="tracking frame link name in the URDF")
    p.add_argument("--profile", action="store_true",
                   help="print the named-block timing table at exit "
                        "(simple_prof.cc:61-122 role)")
    p.add_argument("--log-resources", action="store_true",
                   help="sample CPU%% and memory to "
                        "~/.staticmapping_torch_log (ProcessProfiler role, "
                        "process_info.h:46-66)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where clouds and kernels run (default: cuda)")
    p.add_argument("--quiet", action="store_true")
    return p


def _synthetic_config() -> str:
    """``config/synthetic.xml`` of the repository this package sits in: the
    synthetic world's own knobs (density-normalized scores, sparse-world
    z gate)."""
    return os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "config", "synthetic.xml")


def run(args: argparse.Namespace):
    """Build the ``MapBuilder`` that ``args`` describe, feed it every scan,
    write the outputs and print the summary (and ATE/RPE under ``--gt``).
    Returns the finished builder."""
    from . import config as config_lib
    from .common import prof
    from .io import kitti as kitti_io
    from .io import synthetic

    cfg_path = args.cfg
    if cfg_path is None and args.kitti is None:   # synthetic-world run
        # an explicit --cfg wins
        if os.path.exists(_synthetic_config()):
            cfg_path = _synthetic_config()
    cfg = config_lib.load_config(cfg_path)
    if args.out:
        cfg.map_builder.export_file_path = args.out
    if args.pipelined:
        cfg.map_builder.pipelined = True
        cfg.map_builder.pipeline_chunk = args.chunk
        cfg.map_builder.pair_match_batch = 16
    if args.profile:
        prof.enable(report_at_exit=False)
    profiler = None
    if args.log_resources:
        from .common.process_info import ProcessProfiler
        profiler = ProcessProfiler().start()

    mb = config_lib.build_map_builder(cfg, with_backend=not args.no_backend,
                                      device=args.device)
    if args.urdf:
        from .io.urdf import apply_urdf_extrinsics
        apply_urdf_extrinsics(mb, args.urdf, tracking_frame=args.track)

    # ---- input source ----
    if args.kitti:
        files = kitti_io.list_sequence(args.kitti)
        if not files:
            raise FileNotFoundError(f"no .bin files in {args.kitti}")
        if args.scans:
            files = files[:args.scans]
        n_total = len(files)

        def scan_iter():
            for i, f in enumerate(files):
                yield i / args.rate, kitti_io.read_bin(f)
    else:
        traj = args.synthetic or "square"
        scans, gt_poses = synthetic.make_sequence(
            n_scans=args.scans, trajectory=traj, seed=7)
        n_total = len(scans)
        # ground truth for the synthetic world, sensor-relative like the
        # estimate, so the ATE/RPE protocol works without datasets
        os.makedirs(cfg.map_builder.export_file_path, exist_ok=True)
        kitti_io.write_poses(
            os.path.join(cfg.map_builder.export_file_path, "gt_pose.txt"),
            [np.linalg.solve(gt_poses[0], g) for g in gt_poses])

        def scan_iter():
            for i, pts in enumerate(scans):
                yield i / args.rate, pts

    # ---- the pipeline loop (ScanMatchProcessing drive) ----
    t0 = time.time()
    n_done = 0
    for stamp, points in scan_iter():
        mb.insert_pointcloud(stamp, points)
        n_done += 1
        if not args.quiet and (n_done % 10 == 0 or n_done == n_total):
            el = time.time() - t0
            print(f"\r[{n_done}/{n_total}] scans  "
                  f"{n_done / max(el, 1e-9):6.1f} scans/s  "
                  f"submaps={len(mb.trajectory)}",
                  end="", flush=True)
    if not args.quiet:
        print()

    mb.finish()
    el = time.time() - t0
    if not args.quiet:
        print(f"done: {n_done} scans in {el:.1f}s "
              f"({n_done / max(el, 1e-9):.1f} scans/s), "
              f"{len(mb.trajectory)} submaps, "
              f"outputs in {cfg.map_builder.export_file_path}")
    if args.gt:
        # stamp-match keyframes to ground-truth rows: kitti_pose.txt is per
        # submap while the ground truth is per scan
        gt = kitti_io.read_poses(args.gt)
        pairs = []
        for s in mb.trajectory:
            for f in s.frames:
                gi = int(round(f.stamp * args.rate))
                if 0 <= gi < len(gt):
                    pairs.append((f.global_pose, gt[gi]))
        if pairs:
            est = np.stack([p[0] for p in pairs])
            gtm = np.stack([p[1] for p in pairs])
            ate = kitti_io.ate_rmse(est, gtm)
            t_rpe, r_rpe = kitti_io.rpe(est, gtm)
            print(f"ATE RMSE: {ate:.3f} m over {len(pairs)} keyframes   "
                  f"RPE: {t_rpe:.3f} m / {np.degrees(r_rpe):.3f} deg")
    if args.profile:
        prof.report()
    if profiler is not None:
        profiler.stop()
    return mb


def main(argv=None) -> int:
    args = make_parser().parse_args(argv)
    try:
        run(args)
    except (NotImplementedError, FileNotFoundError) as e:
        print(f"staticmapping_torch: {e}", file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
