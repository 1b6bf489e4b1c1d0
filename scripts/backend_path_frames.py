"""The port's back-end path with each keyframe held against the ground
truth: where a front end jumps, and whether the loop closes after it.

Runs ``python -m staticmapping_torch --synthetic square --scans 0`` through
its entry point at ``scripts/main_path.py::BACKEND_PATH`` and prints one
JSON line with the ATE, the loop gap, the loop edges and each keyframe's
error and ICP score: the fields of ``scripts/jax_backend_ate.py``, which
measures the JAX package at the same settings.  ``--sequential`` runs the
sequential front end, ``--no-backend`` leaves the back end off; both may be
given.  GPU by default (``--device cpu`` takes minutes a scan).

    python3 scripts/backend_path_frames.py [--sequential] [--no-backend]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--sequential", action="store_true")
    p.add_argument("--no-backend", action="store_true")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args()

    from scripts.main_path import (BACKEND_PATH, keyframe_errors, loop_gap,
                                   stamp_matched_ate)
    from staticmapping_torch import __main__ as cli
    from staticmapping_torch.io import kitti

    B = BACKEND_PATH
    pipelined = B["pipelined"] and not args.sequential
    out = tempfile.mkdtemp(prefix="backend_path_")
    argv = ["--synthetic", B["trajectory"], "--scans", str(B["n_scans"]),
            "--out", out, "--device", args.device, "--quiet"]
    if pipelined:
        argv += ["--pipelined", "--chunk", str(B["chunk"])]
    if args.no_backend:
        argv.append("--no-backend")
    t0 = time.perf_counter()
    mb = cli.run(cli.make_parser().parse_args(argv))
    seconds = time.perf_counter() - t0
    period = 1.0 / B["rate"]
    gt = list(kitti.read_poses(os.path.join(out, "gt_pose.txt")))
    frames = [(f.stamp, f.global_pose, f.match_score)
              for s in mb.trajectory for f in s.frames]
    be = mb.backend
    edges = [] if be is None else [
        (int(i), int(j)) for i, j in zip(be.graph.factors.i,
                                         be.graph.factors.j) if j != i + 1]
    print(json.dumps({
        "package": "staticmapping_torch", "device": args.device,
        "n_scans": len(gt), "submaps": len(mb.trajectory),
        "ate_m": stamp_matched_ate([f[:2] for f in frames], gt, period,
                                   kitti.ate_rmse),
        "loop_edge_count": 0 if be is None else be.loop_edge_count,
        "loop_edges": edges,
        "loop_gap_m": loop_gap([s.global_pose for s in mb.trajectory],
                               [s.stamp for s in mb.trajectory], gt, period),
        "pipelined": pipelined, "backend": be is not None,
        "seed": B["seed"], "seconds": seconds,
        "frames": keyframe_errors(frames, gt, period)}))


if __name__ == "__main__":
    main()
