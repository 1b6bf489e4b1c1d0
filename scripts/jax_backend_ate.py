"""ATE and loop closures of the JAX package on the port's back-end path,
run on the CPU.

``chip_smoke.py``'s ``backend`` phase drives ``python -m staticmapping_torch
--synthetic square --scans 0`` with the back end on, on the GPU, and bounds
its ATE by the JAX package's ATE at the same settings.  This script measures
that reference: it builds ``staticmapping_tpu``'s ``MapBuilder`` from
``config/synthetic.xml`` with the back end on, as that package's CLI does
(with ``--pipelined`` where ``scripts/main_path.py::BACKEND_PATH`` asks for
the chunked front end), feeds it the same synthetic square, and prints one
JSON line with the ATE (keyframes matched to the ground truth by stamp), the
loop-closure edges and their count, the loop gap
(``scripts/main_path.py::loop_gap``) and each keyframe's error and ICP
score.  ``--sequential`` runs the sequential front end instead, and
``--no-backend`` leaves the back end off.  ``--trajectory``, ``--scans``
and ``--seed`` swap the world for one of ``scripts/main_path.py::EVAL_ROWS``
(bench.py's eval rows), at the same settings.  It needs JAX, not torch.

    python3 scripts/jax_backend_ate.py [--sequential] [--no-backend]
        [--trajectory square|eight] [--scans N] [--seed S]

On an 8-core CPU shared with other work, with the back end on, it did
not finish in 3 hours (5.6 GB): each of its 26 loop verifications is
18 × 65536 × 8192 points × 40 trips of the plain 1-NN there.  With
``--no-backend`` it took 13–17 minutes.
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
    p.add_argument("--sequential", action="store_true",
                   help="the sequential front end, whatever BACKEND_PATH says")
    p.add_argument("--no-backend", action="store_true")
    p.add_argument("--trajectory", default=None,
                   help="the world's trajectory (BACKEND_PATH's by default)")
    p.add_argument("--scans", type=int, default=None,
                   help="scans (0: the whole trajectory)")
    p.add_argument("--seed", type=int, default=None)
    args = p.parse_args()
    import jax
    import numpy as np
    if jax.config.jax_platforms != "cpu":
        jax.config.update("jax_platforms", "cpu")
        from jax.extend.backend import clear_backends
        clear_backends()

    from scripts.main_path import (BACKEND_PATH, backend_sequence,
                                   keyframe_errors, loop_gap,
                                   stamp_matched_ate)
    from staticmapping_tpu import config as config_lib
    from staticmapping_tpu.io import kitti, synthetic

    world = {k: v for k, v in (("trajectory", args.trajectory),
                               ("n_scans", args.scans),
                               ("seed", args.seed)) if v is not None}
    scans, gt = backend_sequence(synthetic.make_sequence, **world)
    rel_gt = [np.linalg.solve(gt[0], g) for g in gt]
    cfg = config_lib.load_config(os.path.join(ROOT, BACKEND_PATH["cfg"]))
    cfg.map_builder.export_file_path = tempfile.mkdtemp(prefix="jax_be_")
    pipelined = BACKEND_PATH["pipelined"] and not args.sequential
    if pipelined:                     # as the CLI's --pipelined sets it
        cfg.map_builder.pipelined = True
        cfg.map_builder.pipeline_chunk = BACKEND_PATH["chunk"]
        cfg.map_builder.pair_match_batch = 16
    mb = config_lib.build_map_builder(cfg, with_backend=not args.no_backend)
    period = 1.0 / BACKEND_PATH["rate"]
    t0 = time.perf_counter()
    for i, pts in enumerate(scans):
        mb.insert_pointcloud(i * period, pts)
    mb.finish()
    seconds = time.perf_counter() - t0
    be = mb.backend
    frames = [(f.stamp, f.global_pose, f.match_score)
              for s in mb.trajectory for f in s.frames]
    edges = [] if be is None else [
        (int(i), int(j)) for i, j in zip(be.graph.factors.i,
                                         be.graph.factors.j) if j != i + 1]
    print(json.dumps({
        "package": "staticmapping_tpu", "platform": jax.default_backend(),
        "n_scans": len(scans), "submaps": len(mb.trajectory),
        "ate_m": stamp_matched_ate([f[:2] for f in frames], gt, period,
                                   kitti.ate_rmse),
        "loop_edge_count": 0 if be is None else be.loop_edge_count,
        "loop_edges": edges,
        "use_descriptor": cfg.loop_detector.use_descriptor,
        "loop_gap_m": loop_gap([s.global_pose for s in mb.trajectory],
                               [s.stamp for s in mb.trajectory], rel_gt,
                               period),
        "pipelined": pipelined, "backend": be is not None,
        "trajectory": world.get("trajectory", BACKEND_PATH["trajectory"]),
        "seed": world.get("seed", BACKEND_PATH["seed"]), "seconds": seconds,
        "frames": keyframe_errors(frames, gt, period)}))


if __name__ == "__main__":
    main()
