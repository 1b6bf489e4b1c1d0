"""ATE of the JAX package on the port's matcher path, run on the CPU with the
back end off.

``chip_smoke.py``'s ``matchers`` phase drives matcher types 3 and 5 through
the chunked front end with the back end on, and type 1 through the CLI
with ``--no-backend``, on the GPU (``scripts/main_path.py::MATCHER_PATH``).
Each run's ATE is held to max(2 x this script's ATE on the same scans
without the back end, the bound of tests/test_matcher_e2e.py for the type).
It builds ``staticmapping_tpu``'s ``MapBuilder`` from the same config with
the same settings and prints one JSON line a run: the ATE (keyframes
matched to the ground truth by stamp), the keyframe and submap counts and
the seconds the run took.  It needs JAX, not torch.  ``--permute SEED``
permutes the points within each scan (numpy ``default_rng(SEED)``) before
they are inserted; ``scripts/torch_matcher_ate.py`` makes the same chunked
runs through the port.

    python3 scripts/jax_matcher_ate.py [--run type3|type5|type1 ...]
        [--permute SEED]
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


def chunked_run(run, permute=None) -> dict:
    from scripts.main_path import (MATCHER_PATH, configure_matcher_run,
                                   matcher_sequence, permute_points,
                                   stamp_matched_ate)
    from staticmapping_tpu import config as config_lib
    from staticmapping_tpu.io import kitti, synthetic

    scans, gt = matcher_sequence(run, synthetic.make_sequence)
    scans = permute_points(scans, permute)
    cfg = config_lib.load_config(os.path.join(ROOT, MATCHER_PATH["cfg"]))
    cfg.map_builder.export_file_path = tempfile.mkdtemp(prefix="jax_mt_")
    configure_matcher_run(cfg, run)
    mb = config_lib.build_map_builder(cfg, with_backend=False)
    period = 1.0 / MATCHER_PATH["rate"]
    t0 = time.perf_counter()
    for i, pts in enumerate(scans):
        mb.insert_pointcloud(i * period, pts)
    mb.finish()
    seconds = time.perf_counter() - t0
    frames = [(f.stamp, f.global_pose) for s in mb.trajectory
              for f in s.frames]
    return {"n_scans": len(scans), "submaps": len(mb.trajectory),
            "keyframes": len(frames),
            "ate_m": stamp_matched_ate(frames, gt, period, kitti.ate_rmse),
            "seconds": seconds}


def sequential_run(run, permute=None) -> dict:
    from scripts.main_path import (CLI_PATH, cli_sequence, path_csv_frames,
                                   permute_points, stamp_matched_ate,
                                   write_kitti_bins, write_matcher_cfg)
    from staticmapping_tpu.__main__ import main as cli_main
    from staticmapping_tpu.io import kitti, synthetic

    scans, gt = cli_sequence(synthetic.make_sequence, run["n_scans"])
    scans = permute_points(scans, permute)
    work = tempfile.mkdtemp(prefix="jax_mt1_")
    velodyne, out = os.path.join(work, "velodyne"), os.path.join(work, "out")
    write_kitti_bins(velodyne, scans)
    cfg = os.path.join(work, "matcher.xml")
    write_matcher_cfg(os.path.join(ROOT, run["cfg"]), run["matcher_type"],
                      cfg)
    t0 = time.perf_counter()
    rc = cli_main(["--cfg", cfg, "--kitti", velodyne, "--out", out,
                   "--no-backend", "--rate", str(CLI_PATH["rate"]),
                   "--quiet"])
    seconds = time.perf_counter() - t0
    frames = path_csv_frames(os.path.join(out, "path.csv"))
    return {"rc": rc, "n_scans": len(scans),
            "submaps": len(kitti.read_poses(os.path.join(
                out, "kitti_pose.txt"))),
            "keyframes": len(frames),
            "ate_m": stamp_matched_ate(frames, gt, 1.0 / CLI_PATH["rate"],
                                       kitti.ate_rmse),
            "seconds": seconds}


def main() -> None:
    from scripts.main_path import MATCHER_PATH
    runs = {r["name"]: r for r in MATCHER_PATH["chunked"]}
    seq = MATCHER_PATH["sequential"]
    p = argparse.ArgumentParser()
    p.add_argument("--run", action="append",
                   choices=sorted(runs) + [seq["name"]],
                   help="the runs to make (default: all)")
    p.add_argument("--permute", type=int, default=None, metavar="SEED",
                   help="permute the points within each scan")
    args = p.parse_args()
    import jax
    if jax.config.jax_platforms != "cpu":
        jax.config.update("jax_platforms", "cpu")
        from jax.extend.backend import clear_backends
        clear_backends()
    for name in args.run or sorted(runs) + [seq["name"]]:
        res = sequential_run(seq, args.permute) if name == seq["name"] \
            else chunked_run(runs[name], args.permute)
        print(json.dumps({"package": "staticmapping_tpu",
                          "platform": jax.default_backend(), "run": name,
                          "matcher_type": (seq if name == seq["name"]
                                           else runs[name])["matcher_type"],
                          "backend": False, "permute": args.permute, **res}),
              flush=True)


if __name__ == "__main__":
    main()
