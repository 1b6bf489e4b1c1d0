"""ATE of the port on the matcher path's chunked runs, the back end off: the
same runs as ``scripts/jax_matcher_ate.py`` makes through the JAX package,
made through ``staticmapping_torch`` on ``--device`` (``cuda`` by default).

It builds the port's ``MapBuilder`` with ``config.build_map_builder`` from
the same config and settings (``scripts/main_path.py::MATCHER_PATH``) and
prints one JSON line a run: the ATE (keyframes matched to the ground truth
by stamp), the keyframe and submap counts and the seconds the run took.
``--permute SEED`` permutes the points within each scan (numpy
``default_rng(SEED)``) before they are inserted, as the JAX script's
option does: the same scans, summed in another order.  It needs torch, not
JAX.

    python3 scripts/torch_matcher_ate.py [--run type3|type5 ...]
        [--permute SEED] [--device cpu]
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


def chunked_run(run, device, permute=None) -> dict:
    from scripts.main_path import (MATCHER_PATH, configure_matcher_run,
                                   matcher_sequence, permute_points,
                                   stamp_matched_ate)
    from staticmapping_torch import config as config_lib
    from staticmapping_torch.io import kitti, synthetic

    scans, gt = matcher_sequence(run, synthetic.make_sequence)
    scans = permute_points(scans, permute)
    cfg = config_lib.load_config(os.path.join(ROOT, MATCHER_PATH["cfg"]))
    cfg.map_builder.export_file_path = tempfile.mkdtemp(prefix="torch_mt_")
    configure_matcher_run(cfg, run)
    mb = config_lib.build_map_builder(cfg, with_backend=False, device=device)
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


def main() -> None:
    from scripts.main_path import MATCHER_PATH
    runs = {r["name"]: r for r in MATCHER_PATH["chunked"]}
    p = argparse.ArgumentParser()
    p.add_argument("--run", action="append", choices=sorted(runs),
                   help="the runs to make (default: all)")
    p.add_argument("--permute", type=int, default=None, metavar="SEED",
                   help="permute the points within each scan")
    p.add_argument("--device", default="cuda")
    args = p.parse_args()
    import torch
    device = torch.device(args.device)
    name_of = (torch.cuda.get_device_name(device) if device.type == "cuda"
               else "cpu")
    for name in args.run or sorted(runs):
        res = chunked_run(runs[name], device, args.permute)
        print(json.dumps({"package": "staticmapping_torch",
                          "device": name_of, "run": name,
                          "matcher_type": runs[name]["matcher_type"],
                          "backend": False, "permute": args.permute,
                          **res}), flush=True)


if __name__ == "__main__":
    main()
