"""ATE and static-map size of the port's CLI on the CLI path: the port's
side of ``scripts/jax_cli_ate.py``.

It writes the same .bin sequence (``scripts/main_path.py::CLI_PATH``, 64
scans of MAIN_PATH's world at full width), runs ``python -m
staticmapping_torch --cfg config/lidar_only_kitti.xml --kitti DIR
--no-backend`` on it through the CLI's entry point on ``--device`` at the
default widths, and prints one JSON line: the keyframe and submap counts,
the ATE (keyframes of ``path.csv`` matched to the ground truth by stamp),
the voxel count of ``static_map.pcd``, and, with ``--jax-out DIR`` (the
``--out`` of a ``scripts/jax_cli_ate.py`` run), the largest position gap
between the two runs' keyframes of the same stamp and the stamps that only
one run made a keyframe of.  It needs torch, not JAX.

    python3 scripts/torch_cli_ate.py --device cpu [--jax-out DIR] [--out DIR]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def keyframe_gap(frames, ref_frames) -> dict:
    """The largest position gap (m) between keyframes of ``frames`` and
    ``ref_frames`` (``[(stamp, pose)]``) that share a stamp, the stamp it
    is at, and the stamps only one of them holds."""
    ref = {round(st, 6): T for st, T in ref_frames}
    own = {round(st, 6): T for st, T in frames}
    shared = sorted(set(ref) & set(own))
    gaps = [float(np.linalg.norm(own[st][:3, 3] - ref[st][:3, 3]))
            for st in shared]
    worst = int(np.argmax(gaps)) if gaps else None
    return {"max_keyframe_gap_m": gaps[worst] if gaps else None,
            "at_stamp": shared[worst] if gaps else None,
            "shared_keyframes": len(shared),
            "only_port": sorted(set(own) - set(ref)),
            "only_jax": sorted(set(ref) - set(own))}


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--jax-out", default=None, metavar="DIR",
                   help="the outputs of scripts/jax_cli_ate.py --out DIR")
    p.add_argument("--out", default=None, metavar="DIR",
                   help="keep the CLI's outputs here (default: a new "
                        "temporary directory)")
    args = p.parse_args()
    import torch

    from scripts.main_path import (CLI_PATH, MAIN_PATH, cli_sequence,
                                   path_csv_frames, stamp_matched_ate,
                                   write_kitti_bins)
    from staticmapping_torch.__main__ import main as cli_main
    from staticmapping_torch.io import kitti, pcd, synthetic

    scans, gt = cli_sequence(synthetic.make_sequence)
    work = tempfile.mkdtemp(prefix="torch_cli_")
    velodyne = os.path.join(work, "velodyne")
    out = args.out or os.path.join(work, "out")
    write_kitti_bins(velodyne, scans)
    t0 = time.perf_counter()
    rc = cli_main(["--cfg", os.path.join(ROOT, CLI_PATH["cfg"]),
                   "--kitti", velodyne, "--out", out, "--no-backend",
                   "--rate", str(CLI_PATH["rate"]), "--device", args.device,
                   "--quiet"])
    seconds = time.perf_counter() - t0
    frames = path_csv_frames(os.path.join(out, "path.csv"))
    res = {
        "package": "staticmapping_torch",
        "device": (torch.cuda.get_device_name(0) if args.device == "cuda"
                   else "cpu"),
        "rc": rc, "n_scans": len(scans),
        "ate_m": stamp_matched_ate(frames, gt, 1.0 / CLI_PATH["rate"],
                                   kitti.ate_rmse),
        "keyframes": len(frames),
        "submaps": len(kitti.read_poses(os.path.join(out, "kitti_pose.txt"))),
        "static_voxels": len(pcd.read_pcd(os.path.join(out,
                                                       "static_map.pcd"))),
        "seed": MAIN_PATH["seed"], "seconds": seconds, "out": out}
    if args.jax_out:
        res.update(keyframe_gap(
            frames, path_csv_frames(os.path.join(args.jax_out, "path.csv"))))
    print(json.dumps(res))


if __name__ == "__main__":
    main()
