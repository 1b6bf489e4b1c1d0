"""ATE and static-map size of the JAX package's CLI on the port's CLI path,
run on the CPU.

``chip_smoke.py`` drives ``python -m staticmapping_torch --cfg
config/lidar_only_kitti.xml --kitti DIR --no-backend`` on the GPU and bounds
its ATE by the JAX package's ATE at the same settings.  This script
measures that reference: it writes the same .bin sequence
(``scripts/main_path.py::CLI_PATH``), runs ``staticmapping_tpu``'s CLI on it
with the same arguments, and prints one JSON line with the ATE (keyframes of
``path.csv`` matched to the ground truth by stamp), the keyframe and submap
counts and the voxel count of ``static_map.pcd``.  It needs JAX, not torch.

    python3 scripts/jax_cli_ate.py

It took about 7 minutes and 3 GiB on an 8-core CPU.
"""
from __future__ import annotations

import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> None:
    import jax
    if jax.config.jax_platforms != "cpu":
        jax.config.update("jax_platforms", "cpu")
        from jax.extend.backend import clear_backends
        clear_backends()

    from scripts.main_path import (CLI_PATH, MAIN_PATH, cli_sequence,
                                   path_csv_frames, stamp_matched_ate,
                                   write_kitti_bins)
    from staticmapping_tpu.__main__ import main as cli_main
    from staticmapping_tpu.io import kitti, pcd, synthetic

    scans, gt = cli_sequence(synthetic.make_sequence)
    work = tempfile.mkdtemp(prefix="jax_cli_")
    velodyne, out = os.path.join(work, "velodyne"), os.path.join(work, "out")
    write_kitti_bins(velodyne, scans)
    t0 = time.perf_counter()
    rc = cli_main(["--cfg", os.path.join(ROOT, CLI_PATH["cfg"]),
                   "--kitti", velodyne, "--out", out, "--no-backend",
                   "--rate", str(CLI_PATH["rate"]), "--quiet"])
    seconds = time.perf_counter() - t0
    frames = path_csv_frames(os.path.join(out, "path.csv"))
    print(json.dumps({
        "package": "staticmapping_tpu", "platform": jax.default_backend(),
        "rc": rc, "n_scans": len(scans),
        "ate_m": stamp_matched_ate(frames, gt, 1.0 / CLI_PATH["rate"],
                                   kitti.ate_rmse),
        "keyframes": len(frames),
        "submaps": len(kitti.read_poses(os.path.join(out, "kitti_pose.txt"))),
        "static_voxels": len(pcd.read_pcd(os.path.join(out,
                                                       "static_map.pcd"))),
        "seed": MAIN_PATH["seed"], "seconds": seconds}))


if __name__ == "__main__":
    main()
