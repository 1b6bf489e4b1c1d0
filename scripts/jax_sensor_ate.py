"""The JAX package on the port's sensor path, run on the CPU: the reference
numbers of ``chip_smoke.py``'s ``sensors`` phase.

It reads ``scripts/main_path.py::SENSOR_PATH``'s copy of
``config/synthetic.xml`` (GPS, odometry and the extrinsic calibration on,
no loop closure) with ``staticmapping_tpu``'s own loader, builds its
``MapBuilder`` with the back end and the chunked front end, feeds the
synthetic square (seed 7, 92 scans) with one GPS fix and one odometry pose
a scan through ``insert_pointcloud`` / ``insert_gps`` / ``insert_odom`` in
stamp order, calls ``finish`` and prints one JSON line: the keyframe and
submap counts, the submap at which the GPS init fired, the GPS coordinate
transform and the calibrated ``tf_odom_lidar``, the ENU error and the ATE
after SE(3) alignment, the static voxels, the size and SHA-256 of
``original_gps.pcd`` and ``original_odom.pcd``, the GPS and odometry
factor counts and the seconds of the pose-graph solves.  It needs JAX, not
torch.

    python3 scripts/jax_sensor_ate.py [--out DIR]
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
    p.add_argument("--out", default=None, metavar="DIR",
                   help="keep the config copy and the outputs here "
                        "(default: a new temporary directory)")
    args = p.parse_args()
    import jax
    if jax.config.jax_platforms != "cpu":
        jax.config.update("jax_platforms", "cpu")
        from jax.extend.backend import clear_backends
        clear_backends()

    from scripts.main_path import (SENSOR_PATH, backend_sequence,
                                   drive_sensor_path, sensor_config,
                                   sensor_feed, sensor_results)
    from staticmapping_tpu import config as config_lib
    from staticmapping_tpu.common import np_se3
    from staticmapping_tpu.common.geo import LocalCartesian
    from staticmapping_tpu.io import kitti, synthetic

    work = args.out or tempfile.mkdtemp(prefix="jax_sensor_")
    os.makedirs(work, exist_ok=True)
    scans, gt = backend_sequence(synthetic.make_sequence)
    cfg = sensor_config(config_lib, os.path.join(ROOT, SENSOR_PATH["cfg"]),
                        work)
    mb = config_lib.build_map_builder(cfg, with_backend=True)
    feed, truth = sensor_feed(gt, LocalCartesian, np_se3)
    t0 = time.perf_counter()
    run = drive_sensor_path(mb, scans, feed, np_se3)
    seconds = time.perf_counter() - t0
    print(json.dumps({
        "package": "staticmapping_tpu", "platform": jax.default_backend(),
        "n_scans": len(scans), **run,
        **sensor_results(mb, gt, truth, kitti.ate_rmse,
                         cfg.map_builder.export_file_path),
        "seconds": seconds}))


if __name__ == "__main__":
    main()
