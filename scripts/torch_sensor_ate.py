"""The port on the sensor path: the port's side of
``scripts/jax_sensor_ate.py``.

It reads ``scripts/main_path.py::SENSOR_PATH``'s copy of
``config/synthetic.xml`` (GPS, odometry and the extrinsic calibration on,
no loop closure) with ``staticmapping_torch``'s loader, builds its
``MapBuilder`` on ``--device`` with the back end and the chunked front
end, feeds the synthetic square (seed 7, 92 scans at the default widths)
with one GPS fix and one odometry pose a scan through
``insert_pointcloud`` / ``insert_gps`` / ``insert_odom`` in stamp order,
calls ``finish`` and prints one JSON line with the same figures as the
JAX script.  It needs torch, not JAX.

    python3 scripts/torch_sensor_ate.py --device {cuda,cpu} [--out DIR]
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
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--out", default=None, metavar="DIR",
                   help="keep the config copy and the outputs here "
                        "(default: a new temporary directory)")
    args = p.parse_args()
    import torch

    from scripts.main_path import (SENSOR_PATH, backend_sequence,
                                   drive_sensor_path, sensor_config,
                                   sensor_feed, sensor_results)
    from staticmapping_torch import config as config_lib
    from staticmapping_torch.common import np_se3
    from staticmapping_torch.common.geo import LocalCartesian
    from staticmapping_torch.io import kitti, synthetic

    work = args.out or tempfile.mkdtemp(prefix="torch_sensor_")
    os.makedirs(work, exist_ok=True)
    scans, gt = backend_sequence(synthetic.make_sequence)
    cfg = sensor_config(config_lib, os.path.join(ROOT, SENSOR_PATH["cfg"]),
                        work)
    mb = config_lib.build_map_builder(cfg, with_backend=True,
                                      device=args.device)
    feed, truth = sensor_feed(gt, LocalCartesian, np_se3)
    sync = (torch.cuda.synchronize if args.device == "cuda"
            else (lambda: None))
    t0 = time.perf_counter()
    run = drive_sensor_path(mb, scans, feed, np_se3, sync=sync)
    seconds = time.perf_counter() - t0
    print(json.dumps({
        "package": "staticmapping_torch", "device": args.device,
        "n_scans": len(scans), **run,
        **sensor_results(mb, gt, truth, kitti.ate_rmse,
                         cfg.map_builder.export_file_path),
        "seconds": seconds}))


if __name__ == "__main__":
    main()
