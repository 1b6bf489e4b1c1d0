"""Times the voxel segment reductions of one or more checkouts on one GPU.

    python3 scripts/segment_sum_times.py [ROOT ...]

For each ROOT in the order given (default: this checkout), a fresh Python
process imports ROOT's ``staticmapping_torch`` and times, on the same
seeded inputs, the device work of the calls that sum per-voxel segments:
- ``scan_events_ms``: ``builder/mrvm.py::_scan_events`` of one CLI-path
  scan in a 65536-slot submap, 96 ray steps at 0.1 m (about 6.3 M events,
  the MRVM export's device reduction of one submap);
- ``downsample_32768_ms`` / ``downsample_65536_ms``: ``ops/voxel.py::
  voxel_downsample`` at 0.1 m of one scan in the scan capacity and of two
  scans in the submap capacity (the main path's voxel filters);
- ``ndt_stats_ms``: ``voxel_stats_floor`` at 1 m of one scan (NDT's field;
  only where ROOT has it).
Each is the mean of ``reps`` calls issued from Python between CUDA events,
after a warm call.  One JSON line per ROOT.  To compare two checkouts,
name them in turns (``A B B A``) in one run on one card.  GPU only;
imports no JAX.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def eager_ms(fn, reps: int) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def one(root: str) -> dict:
    sys.path.insert(0, root)
    sys.path.insert(0, HERE)
    import numpy as np
    import torch
    from main_path import cli_sequence
    from staticmapping_torch.builder import mrvm
    from staticmapping_torch.data import cloud as cloud_lib
    from staticmapping_torch.io import synthetic
    from staticmapping_torch.ops import voxel

    dev = torch.device("cuda")
    scans, gt = cli_sequence(synthetic.make_sequence, 2)
    pts0 = scans[0][:, :3].astype(np.float32)
    pts1 = (scans[1][:, :3] @ gt[1][:3, :3].T + gt[1][:3, 3]).astype(
        np.float32)
    scan = cloud_lib.from_numpy(pts0, capacity=32768, device=dev)
    submap = cloud_lib.from_numpy(pts0, capacity=65536, device=dev)
    pair = cloud_lib.from_numpy(np.concatenate([pts0, pts1]),
                                capacity=65536, device=dev)
    s = mrvm.MrvmSettings()
    origin = torch.tensor([0.0, 0.0, s.z_offset], device=dev)
    out = {"root": root,
           "points": [int(scan.num_valid()), int(pair.num_valid())],
           "scan_events_ms": eager_ms(lambda: mrvm._scan_events(
               submap.xyz, submap.mask, submap.intensity, origin,
               s.high_resolution, s.max_ray_steps), 5),
           "downsample_32768_ms": eager_ms(
               lambda: voxel.voxel_downsample(scan, 0.1), 20),
           "downsample_65536_ms": eager_ms(
               lambda: voxel.voxel_downsample(pair, 0.1), 20)}
    if hasattr(voxel, "voxel_stats_floor"):
        out["ndt_stats_ms"] = eager_ms(lambda: voxel.voxel_stats_floor(
            scan, 1.0, torch.zeros(3, device=dev)), 20)
    return out


def main(argv) -> int:
    if argv[:1] == ["--one"]:
        print(json.dumps(one(os.path.abspath(argv[1]))), flush=True)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("segment_sum_times.py needs a CUDA device", file=sys.stderr)
        return 2
    for root in argv or [os.path.dirname(HERE)]:
        res = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--one", root], capture_output=True, text=True)
        if res.returncode != 0:
            sys.stderr.write(res.stderr)
            return res.returncode
        sys.stdout.write(res.stdout)
        sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
