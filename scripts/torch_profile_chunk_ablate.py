"""Ablation of the chunked front end: the port's side of
``tools/profile_chunk_ablate.py``, on ``builder/pipeline.py::DeviceFrontEnd``.

The same chunks (32 scans, the straight world at seed 3, 0.5 m steps,
15000 points within 60 m, 16384 slots) run with stages turned off one at
a time:
- ``base``: the full step (motion compensation, up to 100 ICP trips,
  keyframes and their normals);
- ``icp1``: one ICP trip (the cost of the trips);
- ``nokf``: the motion filter's range out of reach: no keyframe switch, no
  normals;
- ``nocomp``: no motion compensation;
- ``icp1+nokf``: the floor, all but the trips and the normals;
- ``icp1+nokf+nc``: the floor without compensation.
Each variant is warmed on the first ``2·chunk + 2`` scans, then timed over
the next two chunks (device work by CUDA events on the GPU, the host's
clock on the CPU).  It prints one JSON line a variant: ms a chunk and
scans/s.

    python3 scripts/torch_profile_chunk_ablate.py [--device cpu]
        [--scans N] [--capacity C] [--max-points P] [--chunk K]

It needs torch, not JAX; the GPU unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from scripts.torch_profile_floor import (make_timer,  # noqa: E402
                                         straight_scans, warm_front_end)

# tools/profile_chunk_ablate.py's sizes
SCANS, CAPACITY, MAX_POINTS, CHUNK = 130, 16384, 15000, 32


def variants():
    """``(name, FrontEndOptions keyword arguments)`` of the six runs."""
    from staticmapping_torch.builder.frontend import MotionFilterOptions
    nokf = MotionFilterOptions(translation_range=1e9, angle_range=0.0)
    return [("base", {}),
            ("icp1", {"max_iteration": 1}),
            ("nokf", {"motion_filter": nokf}),
            ("nocomp", {"motion_compensation": False}),
            ("icp1+nokf", {"max_iteration": 1, "motion_filter": nokf}),
            ("icp1+nokf+nc", {"max_iteration": 1, "motion_filter": nokf,
                              "motion_compensation": False})]


def run_variant(name, scans, device, capacity, chunk, **fe_kwargs) -> dict:
    import torch
    from staticmapping_torch.builder.frontend import FrontEndOptions
    dev = torch.device(device)
    warm = 2 * chunk + 2
    timed_scans = scans[warm:warm + 2 * chunk]
    if len(timed_scans) < 2 * chunk:
        raise ValueError(f"need at least {warm + 2 * chunk} scans")
    opts = FrontEndOptions(scan_capacity=capacity, nn_tile=1024,
                           **fe_kwargs)
    fe = warm_front_end(opts, scans, chunk, dev, warm)

    def feed():
        frames = []
        for i, pts in enumerate(timed_scans):
            frames += fe.process((warm + i) * 0.1, pts)
        return frames
    frames, ms = make_timer(dev)(feed)
    fe.close()
    per_chunk = ms / 2
    return {"variant": name, "ms_per_chunk": per_chunk,
            "scans_per_s": chunk / (per_chunk / 1e3),
            "keyframes": len(frames)}


def run(device="cuda", n_scans=SCANS, capacity=CAPACITY,
        max_points=MAX_POINTS, chunk=CHUNK):
    scans = straight_scans(n_scans, max_points)
    return [run_variant(name, scans, device, capacity, chunk, **kw)
            for name, kw in variants()]


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--scans", type=int, default=SCANS)
    p.add_argument("--capacity", type=int, default=CAPACITY)
    p.add_argument("--max-points", type=int, default=MAX_POINTS)
    p.add_argument("--chunk", type=int, default=CHUNK)
    args = p.parse_args()
    for row in run(args.device, args.scans, args.capacity, args.max_points,
                   args.chunk):
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
