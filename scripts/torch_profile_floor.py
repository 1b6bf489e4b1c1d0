"""The chunked front end's floor, stage by stage: the port's side of
``tools/profile_floor.py``, on ``builder/pipeline.py::DeviceFrontEnd``.

Each stage of one 32-scan chunk is timed alone, over ``--reps`` repeats
after a warm one:
- ``pack``: the host's int16 pack of the chunk (``_pack_chunk``);
- ``h2d``: the pinned host-to-device copy of its ``qdata`` and ``meta``
  (a plain copy on the CPU);
- ``run_chunk_floor``: ``_run_chunk`` on the staged inputs with one ICP
  trip and no keyframe (the motion filter's range out of reach): the
  floor of a scan's step;
- ``run_chunk_full``: ``_run_chunk`` on the same inputs at the front
  end's defaults (up to 100 trips, keyframes, their normals);
- ``harvest``: the read of the chunk's poses and scores to the host.
The front ends are warmed on the straight world first (seed 3, 0.5 m
steps, 15000 points within 60 m, 16384 slots), as the tool does.  Device
work is timed with CUDA events on the GPU, the host's clock on the CPU.
It prints one JSON object, in ms.

    python3 scripts/torch_profile_floor.py [--device cpu] [--scans N]
        [--capacity C] [--max-points P] [--chunk K] [--reps R]

It needs torch, not JAX; the GPU unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# tools/profile_floor.py's sizes
SCANS, CAPACITY, MAX_POINTS, CHUNK, REPS = 70, 16384, 15000, 32, 5


def make_timer(device):
    """``timed(fn) -> (result, ms)``: CUDA events around ``fn`` on the
    GPU, the host's clock on the CPU."""
    import torch
    if torch.device(device).type == "cuda":
        def timed(fn):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn()
            end.record()
            end.synchronize()
            return out, start.elapsed_time(end)
    else:
        def timed(fn):
            t0 = time.perf_counter()
            out = fn()
            return out, 1e3 * (time.perf_counter() - t0)
    return timed


def straight_scans(n_scans, max_points):
    from staticmapping_torch.io import synthetic
    scans, _ = synthetic.make_sequence(
        n_scans=n_scans, seed=3, trajectory="straight", step=0.5,
        max_points=max_points, max_range=60.0)
    return scans


def warm_front_end(options, scans, chunk, device, warm_scans):
    """A ``DeviceFrontEnd`` fed ``warm_scans`` scans: its state is a
    running front end's."""
    from staticmapping_torch.builder.pipeline import DeviceFrontEnd
    fe = DeviceFrontEnd(options, chunk_size=chunk, queue_depth=1,
                        device=device)
    for i, pts in enumerate(scans[:warm_scans]):
        fe.process(i * 0.1, pts)
    return fe


def run(device="cuda", n_scans=SCANS, capacity=CAPACITY,
        max_points=MAX_POINTS, chunk=CHUNK, reps=REPS) -> dict:
    import torch
    from staticmapping_torch.builder.frontend import (FrontEndOptions,
                                                      MotionFilterOptions)
    from staticmapping_torch.builder.pipeline import _pack_chunk

    dev = torch.device(device)
    timed = make_timer(dev)
    scans = straight_scans(n_scans, max_points)
    warm_scans = 2 * chunk + 2
    if len(scans) < warm_scans:
        raise ValueError(f"need at least {warm_scans} scans")
    buf = [(i * 0.1, scans[i % len(scans)]) for i in range(chunk)]

    def repeat(fn):
        fn()                                      # warm
        return float(np.mean([timed(fn)[1] for _ in range(reps)]))
    out = {"device": str(dev), "chunk": chunk, "capacity": capacity,
           "max_points": max_points, "reps": reps}

    out["pack_ms"] = repeat(lambda: _pack_chunk(buf, 0.0, chunk, capacity))
    q, meta, imu = _pack_chunk(buf, 0.0, chunk, capacity)
    q_h, meta_h = torch.from_numpy(q), torch.from_numpy(meta)
    if dev.type == "cuda":
        q_h, meta_h = q_h.pin_memory(), meta_h.pin_memory()
    out["h2d_bytes"] = q.nbytes + meta.nbytes
    out["h2d_ms"] = repeat(lambda: (q_h.to(dev, non_blocking=True),
                                    meta_h.to(dev, non_blocking=True)))
    qdata, meta_d = q_h.to(dev), meta_h.to(dev)
    imu_d = torch.from_numpy(imu).to(dev)
    # chunk-relative stamps continuing the warm scans
    meta_d[:, 0] += warm_scans * 0.1
    valid = np.ones((chunk,), dtype=bool)

    floor = FrontEndOptions(scan_capacity=capacity, nn_tile=1024,
                            max_iteration=1,
                            motion_filter=MotionFilterOptions(
                                translation_range=1e9, angle_range=0.0))
    full = FrontEndOptions(scan_capacity=capacity, nn_tile=1024)
    outputs = None
    for name, options in (("run_chunk_floor", floor),
                          ("run_chunk_full", full)):
        fe = warm_front_end(options, scans, chunk, dev, warm_scans)
        state = fe.state

        def chunk_run():
            return fe._run_chunk(state, qdata, meta_d, imu_d, valid)
        out[f"{name}_ms"] = repeat(chunk_run)
        outputs = chunk_run()[1]
        out[f"{name}_keyframes"] = sum(bool(o[2]) for o in outputs)
        fe.close()

    def harvest():
        return (torch.stack([o[0] for o in outputs]).cpu(),
                torch.stack([o[1] for o in outputs]).cpu())
    out["harvest_ms"] = repeat(harvest)
    return out


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--scans", type=int, default=SCANS)
    p.add_argument("--capacity", type=int, default=CAPACITY)
    p.add_argument("--max-points", type=int, default=MAX_POINTS)
    p.add_argument("--chunk", type=int, default=CHUNK)
    p.add_argument("--reps", type=int, default=REPS)
    args = p.parse_args()
    print(json.dumps(run(args.device, args.scans, args.capacity,
                         args.max_points, args.chunk, args.reps)))


if __name__ == "__main__":
    main()
