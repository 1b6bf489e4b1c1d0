"""Time of each filter of the registry on one full-width scan, on the GPU.

    python3 scripts/filter_times.py [--reps 5]

Runs every name of ``staticmapping_torch.filters.FILTER_REGISTRY``, with
the parameters of tests/test_torch_filters.py where its defaults would
keep every point or none (this world's ground lies 1.8 m below the
sensor), on the first scan of
``scripts/main_path.py::MAIN_PATH``'s world (30000 points, 32768 slots) on
``cuda``, and prints one JSON line: the card, and per filter the mean
milliseconds of a call issued from Python (CUDA events, after a warm
call) and the points it keeps.  GroundRemoval2's line fit is a loop of
one small step a range bin (200 by default), so its time is mostly the
host's dispatch.  GPU only.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("scripts/filter_times.py needs a CUDA device")
    from scripts.main_path import MAIN_PATH
    from scripts.nn_kernel_times import eager_ms
    from staticmapping_torch.data import cloud as cloud_lib
    from staticmapping_torch.filters import FILTER_REGISTRY, create_filter
    from staticmapping_torch.io import synthetic

    P = MAIN_PATH
    scans, _ = synthetic.make_sequence(
        n_scans=1, seed=P["seed"], trajectory=P["trajectory"],
        step=P["step"], max_points=P["max_points"],
        max_range=P["max_range"])
    pc = cloud_lib.from_numpy(scans[0], capacity=P["scan_capacity"],
                              device="cuda")
    params = {
        "BoundingBoxRemoval": {"min_x": -3.0, "max_x": 3.0, "min_y": -2.0,
                               "max_y": 2.0, "min_z": -3.0, "max_z": 1.0},
        "GroundRemoval": {"min_point_num_in_voxel": 3},
        "GroundRemoval2": {"start_ground_height": -1.8},
        "RandomSampler": {"sampling_rate": 0.5},
        "RandomSamplerWithPlaneDetect": {
            "sampling_rate": 0.5, "leaf_size": 2.0,
            "min_point_num_in_voxel": 5, "ground_height_threshold": 0.5}}
    out = {}
    for name in sorted(FILTER_REGISTRY):
        f = create_filter(name, params.get(name, {}))
        kept = int(f(pc).mask.sum())
        out[name] = {"ms": eager_ms(lambda f=f: f(pc), args.reps),
                     "kept": kept}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(json.dumps({"device": smi, "points": int(pc.mask.sum()),
                      "capacity": pc.capacity, "filters": out}))


if __name__ == "__main__":
    main()
