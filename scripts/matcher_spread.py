"""Run-to-run spread of one chunked matcher run of the matcher path, on the
GPU.

    python3 scripts/matcher_spread.py [--run type5] [--repeats 8]

Runs ``chip_smoke.py``'s chunked matcher run (``matcher_chunked_run``:
``scripts/main_path.py::MATCHER_PATH``, the back end on) ``--repeats``
times in one process and prints one JSON line a run: the ATE, the
keyframes, the loop edges and the NDT trips run and needed.  The card's
``index_add_`` sums each voxel's moments in a run-dependent order, and on
the matcher path's sparse world NDT's voxel Gaussians are dominated by
that rounding (ROADMAP.md queue C), so one configuration gives several
trajectories.  GPU only.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> None:
    from scripts.main_path import MATCHER_PATH
    runs = {r["name"]: r for r in MATCHER_PATH["chunked"]}
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--run", default="type5", choices=sorted(runs))
    ap.add_argument("--repeats", type=int, default=8)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("scripts/matcher_spread.py needs a CUDA device")
    import chip_smoke
    from staticmapping_torch.ops import nn_search
    for k in range(args.repeats):
        r = chip_smoke.matcher_chunked_run(nn_search, runs[args.run])
        print(json.dumps({"run": args.run, "repeat": k, "ate_m": r["ate_m"],
                          "ate_limit_m": r["ate_limit_m"],
                          "keyframes": r["keyframes"],
                          "loop_edge_count": r["loop_edge_count"],
                          "ndt_trips": r["ndt_trips"],
                          "scans_per_s": r["scans_per_s"]}), flush=True)


if __name__ == "__main__":
    main()
