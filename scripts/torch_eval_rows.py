"""bench.py's eval rows that no one had run through the port
(``scripts/main_path.py::EVAL_ROWS``): the figure-eight world, 240 scans
at seed 7, with the back end and without it, and the square with the back
end at seeds 8 and 9.  Each row builds the port's ``MapBuilder`` from
config/synthetic.xml with the chunked front end (16 scans a chunk, pair
matches in batches of 16, the default widths) through
``config.build_map_builder``, feeds the scans through
``insert_pointcloud`` and calls ``finish``, as bench.py::eval_run does.
It prints one JSON line a row: scans/s over the insert loop, ``finish``
seconds, ATE against its limit (``eval_limit``: the JAX package's front
end's ATE on the same scans for a row with the back end, max(2 x it,
0.35 m) without), keyframes, loop edges and the loop gap, the 1-NN
kernels' launches.  It exits 1 if a row is over its limit.

    python3 scripts/torch_eval_rows.py [--row NAME] [--device cpu]

It needs torch, not JAX; the GPU unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from scripts.main_path import (EVAL_ROWS, drive_eval_row,  # noqa: E402
                               eval_config, eval_limit, eval_results,
                               eval_sequence)


def run_row(name, device="cuda", out=None) -> dict:
    """One row of EVAL_ROWS on ``device``; its outputs go to ``out`` (a new
    temporary directory unless named, removed after the run)."""
    import torch
    from staticmapping_torch import config as config_lib
    from staticmapping_torch.io import kitti, synthetic
    from staticmapping_torch.ops import nn_search

    row = EVAL_ROWS[name]
    work = out or tempfile.mkdtemp(prefix=f"torch_eval_{name}_")
    try:
        scans, gt = eval_sequence(synthetic.make_sequence, row)
        cfg = eval_config(config_lib, work)
        dev = torch.device(device)
        sync = (torch.cuda.synchronize if dev.type == "cuda"
                else (lambda: None))
        mb = config_lib.build_map_builder(cfg, with_backend=row["backend"],
                                          device=dev)
        nn_search.reset_launches()
        run = drive_eval_row(mb, scans, sync)
        launches = dict(nn_search.launches)
        got = eval_results(mb, gt, kitti.ate_rmse)
    finally:
        if out is None:
            shutil.rmtree(work, ignore_errors=True)
    limit = eval_limit(row)
    return {"row": name, **row, "n_scans": len(scans), **run, **got,
            "ate_limit_m": limit, "within_limit": got["ate_m"] <= limit,
            "launches": launches}


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--row", default=None, choices=sorted(EVAL_ROWS),
                   help="one row (default: every row)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args()
    ok = True
    for name in [args.row] if args.row else list(EVAL_ROWS):
        res = run_row(name, args.device)
        ok &= res["within_limit"]
        print(json.dumps(res), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
