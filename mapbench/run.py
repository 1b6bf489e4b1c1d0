"""Run one cell of the benchmark once.

    python3 -m mapbench.run --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  Prints one JSON line last on standard output:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer metrics), ``device``, with
``--trace 1`` ``breakdown``, and ``checks``: each number the output check
compared, beside its limit, which also end standard error.  Exits non-zero
with no result where no GPU is present, where the cell asks for more GPUs
than there are, or where JAX or the JAX package was loaded.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

T_START = time.perf_counter()

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "staticmapping_tpu")


def _process_age_s() -> float:
    """Seconds since this process started (Linux), else since this module
    was first run."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - T_START


CACHE = os.path.join(ROOT, ".mapbench_cache")


def _set_environment() -> None:
    """Caches of anything the program or torch builds go inside the
    checkout, at fixed paths (the program keeps its own kernels in its
    package's ``_build``); the CPU's math libraries get one thread, since
    the run is one process feeding the card and idle pool threads only
    add noise to its clock."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ.setdefault(var, os.path.join(CACHE, sub))
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ.setdefault(var, "1")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX
    package's."""
    return sorted({m.split(".")[0] for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})


def main(argv=None) -> int:
    t_start = T_START - _process_age_s()
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    _set_environment()
    import torch
    from mapbench import drive, manifest
    torch.set_num_threads(1)

    bench = manifest.load(ROOT)
    chips = manifest.cell(bench, args.workload, ROOT)["workload"]["chips"]
    if not torch.cuda.is_available():
        print("mapbench: no CUDA device", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < chips:
        print(f"mapbench: {args.workload} needs {chips} GPUs, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    res = drive.run_cell(bench, args.workload, args.seed, args.seconds,
                         bool(args.trace), "cuda", t_start, ROOT)
    bad = forbidden_modules()
    if bad:
        print(f"mapbench: loaded {bad}, which the benchmark must not",
              file=sys.stderr)
        return 3
    for name, c in res["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
