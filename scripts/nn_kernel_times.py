"""Times the 1-NN CUDA kernels of one or more checkouts on one GPU.

    python3 scripts/nn_kernel_times.py [ROOT ...]

For each ROOT in the order given (default: this checkout), a fresh Python
process imports ROOT's ``staticmapping_torch.ops.nn_search`` and
``nn_variants``, builds their kernels, and times on the same seeded inputs
``_nearest_cuda`` (K1, K2) at the main path's two shapes and the three
variant forms (K3 ``nearest_packed``, K4 ``nearest_aug`` packed and not)
at the variant bench's 16384 x 2048, each through its public function
with its default launch, three ways:
- ``ms``: the device time of one whole call (every launch it makes), from
  CUDA events around the replay of a CUDA graph that holds ``reps`` calls,
  so the host's dispatch of the call is not in it;
- ``eager_ms``: CUDA events around ``reps`` calls issued from Python, which
  is what a caller pays when the host dispatches more slowly than the card
  runs;
- ``kernels_us``: each kernel's mean device time per call, from
  ``torch.profiler`` over ``reps`` eager calls (the split kernel and the
  merge apart, without the gaps between them).
One JSON line per ROOT.  To compare two checkouts, name them in turns
(``A B B A``) in one run on one card.  GPU only; imports no JAX.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

# (batch, queries, targets) of the main path, as in chip_smoke.MAIN_SHAPES
SHAPES = {"single": (0, 32768, 4096), "batched": (16, 16384, 8192)}
REPS = {"single": 50, "batched": 10}
# queries x targets of the variant bench, as in chip_smoke.VARIANT_SHAPE
VARIANT_SHAPE = (16384, 2048)
VARIANT_REPS = 50


def eager_ms(fn, reps: int) -> float:
    """Mean time of ``fn()`` over ``reps`` calls issued from Python, after a
    warm call, by CUDA events."""
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


def graph_ms(fn, reps: int, replays: int = 3) -> float:
    """Mean device time of one ``fn()``: ``reps`` calls captured in one CUDA
    graph, replayed ``replays`` times between CUDA events."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                                 # warm: build, allocator
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / (reps * replays)


def kernels_us(fn, reps: int) -> dict:
    """Mean device time (µs) per call of each kernel ``fn()`` launches."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", None)
        if us is None:
            us = e.cuda_time_total
        if us > 0:
            out[e.key[:60]] = us / reps
    return out


def child(root: str) -> dict:
    sys.path.insert(0, root)
    import numpy as np
    import torch
    from staticmapping_torch.ops import nn_search
    dev = torch.device("cuda")
    out = {"root": root}
    for entry, (b, m, n) in SHAPES.items():
        rng = np.random.default_rng(1)
        lead = (b,) if b else ()
        q = torch.from_numpy(rng.uniform(-30, 30, lead + (m, 3))
                             .astype(np.float32)).to(dev)
        t = torch.from_numpy(rng.uniform(-30, 30, lead + (n, 3))
                             .astype(np.float32)).to(dev)
        t[..., -n // 16:, :] = nn_search._FAR
        call = lambda: nn_search._nearest_cuda(q, t)
        out[entry] = {"shape": [b, m, n],
                      "ms": graph_ms(call, REPS[entry]),
                      "eager_ms": eager_ms(call, REPS[entry]),
                      "kernels_us": kernels_us(call, REPS[entry])}
    from staticmapping_torch.ops import nn_variants as nv
    m, n = VARIANT_SHAPE
    rng = np.random.default_rng(2)
    q = torch.from_numpy(rng.uniform(-30, 30, (m, 3))
                         .astype(np.float32)).to(dev)
    t = torch.from_numpy(rng.uniform(-30, 30, (n, 3))
                         .astype(np.float32)).to(dev)
    q8, t8, qa, ta = nv.pad8(q), nv.pad8(t), nv.aug_q(q), nv.aug_t(t)
    for name, call in (("packed", lambda: nv.nearest_packed(q8, t8, 11)),
                       ("aug_packed", lambda: nv.nearest_aug(qa, ta, True)),
                       ("aug", lambda: nv.nearest_aug(qa, ta, False))):
        out[name] = {"shape": [m, n],
                     "ms": graph_ms(call, VARIANT_REPS),
                     "eager_ms": eager_ms(call, VARIANT_REPS),
                     "kernels_us": kernels_us(call, VARIANT_REPS)}
    return out


def main(argv) -> int:
    if argv[:1] == ["--child"]:
        print(json.dumps(child(os.path.abspath(argv[1]))), flush=True)
        return 0
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(json.dumps({"nvidia_smi": smi}), flush=True)
    for root in argv or [here]:
        subprocess.run([sys.executable, os.path.abspath(__file__), "--child",
                        root], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
