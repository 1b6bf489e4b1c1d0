"""Ops (``ops/nn_search.py``, K1 and K2): the least time the H100 could
take for the window's 1-NN calls against their device time, in percent.
The bound is ``chip_smoke.py::nn_bound``'s arithmetic summed over the
calls, from the program's counters over the window, a scan: the larger of
``nn_pairs`` × 6 FP32 operations at 67 TFLOP/s and ``nn_bytes`` at
3.35 TB/s.  The time is ``nn_ms_per_scan``'s, from the traced stretch."""
from .. import spans
from . import nn_ms_per_scan

OPS_PER_PAIR = 6
PEAK_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12


def at_open(ctx):
    spans.install(ctx)


def read(ctx):
    _, counters = spans.of(ctx)
    ms = nn_ms_per_scan.read(ctx)
    if not counters or not counters.get("nn_pairs") or ms is None:
        return None
    bound_s = max(counters["nn_pairs"] * OPS_PER_PAIR / PEAK_FLOPS,
                  counters.get("nn_bytes", 0) / PEAK_BYTES_PER_S)
    return 100.0 * 1e3 * bound_s / ctx.window_scans / ms
