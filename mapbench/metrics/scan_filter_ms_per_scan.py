"""Chunked front end (``builder/pipeline.py``'s scan step): the program's
``ScanStep:filter`` blocks over the window, a millisecond a scan.
The span covers the filter chain's call."""
from .. import spans
from . import _prof


def at_open(ctx):
    spans.install(ctx)


def read(ctx):
    s = _prof.block_s(ctx, "ScanStep:filter")
    return None if s is None else 1e3 * s / ctx.window_scans
