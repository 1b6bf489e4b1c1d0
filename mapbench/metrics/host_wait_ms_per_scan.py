"""Chunked front end: the program's four ``*_read`` blocks over the
window, a millisecond a scan: the host blocked on a read of a device
tensor, waiting for the device's queue."""
from .. import spans
from . import _prof

READS = ("FrontEndChunk:harvest_read", "Icp:converged_read",
         "ScanStep:keyframe_read", "SubmapPairConsume:read")


def at_open(ctx):
    spans.install(ctx)


def read(ctx):
    s = _prof.block_s(ctx, *READS)
    return None if s is None else 1e3 * s / ctx.window_scans
