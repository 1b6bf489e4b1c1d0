"""Chunked front end (``builder/pipeline.py::DeviceFrontEnd``): the
``FrontEndChunk`` block over the window, a millisecond a scan.  The block
ends in the harvest's host read of the older chunk's poses, which waits
for the device's queue."""
from . import _prof


def read(ctx):
    s = _prof.block_s(ctx, "FrontEndChunk")
    return None if s is None else 1e3 * s / ctx.window_scans
