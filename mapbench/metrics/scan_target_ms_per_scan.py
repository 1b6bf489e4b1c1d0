"""Chunked front end (``builder/pipeline.py``'s scan step): the program's
``ScanStep:target`` blocks over the window, a millisecond a scan.
The span covers a keyframe's new matcher target (its normals)."""
from .. import spans
from . import _prof


def at_open(ctx):
    spans.install(ctx)


def read(ctx):
    s = _prof.block_s(ctx, "ScanStep:target")
    return None if s is None else 1e3 * s / ctx.window_scans
