"""Entry layer (``MapBuilder.insert_pointcloud``: host padding, queueing to
the stage thread): the benchmark's own span around each call in the
window, less the program's outermost ``prof`` blocks inside it (the
chunked front end's ``FrontEndChunk`` and each keyframe's
``SubmapInsert``), a millisecond a scan."""
from . import _prof


def read(ctx):
    if not ctx.feed_s:
        return None
    inner = _prof.block_s(ctx, "FrontEndChunk", "SubmapInsert") or 0.0
    return 1e3 * (sum(ctx.feed_s) - inner) / ctx.window_scans
