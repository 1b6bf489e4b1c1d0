"""Pair matches (``MapBuilder._flush_pair_matches``): the
``SubmapPairMatchBatch`` block over the window, a millisecond a submap.
The block merges the queued submaps, builds their normals and queues the
batched ICP on K2; it does not end in a read of the matches (they are read
one flush later, outside any block), so it measures their dispatch and
the host syncs inside it, not the device's work."""
from . import _prof


def read(ctx):
    s = _prof.block_s(ctx, "SubmapPairMatchBatch")
    if s is None or not ctx.window_submaps:
        return None
    return 1e3 * s / ctx.window_submaps
