"""Pair matches (``MapBuilder._consume_pair_results``): the program's
``SubmapPairConsume:read`` blocks over the window, the host's read of a
batch's matched transforms and scores, a millisecond a submap."""
from .. import spans
from . import _prof


def at_open(ctx):
    spans.install(ctx)


def read(ctx):
    s = _prof.block_s(ctx, "SubmapPairConsume:read")
    if s is None or not ctx.window_submaps:
        return None
    return 1e3 * s / ctx.window_submaps
