"""Entry layer (``MapBuilder.insert_pointcloud``): the self time of the
program's ``InsertPointcloud`` spans over the window (their durations less
their child spans: the front end's ``FrontEndChunk``, ``SubmapInsert``), a
millisecond a scan; the inside counterpart of ``feed_ms_per_scan``."""
from .. import spans


def at_open(ctx):
    spans.install(ctx)


def read(ctx):
    sp, _ = spans.of(ctx)
    s = spans.self_seconds(sp, spans.ENTRY) if sp else None
    return None if s is None else 1e3 * s / ctx.window_scans
