"""Chunked front end: the program's ``host_reads`` counter over the window
(one a device-to-host transfer in the four ``*_read`` spans), a scan."""
from .. import spans


def at_open(ctx):
    spans.install(ctx)


def read(ctx):
    _, counters = spans.of(ctx)
    n = (counters or {}).get("host_reads")
    return n / ctx.window_scans if n else None
