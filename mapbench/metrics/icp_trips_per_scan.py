"""Chunked front end: the scan-to-keyframe ICP's trips run in the window
(``registration/icp_fast.py::trip_counts()["while"]["run"]``) a scan."""


def at_open(ctx):
    ctx.program("registration.icp_fast").reset_trips()


def read(ctx):
    run = ctx.program("registration.icp_fast").trip_counts()["while"]["run"]
    return run / ctx.window_scans if run else None
