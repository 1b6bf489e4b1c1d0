"""Registration (``registration/icp_fast.py``): the share of the window's
point-to-plane ICP trips that ran as CUDA-graph replays, in percent.  The
program's ``icp_graph_trips`` counter over the trips of both forms in
``icp_fast.trip_counts()`` (``run``, each summed over the pairs, as the
counter is).  None where the program counts no replayed trip."""
from .. import spans


def at_open(ctx):
    spans.install(ctx)
    ctx.program("registration.icp_fast").reset_trips()


def read(ctx):
    _, counters = spans.of(ctx)
    replayed = (counters or {}).get("icp_graph_trips")
    counts = ctx.program("registration.icp_fast").trip_counts()
    run = sum(c["run"] for c in counts.values())
    if not replayed or not run:
        return None
    return 100.0 * replayed / run
