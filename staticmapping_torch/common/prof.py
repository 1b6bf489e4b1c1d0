"""Named spans and counters on the host's clock — SimpleProf parity, with a
span tree.

The reference aggregates scoped timers per named block and prints a
count/avg/sum/min/max table at exit (common/performance/simple_prof.h:44-113,
simple_prof.cc:61-122, enabled by -DENABLE_PROFILING).  Here, while
enabled, each :func:`block` records one span: its name, its start and end on
``time.perf_counter_ns()``, its parent (the block open around it on the
same thread), its request id (a scan, chunk or batch index; a block given
none takes its parent's) and its thread.  :func:`count` adds to a named
counter.  :func:`spans` and :func:`counters` read them; :func:`stats` and
:func:`report` sum the durations per name, nested blocks included, as the
reference's table does.  :func:`clock_pair` samples this clock beside the
Unix-epoch clock of ``time.time_ns()``, on which ``torch.profiler`` stamps
its events, so a reader can lay the spans over a device trace.

Device time: torch launches CUDA work asynchronously, so a block that only
launches work measures the launches.  A host read of a device tensor
(``.cpu()``, ``bool(t)``, ``.item()``) waits until the device's queue has
run up to it; the program wraps each such read on the hot path in a block
whose name ends in ``_read`` and counts it under ``host_reads``.

Disabled by default: :func:`block` is then one check returning a shared
no-op context manager, and :func:`count` two (the first for an open
:func:`tally`).  Enable with :func:`enable` or the CLI ``--profile``
flag.
"""
from __future__ import annotations

import atexit
import itertools
import threading
import time
from contextlib import contextmanager, nullcontext
from typing import Dict, List, NamedTuple, Optional, Tuple

# spans kept between resets; blocks past it still add to stats()
MAX_SPANS = 1 << 20


class Span(NamedTuple):
    name: str
    start_ns: int            # time.perf_counter_ns()
    end_ns: int
    parent: int              # index in spans() of the enclosing block, or -1
    req: Optional[int]       # request id (scan, chunk or batch index)
    thread: int              # threading.get_native_id()


_enabled = False
_report_at_exit = False
_NOOP = nullcontext()
_lock = threading.Lock()
_local = threading.local()         # per thread: the open blocks, the id
_ids = itertools.count()           # span ids in entry order
# closed spans as (id, name, start, end, parent id, req, thread); reset()
# replaces the list, so a block open across it records nothing
_closed: List[tuple] = []
_sums: Dict[str, List[float]] = {}        # name -> [count, sum, min, max]
_counters: Dict[str, int] = {}
_tallies: Dict[int, Dict[str, int]] = {}  # thread ident -> held counts


def enable(report_at_exit: bool = True) -> None:
    global _enabled, _report_at_exit
    _enabled = True
    if report_at_exit and not _report_at_exit:
        _report_at_exit = True
        atexit.register(_atexit_report)


def disable() -> None:
    global _enabled
    _enabled = False


def reset() -> None:
    global _closed
    with _lock:
        _closed = []
        _sums.clear()
        _counters.clear()


class _Block:
    __slots__ = ("name", "req", "closed", "id", "parent", "t0")

    def __init__(self, name: str, req: Optional[int]):
        self.name = name
        self.req = req

    def __enter__(self):
        try:
            stack = _local.stack
        except AttributeError:
            stack = _local.stack = []
            _local.thread = threading.get_native_id()
        self.closed = _closed
        self.id = next(_ids)
        self.parent = -1
        if stack:
            top = stack[-1]
            if self.req is None:
                self.req = top.req
            if top.closed is _closed:
                self.parent = top.id
        stack.append(self)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        _local.stack.pop()
        closed = self.closed
        if closed is not _closed:
            return False
        if len(closed) < MAX_SPANS:
            closed.append((self.id, self.name, self.t0, t1, self.parent,
                           self.req, _local.thread))
        dt = (t1 - self.t0) * 1e-9
        with _lock:
            s = _sums.get(self.name)
            if s is None:
                _sums[self.name] = [1, dt, dt, dt]
            else:
                s[0] += 1
                s[1] += dt
                s[2] = min(s[2], dt)
                s[3] = max(s[3], dt)
        return False


def block(name: str, req: Optional[int] = None):
    """``with prof.block("FrontEndChunk:run", req=chunk): ...`` —
    REGISTER_BLOCK role (simple_prof.h:108-113)."""
    if not _enabled:
        return _NOOP
    return _Block(name, req)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name``, or to the calling thread's
    :func:`tally` where one is open."""
    if _tallies:
        held = _tallies.get(threading.get_ident())
        if held is not None:
            held[name] = held.get(name, 0) + n
            return
    if not _enabled:
        return
    with _lock:
        _counters[name] = _counters.get(name, 0) + n


@contextmanager
def tally():
    """``with prof.tally() as held: ...`` — the counts this thread makes
    inside go to the dict ``held``, enabled or not, and not to
    :func:`counters`.  A CUDA graph's capture runs the host code of work
    that runs later, once a replay: its counts are held back at the
    capture and added at each replay."""
    me = threading.get_ident()
    held: Dict[str, int] = {}
    _tallies[me] = held
    try:
        yield held
    finally:
        del _tallies[me]


def spans() -> List[Span]:
    """The closed spans since the last :func:`reset`, in entry order, each
    ``parent`` an index in this list (-1 for a root, or where the parent
    is still open or was not kept)."""
    closed = sorted(_closed)
    index = {rec[0]: i for i, rec in enumerate(closed)}
    return [Span(name, t0, t1, index.get(parent, -1), req, thread)
            for _, name, t0, t1, parent, req, thread in closed]


def counters() -> Dict[str, int]:
    with _lock:
        return dict(_counters)


def clock_pair() -> Tuple[int, int]:
    """``(perf_counter_ns, time_ns)`` sampled together: the midpoint of the
    tightest of a few ``perf_counter_ns`` brackets around a ``time_ns``
    read."""
    best = None
    for _ in range(8):
        a = time.perf_counter_ns()
        w = time.time_ns()
        b = time.perf_counter_ns()
        if best is None or b - a < best[0]:
            best = (b - a, (a + b) // 2, w)
    return best[1], best[2]


def stats() -> Dict[str, dict]:
    with _lock:
        sums = {k: list(v) for k, v in _sums.items()}
    return {name: {"count": n, "sum": total, "avg": total / n,
                   "min": lo, "max": hi}
            for name, (n, total, lo, hi) in sums.items()}


def report(unit: str = "ms") -> str:
    """Print + return the stats table (simple_prof.cc:61-122 UX)."""
    scale = {"s": 1.0, "ms": 1e3, "us": 1e6}[unit]
    rows = sorted(stats().items(), key=lambda kv: -kv[1]["sum"])
    name_w = max([len(n) for n, _ in rows] + [10])
    lines = [f"{'block':<{name_w}}  {'count':>7}  {'avg':>10}  "
             f"{'sum':>10}  {'min':>10}  {'max':>10}   [{unit}]"]
    for name, s in rows:
        lines.append(
            f"{name:<{name_w}}  {s['count']:>7d}  "
            f"{s['avg'] * scale:>10.3f}  {s['sum'] * scale:>10.3f}  "
            f"{s['min'] * scale:>10.3f}  {s['max'] * scale:>10.3f}")
    table = "\n".join(lines)
    print(table)
    return table


def _atexit_report():
    if _enabled and _sums:
        report()
