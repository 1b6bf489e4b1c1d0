"""The program's spans and counters (``common/prof.py`` of the program) for
the readers, and the spans laid over the device trace's clock.

While the window is open the program records a span at each layer
boundary (``MapBuilder.insert_pointcloud`` is ``InsertPointcloud``, the
root of a scan's spans) and counts its host reads and its 1-NN pairs and
bytes.  :func:`of` hands a reader the window's spans and counters, or
``(None, None)`` where the program records none.

:func:`install`, called by the span readers' ``at_open``, wraps
``trace.mark`` and ``trace.reduce`` for the run.  Each window mark is
bracketed on ``time.perf_counter_ns()``, the spans' clock, and the first
samples ``prof.clock_pair()``.  The reduction then converts the spans to
the trace's clock (Unix-epoch microseconds), checks the conversion at
both marks (the runtime call that launched a mark must fall inside its
bracket; the worst misfit goes to standard error as ``trace
clock_misfit_us``), and names each idle gap ``<outermost span> /
<innermost span>`` from the feeding thread's spans open at the gap's
start, followed by the runtime call running there, if any.  Gap lengths,
their order and everything else ``trace.reduce_events`` returns stay as
they are; with no spans, or a misfit over :data:`MISFIT_LIMIT_US`, the
reduction is ``trace.reduce``'s own.

The profiler can lose a mark's device record (one traced run in many
has come back without one).  Such a mark is placed at the end of its
host bracket, where the device, idle at each mark, ran it within
microseconds, provided the trace holds device work within
:data:`PLACED_GUARD_US` on the window's side of it; a trace that stops
short of the bracket keeps no window, as ``trace.reduce`` keeps none.
"""
from __future__ import annotations

import sys
import time
from typing import Dict, List, Optional, Tuple

from . import trace

ENTRY = "InsertPointcloud"
SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize")
MISFIT_LIMIT_US = 50.0
# a mark placed from its bracket needs device work this near, inside
PLACED_GUARD_US = 1e6

_MARK, _REDUCE = trace.mark, trace.reduce

# (start_us, end_us, name) on the trace's clock
Interval = Tuple[float, float, str]


def _program_prof(ctx):
    """The program's ``prof`` module where it records spans, else None."""
    try:
        mod = ctx.program("common.prof")
    except ImportError:
        return None
    if not all(hasattr(mod, f) for f in ("spans", "counters", "clock_pair")):
        return None
    return mod


def of(ctx):
    """``(spans, counters)`` of the window, read once and kept on ``ctx``;
    ``(None, None)`` where the program records no spans."""
    if getattr(ctx, "spans", None) is None:
        mod = _program_prof(ctx)
        if mod is None:
            return None, None
        ctx.spans, ctx.counters = mod.spans(), mod.counters()
    return ctx.spans, getattr(ctx, "counters", None) or {}


def self_seconds(spans, name: str) -> Optional[float]:
    """Self time of the spans called ``name``: their durations less their
    direct children's (a thread's children run one after another)."""
    inner = [0] * len(spans)
    for s in spans:
        if s.parent >= 0:
            inner[s.parent] += s.end_ns - s.start_ns
    found = [s.end_ns - s.start_ns - inner[i]
             for i, s in enumerate(spans) if s.name == name]
    return sum(found) * 1e-9 if found else None


# --- the spans on the trace's clock ----------------------------------

def feeding_thread(spans) -> Optional[int]:
    """The thread that runs ``InsertPointcloud``."""
    for s in spans:
        if s.name == ENTRY:
            return s.thread
    return None


def on_trace_clock(spans, pair: Tuple[int, int],
                   thread: Optional[int]) -> List[Interval]:
    """``thread``'s spans as ``(start_us, end_us, name)`` on the trace's
    clock, given ``pair = (perf_counter_ns, time_ns)`` read together."""
    off = pair[1] - pair[0]
    return sorted(((s.start_ns + off) / 1e3, (s.end_ns + off) / 1e3, s.name)
                  for s in spans if s.thread == thread)


def open_at(feed: List[Interval], t: float) -> List[Tuple[float, str]]:
    return [(s, n) for s, e, n in feed if s <= t < e]


def gap_name(call: str, feed: List[Interval], t: float) -> str:
    """``<outermost span> / <innermost span>`` of the spans open at ``t``,
    then ``call`` (the runtime call running there) unless it is ``host``;
    ``call`` alone where no span is open."""
    opened = open_at(feed, t)
    if not opened:
        return call
    outer, inner = min(opened)[1], max(opened)[1]
    name = outer if inner == outer else f"{outer} / {inner}"
    if call != "host":
        name = f"{name} / {call}"
    return name[:trace.NAME_CHARS]


def reduce_events(events, window, feed: List[Interval], top: int = 10):
    """``trace.reduce_events`` with each idle gap named by :func:`gap_name`
    from ``feed``."""
    plain = trace._host_at

    def named(host, starts, t, look_back=20000):
        return gap_name(plain(host, starts, t, look_back), feed, t)

    trace._host_at = named
    try:
        return trace.reduce_events(events, window, top)
    finally:
        trace._host_at = plain


def clock_misfit_us(launches: List[Optional[Tuple[float, float]]],
                    brackets: List[Tuple[int, int]],
                    pair: Tuple[int, int]) -> Optional[float]:
    """The worst distance in µs by which a mark's runtime launch
    (``(start_us, end_us)``, trace clock; None where the trace lacks it)
    lies outside the host bracket around its ``trace.mark()`` call
    (``perf_counter_ns``); None unless there is an entry a bracket and at
    least one launch."""
    found = [(r, b) for r, b in zip(launches, brackets) if r is not None]
    if not found or len(launches) != len(brackets):
        return None
    off = pair[1] - pair[0]
    return max(max((b0 + off) / 1e3 - r0, r1 - (b1 + off) / 1e3, 0.0)
               for (r0, r1), (b0, b1) in found)


def clock_pair() -> Tuple[int, int]:
    """``(perf_counter_ns, time_ns)`` read together, for a program that
    gives none: the middle of the tightest of a few brackets."""
    best = None
    for _ in range(8):
        a = time.perf_counter_ns()
        w = time.time_ns()
        b = time.perf_counter_ns()
        if best is None or b - a < best[0]:
            best = (b - a, (a + b) // 2, w)
    return best[1], best[2]


def place_window(marks: List[Tuple[float, float]], events,
                 brackets: List[Tuple[int, int]],
                 pair: Optional[Tuple[int, int]],
                 guard_us: float = PLACED_GUARD_US
                 ) -> Optional[Tuple[Tuple[float, float], List[int]]]:
    """The window from fewer than two device ``marks``: each end the trace
    holds a mark for is that mark's, the other is the end of its host
    bracket (``perf_counter_ns``) on the trace's clock, provided a device
    operation of ``events`` starts (window start) or ends (window end)
    within ``guard_us`` inside it.  Returns the window and the indices
    (0 start, 1 end) of the ends placed so, or None."""
    if len(brackets) < 2 or pair is None:
        return None
    off = pair[1] - pair[0]
    at = [(brackets[0][1] + off) / 1e3, (brackets[-1][1] + off) / 1e3]
    near: List[List[Tuple[float, float]]] = [[], []]
    for m in marks:
        near[abs(m[0] - at[0]) > abs(m[0] - at[1])].append(m)
    dev = [(s, e) for n, s, e, d in events if d and trace.MARK not in n]
    placed = []
    if near[0]:
        w0 = min(near[0])[0]
    elif any(at[0] <= s <= at[0] + guard_us for s, _ in dev):
        w0 = at[0]
        placed.append(0)
    else:
        return None
    if near[1]:
        w1 = max(e for _, e in near[1])
    elif any(at[1] - guard_us <= e <= at[1] for _, e in dev):
        w1 = at[1]
        placed.append(1)
    else:
        return None
    return ((w0, w1), placed) if w1 > w0 else None


def syncs_by_span(events, window, feed: List[Interval]) -> Dict[str, int]:
    """The host syncs among ``events`` in ``window``, counted by the
    innermost span of ``feed`` open at each.  The trace's thread ids are
    not the spans' (``threading.get_native_id()``), so a sync is placed by
    its time alone."""
    out: Dict[str, int] = {}
    for n, s, _, on_device in events:
        if on_device or n not in SYNCS or not window[0] <= s < window[1]:
            continue
        opened = open_at(feed, s)
        key = max(opened)[1] if opened else "no span"
        out[key] = out.get(key, 0) + 1
    return out


# --- the hooks ---------------------------------------------------------

def mark_launches(prof, marks: List[Tuple[float, float]],
                  lead_us: float = 1e6, idle_lead_us: float = 2000.0):
    """For each window mark (device spans ``marks``, in order) the runtime
    call that launched it, ``(start_us, end_us)``: the host event in the
    ``lead_us`` before the mark with the mark's correlation id, else the
    last kernel launch that began in the ``idle_lead_us`` before it (the
    device is synchronised before each mark, so its kernel starts right
    after its launch); None where the trace holds neither.  Returns the
    launches and how each was found (``id``, ``time`` or None)."""
    from torch.autograd import DeviceType
    cpu = DeviceType.CPU
    starts = [m for m, _ in marks]
    ids, near = {}, []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != cpu:
            if trace.MARK in e.name() and e.correlation_id():
                s = e.start_ns() / 1e3
                ids[e.correlation_id()] = min(
                    range(len(starts)), key=lambda i: abs(starts[i] - s))
            continue
        s = e.start_ns() / 1e3
        if any(m - lead_us <= s <= m for m in starts):
            near.append((s, s + e.duration_ns() / 1e3, e.name(),
                         e.correlation_id()))
    launches, how = [None] * len(marks), [None] * len(marks)
    for s, e, _, c in near:
        if c and c in ids:
            launches[ids[c]], how[ids[c]] = (s, e), "id"
    for i, m in enumerate(starts):
        if launches[i] is None:
            before = [(s, e) for s, e, n, _ in near
                      if "LaunchKernel" in n and m - idle_lead_us <= s <= m]
            if before:
                launches[i], how[i] = max(before), "time"
    return launches, how


class _Hooks:
    """``trace.mark`` and ``trace.reduce`` for one run."""

    def __init__(self, ctx):
        self.ctx = ctx
        self.pair = None
        self.brackets: List[Tuple[int, int]] = []

    def mark(self) -> None:
        if self.pair is None:
            mod = _program_prof(self.ctx)
            self.pair = (mod.clock_pair if mod is not None
                         else clock_pair)()
        b0 = time.perf_counter_ns()
        _MARK()
        self.brackets.append((b0, time.perf_counter_ns()))

    def reduce(self, prof, top: int = 10):
        events = trace._raw_events(prof)
        ends = sorted((s, e) for n, s, e, d in events
                      if d and trace.MARK in n)
        if len(ends) >= 2:
            window = (ends[0][0], max(e for _, e in ends))
        else:
            placed = place_window(ends, events, self.brackets, self.pair)
            print(f"trace: {len(ends)} of the window's marks in the trace; "
                  + ("no window" if placed is None else
                     f"ends {placed[1]} placed from their host brackets"),
                  file=sys.stderr)
            if placed is None:
                return None
            window = placed[0]
            ends = [(window[0], window[0]), (window[1], window[1])]
        spans, _ = of(self.ctx)
        if not spans:
            return trace.reduce_events(events, window, top)
        launches, how = mark_launches(prof, ends)
        misfit = clock_misfit_us(launches, self.brackets, self.pair)
        self.ctx.clock_misfit_us = misfit
        print(f"trace clock_misfit_us: {misfit} (mark launches found by "
              f"{how})", file=sys.stderr)
        if misfit is None or misfit > MISFIT_LIMIT_US:
            print("trace: idle gaps left unnamed by spans", file=sys.stderr)
            return trace.reduce_events(events, window, top)
        feed = on_trace_clock(spans, self.pair, feeding_thread(spans))
        by_span = syncs_by_span(events, window, feed)
        print(f"trace syncs: {sum(by_span.values())} in "
              f"{getattr(self.ctx, 'trace_scans', 0)} scans; by span: "
              + ", ".join(f"{k} {v}" for k, v in
                          sorted(by_span.items(), key=lambda kv: -kv[1])),
              file=sys.stderr)
        return reduce_events(events, window, feed, top)


def install(ctx) -> None:
    """Wrap ``trace.mark`` and ``trace.reduce`` for the run of ``ctx``;
    once a run."""
    if getattr(ctx, "span_hooks", None) is not None:
        return
    ctx.span_hooks = hooks = _Hooks(ctx)
    trace.mark, trace.reduce = hooks.mark, hooks.reduce


def uninstall() -> None:
    trace.mark, trace.reduce = _MARK, _REDUCE
