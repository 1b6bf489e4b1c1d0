"""The program's spans on the trace's clock (``mapbench/spans.py``) and the
readers of the span metrics, from hand-made spans, counters and events."""
import time
import types
from typing import NamedTuple, Optional

import pytest
from torch.autograd import DeviceType

from mapbench import drive, spans, trace
from mapbench.metrics import (entry_self_ms_per_scan, host_reads_per_scan,
                              host_wait_ms_per_scan, nn_roofline,
                              pair_match_wait_ms_per_submap,
                              scan_filter_ms_per_scan, scan_icp_ms_per_scan,
                              scan_target_ms_per_scan)

READERS = (entry_self_ms_per_scan, host_reads_per_scan,
           host_wait_ms_per_scan, nn_roofline, pair_match_wait_ms_per_submap,
           scan_filter_ms_per_scan, scan_icp_ms_per_scan,
           scan_target_ms_per_scan)
MAIN, STAGE = 11, 12
# perf_counter_ns 0 is Unix-epoch 1_000_000 µs on the trace's clock
PAIR = (0, 1_000_000_000)
W = (1_001_000.0, 1_011_000.0)         # a 10 ms window, trace µs


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    parent: int
    req: Optional[int]
    thread: int


def _us(t_us):
    """Trace µs to the spans' perf_counter_ns."""
    return int(t_us * 1e3) - (PAIR[1] - PAIR[0])


def _span(name, s_us, e_us, parent=-1, req=None, thread=MAIN):
    return Span(name, _us(s_us), _us(e_us), parent, req, thread)


# one scan: the entry, its chunk with a step (filter, ICP and its
# converged read, keyframe read), a submap insert with the consume's read;
# the stage thread packs a chunk meanwhile
SPANS = [
    _span("InsertPointcloud", 1_001_000, 1_010_000, req=0),           # 0
    _span("FrontEndChunk", 1_001_500, 1_006_000, 0, 0),                # 1
    _span("FrontEndChunk:run", 1_001_600, 1_005_000, 1, 3),            # 2
    _span("ScanStep", 1_001_700, 1_004_900, 2, 96),                    # 3
    _span("ScanStep:filter", 1_001_700, 1_002_000, 3, 96),             # 4
    _span("ScanStep:icp", 1_002_000, 1_004_000, 3, 96),                # 5
    _span("Icp:converged_read", 1_003_000, 1_003_500, 5, 96),          # 6
    _span("ScanStep:keyframe_read", 1_004_000, 1_004_200, 3, 96),      # 7
    _span("ScanStep:target", 1_004_200, 1_004_900, 3, 96),             # 8
    _span("FrontEndChunk:harvest_read", 1_005_000, 1_006_000, 1, 2),   # 9
    _span("SubmapInsert", 1_006_000, 1_009_000, 0, 0),                 # 10
    _span("SubmapPairConsume", 1_007_000, 1_009_000, 10, 4),           # 11
    _span("SubmapPairConsume:read", 1_007_000, 1_008_000, 11, 4),      # 12
    _span("StageChunk", 1_002_000, 1_008_500, -1, 4, STAGE),           # 13
]


def _ctx(spans_=SPANS, counters=None, scans=2, submaps=1):
    """A context as the window leaves it: the spans, the counters and the
    per-name sums ``prof.stats()`` gives."""
    ctx = drive.Context()
    ctx.window_scans = ctx.trace_scans = scans
    ctx.window_submaps = submaps
    ctx.spans = spans_
    ctx.counters = counters or {}
    for sp in spans_:
        st = ctx.prof.setdefault(sp.name, {"count": 0, "sum": 0.0})
        st["count"] += 1
        st["sum"] += (sp.end_ns - sp.start_ns) * 1e-9
    return ctx


def test_readers_on_hand_made_spans_and_counters():
    counters = {"host_reads": 7, "nn_pairs": 10 ** 9, "nn_bytes": 10 ** 6}
    ctx = _ctx(counters=counters)
    # entry: 9 ms less FrontEndChunk's 4.5 and SubmapInsert's 3
    assert entry_self_ms_per_scan.read(ctx) == pytest.approx(1.5 / 2)
    assert scan_filter_ms_per_scan.read(ctx) == pytest.approx(0.3 / 2)
    assert scan_icp_ms_per_scan.read(ctx) == pytest.approx(2.0 / 2)
    assert scan_target_ms_per_scan.read(ctx) == pytest.approx(0.7 / 2)
    # the four reads: 0.5 + 0.2 + 1.0 + 1.0 ms
    assert host_wait_ms_per_scan.read(ctx) == pytest.approx(2.7 / 2)
    assert host_reads_per_scan.read(ctx) == pytest.approx(3.5)
    assert pair_match_wait_ms_per_submap.read(ctx) == pytest.approx(1.0)
    # 1e9 pairs × 6 / 67e12 = 89.55 µs > 1e6 B / 3.35e12 B/s, over 2 scans;
    # 0.5 ms of nn kernels a scan
    ctx.trace = {"kernels": [("void nn_main<2, 256>(float const*)", 1e-3),
                             ("elementwise_kernel", 5e-3)]}
    bound_ms = 1e3 * 1e9 * 6 / 67e12 / 2
    assert nn_roofline.read(ctx) == pytest.approx(100 * bound_ms / 0.5)


def test_roofline_by_bytes_where_they_bound():
    ctx = _ctx(counters={"nn_pairs": 1, "nn_bytes": 3.35e9})
    ctx.trace = {"kernels": [("nn_main", 4e-3)]}
    # 1 ms of bytes over 2 scans against 2 ms of kernel a scan
    assert nn_roofline.read(ctx) == pytest.approx(25.0)


def test_readers_read_nothing_from_a_program_without_spans():
    parent_prof = types.SimpleNamespace(stats=dict, reset=lambda: None)
    ctx = drive.Context()
    ctx.window_scans = ctx.trace_scans = 2
    ctx.window_submaps = 1
    ctx.program = lambda name: parent_prof
    ctx.trace = {"kernels": [("nn_main", 1e-3)]}
    for r in READERS:
        assert r.read(ctx) is None, r.__name__


def test_readers_read_nothing_where_their_spans_did_not_run():
    ctx = _ctx(spans_=[_span("SubmapInsert", 1_006_000, 1_009_000)])
    for r in READERS:
        assert r.read(ctx) is None, r.__name__


DEV_EVENTS = [
    ("spin_kernel", 1_000_990.0, 1_001_000.0, True),
    ("void nn_main<2, 256>(float const*)", 1_001_000.0, 1_001_100.0, True),
    ("elementwise_kernel", 1_003_600.0, 1_003_700.0, True),
    ("elementwise_kernel", 1_006_500.0, 1_006_600.0, True),
    ("spin_kernel", 1_011_000.0, 1_011_010.0, True),
]
HOST_EVENTS = [
    ("cudaLaunchKernel", 1_000_980.0, 1_000_985.0, False),
    ("cudaMalloc", 1_006_600.0, 1_006_800.0, False),
    ("cudaStreamSynchronize", 1_003_000.0, 1_003_550.0, False),
    ("cudaLaunchKernel", 1_010_990.0, 1_010_995.0, False),
]


def test_gaps_are_named_by_the_spans_open_at_their_start():
    feed = spans.on_trace_clock(SPANS, PAIR, MAIN)
    events = DEV_EVENTS + HOST_EVENTS
    window = (1_000_990.0, 1_011_010.0)
    named = spans.reduce_events(events, window, feed)
    plain = trace.reduce_events(events, window)
    # everything but the gaps' names is trace.reduce_events' own
    assert {k: v for k, v in named.items() if k != "idle_gaps"} == {
        k: v for k, v in plain.items() if k != "idle_gaps"}
    assert [g[1] for g in named["idle_gaps"]] == [
        g[1] for g in plain["idle_gaps"]]
    gaps = {round(length * 1e6): name for name, length in named["idle_gaps"]}
    # 1_001_100: the entry alone, before its chunk; no runtime call
    assert gaps[2500] == "InsertPointcloud"
    # 1_003_700: inside the ICP's span, past its converged read
    assert gaps[2800] == "InsertPointcloud / ScanStep:icp"
    # 1_006_600 to the window's end (the marks are no work): a cudaMalloc
    # in the submap insert
    assert gaps[4410] == "InsertPointcloud / SubmapInsert / cudaMalloc"
    # before the entry: no span open
    assert gaps[10] == "host"
    # without spans the names are trace's own
    assert {n for n, _ in plain["idle_gaps"]} <= {"host", "cudaMalloc"}


def test_a_gap_where_no_span_is_open_stays_host():
    feed = spans.on_trace_clock(SPANS, PAIR, MAIN)
    assert spans.gap_name("host", feed, 1_010_500.0) == "host"
    assert spans.gap_name("cudaLaunchKernel", feed,
                          1_010_500.0) == "cudaLaunchKernel"
    # the stage thread's spans never name a gap
    assert spans.gap_name("host", [], 1_002_500.0) == "host"
    long = spans.gap_name("x" * 200, feed, 1_001_050.0)
    assert len(long) == trace.NAME_CHARS


def test_gap_names_with_no_spans_are_the_plain_reduction():
    events = DEV_EVENTS + HOST_EVENTS
    window = (1_000_990.0, 1_011_010.0)
    assert spans.reduce_events(events, window, []) == trace.reduce_events(
        events, window)


def test_clock_misfit_at_the_marks():
    brackets = [(_us(1_000_970), _us(1_000_990)),
                (_us(1_010_980), _us(1_011_000))]
    launches = [(1_000_980.0, 1_000_985.0), (1_010_990.0, 1_010_995.0)]
    assert spans.clock_misfit_us(launches, brackets, PAIR) == 0.0
    late = [(1_000_980.0, 1_000_995.0), (1_010_960.0, 1_010_995.0)]
    # 5 µs past the first bracket's end, 20 µs before the second's start
    assert spans.clock_misfit_us(late, brackets, PAIR) == pytest.approx(20.0)
    # a launch the trace lacks: the other mark alone is checked
    assert spans.clock_misfit_us([None, late[1]], brackets,
                                 PAIR) == pytest.approx(20.0)
    assert spans.clock_misfit_us([None, None], brackets, PAIR) is None
    assert spans.clock_misfit_us(launches[:1], brackets, PAIR) is None


def test_syncs_are_counted_by_their_innermost_span():
    feed = spans.on_trace_clock(SPANS, PAIR, MAIN)
    events = [("cudaStreamSynchronize", 1_003_100.0, 1_003_200.0, False),
              ("cudaStreamSynchronize", 1_007_500.0, 1_007_600.0, False),
              ("cudaStreamSynchronize", 1_010_500.0, 1_010_600.0, False),
              ("cudaDeviceSynchronize", 1_002_500.0, 1_002_600.0, False),
              ("cudaStreamSynchronize", 1_000_500.0, 1_000_600.0, False),
              ("cudaLaunchKernel", 1_003_100.0, 1_003_200.0, False)]
    # the last sync lies before the window, the launch is no sync
    assert spans.syncs_by_span(events, W, feed) == {
        "Icp:converged_read": 1, "SubmapPairConsume:read": 1,
        "ScanStep:icp": 1, "no span": 1}


class _Event:
    """A kineto event as ``trace._raw_events`` and the hooks read it."""

    def __init__(self, name, s_us, e_us, on_device, corr=0):
        self._n, self._s, self._e = name, s_us, e_us
        self._d, self._c = on_device, corr

    def name(self):
        return self._n

    def device_type(self):
        return DeviceType.CUDA if self._d else DeviceType.CPU

    def activity_type(self):
        return "kernel"

    def is_user_annotation(self):
        return False

    def start_ns(self):
        return int(self._s * 1e3)

    def duration_ns(self):
        return int((self._e - self._s) * 1e3)

    def correlation_id(self):
        return self._c


def _profiler(events):
    results = types.SimpleNamespace(events=lambda: events)
    return types.SimpleNamespace(
        profiler=types.SimpleNamespace(kineto_results=results))


def test_the_hooks_join_the_clocks_and_name_the_gaps(capsys):
    corr = {("spin_kernel", 1_000_990.0): 1, ("spin_kernel", 1_011_000.0): 2,
            ("cudaLaunchKernel", 1_000_980.0): 1,
            ("cudaLaunchKernel", 1_010_990.0): 2}
    events = [_Event(n, s, e, d, corr.get((n, s), 0))
              for n, s, e, d in DEV_EVENTS + HOST_EVENTS]
    prog = types.SimpleNamespace(spans=lambda: SPANS, counters=dict,
                                 clock_pair=lambda: PAIR)
    ctx = drive.Context()
    ctx.program = lambda name: prog
    ctx.trace_scans = 2
    marked = []
    device_mark = spans._MARK
    spans._MARK = lambda: marked.append(1)      # no device here
    try:
        spans.install(ctx)
        hooks = ctx.span_hooks
        spans.install(ctx)                      # once a run
        assert ctx.span_hooks is hooks
        trace.mark()
        trace.mark()
        assert len(marked) == 2 and hooks.pair == PAIR
        # the brackets as the mark calls would have seen them
        hooks.brackets = [(_us(1_000_970), _us(1_000_990)),
                          (_us(1_010_980), _us(1_011_000))]
        red = trace.reduce(_profiler(events))
    finally:
        spans._MARK = device_mark
        spans.uninstall()
    assert trace.mark is device_mark and trace.reduce is spans._REDUCE
    assert ctx.clock_misfit_us == 0.0
    names = [n for n, _ in red["idle_gaps"]]
    assert "InsertPointcloud / SubmapInsert / cudaMalloc" in names
    err = capsys.readouterr().err
    assert "trace clock_misfit_us: 0.0" in err
    assert "Icp:converged_read 1" in err


def test_hooks_fall_back_without_spans():
    prog = types.SimpleNamespace(stats=dict)        # the parent's program
    ctx = drive.Context()
    ctx.program = lambda name: prog
    events = [_Event(n, s, e, d) for n, s, e, d in DEV_EVENTS + HOST_EVENTS]
    try:
        spans.install(ctx)
        red = trace.reduce(_profiler(events))
    finally:
        spans.uninstall()
    assert red == spans._REDUCE(_profiler(events))
    assert trace.mark is spans._MARK and trace.reduce is spans._REDUCE


def test_hooks_leave_gaps_unnamed_where_the_clocks_misfit(capsys):
    corr = {("spin_kernel", 1_000_990.0): 1, ("spin_kernel", 1_011_000.0): 2,
            ("cudaLaunchKernel", 1_000_980.0): 1,
            ("cudaLaunchKernel", 1_010_990.0): 2}
    events = [_Event(n, s, e, d, corr.get((n, s), 0))
              for n, s, e, d in DEV_EVENTS + HOST_EVENTS]
    prog = types.SimpleNamespace(spans=lambda: SPANS, counters=dict,
                                 clock_pair=lambda: PAIR)
    ctx = drive.Context()
    ctx.program = lambda name: prog
    try:
        spans.install(ctx)
        ctx.span_hooks.pair = PAIR
        # the second bracket ends 100 µs before its launch began
        ctx.span_hooks.brackets = [(_us(1_000_970), _us(1_000_990)),
                                   (_us(1_010_880), _us(1_010_890))]
        red = trace.reduce(_profiler(events))
    finally:
        spans.uninstall()
    assert ctx.clock_misfit_us == pytest.approx(105.0)
    assert red == trace.reduce_events(
        [(n, s, e, d) for n, s, e, d in DEV_EVENTS + HOST_EVENTS],
        (1_000_990.0, 1_011_010.0))
    assert "left unnamed" in capsys.readouterr().err


def test_mark_launches_by_correlation_else_by_time():
    marks = [(1_000_990.0, 1_001_000.0), (1_011_000.0, 1_011_010.0)]
    by_id = {("spin_kernel", 1_000_990.0): 7,
             ("cudaLaunchKernel", 1_000_980.0): 7}
    events = [_Event(n, s, e, d, by_id.get((n, s), 0))
              for n, s, e, d in DEV_EVENTS + HOST_EVENTS
              + [("cudaLaunchKernel", 1_010_900.0, 1_010_905.0, False)]]
    launches, how = spans.mark_launches(_profiler(events), marks)
    assert how == ["id", "time"]
    # the second mark has no correlation id: the last launch before it
    assert launches == [(1_000_980.0, 1_000_985.0),
                        (1_010_990.0, 1_010_995.0)]
    launches, how = spans.mark_launches(
        _profiler([e for e in events if e.name() != "cudaLaunchKernel"]),
        marks)
    assert launches == [None, None] and how == [None, None]


BRACKETS = [(_us(1_000_970), _us(1_000_990)),
            (_us(1_010_980), _us(1_011_000))]


@pytest.mark.parametrize("lost, window, placed", [
    # the end mark lost: the window ends where its bracket ends
    (1_011_000.0, (1_000_990.0, 1_011_000.0), [1]),
    # the start mark lost: the window starts where its bracket ends
    (1_000_990.0, (1_000_990.0, 1_011_010.0), [0]),
])
def test_a_lost_mark_is_placed_from_its_bracket(lost, window, placed):
    events = [e for e in DEV_EVENTS + HOST_EVENTS
              if not (e[0] == "spin_kernel" and e[1] == lost)]
    marks = [(s, e) for n, s, e, d in events if d and n == "spin_kernel"]
    assert spans.place_window(marks, events, BRACKETS, PAIR) == (
        window, placed)


def test_no_window_where_the_trace_stops_short_of_a_lost_mark():
    # the trace ends 2 ms into the window: no device work near the end
    events = [e for e in DEV_EVENTS if e[1] < 1_003_000.0]
    marks = [(s, e) for n, s, e, d in events if n == "spin_kernel"]
    assert spans.place_window(marks, events, BRACKETS, PAIR,
                              guard_us=1000.0) is None
    # nor without the brackets or the clock pair
    assert spans.place_window(marks, DEV_EVENTS, BRACKETS[:1], PAIR) is None
    assert spans.place_window(marks, DEV_EVENTS, BRACKETS, None) is None
    # nor with both marks lost and no device work at all
    assert spans.place_window([], [], BRACKETS, PAIR) is None


@pytest.mark.parametrize("program", ["with spans", "without spans"])
def test_hooks_reduce_a_trace_that_lost_its_end_mark(program, capsys):
    corr = {("spin_kernel", 1_000_990.0): 1,
            ("cudaLaunchKernel", 1_000_980.0): 1,
            ("cudaLaunchKernel", 1_010_990.0): 2}
    kept = [e for e in DEV_EVENTS + HOST_EVENTS
            if not (e[0] == "spin_kernel" and e[1] == 1_011_000.0)]
    events = [_Event(n, s, e, d, corr.get((n, s), 0))
              for n, s, e, d in kept]
    prog = (types.SimpleNamespace(spans=lambda: SPANS, counters=dict,
                                  clock_pair=lambda: PAIR)
            if program == "with spans" else types.SimpleNamespace())
    ctx = drive.Context()
    ctx.program = lambda name: prog
    try:
        spans.install(ctx)
        ctx.span_hooks.pair = PAIR
        ctx.span_hooks.brackets = list(BRACKETS)
        assert spans._REDUCE(_profiler(events)) is None   # one mark left
        red = trace.reduce(_profiler(events))
    finally:
        spans.uninstall()
    plain = trace.reduce_events(kept, (1_000_990.0, 1_011_000.0))
    assert red["window_s"] == plain["window_s"] == pytest.approx(0.01001)
    assert red["busy_s"] == plain["busy_s"]
    assert "ends [1] placed from their host brackets" in (
        capsys.readouterr().err)
    if program == "with spans":
        # the second launch is found by time and fits its bracket
        assert ctx.clock_misfit_us == 0.0
        assert "InsertPointcloud / SubmapInsert / cudaMalloc" in [
            n for n, _ in red["idle_gaps"]]
    else:
        assert red == plain


def test_the_hooks_clock_pair_without_the_programs():
    prog = types.SimpleNamespace()                  # the parent's program
    ctx = drive.Context()
    ctx.program = lambda name: prog
    marked = []
    device_mark = spans._MARK
    spans._MARK = lambda: marked.append(1)
    try:
        spans.install(ctx)
        trace.mark()
    finally:
        spans._MARK = device_mark
        spans.uninstall()
    perf_ns, epoch_ns = ctx.span_hooks.pair
    assert marked == [1] and len(ctx.span_hooks.brackets) == 1
    assert perf_ns <= ctx.span_hooks.brackets[0][0]
    assert abs(epoch_ns / 1e9 - time.time()) < 60
