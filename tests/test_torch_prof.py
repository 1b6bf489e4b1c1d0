"""``staticmapping_torch.common.prof``: the span tree (parents, request
ids, threads), counters, reset, the disabled no-op, the bound on kept
spans, and the per-name sums the ``--profile`` table prints."""
import threading
import time

import pytest

from staticmapping_torch.common import prof


@pytest.fixture
def enabled():
    prof.reset()
    prof.enable(report_at_exit=False)
    try:
        yield prof
    finally:
        prof.disable()
        prof.reset()


def _by_name(spans):
    return {s.name: s for s in spans}


def test_span_tree_parents_requests_and_threads(enabled):
    with prof.block("InsertPointcloud", req=7):
        with prof.block("FrontEndChunk"):
            with prof.block("FrontEndChunk:run", req=2):
                with prof.block("ScanStep"):
                    pass
        with prof.block("SubmapInsert"):
            pass
    spans = prof.spans()
    assert [s.name for s in spans] == [
        "InsertPointcloud", "FrontEndChunk", "FrontEndChunk:run",
        "ScanStep", "SubmapInsert"]
    assert [s.parent for s in spans] == [-1, 0, 1, 2, 0]
    # a block given no request id takes its parent's
    assert [s.req for s in spans] == [7, 7, 2, 2, 7]
    assert {s.thread for s in spans} == {threading.get_native_id()}
    for s in spans:
        assert s.end_ns >= s.start_ns
    for s in spans[1:]:
        p = spans[s.parent]
        assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns


def test_self_time_is_duration_less_children(enabled):
    with prof.block("outer"):
        time.sleep(0.002)
        with prof.block("inner"):
            time.sleep(0.004)
    s = _by_name(prof.spans())
    outer = s["outer"].end_ns - s["outer"].start_ns
    inner = s["inner"].end_ns - s["inner"].start_ns
    assert inner >= 4e6 and outer - inner >= 2e6


def test_each_thread_has_its_own_stack(enabled):
    seen = {}

    def work():
        with prof.block("StageChunk", req=3):
            with prof.block("pack"):
                seen["tid"] = threading.get_native_id()

    with prof.block("InsertPointcloud", req=1):
        t = threading.Thread(target=work)
        t.start()
        t.join(timeout=10)
    assert not t.is_alive()
    spans = prof.spans()
    s = _by_name(spans)
    # the thread's root has no parent, though the main thread's block was
    # open when it began
    assert s["StageChunk"].parent == -1
    assert spans[s["pack"].parent].name == "StageChunk"
    assert s["pack"].req == 3 and s["pack"].thread == seen["tid"]
    assert s["InsertPointcloud"].thread != seen["tid"]


def test_counters_and_reset(enabled):
    prof.count("host_reads")
    prof.count("host_reads", 2)
    prof.count("nn_pairs", 10)
    assert prof.counters() == {"host_reads": 3, "nn_pairs": 10}
    with prof.block("a"):
        pass
    prof.reset()
    assert prof.spans() == [] and prof.counters() == {} and prof.stats() == {}


def test_block_open_across_reset_records_nothing(enabled):
    with prof.block("straddles"):
        prof.reset()
        with prof.block("after"):
            pass
    spans = prof.spans()
    assert [s.name for s in spans] == ["after"]
    assert spans[0].parent == -1
    assert set(prof.stats()) == {"after"}


def test_disabled_block_is_one_shared_no_op():
    prof.disable()
    prof.reset()
    a, b = prof.block("x"), prof.block("y", req=3)
    assert a is b
    with a:
        prof.count("host_reads")
    assert prof.spans() == [] and prof.counters() == {} and prof.stats() == {}


def test_stats_sum_nested_blocks_per_name(enabled):
    for _ in range(3):
        with prof.block("FrontEndChunk"):
            with prof.block("FrontEndChunk:run"):
                time.sleep(0.001)
    st = prof.stats()
    spans = prof.spans()
    for name in ("FrontEndChunk", "FrontEndChunk:run"):
        d = [(s.end_ns - s.start_ns) * 1e-9 for s in spans if s.name == name]
        assert st[name]["count"] == 3
        assert st[name]["sum"] == pytest.approx(sum(d), rel=1e-12)
        assert st[name]["min"] == pytest.approx(min(d), rel=1e-12)
        assert st[name]["max"] == pytest.approx(max(d), rel=1e-12)
        assert st[name]["avg"] == pytest.approx(sum(d) / 3, rel=1e-12)
    # the outer block's sum holds its child's
    assert st["FrontEndChunk"]["sum"] >= st["FrontEndChunk:run"]["sum"]
    table = prof.report()
    assert "FrontEndChunk:run" in table and table.splitlines()[0].startswith(
        "block")


def test_spans_past_the_bound_still_count_in_stats(enabled, monkeypatch):
    monkeypatch.setattr(prof, "MAX_SPANS", 4)
    for _ in range(6):
        with prof.block("outer"):
            with prof.block("inner"):
                pass
    spans = prof.spans()
    assert len(spans) == 4
    assert [s.parent for s in spans] == [-1, 0, -1, 2]
    assert prof.stats()["outer"]["count"] == 6


def test_clock_pair_reads_both_clocks_together():
    p, w = prof.clock_pair()
    p2, w2 = time.perf_counter_ns(), time.time_ns()
    # both clocks moved by the same few microseconds since the pair
    assert 0 <= p2 - p < 1e8 and abs((w2 - w) - (p2 - p)) < 1e6


def test_tally_holds_back_its_threads_counts(enabled):
    """Counts made inside a tally go to it, not to the counters; another
    thread's counts meanwhile are counted as usual."""
    prof.count("a", 1)
    with prof.tally() as held:
        prof.count("a", 2)
        prof.count("b")
        other = threading.Thread(target=prof.count, args=("a", 5))
        other.start()
        other.join()
    prof.count("a", 3)
    assert held == {"a": 2, "b": 1}
    assert prof.counters() == {"a": 9}


def test_tally_holds_counts_while_disabled():
    prof.reset()
    with prof.tally() as held:
        prof.count("x", 4)
    prof.count("x", 1)
    assert held == {"x": 4}
    assert prof.counters() == {}
