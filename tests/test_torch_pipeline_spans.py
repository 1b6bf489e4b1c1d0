"""The spans and counters of the chunked front end and the pipelined
``MapBuilder`` (``common/prof.py``) on a tiny CPU run: every scan's step
phases under its ``ScanStep``, the chunk's stage wait, run and harvest
read, and ``host_reads`` as the ICP's trips predict."""
import collections

import pytest

from staticmapping_torch.builder import frame as tframe
from staticmapping_torch.builder import frontend as tfrontend
from staticmapping_torch.builder import map_builder as tmb
from staticmapping_torch.builder import pipeline as tpipe
from staticmapping_torch.common import prof
from staticmapping_torch.filters.filters import FilterChain, create_filter
from staticmapping_torch.io import synthetic
from staticmapping_torch.registration import icp_fast

K = 2                    # scans a chunk
# a multiple of the while form's 4 trips between converged reads
MAX_ITERATION = 40


@pytest.fixture(scope="module")
def scans():
    return synthetic.make_sequence(n_scans=1 + 6 * K, seed=5,
                                   max_points=800, max_range=40.0)[0]


def _fe_options():
    return tfrontend.FrontEndOptions(
        scan_capacity=1024, nn_tile=512, max_iteration=MAX_ITERATION,
        motion_compensation=False, use_average=False, target_leaf_size=8)


@pytest.fixture
def recording():
    prof.reset()
    icp_fast.reset_trips()
    prof.enable(report_at_exit=False)
    try:
        yield
    finally:
        prof.disable()
        prof.reset()


def _children(spans, i):
    return [s for s in spans if s.parent == i]


def test_two_chunks_give_each_scan_its_spans(scans, recording):
    chain = FilterChain([create_filter("Range")])
    fe = tpipe.DeviceFrontEnd(_fe_options(), filter_chain=chain,
                              chunk_size=K, device="cpu")
    try:
        prof.disable()                 # scan 0 runs alone, outside any chunk
        fe.process(0.0, scans[0])
        prof.enable(report_at_exit=False)
        frames = []
        for i in range(1, 1 + 2 * K):
            frames += fe.process(0.1 * i, scans[i])
        frames += fe.flush()
    finally:
        fe.close()
    prof.disable()
    spans = prof.spans()
    steps = [(i, s) for i, s in enumerate(spans) if s.name == "ScanStep"]
    assert [s.req for _, s in steps] == list(range(1, 1 + 2 * K))
    converged_reads = 0
    for i, step in steps:
        kids = _children(spans, i)
        names = [c.name for c in kids]
        assert names[:3] == ["ScanStep:filter", "ScanStep:icp",
                             "ScanStep:keyframe_read"]
        assert names[3:] in ([], ["ScanStep:target"])
        assert all(c.req == step.req for c in kids)
        run = spans[step.parent]
        assert run.name == "FrontEndChunk:run"
        assert run.req == (step.req - 1) // K
        icp = spans.index(kids[1])
        reads = _children(spans, icp)
        assert reads and {r.name for r in reads} == {"Icp:converged_read"}
        converged_reads += len(reads)
    keyframes = sum(s.name == "ScanStep:target" for s in spans)
    assert keyframes == len(frames)

    per_chunk = collections.Counter((s.name, s.req) for s in spans
                                    if s.name.startswith(("FrontEndChunk:",
                                                          "StageChunk")))
    for chunk in range(2):
        for name in ("StageChunk", "FrontEndChunk:stage_wait",
                     "FrontEndChunk:run", "FrontEndChunk:harvest_read"):
            assert per_chunk[(name, chunk)] == 1, (name, chunk)
    stage = [s for s in spans if s.name == "StageChunk"]
    assert {s.thread for s in stage} != {steps[0][1].thread}

    # 4 trips between converged reads, 1 keyframe read a scan, 2 reads a
    # harvest
    trips = icp_fast.trip_counts()["while"]["run"]
    assert trips == 4 * converged_reads
    assert prof.counters()["host_reads"] == (trips / 4 + 2 * K + 2 * 2)


def test_builder_roots_each_scan_and_times_the_consume(scans, recording,
                                                       tmp_path):
    opts = tmb.MapBuilderOptions(
        front_end=_fe_options(), submap=tframe.SubmapOptions(frame_count=2),
        submap_capacity=2048, submap_matcher_leaf_size=8, pipelined=True,
        pipeline_chunk=K, pair_match_batch=2,
        export_file_path=str(tmp_path), output_mrvm=False,
        output_direct_combined_map=False)
    mb = tmb.MapBuilder(opts, device="cpu")
    try:
        for i in range(1 + 6 * K):
            mb.insert_pointcloud(0.1 * i, scans[i])
    finally:
        mb.front_end.close()
    prof.disable()
    spans = prof.spans()
    roots = [s for s in spans if s.parent == -1
             and s.name != "StageChunk"]
    assert [s.name for s in roots] == ["InsertPointcloud"] * (1 + 6 * K)
    assert [s.req for s in roots] == list(range(1 + 6 * K))
    for i, s in enumerate(spans):
        if s.name in ("FrontEndChunk", "SubmapInsert"):
            assert spans[s.parent].name == "InsertPointcloud"
    consume = [i for i, s in enumerate(spans)
               if s.name == "SubmapPairConsume"]
    assert consume
    for i in consume:
        assert spans[spans[i].parent].name == "SubmapInsert"
        assert [c.name for c in _children(spans, i)][:1] == [
            "SubmapPairConsume:read"]
    # the --profile table still sums the blocks it summed before
    assert {"FrontEndChunk", "SubmapInsert", "SubmapPairMatchBatch"} <= set(
        prof.stats())
