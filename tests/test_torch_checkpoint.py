"""The port's checkpoint and resume (staticmapping_torch.builder.checkpoint)
on the CPU: the cases of tests/test_checkpoint.py under its bounds, a resume
past a dropped partial submap, a checkpoint the JAX package wrote loaded by
the port, and the chunked front end's resume in both packages.

The scans are tests/test_checkpoint.py's (seed 5, 1 m steps: every scan a
keyframe, 2-frame submaps).  The port runs them once: it saves after 8
scans (four full submaps) and after 9 (and one partial), then goes on to
the end as the uninterrupted run.  The JAX package runs the 9-scan prefix
once."""
import copy
import types

import numpy as np
import pytest
import torch

from staticmapping_tpu.backend.loop_detector import \
    LoopDetectorSettings as JLoopSettings
from staticmapping_tpu.backend.optimizer import (
    IncrementalOptimizer as JOptimizer, OptimizerOptions as JOptimizerOptions)
from staticmapping_tpu.builder import checkpoint as jckpt
from staticmapping_tpu.builder.frame import SubmapOptions as JSubmapOptions
from staticmapping_tpu.builder.frontend import \
    FrontEndOptions as JFrontEndOptions
from staticmapping_tpu.builder.map_builder import (
    MapBuilder as JMapBuilder, MapBuilderOptions as JMapBuilderOptions)
from staticmapping_tpu.io import synthetic
from staticmapping_torch.backend.loop_detector import LoopDetectorSettings
from staticmapping_torch.backend.optimizer import (IncrementalOptimizer,
                                                   OptimizerOptions)
from staticmapping_torch.builder import checkpoint as tckpt
from staticmapping_torch.builder.frame import SubmapOptions
from staticmapping_torch.builder.frontend import FrontEndOptions
from staticmapping_torch.builder.map_builder import (MapBuilder,
                                                     MapBuilderOptions)

CPU = "cpu"
PREFIX = 9          # scans before the JAX package's save and the port's
                    # second; the port's first save follows scan 8
FACTOR_FIELDS = {"factors": ("i", "j", "T_meas", "sigmas"),
                 "gps_factors": ("i", "enu", "p_tg", "sigmas", "use_err"),
                 "odom_factors": ("i", "T_odom", "sigmas"),
                 "prior_factors": ("i", "T_prior", "sigmas")}


def _opts(pkg, **kw):
    """tests/test_checkpoint.py::_opts for either package's classes."""
    fe_cls, sub_cls, mb_cls = pkg
    return mb_cls(
        front_end=fe_cls(scan_capacity=8192, nn_tile=512, max_iteration=40,
                         motion_compensation=False, use_average=False,
                         target_leaf_size=4),
        submap=sub_cls(frame_count=2), submap_capacity=16384,
        submap_matcher_leaf_size=4, output_kitti_pose=False,
        output_mrvm=False, output_direct_combined_map=False, **kw)


JAX = (JFrontEndOptions, JSubmapOptions, JMapBuilderOptions)
PORT = (FrontEndOptions, SubmapOptions, MapBuilderOptions)


def _backend():
    return IncrementalOptimizer(
        OptimizerOptions(),
        loop_settings=LoopDetectorSettings(loop_ignore_threshold=50,
                                           use_descriptor=False),
        device=CPU)


def _jax_backend():
    return JOptimizer(JOptimizerOptions(),
                      loop_settings=JLoopSettings(loop_ignore_threshold=50,
                                                  use_descriptor=False))


@pytest.fixture(autouse=True)
def _two_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def scans():
    return synthetic.make_sequence(n_scans=16, seed=5, trajectory="straight",
                                   step=1.0, max_points=6000,
                                   max_range=70.0)[0]


@pytest.fixture(scope="module")
def port_run(scans, tmp_path_factory):
    """The port's run: its state and checkpoint after 8 scans ("full"),
    its checkpoint after 9 ("partial"), and the same builder run on to the
    end (the uninterrupted run)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    out = {}
    try:
        mb = MapBuilder(_opts(PORT), backend=_backend(), device=CPU)
        for i, pts in enumerate(scans):
            mb.insert_pointcloud(i * 0.1, pts)
            if i + 1 not in (PREFIX - 1, PREFIX):
                continue
            key = "full" if i + 1 == PREFIX - 1 else "partial"
            out[key] = {
                "n_full": len([s for s in mb.trajectory if s.full]),
                "partial": [s.id for s in mb.trajectory if not s.full],
                "graph": copy.deepcopy({k: getattr(mb.backend.graph, k)
                                        for k in FACTOR_FIELDS}),
                "special": copy.deepcopy(mb.backend.graph.special_values),
                "ckpt": str(tmp_path_factory.mktemp("port") / key)}
            tckpt.save_checkpoint(mb, out[key]["ckpt"])
    finally:
        torch.set_num_threads(saved)
    out["run"] = mb
    return out


def _resume(at, scans, start: int):
    mb = tckpt.load_checkpoint(at["ckpt"], map_builder_options=_opts(PORT),
                               backend=_backend(), device=CPU)
    n_full = at["n_full"]
    assert len(mb.trajectory) == n_full
    assert mb.backend.graph.num_nodes == n_full
    assert len(mb.backend.graph.factors) == len(at["graph"]["factors"])
    assert len(mb.backend.loop_detector.frames) == n_full
    for i, pts in enumerate(scans[start:]):
        mb.insert_pointcloud((start + i) * 0.1, pts)
    return mb


@pytest.fixture(scope="module")
def jax_run(scans, tmp_path_factory):
    """The JAX package's prefix and its checkpoint."""
    mb = JMapBuilder(_opts(JAX), backend=_jax_backend())
    for i, pts in enumerate(scans[:PREFIX]):
        mb.insert_pointcloud(i * 0.1, pts)
    ckpt = str(tmp_path_factory.mktemp("jax") / "ckpt")
    jckpt.save_checkpoint(mb, ckpt)
    return {"mb": mb, "ckpt": ckpt}


def test_checkpoint_resume_continues_run(port_run, scans):
    """tests/test_checkpoint.py::test_checkpoint_resume_continues_run: cut
    after 8 scans, every submap full, replay the rest."""
    at = port_run["full"]
    assert at["partial"] == []
    mb = _resume(at, scans, PREFIX - 1)
    full = port_run["run"]
    full_ids = [s.id for s in full.trajectory if s.full]
    res_ids = [s.id for s in mb.trajectory if s.full]
    assert len(res_ids) >= len(full_ids) - 1
    for k in range(min(len(full.trajectory), len(mb.trajectory))):
        a = full.trajectory[k].global_pose[:3, 3]
        b = mb.trajectory[k].global_pose[:3, 3]
        assert np.linalg.norm(a - b) < 0.8, (k, a, b)


def test_resume_refills_the_dropped_partial_submap(port_run, scans):
    """Cut after 9 scans, the ninth keyframe alone in a partial submap:
    the replay starts at that scan.  It is the saved target, so it matches
    in place and makes no keyframe; the next scan opens the dropped
    submap's id again.  Ids stay dense, the submap count is at least the
    uninterrupted run's minus one, and every resumed keyframe lies within
    tests/test_checkpoint.py's 0.8 m of the uninterrupted run's keyframe
    of the same scan."""
    at = port_run["partial"]
    assert at["partial"] == [at["n_full"]]
    mb = _resume(at, scans, PREFIX - 1)
    full = port_run["run"]
    assert [s.id for s in mb.trajectory] == list(range(len(mb.trajectory)))
    assert len(mb.trajectory) >= len(full.trajectory) - 1
    want = {round(f.stamp, 3): f.global_pose[:3, 3]
            for s in full.trajectory for f in s.frames}
    got = [(round(f.stamp, 3), f.global_pose[:3, 3])
           for s in mb.trajectory for f in s.frames]
    assert len(got) >= len(want) - 1
    for st, p in got:
        assert np.linalg.norm(p - want[st]) < 0.8, (st, p, want[st])


def _assert_same_factors(got, want) -> None:
    for name, fields in FACTOR_FIELDS.items():
        g, w = getattr(got, name), getattr(want, name)
        assert len(g) == len(w), name
        for f in fields:
            for a, b in zip(getattr(g, f), getattr(w, f)):
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("cut", ["full", "partial"])
def test_checkpoint_preserves_factor_payloads(cut, port_run):
    """tests/test_checkpoint.py::test_checkpoint_preserves_factor_payloads:
    every factor batch and the special values come back exactly."""
    at = port_run[cut]
    mb = tckpt.load_checkpoint(at["ckpt"], map_builder_options=_opts(PORT),
                               backend=_backend(), device=CPU)
    g = mb.backend.graph
    assert len(g.factors) > 0
    _assert_same_factors(g, types.SimpleNamespace(**at["graph"]))
    for a, b in zip(g.special_values, at["special"]):
        np.testing.assert_array_equal(a, b)


def test_jax_checkpoint_loads_in_the_port(jax_run):
    """A checkpoint the JAX package wrote: equal factor payloads, loop
    state and front-end state (poses, counters, target) in the port."""
    jmb = jax_run["mb"]
    mb = tckpt.load_checkpoint(jax_run["ckpt"],
                               map_builder_options=_opts(PORT),
                               backend=_backend(), device=CPU)
    be, jbe = mb.backend, jmb.backend
    _assert_same_factors(be.graph, jbe.graph)
    assert be.graph.num_nodes == jbe.graph.num_nodes
    assert be.loop_detector.status.value == jbe.loop_detector.status.value
    assert (be.loop_detector.accumulate_count
            == jbe.loop_detector.accumulate_count)
    assert be.loop_edge_count == jbe.loop_edge_count
    fe, jfe = mb.front_end, jmb.front_end
    np.testing.assert_array_equal(fe.pose_target, jfe.pose_target)
    np.testing.assert_array_equal(fe.accumulative, jfe.accumulative)
    assert (fe.num_scans, fe.got_first) == (jfe.num_scans, jfe.got_first)
    assert fe.last_score == pytest.approx(jfe.last_score, abs=0)
    for k in ("xyz", "normals", "mask"):
        np.testing.assert_array_equal(getattr(fe.target, k).numpy(),
                                      np.asarray(getattr(jfe.target, k)))
    assert [s.id for s in mb.trajectory] == [s.id for s in jmb.trajectory
                                             if s.full]
    for s, js in zip(mb.trajectory, jmb.trajectory):
        np.testing.assert_allclose(s.global_pose, js.global_pose,
                                   rtol=1e-8, atol=1e-8)


def test_jax_resume_past_a_partial_submap_fails(jax_run, scans):
    """The reference defect the port repairs (ROADMAP.md queue C): the JAX
    package keeps its submap counter past the dropped partial submap, so
    the first submap after the replay indexes past the trajectory."""
    mb = jckpt.load_checkpoint(jax_run["ckpt"],
                               map_builder_options=_opts(JAX),
                               backend=_jax_backend())
    with pytest.raises(IndexError):
        for i, pts in enumerate(scans[PREFIX - 1:]):
            mb.insert_pointcloud((PREFIX - 1 + i) * 0.1, pts)


def test_chunked_resume_restarts_at_identity(scans, tmp_path):
    """The chunked front end's resume in both packages, cut at a chunk
    boundary: ``base`` is kept, the device state is not, so the first
    replayed scan becomes a keyframe at the identity in both (ROADMAP.md
    queue C).  The JAX package's in-flight chunk is drained by hand before
    its save; the port's save drains it itself."""
    kw = dict(pipelined=True, pipeline_chunk=8, pair_match_batch=4)
    first = {}
    for name, pkg, mod in (("jax", JAX, jckpt), ("torch", PORT, tckpt)):
        dev = {} if name == "jax" else {"device": CPU}
        mb = (JMapBuilder if name == "jax" else MapBuilder)(
            _opts(pkg, **kw), **dev)
        for i, pts in enumerate(scans[:PREFIX]):
            mb.insert_pointcloud(i * 0.1, pts)
        if name == "jax":
            for f in mb.front_end.flush():
                mb._insert_frame(f)
        ckpt = str(tmp_path / name)
        mod.save_checkpoint(mb, ckpt)
        if name == "torch":
            mb.front_end.close()
        back = mod.load_checkpoint(ckpt, map_builder_options=_opts(pkg, **kw),
                                   **dev)
        back.insert_pointcloud(PREFIX * 0.1, scans[PREFIX])
        frame = back.trajectory[-1].frames[-1]
        first[name] = (back.front_end.base, frame.stamp, frame.global_pose)
        if name == "torch":
            back.front_end.close()
    (base_j, st_j, T_j), (base_t, st_t, T_t) = first["jax"], first["torch"]
    assert st_j == st_t == pytest.approx(PREFIX * 0.1)
    np.testing.assert_array_equal(T_j, np.eye(4))
    np.testing.assert_array_equal(T_t, np.eye(4))
    # the saved base is the last harvested pose, 8 m down the street
    np.testing.assert_allclose(base_t, base_j, atol=1e-2)
    assert np.linalg.norm(base_t[:3, 3]) > 6.0
