"""Parity of the PyTorch port's loop closing with the JAX package on the CPU:
the verifier's hash thinning, GICP (point normals and ``align_gicp``), the
batched pair registration, and a fixed stream of submaps through both
packages' ``IncrementalOptimizer``.  Then the port alone through
``MapBuilder``: tests/test_backend_e2e.py's scenario, and the batched
pair-match path handing every submap to the back end in order."""
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scripts.main_path import loop_gap
from staticmapping_tpu.backend import loop_detector as jld
from staticmapping_tpu.backend import optimizer as jopt
from staticmapping_tpu.builder import frontend as jfrontend
from staticmapping_tpu.data import cloud as jcloud
from staticmapping_tpu.io import synthetic
from staticmapping_tpu import parallel as jparallel
from staticmapping_tpu.registration import gicp as jgicp
from staticmapping_tpu.registration import icp_pm as jicp_pm
from staticmapping_torch import interop
from staticmapping_torch.backend import loop_detector as tld
from staticmapping_torch.backend import optimizer as topt
from staticmapping_torch.builder import frame as tframe
from staticmapping_torch.builder import frontend as tfrontend
from staticmapping_torch.builder import map_builder as tmb
from staticmapping_torch.common import np_se3
from staticmapping_torch.io import kitti as tkitti
from staticmapping_torch import parallel as tap
from staticmapping_torch.registration import gicp as tgicp
from staticmapping_torch.registration import icp_pm as ticp_pm

import torch_loop_stream as loop_stream

CPU = "cpu"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The loop closing is chains of small ops, which a many-thread CPU
    pool only slows down."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _yaw(a):
    return np_se3.from_rt(np_se3.euler_to_matrix(np.array([0.0, 0.0, a])),
                          np.zeros(3))


def _scan(seed, max_points=2000):
    world = synthetic.make_world(seed=3)
    pose = synthetic.square_loop_trajectory()[seed % 40]
    return synthetic.render_scan(world, pose, max_points=max_points,
                                 max_range=30.0, seed=seed)[:, :3]


def _assert_transforms_close(T_t, T_j, trans, rot):
    T_t, T_j = np.asarray(T_t, np.float64), np.asarray(T_j, np.float64)
    assert np.abs(T_t[..., :3, 3] - T_j[..., :3, 3]).max() <= trans
    rel = np.swapaxes(T_t[..., :3, :3], -1, -2) @ T_j[..., :3, :3]
    skew = rel - np.swapaxes(rel, -1, -2)
    sin = 0.5 * np.linalg.norm(skew[..., [2, 0, 1], [1, 2, 0]], axis=-1)
    cos = 0.5 * (np.trace(rel, axis1=-2, axis2=-1) - 1.0)
    assert np.arctan2(sin, cos).max() <= rot


# ---------------------------------------------------------------------------
# the verifier's pieces
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("capacity", [4096, 65536])
def test_hash_thin_matches_jax(capacity):
    """The kept mask is the JAX package's uint32 hash, bit for bit."""
    pts = np.random.default_rng(0).normal(size=(capacity - 7, 3))
    jc = jcloud.from_numpy(pts, capacity=capacity)
    keep_j = np.asarray(jicp_pm._hash_thin(jc, 0.9).mask)
    keep_t = ticp_pm._hash_thin(interop.point_cloud(jc, CPU), 0.9).mask
    assert np.array_equal(keep_t.numpy(), keep_j)
    assert 0.88 < keep_j.sum() / (capacity - 7) < 0.92


@pytest.fixture(scope="module")
def gicp_clouds():
    """One scan and its k-NN normal clouds in both packages."""
    jc = jcloud.from_numpy(_scan(1), capacity=2048)
    return jc, jgicp.compute_point_normals(jc, k=20), \
        tgicp.compute_point_normals(interop.point_cloud(jc, CPU), k=20)


def test_point_normals_match_jax(gicp_clouds):
    """Equal up to sign to 1e-3 on at least 99% of the points (k-NN ties
    may pick other neighbours for the rest), with the same mask."""
    _, gj, gt = gicp_clouds
    assert np.array_equal(gt.mask.numpy(), np.asarray(gj.mask))
    m = np.asarray(gj.mask)
    nj, nt = np.asarray(gj.normals)[m], gt.normals.numpy()[m]
    sign = np.where(np.sum(nj * nt, axis=1) < 0, -1.0, 1.0)[:, None]
    close = np.abs(nt * sign - nj).max(axis=1) <= 1e-3
    assert close.mean() >= 0.99


def test_align_gicp_matches_jax(gicp_clouds):
    """The scan against itself moved by 0.3 m and 0.05 rad, both packages
    on the JAX package's normal clouds: T within 1e-3 m and 1e-3 rad, the
    score within 1e-3 — in the gate's setting and in the matcher's."""
    _, gj, _ = gicp_clouds
    gt = tgicp.GicpCloud(*(torch.from_numpy(np.array(x)) for x in gj))
    guess = (np_se3.from_rt(np.eye(3), np.array([0.3, -0.2, 0.05]))
             @ _yaw(0.05)).astype(np.float32)
    for kw in (dict(max_correspondence_dist=2.0, max_iteration=8),
               dict()):
        T_j, s_j = jgicp.align_gicp(gj, gj, jnp.asarray(guess), **kw)
        T_t, s_t = tgicp.align_gicp(gt, gt, torch.from_numpy(guess), **kw)
        _assert_transforms_close(T_t.numpy(), T_j, 1e-3, 1e-3)
        assert abs(float(s_t) - float(s_j)) <= 1e-3


def test_align_pair_list_matches_jax():
    """Three pairs, 40 fixed trips, padded to 4: T within 1e-3 of JAX's,
    scores within 1e-3, and the padding's result is dropped."""
    rng = np.random.default_rng(2)
    srcs, tgts, guesses = [], [], []
    for k in range(3):
        jc = jcloud.from_numpy(_scan(10 + k), capacity=2048)
        srcs.append(jicp_pm._hash_thin(jc, 0.9))
        tgts.append(jfrontend._target_normals(jc, leaf_size=8))
        guesses.append(np_se3.from_rt(
            np_se3.euler_to_matrix(np.array([0.0, 0.0, rng.uniform(-0.05,
                                                                   0.05)])),
            rng.uniform(-0.3, 0.3, 3)))
    kw = dict(dist_outlier_ratio=0.7, max_iteration=150, pad_to=4,
              fixed_iterations=40, score_spacing_ref=0.35)
    Ts_j, sc_j = jparallel.align_pair_list(srcs, tgts, guesses, **kw)
    Ts_t, sc_t = tap.align_pair_list(
        [interop.point_cloud(s, CPU) for s in srcs],
        [interop.normal_cloud(t, CPU) for t in tgts], guesses, **kw)
    assert len(Ts_t) == len(sc_t) == 3
    _assert_transforms_close(np.stack(Ts_t), np.stack(Ts_j), 1e-3, 1e-3)
    np.testing.assert_allclose(sc_t, sc_j, atol=1e-3)
    assert min(sc_t) > 0.75          # the pairs did register


def test_pad_pairs_matches_jax():
    """Three stacked pairs padded to a multiple of 4 repeat the last pair,
    as the JAX package pads them."""
    jcs = [jcloud.from_numpy(_scan(20 + k, 500), capacity=512)
           for k in range(3)]
    jns = [jfrontend._target_normals(c, leaf_size=8) for c in jcs]
    gs = [np_se3.from_rt(np.eye(3), np.array([k, 0.0, 0.0]))
          for k in range(3)]
    out_j = jparallel.pad_pairs(*jparallel.stack_pairs(jcs, jns, gs), 4)
    out_t = tap.pad_pairs(*tap.stack_pairs(
        [interop.point_cloud(c, CPU) for c in jcs],
        [interop.normal_cloud(n, CPU) for n in jns], gs), 4)
    assert out_t[3] == out_j[3] == 3
    for k, fields in ((0, ("xyz", "intensity", "factor", "mask")),
                      (1, ("xyz", "normals", "mask"))):
        for f in fields:
            np.testing.assert_array_equal(getattr(out_t[k], f).numpy(),
                                          np.asarray(getattr(out_j[k], f)))
    np.testing.assert_array_equal(out_t[2].numpy(), np.asarray(out_j[2]))
    assert out_t[2].shape[0] == 4


def test_sharded_pair_registration_is_refused():
    """Without a process group there is no mesh, and a mesh that is not
    the port's is refused; tests/test_torch_multidevice.py runs the
    sharded path."""
    with pytest.raises(RuntimeError, match="process group"):
        tap.make_submap_mesh()
    with pytest.raises(TypeError, match="multihost.Mesh"):
        tap.align_pair_list([], [], [], mesh=object())


# ---------------------------------------------------------------------------
# a fixed submap stream through both IncrementalOptimizers
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def stream():
    """tests/torch_loop_stream.py's stream (a 44-pose square loop, one
    2000-point submap every second pose, matches that drift 0.003 rad a
    submap in yaw, the JAX package's target normals) through both
    packages."""
    st = loop_stream.make_stream()
    be_j = jopt.IncrementalOptimizer(
        jopt.OptimizerOptions(),
        loop_settings=jld.LoopDetectorSettings(**loop_stream.STREAM_SETTINGS))
    be_t = topt.IncrementalOptimizer(
        topt.OptimizerOptions(),
        loop_settings=tld.LoopDetectorSettings(**loop_stream.STREAM_SETTINGS),
        device=CPU)
    run_j = loop_stream.run_stream(be_j, *loop_stream.package_inputs(
        st, "jax"), st["drifted"], st["matches"])
    run_t = loop_stream.run_stream(be_t, *loop_stream.package_inputs(
        st, "torch", CPU), st["drifted"], st["matches"])
    return dict(gt=st["gt"], drifted=st["drifted"], jax=(be_j,) + run_j,
                torch=(be_t,) + run_t)


_loop_edges = loop_stream.loop_edges


def test_stream_loop_states_match_jax(stream):
    _, _, states_j = stream["jax"]
    _, _, states_t = stream["torch"]
    assert [s.name for s in states_t] == [s.name for s in states_j]
    assert states_t[-1] == tld.LoopStatus.CONTINOUS


def test_stream_accepted_edges_match_jax(stream):
    """The same (target, source) loop edges, with transforms within 2 cm
    and 2e-3 rad."""
    edges_j, edges_t = _loop_edges(stream["jax"][0]), \
        _loop_edges(stream["torch"][0])
    assert len(edges_t) >= 2
    assert [e[:2] for e in edges_t] == [e[:2] for e in edges_j]
    assert stream["torch"][0].loop_edge_count == len(edges_t)
    _assert_transforms_close(np.stack([e[2] for e in edges_t]),
                             np.stack([e[2] for e in edges_j]), 0.02, 2e-3)


def test_stream_final_poses_match_jax(stream):
    """The submap poses after the loop's solves agree within 2 cm, and
    the loop pulled them toward the ground truth."""
    pose_j = np.stack([s.global_pose for s in stream["jax"][1]])
    pose_t = np.stack([s.global_pose for s in stream["torch"][1]])
    assert np.abs(pose_t[:, :3, 3] - pose_j[:, :3, 3]).max() <= 0.02
    gt = np.stack(stream["gt"])[:, :3, 3]
    err = lambda p: np.linalg.norm(p[:, :3, 3] - gt, axis=1).max()
    assert err(pose_t) < 0.75 * err(np.stack(stream["drifted"]))


# ---------------------------------------------------------------------------
# the port alone, through MapBuilder
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def loop_run(tmp_path_factory):
    """tests/test_backend_e2e.py's scenario (the square loop, seed 11, 30 m
    range, 1 m steps, nn_tile 512, leaf-4 targets, 2-frame submaps) at a
    quarter of its widths: 2000 points in 2048-slot scans, 4096-slot
    submaps.  At the JAX test's widths one loop verification is 15 pairs ×
    16384 × 4096 points × 40 trips of the plain 1-NN, minutes on the CPU.
    The sparser scans take config/synthetic.xml's density-normalised
    scores (``score_spacing_ref`` 0.35) and 3 m z gate, and one history
    candidate a submap."""
    scans, gt = synthetic.make_sequence(
        n_scans=0, seed=11, trajectory="square", step=1.0, max_points=2000,
        max_range=30.0)
    backend = topt.IncrementalOptimizer(
        topt.OptimizerOptions(),
        loop_settings=tld.LoopDetectorSettings(
            loop_ignore_threshold=8, max_close_loop_distance=5.0,
            max_close_loop_z_distance=3.0, trying_detect_loop_count=1,
            use_descriptor=False, nn_tile=512, normal_leaf_size=4,
            accept_scan_match_score=0.45, nearest_history_pos_num=1,
            score_spacing_ref=0.35),
        device=CPU)
    opts = tmb.MapBuilderOptions(
        front_end=tfrontend.FrontEndOptions(
            scan_capacity=2048, nn_tile=512, max_iteration=40,
            motion_compensation=False, use_average=False,
            target_leaf_size=4),
        submap=tframe.SubmapOptions(frame_count=2), submap_capacity=4096,
        submap_matcher_leaf_size=4, score_spacing_ref=0.35,
        output_kitti_pose=False, output_mrvm=False,
        output_direct_combined_map=False,
        export_file_path=str(tmp_path_factory.mktemp("loop_run")))
    mb = tmb.MapBuilder(opts, backend=backend, device=CPU)
    for i, pts in enumerate(scans):
        mb.insert_pointcloud(i * 0.1, pts)
    mb.finish()
    return mb, backend, gt


def test_e2e_loop_edges_found(loop_run):
    _, backend, _ = loop_run
    assert backend.loop_edge_count > 0, "no loop closures detected"


def test_e2e_loop_gap_after_optimization(loop_run):
    """The last submap is back near the first: the optimized gap is within
    1 m of the true one.  Both ends are matched to the ground truth by
    stamp (tests/test_backend_e2e.py takes the last scan's pose, a step
    past the last submap's first frame)."""
    mb, _, gt = loop_run
    gap = loop_gap([s.global_pose for s in mb.trajectory],
                   [s.stamp for s in mb.trajectory], gt, 0.1)
    assert gap < 1.0, gap


def test_e2e_frame_ate(loop_run):
    mb, _, gt = loop_run
    frames = [f for s in mb.trajectory for f in s.frames]
    idx = [min(int(round(f.stamp / 0.1)), len(gt) - 1) for f in frames]
    ate = tkitti.ate_rmse(np.stack([f.global_pose for f in frames]),
                          np.stack([np.linalg.inv(gt[0]) @ gt[i]
                                    for i in idx]), align=True)
    assert ate < 1.0, f"ATE {ate}"


def test_e2e_submap_pair_scores(loop_run):
    mb, _, _ = loop_run
    scores = [s.match_score_to_previous for s in mb.trajectory[1:] if s.full]
    assert len(scores) > 10
    assert np.mean(np.asarray(scores) > 0.5) > 0.8


class _RecordingBackend:
    """Records the order in which ``MapBuilder`` hands it submaps."""

    options = types.SimpleNamespace(output_graph_pic=False)

    def __init__(self):
        self.added = []
        self.final = 0

    def add_submap(self, trajectory, submap):
        if submap.id > 0:     # its own pair match has been stored
            assert trajectory[submap.id - 1].match_transform_to_next \
                is not None
        self.added.append(submap.id)

    def run_final_optimization(self, trajectory):
        self.final += 1


def test_batched_pair_match_feeds_the_backend_in_order(tmp_path):
    """With ``pair_match_batch`` 3 the back end gets every full submap
    once, in submap order, each after its own pair match, and the final
    optimization runs once.  The observers fire after each submap reaches
    the back end, and once more at the end."""
    rng = np.random.default_rng(4)
    be = _RecordingBackend()
    mb = tmb.MapBuilder(tmb.MapBuilderOptions(
        submap=tframe.SubmapOptions(frame_count=1), submap_capacity=1024,
        pair_match_batch=3, pair_match_fixed_iterations=2,
        submap_matcher_leaf_size=8, export_file_path=str(tmp_path),
        output_kitti_pose=False, output_mrvm=False,
        output_direct_combined_map=False,
        front_end=tfrontend.FrontEndOptions(nn_tile=256)),
        backend=be, device=CPU)
    seen = {"submap": 0, "path": [], "map": []}
    mb.set_show_submap_function(
        lambda pts: seen.__setitem__("submap", seen["submap"] + 1))
    mb.set_show_path_function(lambda poses: seen["path"].append(len(poses)))
    mb.set_show_map_function(lambda pts: seen["map"].append(pts.shape))
    pts = rng.uniform(-5, 5, (400, 3)).astype(np.float32)
    for k in range(7):
        pose = np_se3.from_rt(np.eye(3), np.array([0.1 * k, 0.0, 0.0]))
        mb._insert_frame(tframe.Frame(
            stamp=0.1 * k, cloud=interop.point_cloud(
                jcloud.from_numpy(pts, capacity=512), CPU),
            global_pose=pose))
    assert be.added == [0, 1, 2]          # one batch read, one in flight
    mb.finish()
    assert be.added == list(range(7)) and be.final == 1
    # the first batch is read while submap 5 is the newest
    assert seen["submap"] == 7 and seen["path"] == [6] * 3 + [7] * 5
    assert len(seen["map"]) == 1 and seen["map"][0][0] > 0
