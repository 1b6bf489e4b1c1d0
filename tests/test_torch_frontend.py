"""Parity of the port's sequential front end (staticmapping_torch.builder.
frontend.FrontEnd and builder/pose_extrapolator.py) with the JAX package on
the CPU: the extrapolator and IMU tracker, one front-end step from the same
state, a 20-scan run, and the sequential ``MapBuilder``."""
import numpy as np
import pytest

from staticmapping_tpu.builder import frame as jframe
from staticmapping_tpu.builder import frontend as jfrontend
from staticmapping_tpu.builder import map_builder as jmb
from staticmapping_tpu.builder import mrvm as jmrvm
from staticmapping_tpu.builder import pose_extrapolator as jpe
from staticmapping_tpu.common import np_se3
from staticmapping_tpu.io import kitti as jkitti
from staticmapping_tpu.io import synthetic
from staticmapping_torch import interop
from staticmapping_torch.builder import frame as tframe
from staticmapping_torch.builder import frontend as tfrontend
from staticmapping_torch.builder import map_builder as tmb
from staticmapping_torch.builder import mrvm as tmrvm
from staticmapping_torch.builder import pose_extrapolator as tpe
from staticmapping_torch.io import pcd as tpcd

CPU = "cpu"
# the settings of tests/test_frontend_e2e.py::small_options
FE = dict(scan_capacity=8192, nn_tile=512, max_iteration=40)


def _pose(rng, scale=1.0):
    T = np.eye(4)
    T[:3, :3] = np_se3.euler_to_matrix(rng.normal(0, 0.2 * scale, 3))
    T[:3, 3] = rng.normal(0, 2.0 * scale, 3)
    return T


@pytest.mark.parametrize("mode", ["ctrv", "imu"])
def test_extrapolator_matches_jax(mode):
    """The same poses and IMU samples through both extrapolators (and, in
    IMU mode, their ImuTrackers): every extrapolated pose and the tracker
    state agree to 1e-12."""
    rng = np.random.default_rng(30)
    ex_j = jpe.PoseExtrapolator(mode=mode)
    ex_t = tpe.PoseExtrapolator(mode=mode)
    stamp, pose = 0.0, _pose(rng)
    for k in range(12):
        for j in range(5):                       # 50 Hz IMU between scans
            st = stamp + 0.02 * (j + 1)
            w, a = rng.normal(0, 0.1, 3), rng.normal([0, 0, 9.8], 0.3)
            ex_j.add_imu_data(jpe.ImuData(st, w, a))
            ex_t.add_imu_data(tpe.ImuData(st, w, a))
        stamp += 0.1
        if k:
            want = ex_j.extrapolate_pose(stamp + 0.05)
            np.testing.assert_allclose(ex_t.extrapolate_pose(stamp + 0.05),
                                       want, atol=1e-12)
        pose = pose @ _pose(rng, 0.1)
        ex_j.add_pose(stamp, pose)
        ex_t.add_pose(stamp, pose)
        np.testing.assert_allclose(ex_t.linear_velocity_from_poses,
                                   ex_j.linear_velocity_from_poses,
                                   atol=1e-12)
        if mode == "imu":
            for name in ("orientation", "gravity_vector",
                         "imu_angular_velocity"):
                np.testing.assert_allclose(
                    getattr(ex_t.imu_tracker, name),
                    getattr(ex_j.imu_tracker, name), atol=1e-12)


def test_imu_tracker_matches_jax():
    rng = np.random.default_rng(31)
    tr_j, tr_t = jpe.ImuTracker(10.0, 0.0), tpe.ImuTracker(10.0, 0.0)
    for k in range(40):
        w, a = rng.normal(0, 0.3, 3), rng.normal([0, 0, 9.8], 0.5)
        for tr in (tr_j, tr_t):
            tr.advance(0.01 * (k + 1))
            tr.add_imu_linear_acceleration_observation(a)
            tr.add_imu_angular_velocity_observation(w)
        np.testing.assert_allclose(tr_t.orientation, tr_j.orientation,
                                   atol=1e-12)
        np.testing.assert_allclose(tr_t.gravity_vector, tr_j.gravity_vector,
                                   atol=1e-12)


@pytest.fixture(scope="module")
def straight():
    """tests/test_frontend_e2e.py's sequence: 20 scans, 0.5 m apart."""
    return synthetic.make_sequence(n_scans=20, seed=6, trajectory="straight",
                                   step=0.5, max_points=6000)


@pytest.mark.parametrize("compensation", [False, True])
def test_one_step_matches_jax(straight, compensation):
    """The JAX front end after four scans, carried across by ``interop``
    (poses, target normals, the extrapolator's queue), then the same fifth
    scan through both: the matched transform agrees to 1e-3 m / 1e-3 rad,
    and so does the keyframe decision.  With compensation on, the step
    compensates, aligns, averages with the guess and compensates again
    (``_frontend_align``)."""
    scans, _ = straight
    opts = dict(FE, motion_compensation=compensation,
                use_average=compensation)
    fe_j = jfrontend.FrontEnd(jfrontend.FrontEndOptions(**opts))
    for i in range(4):
        fe_j.process(0.1 * i, scans[i])
    fe_t = tfrontend.FrontEnd(tfrontend.FrontEndOptions(**opts), device=CPU)
    interop.load_frontend(fe_t, fe_j)
    np.testing.assert_array_equal(fe_t.pose_target, fe_j.pose_target)
    kf_j = fe_j.process(0.4, scans[4])
    kf_t = fe_t.process(0.4, scans[4])
    assert (kf_t is None) == (kf_j is None)
    T_j = (np.linalg.inv(fe_j.pose_target) @ kf_j.global_pose
           if kf_j is not None else fe_j.accumulative)
    T_t = (np.linalg.inv(fe_t.pose_target) @ kf_t.global_pose
           if kf_t is not None else fe_t.accumulative)
    if kf_j is not None:
        np.testing.assert_allclose(kf_t.global_pose[:3, 3],
                                   kf_j.global_pose[:3, 3], atol=1e-3)
        T_j, T_t = kf_j.global_pose, kf_t.global_pose
    np.testing.assert_allclose(T_t[:3, 3], T_j[:3, 3], atol=1e-3)
    dR = T_t[:3, :3].T @ T_j[:3, :3]
    assert np.arccos(np.clip((np.trace(dR) - 1) / 2, -1, 1)) < 1e-3
    np.testing.assert_allclose(fe_t.last_score, fe_j.last_score, atol=1e-3)


def _run(mb, scans):
    for i, pts in enumerate(scans):
        mb.insert_pointcloud(0.1 * i, pts)
    return mb


def _ate(mb, gt):
    frames = [f for s in mb.trajectory for f in s.frames]
    est = np.stack([f.global_pose for f in frames])
    gt_sel = np.stack([np.linalg.inv(gt[0]) @ gt[int(round(f.stamp / 0.1))]
                       for f in frames])
    return jkitti.ate_rmse(est, gt_sel, align=True)


def test_straight_run_matches_jax(straight, tmp_path):
    """The sequential MapBuilder of both packages on the same 20 scans
    (tests/test_frontend_e2e.py's settings), MRVM export included: equal
    keyframe and submap counts, the port's ATE under that test's 0.3 m
    bound, and static maps of the same size within 1%.  The MRVM keeps
    every voxel hit more often than missed (threshold 0.5), so the maps are
    large enough to compare, and samples 32 steps a ray to keep the test
    short."""
    scans, gt = straight
    out = {}
    for name, fe, fr, mb, mrvm, kw in (
            ("jax", jfrontend, jframe, jmb, jmrvm, {}),
            ("torch", tfrontend, tframe, tmb, tmrvm, {"device": CPU})):
        out[name] = _run(mb.MapBuilder(mb.MapBuilderOptions(
            front_end=fe.FrontEndOptions(**FE),
            submap=fr.SubmapOptions(frame_count=2), submap_capacity=16384,
            mrvm_settings=mrvm.MrvmSettings(prob_threshold=0.5,
                                            max_ray_steps=32),
            export_file_path=str(tmp_path / name)), **kw), scans)
        out[name].finish()
    mb_j, mb_t = out["jax"], out["torch"]
    assert len(mb_t.frame_poses()) == len(mb_j.frame_poses())
    assert len(mb_t.trajectory) == len(mb_j.trajectory)
    assert _ate(mb_t, gt) < 0.3
    pts_t, pts_j = (tpcd.read_pcd(str(tmp_path / name / "static_map.pcd"))
                    for name in ("torch", "jax"))
    assert len(pts_t) > 1000
    assert abs(len(pts_t) - len(pts_j)) <= 0.01 * len(pts_j)


def test_submap_grouping():
    """tests/test_frontend_e2e.py::test_submap_grouping through the port,
    on 12 of its 20 scans: every submap but the last is full and holds a
    merged cloud."""
    scans, _ = synthetic.make_sequence(n_scans=12, seed=6, step=0.5,
                                       max_points=6000)
    mb = _run(tmb.MapBuilder(tmb.MapBuilderOptions(
        front_end=tfrontend.FrontEndOptions(**FE),
        submap=tframe.SubmapOptions(frame_count=2), submap_capacity=16384),
        device=CPU), scans)
    assert len(mb.trajectory) > 1
    for s in mb.trajectory.submaps[:-1]:
        assert s.full
        assert s.cloud is not None
        assert int(s.cloud.num_valid()) > 0
