"""The GPS- and odometry-aided mapping path of the port against the JAX
package, on the CPU:

- the thirteen cases of tests/test_sensors.py (geodesy, the DataCollector,
  the GPS and odometry factors, the optimizer's two-stage GPS init, the
  odometry extrinsic calibration in its (a) and (b) forms, the ImuTracker,
  IMU mode through MapBuilder), each one test parametrised over the two
  packages, with that file's inputs and bounds;
- a fake-submap stream through both packages' ``IncrementalOptimizer``
  with GPS, odometry and the extrinsic calibration on;
- one small GPS- and odometry-aided run through each package's config
  loader, ``build_map_builder``, ``insert_odom`` / ``insert_pointcloud`` /
  ``insert_gps`` and ``finish`` (``scripts/main_path.py``'s sensor-path
  helpers, at small widths);
- that run checkpointed after its GPS init and resumed, in both packages:
  neither checkpoint keeps the DataCollector's ENU anchor or odometry
  base (ROADMAP.md queue C).
"""
import copy
import dataclasses
import os
import types

import numpy as np
import pytest
import torch

from scripts.main_path import (SENSOR_PATH, drive_sensor_path, enu_error,
                               sensor_config, sensor_feed, sensor_results,
                               transform_gap)
from staticmapping_tpu import config as jconfig
from staticmapping_tpu.backend import loop_detector as jld
from staticmapping_tpu.backend import optimizer as jopt
from staticmapping_tpu.backend import pose_graph as jpg
from staticmapping_tpu.builder import checkpoint as jckpt
from staticmapping_tpu.builder import map_builder as jmb
from staticmapping_tpu.builder import pose_extrapolator as jpe
from staticmapping_tpu.common import geo as jgeo
from staticmapping_tpu.common import np_se3 as jnp_se3
from staticmapping_tpu.data import data_collector as jdc
from staticmapping_tpu.io import kitti, synthetic
from staticmapping_torch import config as tconfig
from staticmapping_torch.backend import loop_detector as tld
from staticmapping_torch.backend import optimizer as topt
from staticmapping_torch.backend import pose_graph as tpg
from staticmapping_torch.builder import checkpoint as tckpt
from staticmapping_torch.builder import map_builder as tmb
from staticmapping_torch.builder import pose_extrapolator as tpe
from staticmapping_torch.common import geo as tgeo
from staticmapping_torch.common import np_se3
from staticmapping_torch.data import data_collector as tdc

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = "cpu"
PKGS = {
    "jax": types.SimpleNamespace(
        geo=jgeo, dc=jdc, pg=jpg, opt=jopt, ld=jld, pe=jpe, mb=jmb,
        ckpt=jckpt, config=jconfig, np_se3=jnp_se3, dev={}),
    "torch": types.SimpleNamespace(
        geo=tgeo, dc=tdc, pg=tpg, opt=topt, ld=tld, pe=tpe, mb=tmb,
        ckpt=tckpt, config=tconfig, np_se3=np_se3, dev={"device": CPU}),
}
pkg_names = pytest.mark.parametrize("name", sorted(PKGS))


@pytest.fixture(autouse=True)
def _two_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


# ---------------------------------------------------------------------------
# the cases of tests/test_sensors.py, each through both packages
# ---------------------------------------------------------------------------

@pkg_names
def test_enu_round_trip(name):
    lc = PKGS[name].geo.LocalCartesian(48.8566, 2.3522, 35.0)
    for enu in ([0, 0, 0], [100.0, -250.0, 12.0], [-5000.0, 3000.0, -40.0]):
        lat, lon, alt = lc.reverse(np.asarray(enu, dtype=float))
        np.testing.assert_allclose(lc.forward(lat, lon, alt), enu,
                                   atol=1e-6)


@pkg_names
def test_enu_scale_sanity(name):
    lc = PKGS[name].geo.LocalCartesian(0.0, 0.0, 0.0)
    enu = lc.forward(0.001, 0.0, 0.0)
    assert abs(enu[1] - 110.57) < 0.1
    assert abs(enu[0]) < 1e-6
    np.testing.assert_allclose(lc.forward(0.0, 0.0, 123.0), [0, 0, 123.0],
                               atol=1e-6)


@pkg_names
def test_cloud_accumulation(name):
    dc = PKGS[name].dc
    c = dc.DataCollector(dc.DataCollectorOptions(accumulate_cloud_num=3))
    rng = np.random.default_rng(0)
    a, b, d = (rng.random((k, 4)).astype(np.float32) for k in (10, 20, 5))
    assert c.add_cloud(1.0, a) is None
    assert c.add_cloud(1.1, b) is None
    stamp, merged = c.add_cloud(1.2, d)
    assert stamp == 1.0
    assert merged.shape == (35, 4)
    assert c.add_cloud(1.3, a) is None


@pkg_names
def test_gps_enu_anchoring_and_interpolation(name):
    dc = PKGS[name].dc
    c = dc.DataCollector()
    c.add_gps(dc.NavSatFixMsg(0.5, 48.8566, 2.3522, 35.0, status=-1))
    assert c.reference_gps is None
    c.add_gps(dc.NavSatFixMsg(1.0, 48.8566, 2.3522, 35.0))
    c.add_gps(dc.NavSatFixMsg(1.1, 48.85661, 2.3522, 35.0))
    assert len(c.gps_data) == 2
    np.testing.assert_allclose(c.gps_data[0].enu, [0, 0, 0], atol=1e-9)
    np.testing.assert_allclose(c.interpolate_gps(1.05),
                               c.gps_data[1].enu * 0.5, atol=1e-9)
    assert c.interpolate_gps(0.9) is None
    assert c.interpolate_gps(1.2) is None


@pkg_names
def test_gps_interpolation_gap_gate(name):
    dc = PKGS[name].dc
    c = dc.DataCollector()
    c.add_gps(dc.NavSatFixMsg(1.0, 10.0, 10.0, 0.0))
    c.add_gps(dc.NavSatFixMsg(1.5, 10.0001, 10.0, 0.0))
    assert c.interpolate_gps(1.25) is None


@pkg_names
def test_odom_rebase_and_interpolation(name):
    dc = PKGS[name].dc
    c = dc.DataCollector()
    T0 = np_se3.from_rt(np_se3.euler_to_matrix([0, 0, 0.3]), [5.0, 2.0, 0.0])
    T1 = T0 @ np_se3.from_rt(np.eye(3), [1.0, 0.0, 0.0])
    c.add_odom(dc.OdomMsg(1.0, T0))
    c.add_odom(dc.OdomMsg(2.0, T1))
    np.testing.assert_allclose(c.odom_data[0][1], np.eye(4), atol=1e-12)
    np.testing.assert_allclose(c.interpolate_odom(1.5)[:3, 3], [0.5, 0, 0],
                               atol=1e-9)
    c2 = dc.DataCollector()
    c2.add_odom(dc.OdomMsg(1.0, T0))
    c2.add_odom(dc.OdomMsg(3.0, T1))
    assert c2.interpolate_odom(2.0) is None


@pkg_names
def test_odom_trim(name):
    dc = PKGS[name].dc
    c = dc.DataCollector()
    for k in range(5):
        c.add_odom(dc.OdomMsg(float(k),
                              np_se3.from_rt(np.eye(3), [float(k), 0, 0])))
    assert c.interpolate_odom(3.5, trim_data=True) is not None
    assert c.odom_data[0][0] == 3.0


def _circle_poses(n, radius=30.0):
    """tests/test_sensors.py::_circle_poses."""
    poses = []
    for k in range(n):
        th = 2 * np.pi * k / n * 0.6
        R = np_se3.euler_to_matrix([0, 0, th + np.pi / 2])
        poses.append(np_se3.from_rt(
            R, np.array([radius * np.cos(th), radius * np.sin(th), 0.0])))
    return poses


def _graph(name):
    p = PKGS[name]
    return p.pg.PoseGraph(**p.dev)


@pkg_names
def test_gps_factors_pull_map_into_enu_shape(name):
    """The mean antenna error through the estimated coord transform stays
    under tests/test_sensors.py's 0.3 m."""
    pg = PKGS[name].pg
    rng = np.random.default_rng(0)
    n = 24
    poses_true = _circle_poses(n)
    T_enu = np_se3.from_rt(np_se3.euler_to_matrix([0, 0, 0.8]),
                           [100.0, -50.0, 2.0])
    g = _graph(name)
    for _ in range(n):
        g.add_node()
    for k in range(1, n):
        noise = np_se3.from_rt(
            np_se3.euler_to_matrix(rng.normal(0, 0.002, 3)),
            rng.normal(0, 0.02, 3))
        g.add_between(k - 1, k, np_se3.inverse(poses_true[k - 1])
                      @ poses_true[k] @ noise)
    for k in range(n):
        g.add_gps(k, (T_enu @ poses_true[k])[:3, 3]
                  + rng.normal(0, 0.05, 3))
    X = np.stack([p[:3, 3] for p in poses_true])
    Y = np.stack([(T_enu @ p)[:3, 3] for p in poses_true])
    xc, yc = X.mean(0), Y.mean(0)
    U, _, Vt = np.linalg.svd((X - xc).T @ (Y - yc))
    d = np.sign(np.linalg.det(Vt.T @ U.T))
    R0 = Vt.T @ np.diag([1.0, 1.0, d]) @ U.T
    g.set_special_value(pg.SPECIAL_GPS_COORD, np_se3.from_rt(R0, yc - R0 @ xc))
    out = g.optimize(np.stack(poses_true), num_iters=10)
    T_coord = g.get_special_value(pg.SPECIAL_GPS_COORD)
    errs = [np.linalg.norm((T_coord @ out[k])[:3, 3]
                           - (T_enu @ poses_true[k])[:3, 3])
            for k in range(n)]
    assert np.mean(errs) < 0.3, np.mean(errs)


class FakeSubmap:
    """What ``IncrementalOptimizer.add_submap`` reads of a submap."""

    def __init__(self, i, pose, enu, odom=None):
        self.id = i
        self.global_pose = pose
        self.descriptor = np.zeros(192)
        self.match_transform_to_next = None
        self.related_gps_enu = enu
        self.related_odom = odom
        self.cloud = None
        self.stamp = float(i)


def _optimizer(name, options, **settings):
    p = PKGS[name]
    return p.opt.IncrementalOptimizer(
        p.opt.OptimizerOptions(**options),
        loop_settings=p.ld.LoopDetectorSettings(**settings), **p.dev)


@pkg_names
def test_incremental_optimizer_gps_two_stage_init(name):
    """The two-stage init fires and the antenna path through the coord
    transform lies within tests/test_sensors.py's 0.2 m of ENU."""
    n = 24
    poses = _circle_poses(n)
    T_enu = np_se3.from_rt(np_se3.euler_to_matrix([0, 0, -0.5]),
                           [40.0, 10.0, 0.0])
    opt = _optimizer(name, dict(use_gps=True, gps_factor_init_num=6),
                     use_descriptor=False, use_gps=False)
    traj = []
    for k in range(n):
        sm = FakeSubmap(k, poses[k].copy(), (T_enu @ poses[k])[:3, 3])
        if k > 0:
            traj[k - 1].match_transform_to_next = \
                np_se3.inverse(poses[k - 1]) @ poses[k]
        traj.append(sm)
        opt.add_submap(traj, sm)
    assert opt._calculated_first_gps_coord
    T_coord = opt.get_gps_coord_transform()
    errs = [np.linalg.norm((T_coord @ traj[k].global_pose)[:3, 3]
                           - (T_enu @ poses[k])[:3, 3]) for k in range(n)]
    assert np.mean(errs) < 0.2, np.mean(errs)


@pkg_names
@pytest.mark.parametrize("form", ["a", "b"])
def test_odom_extrinsic_calibration(name, form):
    """tests/test_sensors.py::test_odom_extrinsic_calibration: (a) precise
    odometry and a loose prior recover the full extrinsic (2 cm, 0.5°);
    (b) the reference's noise models calibrate the rotation (under 3°)
    and keep the translation near the prior (under 0.15 m)."""
    pg = PKGS[name].pg
    n = 20
    poses = []
    for k, T in enumerate(_circle_poses(n)):
        wobble = np_se3.from_rt(
            np_se3.euler_to_matrix([0.3 * np.sin(1.7 * k),
                                    0.3 * np.cos(2.3 * k), 0.0]),
            [0.0, 0.0, 0.5 * np.sin(0.9 * k)])
        poses.append(np_se3.normalize_rotation(T @ wobble))
    calib_true = np_se3.from_rt(np_se3.euler_to_matrix([0.05, 0.03, 0.15]),
                                [0.5, 0.2, 0.0])
    odom_sigmas, prior_sigmas, iters = {
        "a": ((0.1, 0.1, 0.1, 0.05, 0.05, 0.05),
              (2.0, 2.0, 2.0, 0.5, 0.5, 1.5), 20),
        "b": ((1.5, 1.5, 2.0, 0.2, 0.2, 0.2),
              (0.1, 0.1, 0.1, 0.5, 0.5, 1.5), 12)}[form]
    g = _graph(name)
    for _ in range(n):
        g.add_node()
    for k in range(1, n):
        g.add_between(k - 1, k, np_se3.inverse(poses[k - 1]) @ poses[k],
                      (0.01,) * 3 + (0.005,) * 3)
    inv_c = np_se3.inverse(calib_true)
    for k in range(n):
        g.add_odom(k, inv_c @ poses[k] @ calib_true, odom_sigmas)
    g.add_special_prior(pg.SPECIAL_ODOM_CALIB, np.eye(4), prior_sigmas)
    g.optimize(np.stack(poses), num_iters=iters)
    est = g.get_special_value(pg.SPECIAL_ODOM_CALIB)
    err = np_se3.inverse(est) @ calib_true
    if form == "a":
        assert np.linalg.norm(err[:3, 3]) < 0.02, err[:3, 3]
        assert np_se3.rotation_angles_abs_sum_deg(err) < 0.5
    else:
        assert np_se3.rotation_angles_abs_sum_deg(err) < 3.0
        assert np.linalg.norm(est[:3, 3]) < 0.15


@pkg_names
def test_imu_tracker_gravity_alignment(name):
    """A still IMU with gravity along a tilted axis converges to the true
    roll within 1e-3 of the up axis."""
    R = np_se3.euler_to_matrix(np.array([0.2, 0.0, 0.0]))
    acc_body = R.T @ np.array([0.0, 0.0, 9.8])
    tr = PKGS[name].pe.ImuTracker(imu_gravity_time_constant=1.0, time=0.0)
    for k in range(1, 400):
        tr.advance(k * 0.01)
        tr.add_imu_linear_acceleration_observation(acc_body)
        tr.add_imu_angular_velocity_observation(np.zeros(3))
    up = np_se3.quat_to_matrix(tr.orientation) @ acc_body
    assert abs(up[2] / np.linalg.norm(up) - 1.0) < 1e-3, up


@pkg_names
def test_imu_tracker_yaw_integration(name):
    tr = PKGS[name].pe.ImuTracker(imu_gravity_time_constant=10.0, time=0.0)
    for k in range(1, 101):
        tr.advance(k * 0.01)
        tr.add_imu_angular_velocity_observation(np.array([0.0, 0.0, 0.5]))
    R = np_se3.quat_to_matrix(tr.orientation)
    assert abs(np.arctan2(R[1, 0], R[0, 0]) - 0.5) < 0.02


@pkg_names
def test_imu_mode_reachable_through_map_builder(name):
    p = PKGS[name]
    pe = p.pe.PoseExtrapolator
    mb = p.mb.MapBuilder(p.mb.MapBuilderOptions(use_imu=True), **p.dev)
    assert mb.front_end.extrapolator.mode == pe.MODE_IMU
    mb2 = p.mb.MapBuilder(p.mb.MapBuilderOptions(use_imu=False), **p.dev)
    assert mb2.front_end.extrapolator.mode == pe.MODE_CTRV


# ---------------------------------------------------------------------------
# the small sensor-aided scenario
# ---------------------------------------------------------------------------

# 20 scans of 6000 points along a curve (2 m steps, 0.08 rad a step) in
# the seed-7 world: every scan a keyframe, 10 two-frame submaps.  The GPS
# init waits for 5 cached fixes (submaps 1-5, spread over 16 m of curve so
# the Kabsch fit is not degenerate) and fires at submap 6.
SMALL = dict(n_scans=20, step=2.0, yaw_rate=0.08, max_points=6000,
             max_range=70.0)
INIT_NUM = 5
INIT_SUBMAP = 6
# scans fed before the checkpoint: seven full submaps, the init fired
CUT = 14
# Gauss-Newton trips of every solve in the stream and the small run: the
# trips above the f32 noise floor (tests/test_torch_backend.py's
# PARITY_TRIPS).  The stream, the run and the resumed runs then share the
# JAX package's compiled solvers.
PARITY_TRIPS = 3
PERIOD = 1.0 / SENSOR_PATH["rate"]


@pytest.fixture(scope="module")
def small():
    scans, gt = synthetic.make_sequence(seed=SENSOR_PATH["seed"],
                                        trajectory="straight", **SMALL)
    feeds = {name: sensor_feed(gt, PKGS[name].geo.LocalCartesian,
                               PKGS[name].np_se3) for name in PKGS}
    return scans, gt, feeds


def test_sensor_feed_is_the_same_in_both_packages(small):
    """Each package's own LocalCartesian turns the same ENU into the same
    latitude, longitude and altitude, bit for bit."""
    _, _, feeds = small
    (fj, tj), (ft, tt) = feeds["jax"], feeds["torch"]
    assert tj == tt
    assert [(k, s) for k, s, _ in fj] == [(k, s) for k, s, _ in ft]
    for (kind, _, a), (_, _, b) in zip(fj, ft):
        if kind == "scan":
            assert a == b
        else:
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _small_config(name, work):
    """The sensor path's config copy through the package's own loader, at
    tests/test_checkpoint.py's widths, sequential, no MRVM export."""
    cfg = sensor_config(PKGS[name].config,
                        os.path.join(ROOT, SENSOR_PATH["cfg"]), str(work),
                        gps_factor_init_num=INIT_NUM)
    m = cfg.map_builder
    m.pipelined, m.pair_match_batch = False, 1
    m.front_end.scan_capacity, m.front_end.nn_tile = 8192, 512
    m.front_end.target_leaf_size = 4
    m.submap_capacity, m.submap_matcher_leaf_size = 16384, 4
    m.output_mrvm = False
    cfg.optimizer.gn_iterations = PARITY_TRIPS
    return cfg


def _resume(name, cfg, ckpt, out):
    p = PKGS[name]
    options = dataclasses.replace(cfg.map_builder, export_file_path=out)
    return p.ckpt.load_checkpoint(
        ckpt, map_builder_options=options,
        backend=p.opt.IncrementalOptimizer(
            cfg.optimizer, loop_settings=cfg.loop_detector, **p.dev),
        filter_chain=p.config.build_filter_chain(cfg), **p.dev)


def _tags(mb):
    return [(s.related_gps_enu, s.related_odom) for s in mb.trajectory]


@pytest.fixture(scope="module")
def runs(small, tmp_path_factory):
    """The small run in each package, checkpointed after CUT scans and
    finished, then resumed from the checkpoint and finished."""
    scans, gt, feeds = small
    out = {}
    for name in sorted(PKGS):
        p = PKGS[name]
        feed, truth = feeds[name]
        work = tmp_path_factory.mktemp(name)
        cfg = _small_config(name, work)
        mb = p.config.build_map_builder(cfg, with_backend=True, **p.dev)
        first = drive_sensor_path(mb, scans, feed[:3 * CUT], p.np_se3,
                                  finish=False)
        ckpt = str(work / "ckpt")
        p.ckpt.save_checkpoint(mb, ckpt)
        saved = {"collector": copy.deepcopy(mb.data_collector),
                 "tags": copy.deepcopy(_tags(mb)),
                 "gps_factors": len(mb.backend.graph.gps_factors)}
        drive_sensor_path(mb, scans, feed[3 * CUT:], p.np_se3)
        back = _resume(name, cfg, ckpt, str(work / "resumed"))
        drive_sensor_path(back, scans, feed[3 * CUT:], p.np_se3)
        out[name] = {
            "mb": mb, "resumed": back, "saved": saved, "first": first,
            "res": sensor_results(mb, gt, truth, kitti.ate_rmse,
                                  cfg.map_builder.export_file_path),
            "resumed_res": sensor_results(back, gt, truth, kitti.ate_rmse,
                                          str(work / "resumed"))}
    return out


def test_small_run_inits_gps_where_jax_does(runs):
    """Both packages make every scan a keyframe and fire the GPS init at
    the same submap, before the checkpoint."""
    for name in PKGS:
        assert runs[name]["first"]["gps_init_submap"] == INIT_SUBMAP
        assert runs[name]["res"]["keyframes"] == SMALL["n_scans"]
        assert runs[name]["saved"]["gps_factors"] > 0


def test_small_run_tags_equal_jax(runs):
    """The submaps' GPS and odometry tags: host float64 from the same
    messages at the same stamps, so equal bit for bit."""
    tj, tt = _tags(runs["jax"]["mb"]), _tags(runs["torch"]["mb"])
    assert len(tj) == len(tt)
    assert sum(g is not None for g, _ in tt) == len(tt) - 1
    _assert_same_tags(tt, tj)


def _assert_same_tags(got, want):
    for (g, o), (gw, ow) in zip(got, want):
        assert (g is None) == (gw is None)
        if gw is not None:
            np.testing.assert_array_equal(g, gw)
        np.testing.assert_array_equal(o, ow)


def test_small_run_enu_error_and_ate_within_jax_bounds(runs):
    """The ENU error and the aligned ATE held as on the card:
    max(2 × the JAX run's, 0.35 m)."""
    rj, rt = runs["jax"]["res"], runs["torch"]["res"]
    for key in ("enu_error_m", "ate_m"):
        assert rt[key] <= max(2.0 * rj[key], 0.35), (key, rt[key], rj[key])


def test_small_run_transforms_match_jax(runs):
    """The GPS coordinate transform within 0.1 m and 0.01 rad of the JAX
    run's, the calibrated tf_odom_lidar within 0.05 m and 0.5°, as on the
    card."""
    rj, rt = runs["jax"]["res"], runs["torch"]["res"]
    dt, dr = transform_gap(rt["gps_coord_transform"],
                           rj["gps_coord_transform"])
    assert dt <= 0.1 and dr <= 0.01, (dt, dr)
    dt, dr = transform_gap(rt["tf_odom_lidar"], rj["tf_odom_lidar"])
    assert dt <= 0.05 and np.degrees(dr) <= 0.5, (dt, dr)
    assert (rt["gps_factors"], rt["odom_factors"]) == \
        (rj["gps_factors"], rj["odom_factors"])


def test_small_run_raw_sensor_pcds_equal_jax(runs):
    """original_gps.pcd and original_odom.pcd byte for byte."""
    assert runs["torch"]["res"]["pcds"] == runs["jax"]["res"]["pcds"]
    for name in PKGS:
        assert all(v["bytes"] > 0 for v in runs[name]["res"]["pcds"].values())


@pkg_names
def test_resume_anchors_enu_and_odometry_again(runs, small, name):
    """The reference defect of both packages' checkpoints (ROADMAP.md
    queue C): the DataCollector is not saved, so the resumed run anchors
    ENU at the first fix after the resume and rebases the odometry on the
    first pose after it.  Its later GPS tags are the uninterrupted run's
    shifted by the old-frame ENU of the new anchor (within 1e-3 m: the two
    tangent planes part by ~1e-5 rad over this run), and the graph keeps
    its GPS factors in the old frame."""
    _, _, feeds = small
    feed, _ = feeds[name]
    rest = feed[3 * CUT:]
    first_fix = next(m for kind, _, m in rest if kind == "gps")
    first_odom = next(m for kind, _, m in rest if kind == "odom")
    run = runs[name]
    whole, back = run["mb"].data_collector, run["resumed"].data_collector
    assert whole.reference_gps.origin == feed[2][2]
    assert back.reference_gps.origin == first_fix
    np.testing.assert_array_equal(back.odom_init_offset, first_odom)
    np.testing.assert_array_equal(whole.odom_init_offset, feed[0][2])
    shift = whole.reference_gps.forward(*first_fix)
    assert np.linalg.norm(shift) > 10.0
    moved = 0
    for s, r in zip(run["mb"].trajectory, run["resumed"].trajectory):
        if s.id < CUT // 2 or r.related_gps_enu is None:
            continue
        np.testing.assert_allclose(r.related_gps_enu,
                                   s.related_gps_enu - shift, atol=1e-3)
        moved += 1
    assert moved > 0
    # the old-frame factors came back with the graph
    graph = run["resumed"].backend.graph
    assert len(graph.gps_factors) > run["saved"]["gps_factors"]


def test_resumed_runs_match_jax(runs, small):
    """Both packages resume the same way: the same anchor and odometry
    base, the same tags bit for bit, and final maps whose antennas lie as
    far from the uninterrupted run's ENU frame (within 0.1 m, or 10% of
    the JAX run's error)."""
    _, _, feeds = small
    _, truth = feeds["jax"]
    rj, rt = runs["jax"]["resumed"], runs["torch"]["resumed"]
    assert (rt.data_collector.reference_gps.origin
            == rj.data_collector.reference_gps.origin)
    np.testing.assert_array_equal(rt.data_collector.odom_init_offset,
                                  rj.data_collector.odom_init_offset)
    _assert_same_tags(_tags(rt), _tags(rj))
    errs = {}
    for name, mb in (("jax", rj), ("torch", rt)):
        frames = [(f.stamp, f.global_pose) for s in mb.trajectory
                  for f in s.frames]
        errs[name] = enu_error(frames, truth,
                               runs[name]["mb"].data_collector, PERIOD)
    assert abs(errs["torch"] - errs["jax"]) <= max(0.1, 0.1 * errs["jax"])


# ---------------------------------------------------------------------------
# a fake-submap stream through both IncrementalOptimizers
# ---------------------------------------------------------------------------

YAW_DRIFT = 0.003    # rad the fake front end adds to each submap match


def _yaw(a):
    return np_se3.from_rt(np_se3.euler_to_matrix([0.0, 0.0, a]), np.zeros(3))


def _record_kabsch(be, pg):
    """Wrap ``be._solve_gps_coord_alone`` to keep its inputs and result."""
    solve, rec = be._solve_gps_coord_alone, {}

    def recorded(trajectory):
        rec["enu"] = copy.deepcopy(be._cached_enu)
        rec["poses"] = {i: trajectory[i].global_pose.copy()
                        for i in be._cached_enu}
        rec["submap"] = len(be.loop_detector.frames) - 1
        solve(trajectory)
        rec["T"] = np.array(be.graph.get_special_value(pg.SPECIAL_GPS_COORD))
    be._solve_gps_coord_alone = recorded
    return rec


@pytest.fixture(scope="module")
def stream(small):
    """The small scenario's submaps as fake submaps: their first scans'
    ground truth chained by matches that drift YAW_DRIFT a submap, tagged
    with the GPS and odometry the DataCollector interpolates at their
    stamps; through both packages' optimizers with GPS, odometry and the
    extrinsic calibration on, every solve PARITY_TRIPS trips."""
    _, gt, feeds = small
    feed, _ = feeds["jax"]
    rel = [np.linalg.solve(gt[0], g) for g in gt]
    collector = jdc.DataCollector()
    for kind, stamp, m in feed:
        if kind == "gps":
            collector.add_gps(jdc.NavSatFixMsg(stamp, *m))
        elif kind == "odom":
            collector.add_odom(jdc.OdomMsg(stamp, m))
    starts = list(range(0, SMALL["n_scans"], 2))
    matches = [np_se3.inverse(rel[a]) @ rel[b] @ _yaw(YAW_DRIFT)
               for a, b in zip(starts[:-1], starts[1:])]
    poses = [rel[0]]
    for m in matches:
        poses.append(poses[-1] @ m)
    tags = [(collector.interpolate_gps(k * PERIOD, 0.001),
             collector.interpolate_odom(k * PERIOD, 0.001)) for k in starts]
    T_gps = np_se3.from_rt(np.eye(3), SENSOR_PATH["tracking_to_gps"])
    out = {}
    for name in sorted(PKGS):
        be = _optimizer(name, dict(use_gps=True, use_odom=True,
                                   enable_extrinsic_calib=True,
                                   gps_factor_init_num=INIT_NUM,
                                   gn_iterations=PARITY_TRIPS),
                        use_descriptor=False, use_gps=False)
        be.set_transform_tracking_to_gps(T_gps)
        rec = _record_kabsch(be, PKGS[name].pg)
        traj = []
        for k, (enu, odom) in enumerate(tags):
            sm = FakeSubmap(k, poses[k].copy(), enu, odom)
            sm.stamp = starts[k] * PERIOD
            if k > 0:
                traj[k - 1].match_transform_to_next = matches[k - 1]
            traj.append(sm)
            be.add_submap(traj, sm)
        be.run_final_optimization(traj)
        out[name] = {"be": be, "traj": traj, "kabsch": rec}
    return out


def test_stream_inits_gps_at_the_same_submap(stream):
    assert (stream["torch"]["kabsch"]["submap"]
            == stream["jax"]["kabsch"]["submap"] == INIT_SUBMAP)
    for name in PKGS:
        assert stream[name]["be"]._calculated_first_gps_coord
        assert sorted(stream[name]["kabsch"]["enu"]) == \
            list(range(1, INIT_NUM + 1))


def test_stream_kabsch_matches_jax(stream):
    """The init's Kabsch fit is host float64: on the JAX run's cached
    poses and fixes the port's gives the JAX package's transform to 1e-9;
    on its own poses (f32 solves before the init) to 1e-4."""
    rec_j, rec_t = stream["jax"]["kabsch"], stream["torch"]["kabsch"]
    be = _optimizer("torch", dict(use_gps=True,
                                  enable_extrinsic_calib=True),
                    use_descriptor=False, use_gps=False)
    be.set_transform_tracking_to_gps(stream["jax"]["be"].tf_tracking_gps)
    be._cached_enu = copy.deepcopy(rec_j["enu"])
    traj = {i: types.SimpleNamespace(global_pose=T.copy())
            for i, T in rec_j["poses"].items()}
    be._solve_gps_coord_alone(traj)
    np.testing.assert_allclose(
        be.graph.get_special_value(tpg.SPECIAL_GPS_COORD), rec_j["T"],
        rtol=0, atol=1e-9)
    np.testing.assert_allclose(rec_t["T"], rec_j["T"], rtol=0, atol=1e-4)


def _assert_close(A, B, tol):
    dt, dr = transform_gap(A, B)
    assert dt <= tol and dr <= tol, (dt, dr)


def test_stream_poses_and_special_nodes_match_jax(stream):
    """After the final solve: every submap pose, the GPS coordinate
    transform and the calibrated tf_odom_lidar within 1e-4 m and 1e-4 rad
    of the JAX package's."""
    bj, bt = stream["jax"]["be"], stream["torch"]["be"]
    for sj, st in zip(stream["jax"]["traj"], stream["torch"]["traj"]):
        _assert_close(st.global_pose, sj.global_pose, 1e-4)
    _assert_close(bt.get_gps_coord_transform(), bj.get_gps_coord_transform(),
                  1e-4)
    _assert_close(bt.tf_odom_lidar, bj.tf_odom_lidar, 1e-4)
    assert len(bt.graph.gps_factors) == len(bj.graph.gps_factors)
    assert len(bt.graph.odom_factors) == len(bj.graph.odom_factors)


def test_stream_chi2_matches_jax(stream):
    """The final solve's χ² within 1e-3 relative."""
    cj = stream["jax"]["be"].graph.last_chi2
    ct = stream["torch"]["be"].graph.last_chi2
    assert abs(ct - cj) <= 1e-3 * max(cj, 1.0), (ct, cj)
