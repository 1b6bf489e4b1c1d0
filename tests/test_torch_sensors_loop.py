"""GPS-aided mapping with loop closing: loop edges, GPS factors, odometry
factors and the extrinsic calibration in one pose graph, through both
packages' ``IncrementalOptimizer`` on the CPU.

The submaps are tests/torch_loop_stream.py's stream on a smaller square
(4 side and 4 corner steps, 8 poses of overlap: 20 submaps, the loop
closing at submap 17), each tagged with an
ENU fix (the antenna at ``TRACKING_TO_GPS`` on the ground-truth pose,
moved into ENU by a known ``T_ENU``, with N(0, ``GPS_NOISE_M``) on each
axis) and an odometry pose (the ground truth with drift, seen through an
unknown lidar→odom extrinsic ``ODOM_CALIB``), both drawn from a seed with
numpy.  Two cases: the GPS init fires just before the first loop edge
(``gps_factor_init_num`` 16), or after it (19).  Each solve runs
``GN_TRIPS`` trips.  Every submap brings an odometry factor and so a
solve, and the JAX package compiles its Gauss-Newton for every padded
graph size (about 10 s each on the CPU); up to the init both cases build
the same graphs, so they share those compiles, and the stream stays
short.
"""
import numpy as np
import pytest
import torch

from scripts.main_path import transform_gap
from staticmapping_tpu.backend import loop_detector as jld
from staticmapping_tpu.backend import optimizer as jopt
from staticmapping_torch.backend import loop_detector as tld
from staticmapping_torch.backend import optimizer as topt
from staticmapping_torch.common import np_se3

import torch_loop_stream as loop_stream

CPU = "cpu"
# (side steps, corner steps, overlap, stride) of the stream
STREAM = (4, 4, 8, 2)
GN_TRIPS = 3
T_ENU = np_se3.from_rt(np_se3.euler_to_matrix([0.0, 0.0, 0.8]),
                       [100.0, -50.0, 2.0])
TRACKING_TO_GPS = np.array([0.1, 0.0, 0.2])
GPS_NOISE_M = 0.05
ODOM_CALIB = np_se3.from_rt(np_se3.euler_to_matrix([0.05, 0.03, 0.15]),
                            [0.5, 0.2, 0.0])
ODOM_DRIFT_RAD, ODOM_DRIFT_M = 0.002, 0.02
# case: (gps_factor_init_num, whether the init fires before the first
# loop edge)
CASES = {"init_before_loop": (16, True), "init_after_loop": (19, False)}
PACKAGES = {"jax": (jopt, jld), "torch": (topt, tld)}
# tolerances, port against the JAX package: the loop edges' transforms
# (m, rad; tests/test_torch_loop_detector.py's), the submap poses after the
# final solve (m), the GPS coordinate transform and tf_odom_lidar (m,
# rad), and the final χ² (relative)
EDGE_TOL = (0.02, 2e-3)
POSE_TOL_M = 0.02
NODE_TOL = (0.02, 2e-3)
CHI2_REL_TOL = 0.05

cases = pytest.mark.parametrize("case", sorted(CASES))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The loop closing is chains of small ops, which a many-thread CPU
    pool only slows down."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tags(gt):
    """``(enu, odom)`` of each submap, drawn from one seed, both of the
    ground truth in the stream's frame (the graph's): the antenna moved
    into ENU, and odom_k = C⁻¹ · pose_k · C, pose_k the ground truth with
    drift added each step (scripts/main_path.py::sensor_feed's model)."""
    rng = np.random.default_rng(11)
    enu = [T_ENU[:3, :3] @ (T[:3, :3] @ TRACKING_TO_GPS + T[:3, 3])
           + T_ENU[:3, 3] + rng.normal(0.0, GPS_NOISE_M, 3) for T in gt]
    C_inv = np_se3.inverse(ODOM_CALIB)
    drifted, odom = gt[0], []
    for k in range(len(gt)):
        if k > 0:
            noise = np_se3.from_rt(
                np_se3.euler_to_matrix(rng.normal(0.0, ODOM_DRIFT_RAD, 3)),
                rng.normal(0.0, ODOM_DRIFT_M, 3))
            drifted = drifted @ np_se3.inverse(gt[k - 1]) @ gt[k] @ noise
        odom.append(C_inv @ drifted @ ODOM_CALIB)
    return list(zip(enu, odom))


def _run(package, st, tags, init_num):
    opt, ld = PACKAGES[package]
    be = opt.IncrementalOptimizer(
        opt.OptimizerOptions(use_gps=True, use_odom=True,
                             enable_extrinsic_calib=True,
                             gps_factor_init_num=init_num,
                             gn_iterations=GN_TRIPS),
        loop_settings=ld.LoopDetectorSettings(**loop_stream.STREAM_SETTINGS),
        **({"device": CPU} if package == "torch" else {}))
    be.set_transform_tracking_to_gps(np_se3.from_rt(np.eye(3),
                                                    TRACKING_TO_GPS))
    order = {"init": None, "first_edge": None}
    add_submap = be.add_submap

    def added(trajectory, submap):
        add_submap(trajectory, submap)
        if order["init"] is None and be._calculated_first_gps_coord:
            order["init"] = submap.id
        if order["first_edge"] is None and be.loop_edge_count:
            order["first_edge"] = submap.id
    be.add_submap = added
    subs, states = loop_stream.run_stream(
        be, *loop_stream.package_inputs(st, package, CPU), st["drifted"],
        st["matches"], tags)
    be.run_final_optimization(subs)
    return {"be": be, "subs": subs, "states": states, **order}


@pytest.fixture(scope="module")
def runs():
    st = loop_stream.make_stream(*STREAM)
    tags = _tags(st["gt"])
    return {case: {pkg: _run(pkg, st, tags, init_num) for pkg in PACKAGES}
            for case, (init_num, _) in CASES.items()}


@cases
def test_gps_init_and_first_loop_edge_in_order(runs, case):
    """Both packages close the loop and init GPS; the init fires before
    (or after) the submap of the first loop edge, as the case says."""
    before = CASES[case][1]
    for pkg, run in runs[case].items():
        assert run["init"] is not None and run["first_edge"] is not None, pkg
        assert (run["init"] < run["first_edge"]) == before, (pkg, run["init"],
                                                             run["first_edge"])
        assert len(run["be"].graph.gps_factors) > 0
        assert len(run["be"].graph.odom_factors) == len(run["subs"])


@cases
def test_init_submap_and_loop_states_equal_jax(runs, case):
    j, t = runs[case]["jax"], runs[case]["torch"]
    assert (t["init"], t["first_edge"]) == (j["init"], j["first_edge"])
    assert [s.name for s in t["states"]] == [s.name for s in j["states"]]


@cases
def test_accepted_edges_match_jax(runs, case):
    """The same (target, source) loop edges, their transforms within
    EDGE_TOL."""
    edges_j = loop_stream.loop_edges(runs[case]["jax"]["be"])
    edges_t = loop_stream.loop_edges(runs[case]["torch"]["be"])
    assert len(edges_t) >= 1
    assert [e[:2] for e in edges_t] == [e[:2] for e in edges_j]
    assert runs[case]["torch"]["be"].loop_edge_count == len(edges_t)
    for (_, _, Tt), (_, _, Tj) in zip(edges_t, edges_j):
        dt, dr = transform_gap(Tt, Tj)
        assert dt <= EDGE_TOL[0] and dr <= EDGE_TOL[1], (dt, dr)


@cases
def test_final_poses_match_jax(runs, case):
    """Every submap pose after the final solve within POSE_TOL_M of the
    JAX package's."""
    pj = np.stack([s.global_pose for s in runs[case]["jax"]["subs"]])
    pt = np.stack([s.global_pose for s in runs[case]["torch"]["subs"]])
    assert np.abs(pt[:, :3, 3] - pj[:, :3, 3]).max() <= POSE_TOL_M


@cases
def test_gps_and_calibration_nodes_match_jax(runs, case):
    """The GPS coordinate transform and the calibrated tf_odom_lidar
    within NODE_TOL of the JAX package's, and the map lands in ENU: the
    antenna through the coordinate transform within 0.3 m of its fix on
    average (tests/test_sensors.py's bound)."""
    bj, bt = runs[case]["jax"]["be"], runs[case]["torch"]["be"]
    for A, B in ((bt.get_gps_coord_transform(), bj.get_gps_coord_transform()),
                 (bt.tf_odom_lidar, bj.tf_odom_lidar)):
        dt, dr = transform_gap(A, B)
        assert dt <= NODE_TOL[0] and dr <= NODE_TOL[1], (dt, dr)
    T_coord = bt.get_gps_coord_transform()
    subs = runs[case]["torch"]["subs"]
    errs = [np.linalg.norm(
        (T_coord @ s.global_pose)[:3, :3] @ TRACKING_TO_GPS
        + (T_coord @ s.global_pose)[:3, 3] - s.related_gps_enu)
        for s in subs]
    assert np.mean(errs) < 0.3, np.mean(errs)


@cases
def test_chi2_matches_jax(runs, case):
    cj = runs[case]["jax"]["be"].graph.last_chi2
    ct = runs[case]["torch"]["be"].graph.last_chi2
    assert abs(ct - cj) <= CHI2_REL_TOL * max(cj, 1.0), (ct, cj)


