"""Settings of the port's main path, its CLI path, its back-end path and
its eval rows, its matcher path, its outputs path and its sensor paths
(with and without loop closing), shared by ``chip_smoke.py`` (the port on
the GPU), ``scripts/torch_sensor_ate.py``, ``scripts/torch_eval_rows.py``
and the JAX references
``scripts/jax_main_path_ate.py``, ``scripts/jax_cli_ate.py``,
``scripts/jax_backend_ate.py``, ``scripts/jax_matcher_ate.py`` and
``scripts/jax_sensor_ate.py``.  Plain Python and numpy: importing it loads
neither torch nor JAX; the functions that drive a package take its modules
as arguments."""
from __future__ import annotations

import hashlib
import os
import time

import numpy as np

MAIN_PATH = {
    # synthetic world and sequence (io/synthetic.py)
    "n_scans": 161, "seed": 3, "trajectory": "straight", "step": 0.5,
    "max_points": 30000, "max_range": 70.0, "scan_period": 0.1,
    # the JAX package's default widths
    "scan_capacity": 32768, "submap_capacity": 65536, "target_leaf_size": 8,
    "nn_tile": 1024,
    # pipelined MapBuilder, matcher type 6 (bench.py::pipeline_bench)
    "pipeline_chunk": 32, "pair_match_batch": 16,
    "frame_count": 2, "enable_voxel_filter": True, "voxel_size": 0.1,
    # the filter chain of config/lidar_only_kitti.xml
    "filters": [["Range", {"min_range": 5.0}],
                ["AxisRange", {"min": -2.0}],
                ["RandomSampler", {"sampling_rate": 0.5}]],
    # config/synthetic.xml: density-normalized pair-match score
    "score_spacing_ref": 0.35,
    # scans fed before the timed window opens.  A chunk completes at every
    # 32nd scan: at scan 64 the first chunk runs (loading every front-end
    # kernel), at scan 96 the first keyframes are harvested and the first
    # pair-match batch runs.  The window, scans 97..160, then holds two whole
    # cycles of chunk run, harvest and pair-match flush.
    "warmup_scans": 97,
}


# The CLI path: `python -m <package> --cfg config/lidar_only_kitti.xml
# --kitti DIR --no-backend`, the sequential front end with the MRVM static
# map at the default widths (scan capacity 32768, submap capacity 65536,
# leaf 8), on .bin files made from MAIN_PATH's synthetic world at full width
# (30000 points a scan).  64 scans keep the run well inside chip_smoke.py's
# time limit.
CLI_PATH = {
    "n_scans": 64, "cfg": os.path.join("config", "lidar_only_kitti.xml"),
    "rate": 10.0,
}


# The back-end path: `python -m <package> --synthetic square --scans 0
# --pipelined` without --no-backend: the chunked front end (as
# bench.py::eval_run's square row runs it), loop closing with the M2DP gate,
# the batched loop verifier and the GICP gate, and the pose-graph solves, at
# config/synthetic.xml's settings and the default widths (scan capacity
# 32768, submap capacity 65536, leaf 8).  The CLI draws the synthetic world
# with seed 7; the square loop has 92 poses.  The sequential front end
# jumps 4.8 m at scans 77-78 of this world, after which the loop cannot
# close.
BACKEND_PATH = {
    "trajectory": "square", "seed": 7, "n_scans": 0, "rate": 10.0,
    "cfg": os.path.join("config", "synthetic.xml"),
    # the CLI's --pipelined: the chunked front end, 16 scans a chunk, pair
    # matches in batches of 16
    "pipelined": True, "chunk": 16,
}


# bench.py's eval rows (bench.py:410-418) that the back-end path does not
# run: BACKEND_PATH's settings (config/synthetic.xml, the chunked front end,
# 16 scans a chunk, pair matches in batches of 16, the default widths) with
# the world swapped.  The figure-eight (io/synthetic.py:55-72, 240 poses,
# about 1.5 m a step) is the only world whose loop closes at a crossing,
# entered from another heading; seeds 8 and 9 draw other worlds around the
# square.  The CLI fixes seed 7, so the rows drive build_map_builder,
# insert_pointcloud and finish as bench.py::eval_run does
# (``eval_config``, ``drive_eval_row``).
EVAL_ROWS = {
    "eight_backend": {"trajectory": "eight", "n_scans": 240, "seed": 7,
                      "backend": True},
    "eight_frontend": {"trajectory": "eight", "n_scans": 240, "seed": 7,
                       "backend": False},
    "square_seed8": {"trajectory": "square", "n_scans": 0, "seed": 8,
                     "backend": True},
    "square_seed9": {"trajectory": "square", "n_scans": 0, "seed": 9,
                     "backend": True},
}


# ATE (m) of staticmapping_tpu on each row's scans with the back end off,
# measured on an 8-core CPU by
# ``python3 scripts/jax_backend_ate.py --no-backend --trajectory T --scans N
# --seed S`` (eight 240 7: 37.3 min, 57.5 CPU-min; square 0 8: 22.0 min,
# 29.4 CPU-min; square 0 9: 19.4 min, 26.4 CPU-min; the three ran at once).
# A row with the back end is held to it (the JAX back-end run does not
# finish on the CPU: scripts/jax_backend_ate.py); the row without the back
# end to max(2 x it, 0.35 m), tests/test_pipeline.py's bound.
EVAL_JAX_FRONTEND_ATE_M = {
    ("eight", 240, 7): 0.487468457997727,
    ("square", 0, 8): 0.3278117974514201,
    ("square", 0, 9): 0.25978723337768395,
}


def eval_limit(row) -> float:
    """An eval row's ATE limit (m)."""
    jax_ate = EVAL_JAX_FRONTEND_ATE_M[(row["trajectory"], row["n_scans"],
                                       row["seed"])]
    return jax_ate if row["backend"] else max(2.0 * jax_ate, 0.35)


def eval_sequence(make_sequence, row):
    """An eval row's scans and ground-truth poses."""
    return backend_sequence(make_sequence, trajectory=row["trajectory"],
                            n_scans=row["n_scans"], seed=row["seed"])


def eval_config(config_lib, out: str):
    """A package's ``PipelineConfig`` for an eval row: config/synthetic.xml
    with the chunked front end set as the CLI's --pipelined sets it, the
    outputs in ``out``."""
    B = BACKEND_PATH
    cfg = config_lib.load_config(os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        B["cfg"]))
    cfg.map_builder.export_file_path = out
    cfg.map_builder.pipelined = B["pipelined"]
    cfg.map_builder.pipeline_chunk = B["chunk"]
    cfg.map_builder.pair_match_batch = 16
    return cfg


def drive_eval_row(mb, scans, sync=lambda: None,
                   rate: float = BACKEND_PATH["rate"]) -> dict:
    """Feed ``scans`` through ``insert_pointcloud`` at ``rate`` (Hz) and
    call ``finish``: the seconds of each."""
    period = 1.0 / rate
    t0 = time.perf_counter()
    for i, pts in enumerate(scans):
        mb.insert_pointcloud(i * period, pts)
    sync()
    t1 = time.perf_counter()
    mb.finish()
    sync()
    return {"insert_s": t1 - t0, "finish_s": time.perf_counter() - t1,
            "scans_per_s": len(scans) / (t1 - t0)}


def eval_results(mb, gt_poses, ate_rmse) -> dict:
    """What an eval row reports of its finished ``mb``; either package."""
    period = 1.0 / BACKEND_PATH["rate"]
    be = mb.backend
    frames = [(f.stamp, f.global_pose) for s in mb.trajectory
              for f in s.frames]
    return {
        "keyframes": len(frames), "submaps": len(mb.trajectory),
        "ate_m": stamp_matched_ate(frames, gt_poses, period, ate_rmse),
        "loop_edge_count": 0 if be is None else be.loop_edge_count,
        "loop_edges": [] if be is None else [
            (int(i), int(j)) for i, j in zip(be.graph.factors.i,
                                             be.graph.factors.j)
            if j != i + 1],
        "loop_gap_m": loop_gap([s.global_pose for s in mb.trajectory],
                               [s.stamp for s in mb.trajectory], gt_poses,
                               period)}


# The matcher path: the other matcher types at the default widths (scan
# capacity 32768, submap capacity 65536, leaf 8).  Types 3 and 5 run
# bench.py's eval rows ("square", True, 3, 0, 7) and ("square", True, 5, 48,
# 7): config/synthetic.xml with the scan matcher set to the type, the
# chunked front end (16 scans a chunk, pair matches in batches of 16), the
# back end on.  NDT needs at least 4 points a 1 m voxel, so type 5 gets
# denser, shorter-range scans (bench.py:419-424).  Type 1 runs the CLI,
# sequential and with --no-backend, on the first 16 scans of CLI_PATH's
# .bin sequence, with a copy of config/lidar_only_kitti.xml whose scan
# matcher is type 1.  ``test_ate_m`` is the bound of
# tests/test_matcher_e2e.py for the type.
MATCHER_PATH = {
    "chunked": [
        {"name": "type3", "matcher_type": 3, "trajectory": "square",
         "seed": 7, "n_scans": 0, "max_points": 15000, "max_range": 70.0,
         "test_ate_m": 0.5},
        {"name": "type5", "matcher_type": 5, "trajectory": "square",
         "seed": 7, "n_scans": 48, "max_points": 16000, "max_range": 40.0,
         "test_ate_m": 0.6},
    ],
    "cfg": os.path.join("config", "synthetic.xml"), "rate": 10.0,
    "chunk": 16, "pair_match_batch": 16,
    "sequential": {"name": "type1", "matcher_type": 1, "n_scans": 16,
                   "cfg": os.path.join("config", "lidar_only_kitti.xml"),
                   "test_ate_m": 0.35},
    # chunked runs whose front end is also run on the CPU from the same
    # scans, back end off, the card's keyframes held to the CPU's within
    # twin_tol_m: type 5's ATE limit does not bind (a still estimate
    # scores 11.1 m on its scans, under the 11.65 m limit)
    "cpu_twin": ("type5",), "twin_tol_m": 0.01,
}


# The outputs path: what a user runs after a drive, at the default widths
# (scan capacity 32768, submap capacity 65536, leaf 8).
# - "package": CLI_PATH with a copy of its config whose
#   map_package_options has enable="true": the map package and its pieces.
# - "checkpoint": CLI_PATH's world and config with the back end on and the
#   MRVM export off, sequential; stopped after ``cut_after`` scans, saved,
#   reloaded into a fresh builder and run to the end, held to an
#   uninterrupted run: every submap within ``tol_m`` (tests/
#   test_checkpoint.py's bound), the ATE under ``ate_limit_m`` (CLI_PATH's).
# - "merge": two passes along the ground truth of MAIN_PATH's first
#   ``n_scans`` scans, ``frames`` consecutive full-width renders a submap
#   merged at ``voxel_size``; scan k of pass p is drawn with seed
#   p * 100 + k (tests/test_multi_trajectory.py's rule), and pass 1's
#   stored poses carry ``pose_error`` (x, y m, yaw rad; that test's).  Both
#   are saved as packages, reloaded and merged with ``options``: that
#   test's gates and acceptance score at leaf 8 and 64 pairs, so the
#   merge's K2 batch is 64 x 65536 x 8192.  Its bounds are that test's.
OUTPUTS_PATH = {
    "package": {"n_scans": CLI_PATH["n_scans"], "cfg": CLI_PATH["cfg"],
                "rate": CLI_PATH["rate"]},
    "checkpoint": {"n_scans": CLI_PATH["n_scans"], "cfg": CLI_PATH["cfg"],
                   "rate": CLI_PATH["rate"], "cut_after": 32,
                   "tol_m": 0.8, "ate_limit_m": 0.35},
    "merge": {"n_scans": 80, "frames": 2, "voxel_size": 0.1,
              "submap_capacity": 65536, "scan_capacity": 32768,
              "pose_error": (1.0, -0.7, 0.05),
              "options": {"max_distance": 10.0, "use_descriptor": False,
                          "accept_match_score": 0.3, "normal_leaf_size": 8,
                          "max_pairs": 64},
              "min_edges": 3, "base_move_m": 0.2, "error_ratio": 0.3},
}


# The sensor path: GPS- and odometry-aided mapping without loop closure, as
# mapping vans with an RTK/INS receiver run it.  BACKEND_PATH's world and
# front end (the square, seed 7, 92 poses; the chunked type-6 front end, 16
# scans a chunk, pair matches in batches of 16; the default widths) with a
# copy of config/synthetic.xml (``sensor_config``) whose
# isam_optimizer_options turn GPS, odometry and the extrinsic calibration
# on, with the reference's defaults for the GPS init, and whose
# loop_ignore_threshold of 1000 keeps every loop candidate out.  The chunked
# front end jumps 2.8 m at scans 77-78 of this world: here the GPS factors,
# not a loop edge, must pull the map back.  The messages (``sensor_feed``):
# - GPS: one fix a scan, ``gps_delay_s`` after it, at the antenna
#   (``tracking_to_gps``) midway between the scan's pose and the next, in
#   an ENU frame that is the map turned by ``enu_yaw`` and moved by
#   ``enu_offset`` (tests/test_sensors.py:121-122), with N(0,
#   ``gps_noise_m``) on each axis, turned into latitude, longitude and
#   altitude by ``LocalCartesian(*geo_origin).reverse``; status fixed.
# - Odometry: one pose a scan at its stamp, odom_k = C⁻¹ · pose_k · C, C
#   the true lidar→odom extrinsic ``odom_calib`` (euler, translation;
#   tests/test_sensors.py:213-214) and pose_k the ground truth with N(0,
#   ``odom_drift_rad``) rad and N(0, ``odom_drift_m``) m of drift added each
#   step.  ``tracking_to_odom`` stays the identity, so the calibration node
#   has to find C.
# All noise comes from numpy.random.default_rng(seed): the GPS noise of
# every fix, then the rotation and the translation drift of every step.
SENSOR_PATH = {
    **BACKEND_PATH, "pair_match_batch": 16,
    "optimizer": {"use_gps": True, "use_odom": True,
                  "enable_extrinsic_calib": True, "gps_factor_init_num": 20,
                  "gps_factor_init_angle_rad": 0.5,
                  "gps_factor_sample_step": 1},
    "loop_ignore_threshold": 1000,
    "gps_delay_s": 0.05, "tracking_to_gps": (0.1, 0.0, 0.2),
    "enu_yaw": 0.8, "enu_offset": (100.0, -50.0, 2.0), "gps_noise_m": 0.05,
    "geo_origin": (48.8566, 2.3522, 35.0),
    "odom_calib": ((0.05, 0.03, 0.15), (0.5, 0.2, 0.0)),
    "odom_drift_rad": 0.002, "odom_drift_m": 0.02,
}

# The sensor path with loop closing: an RTK van whose drive revisits a
# street.  SENSOR_PATH's world, front end, widths and feed, with
# config/synthetic.xml's own loop_ignore_threshold (15; None keeps the
# config's): the loop verifier on K2, the GICP gate on K1, loop edges and
# GPS factors in one graph.
SENSOR_LOOP_PATH = {**SENSOR_PATH, "loop_ignore_threshold": None}


def sensor_config(config_lib, src: str, work: str, path=SENSOR_PATH,
                  **optimizer):
    """A package's ``PipelineConfig`` for a sensor path (``path``,
    SENSOR_PATH or SENSOR_LOOP_PATH): a copy of the XML config ``src``
    written into ``work`` with the path's isam_optimizer_options
    (``optimizer`` overrides some) and loop_ignore_threshold (None keeps
    the config's), read by the package's own loader, with the chunked front
    end set as the CLI's --pipelined sets it and the outputs in
    ``work/out``."""
    import xml.etree.ElementTree as ET
    S = path
    tree = ET.parse(src)
    be = tree.getroot().find("static_mapping/back_end_options")
    node = be.find("isam_optimizer_options")
    if node is None:
        node = ET.SubElement(be, "isam_optimizer_options")
    for k, v in {**S["optimizer"], **optimizer}.items():
        node.set(k, str(v).lower() if isinstance(v, bool) else str(v))
    if S["loop_ignore_threshold"] is not None:
        be.find("loop_detector_setting").set(
            "loop_ignore_threshold", str(S["loop_ignore_threshold"]))
    path = os.path.join(work, "sensor.xml")
    tree.write(path)
    cfg = config_lib.load_config(path)
    cfg.map_builder.export_file_path = os.path.join(work, "out")
    cfg.map_builder.pipelined = S["pipelined"]
    cfg.map_builder.pipeline_chunk = S["chunk"]
    cfg.map_builder.pair_match_batch = S["pair_match_batch"]
    return cfg


def sensor_feed(gt_poses, local_cartesian, np_se3):
    """The sensor path's messages for the scans at ``gt_poses``, in stamp
    order: ``("odom", stamp, pose)``, ``("scan", stamp, index)`` and
    ``("gps", stamp, (lat, lon, alt))``; and the noise-free latitude,
    longitude and altitude of the antenna at each scan.
    ``local_cartesian`` and ``np_se3`` are a package's
    ``common.geo.LocalCartesian`` and ``common.np_se3``."""
    S = SENSOR_PATH
    period = 1.0 / S["rate"]
    rng = np.random.default_rng(S["seed"])
    geo = local_cartesian(*S["geo_origin"])
    n = len(gt_poses)
    rel = [np.linalg.solve(gt_poses[0], g) for g in gt_poses]
    antenna = np.stack([T[:3, :3] @ S["tracking_to_gps"] + T[:3, 3]
                        for T in rel])
    after = np.vstack([antenna[1:], 2.0 * antenna[-1:] - antenna[-2:-1]])
    T_enu = np_se3.from_rt(np_se3.euler_to_matrix([0.0, 0.0, S["enu_yaw"]]),
                           S["enu_offset"])

    def enu(p):
        return p @ T_enu[:3, :3].T + T_enu[:3, 3]
    fixes = (enu(0.5 * (antenna + after))
             + rng.normal(0.0, S["gps_noise_m"], (n, 3)))
    rot = rng.normal(0.0, S["odom_drift_rad"], (n, 3))
    trans = rng.normal(0.0, S["odom_drift_m"], (n, 3))
    C = np_se3.from_rt(np_se3.euler_to_matrix(S["odom_calib"][0]),
                       S["odom_calib"][1])
    C_inv = np_se3.inverse(C)
    drifted = rel[0]
    feed = []
    for k in range(n):
        if k > 0:
            drifted = (drifted @ np_se3.inverse(rel[k - 1]) @ rel[k]
                       @ np_se3.from_rt(np_se3.euler_to_matrix(rot[k]),
                                        trans[k]))
        feed += [("odom", k * period, C_inv @ drifted @ C),
                 ("scan", k * period, k),
                 ("gps", k * period + S["gps_delay_s"],
                  tuple(float(x) for x in geo.reverse(fixes[k])))]
    truth = [tuple(float(x) for x in geo.reverse(p)) for p in enu(antenna)]
    return feed, truth


def drive_sensor_path(mb, scans, feed, np_se3, sync=lambda: None,
                      finish: bool = True) -> dict:
    """Set ``mb``'s GPS and odometry extrinsics, feed ``feed`` through
    ``insert_odom`` / ``insert_pointcloud`` / ``insert_gps`` and call
    ``finish`` (unless told not to).  Returns the submaps at which the GPS
    init fired and the first loop edge was added in this call, the
    pose-graph solves' count and seconds, and the seconds of the insert
    loop and of ``finish``."""
    be = mb.backend
    mb.set_tracking_to_odom(np.eye(4))
    mb.set_tracking_to_gps(np_se3.from_rt(np.eye(3),
                                          SENSOR_PATH["tracking_to_gps"]))
    rec = {"gps_init_submap": None, "first_loop_edge_submap": None,
           "pose_graph_solves": 0, "pose_graph_solve_s": 0.0}
    add_submap, optimize = be.add_submap, be.graph.optimize

    def added(trajectory, submap):
        add_submap(trajectory, submap)
        if (rec["gps_init_submap"] is None
                and be._calculated_first_gps_coord):
            rec["gps_init_submap"] = int(submap.id)
        if rec["first_loop_edge_submap"] is None and be.loop_edge_count:
            rec["first_loop_edge_submap"] = int(submap.id)

    def timed(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return optimize(*args, **kwargs)
        finally:
            rec["pose_graph_solves"] += 1
            rec["pose_graph_solve_s"] += time.perf_counter() - t0
    be.add_submap, be.graph.optimize = added, timed
    try:
        t0 = time.perf_counter()
        for kind, stamp, payload in feed:
            if kind == "scan":
                mb.insert_pointcloud(stamp, scans[payload])
            elif kind == "odom":
                mb.insert_odom(stamp, payload)
            else:
                mb.insert_gps(stamp, *payload)
        sync()
        t1 = time.perf_counter()
        if finish:
            mb.finish()
            sync()
    finally:
        del be.add_submap, be.graph.optimize
    return {**rec, "insert_s": t1 - t0,
            "finish_s": time.perf_counter() - t1}


def pcd_points(path: str) -> int:
    """The POINTS count of a PCD file's header."""
    with open(path, "rb") as f:
        for line in f:
            if line.startswith(b"POINTS"):
                return int(line.split()[1])
    raise ValueError(f"{path} has no POINTS line")


def file_digest(path: str) -> dict:
    with open(path, "rb") as f:
        data = f.read()
    return {"bytes": len(data), "sha256": hashlib.sha256(data).hexdigest()}


def enu_error(frames, truth_lla, collector, period: float) -> float:
    """RMS over keyframes ``(stamp, pose)`` of the antenna's distance from
    its noise-free position, both in ``collector``'s ENU frame (the one
    anchored at its first fix)."""
    p_tg = np.asarray(SENSOR_PATH["tracking_to_gps"])
    err = [T[:3, :3] @ p_tg + T[:3, 3] - collector.reference_gps.forward(
               *truth_lla[int(round(st / period))]) for st, T in frames]
    return float(np.sqrt(np.mean(np.sum(np.square(err), axis=1))))


def transform_gap(A, B):
    """``(translation m, rotation rad)`` between two 4×4 transforms."""
    R = np.asarray(A)[:3, :3].T @ np.asarray(B)[:3, :3]
    skew = R - R.T
    sin = 0.5 * np.linalg.norm([skew[2, 1], skew[0, 2], skew[1, 0]])
    cos = 0.5 * (np.trace(R) - 1.0)
    return (float(np.linalg.norm(np.asarray(A)[:3, 3]
                                 - np.asarray(B)[:3, 3])),
            float(np.arctan2(sin, cos)))


def sensor_results(mb, gt_poses, truth_lla, ate_rmse, out_dir: str) -> dict:
    """What a sensor-path run reports, from its finished ``mb`` and its
    export directory; either package."""
    period = 1.0 / SENSOR_PATH["rate"]
    be = mb.backend
    frames = [(f.stamp, f.global_pose) for s in mb.trajectory
              for f in s.frames]
    static = os.path.join(out_dir, "static_map.pcd")
    return {
        "keyframes": len(frames), "submaps": len(mb.trajectory),
        "gps_coord_transform": np.asarray(
            be.get_gps_coord_transform()).tolist(),
        "tf_odom_lidar": np.asarray(be.tf_odom_lidar).tolist(),
        "enu_error_m": enu_error(frames, truth_lla, mb.data_collector,
                                 period),
        "ate_m": stamp_matched_ate(frames, gt_poses, period, ate_rmse),
        "static_voxels": (pcd_points(static) if os.path.exists(static)
                          else 0),
        "pcds": {name: file_digest(os.path.join(out_dir, name))
                 for name in ("original_gps.pcd", "original_odom.pcd")},
        "gps_factors": len(be.graph.gps_factors),
        "odom_factors": len(be.graph.odom_factors),
        "loop_edge_count": be.loop_edge_count,
        "loop_gap_m": loop_gap([s.global_pose for s in mb.trajectory],
                               [s.stamp for s in mb.trajectory], gt_poses,
                               period)}


def write_package_cfg(src: str, path: str) -> None:
    """Copy the XML config ``src`` to ``path`` with its map package
    enabled."""
    import xml.etree.ElementTree as ET
    tree = ET.parse(src)
    tree.getroot().find("static_mapping/map_package_options").set(
        "enable", "true")
    tree.write(path)


def matcher_sequence(run, make_sequence):
    """The scans and ground-truth poses of one chunked matcher run."""
    return make_sequence(n_scans=run["n_scans"], trajectory=run["trajectory"],
                         seed=run["seed"], max_points=run["max_points"],
                         max_range=run["max_range"])


def permute_points(scans, seed):
    """Each scan with its points in an order drawn from ``seed`` (None
    keeps the scans' own order): the same points, summed in another order
    by every reduction over a scan."""
    if seed is None:
        return scans
    rng = np.random.default_rng(seed)
    return [s[rng.permutation(len(s))] for s in scans]


def configure_matcher_run(cfg, run) -> None:
    """Set a loaded ``PipelineConfig`` (either package's) to a chunked
    matcher run, as bench.py::eval_run and the CLI's --pipelined do."""
    cfg.map_builder.front_end.matcher_type = run["matcher_type"]
    cfg.scan_matcher.type = run["matcher_type"]
    cfg.map_builder.pipelined = True
    cfg.map_builder.pipeline_chunk = MATCHER_PATH["chunk"]
    cfg.map_builder.pair_match_batch = MATCHER_PATH["pair_match_batch"]


def write_matcher_cfg(src: str, matcher_type: int, path: str) -> None:
    """Copy the XML config ``src`` to ``path`` with its scan matcher and
    that matcher's registrator options set to ``matcher_type``."""
    import xml.etree.ElementTree as ET
    tree = ET.parse(src)
    node = tree.getroot().find("static_mapping/front_end_options/"
                               "scan_matcher_options")
    node.set("type", str(matcher_type))
    reg = node.find("registrator_options")
    if reg is not None:
        reg.set("type", str(matcher_type))
    tree.write(path)


def backend_sequence(make_sequence, **world):
    """The back-end path's scans and ground-truth poses, as the CLI makes
    them; ``world`` (``trajectory``, ``n_scans``, ``seed``) swaps the world
    as an eval row does."""
    B = {**BACKEND_PATH, **world}
    return make_sequence(n_scans=B["n_scans"], trajectory=B["trajectory"],
                         seed=B["seed"])


def loop_gap(submap_poses, frame_stamps, gt_poses, period: float) -> float:
    """``|est_gap − gt_gap|``: how far the estimated distance between the
    first and the last submap is from the true distance between the scans
    they start at (matched by stamp).  A loop that the back end closed
    brings it near 0."""
    est_gap = np.linalg.norm(submap_poses[-1][:3, 3] - submap_poses[0][:3, 3])
    g0 = gt_poses[int(round(frame_stamps[0] / period))]
    g1 = gt_poses[int(round(frame_stamps[-1] / period))]
    return float(abs(est_gap - np.linalg.norm(g1[:3, 3] - g0[:3, 3])))


def keyframe_errors(frames, gt_poses, period: float):
    """``[(stamp, |t_est − t_gt| m, ICP score)]`` of keyframes ``(stamp,
    pose, score)`` against the ground truth of their scans (relative to
    the first), matched by stamp: where a front end jumps."""
    rel_gt = [np.linalg.solve(gt_poses[0], g) for g in gt_poses]
    return [(round(float(st), 3),
             float(np.linalg.norm(T[:3, 3]
                                  - rel_gt[int(round(st / period))][:3, 3])),
             float(score)) for st, T, score in frames]


def write_kitti_bins(directory: str, scans) -> None:
    """Write scans as a KITTI velodyne sequence: ``%06d.bin`` files of N×4
    f32 with intensity stored 0..1, as the reader rescales it ×255."""
    os.makedirs(directory, exist_ok=True)
    for i, pts in enumerate(scans):
        rec = np.zeros((len(pts), 4), dtype=np.float32)
        rec[:, :3] = pts[:, :3]
        if pts.shape[1] > 3:
            rec[:, 3] = (pts[:, 3] / 255.0 if pts[:, 3].max() > 1.0
                         else pts[:, 3])
        rec.tofile(os.path.join(directory, f"{i:06d}.bin"))


def cli_sequence(make_sequence, n_scans: int = CLI_PATH["n_scans"]):
    """The CLI path's scans and ground-truth poses (its first ``n_scans``),
    from a package's ``io.synthetic.make_sequence`` (both packages hold the
    same copy; each scan is drawn from its own seed)."""
    P = MAIN_PATH
    return make_sequence(n_scans=n_scans, seed=P["seed"],
                         trajectory=P["trajectory"], step=P["step"],
                         max_points=P["max_points"],
                         max_range=P["max_range"])


def path_csv_frames(path: str):
    """``[(stamp, pose)]`` of the keyframes in a ``path.csv`` (stamp x y z
    qw qx qy qz).  The pose carries the translation only, which is all the
    ATE reads."""
    frames = []
    for row in np.atleast_2d(np.loadtxt(path)):
        T = np.eye(4)
        T[:3, 3] = row[1:4]
        frames.append((float(row[0]), T))
    return frames


def stamp_matched_ate(frames, gt_poses, period: float, ate_rmse) -> float:
    """ATE (RMSE after SE(3) alignment) of keyframe poses against the
    ground truth of the scans they came from, matched by stamp."""
    rel_gt = [np.linalg.solve(gt_poses[0], g) for g in gt_poses]
    est, gt = [], []
    for stamp, pose in frames:
        gi = int(round(stamp / period))
        if 0 <= gi < len(rel_gt):
            est.append(pose)
            gt.append(rel_gt[gi])
    return float(ate_rmse(np.stack(est), np.stack(gt)))
