"""Settings of the port's main path, its CLI path and its back-end path,
shared by ``chip_smoke.py`` (the port on the GPU),
``scripts/profile_main_path.py`` and the JAX references
``scripts/jax_main_path_ate.py``, ``scripts/jax_cli_ate.py`` and
``scripts/jax_backend_ate.py``.  Plain Python and numpy: importing it loads
neither torch nor JAX."""
from __future__ import annotations

import os

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


def backend_sequence(make_sequence):
    """The back-end path's scans and ground-truth poses, as the CLI makes
    them."""
    B = BACKEND_PATH
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


def cli_sequence(make_sequence):
    """The CLI path's scans and ground-truth poses, from a package's
    ``io.synthetic.make_sequence`` (both packages hold the same copy)."""
    P = MAIN_PATH
    return make_sequence(n_scans=CLI_PATH["n_scans"], seed=P["seed"],
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
