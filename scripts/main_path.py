"""Settings of the port's main path and of its CLI path, shared by
``chip_smoke.py`` (the port on the GPU), ``scripts/profile_main_path.py`` and
the JAX references ``scripts/jax_main_path_ate.py`` and
``scripts/jax_cli_ate.py``.  Plain Python and numpy: importing it loads
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
