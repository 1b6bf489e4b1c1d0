"""The port's runs of tests/test_matcher_e2e.py: a short synthetic sequence
through ``staticmapping_torch``'s ``MapBuilder`` on the CPU with the matcher
selected as the XML config does (``front_end.matcher_type``), sequential or
chunked, at that file's settings.  The cases are split over the files
tests/test_torch_matcher_e2e_*.py, each short enough to run alone in a
minute."""
import numpy as np
import torch

from staticmapping_torch.builder.frame import SubmapOptions
from staticmapping_torch.builder.frontend import FrontEndOptions
from staticmapping_torch.builder.map_builder import (MapBuilder,
                                                     MapBuilderOptions)
from staticmapping_torch.common import np_se3
from staticmapping_torch.io import kitti as kitti_io
from staticmapping_torch.io import synthetic

# tests/test_matcher_e2e.py's ATE bounds (m) by matcher type
ATE_BOUND = {1: 0.35, 3: 0.5, 5: 0.6}
# NDT forms Gaussians only where at least 4 points fall in a 1 m voxel: it
# gets denser, shorter-range scans than the ICP variants
NDT_SCANS = {"max_points": 20000, "max_range": 40.0}


def options(matcher_type: int, scan_capacity: int = 8192
            ) -> MapBuilderOptions:
    # motion compensation off: the synthetic renderer emits instantaneous
    # snapshots (config/synthetic.xml disables it for the same reason)
    fe = FrontEndOptions(scan_capacity=scan_capacity, nn_tile=512,
                         max_iteration=40, matcher_type=matcher_type,
                         motion_compensation=False)
    return MapBuilderOptions(front_end=fe,
                             submap=SubmapOptions(frame_count=2),
                             submap_capacity=2 * scan_capacity)


def run_ate(matcher_type: int, n_scans: int = 16, step: float = 0.5,
            max_points: int = 6000, max_range: float = 70.0,
            pipelined: bool = False, trajectory: str = "straight",
            seed: int = 4, use_imu: bool = False) -> float:
    """ATE (m) of one run, its keyframes matched to the ground truth by
    stamp.  With ``use_imu`` a 100 Hz gyro, the ground truth's constant
    body rate over each scan interval plus noise, is fed before each scan.
    torch's CPU pool is held to 2 threads for the run: beside five other
    test processes on an 8-core CPU, pools of 4 and 8 threads slowed the
    whole suite by 40% and 60%."""
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        scans, gt = synthetic.make_sequence(
            n_scans=n_scans, seed=seed, trajectory=trajectory, step=step,
            max_points=max_points, max_range=max_range)
        cap = 8192 if max_points <= 8192 else 32768
        opts = options(matcher_type, scan_capacity=cap)
        if pipelined:
            opts.pipelined = True
            opts.pipeline_chunk = 8
            opts.pair_match_batch = 4
        opts.use_imu = use_imu
        mb = MapBuilder(opts, device="cpu")
        rng = np.random.default_rng(0)
        for i, pts in enumerate(scans):
            if use_imu and i > 0:
                rel = np.linalg.solve(gt[i - 1], gt[i])
                w = np_se3.matrix_to_euler(rel[:3, :3]) / 0.1
                for k in range(10):
                    mb.insert_imu((i - 1) * 0.1 + (k + 1) * 0.01,
                                  w + rng.normal(0, 0.01, 3),
                                  np.array([0.0, 0.0, 9.81]))
            mb.insert_pointcloud(i * 0.1, pts)
        if pipelined:
            mb.options.output_kitti_pose = False
            mb.options.output_mrvm = False
            mb.options.output_direct_combined_map = False
            mb.finish()
            mb.front_end.close()
    finally:
        torch.set_num_threads(saved)
    frames = [f for s in mb.trajectory for f in s.frames]
    assert len(frames) >= n_scans // 3, f"too few keyframes: {len(frames)}"
    est = np.stack([f.global_pose for f in frames])
    idx = [int(round(f.stamp / 0.1)) for f in frames]
    gt_sel = np.stack([np.linalg.inv(gt[0]) @ gt[i] for i in idx])
    return kitti_io.ate_rmse(est, gt_sel, align=True)
