"""Scan-matching front end, the odometry loop — the PyTorch counterpart of
``staticmapping_tpu.builder.frontend`` (reference:
``MapBuilder::ScanMatchProcessing``, builder/map_builder.cc:260-397).

The sequential ``FrontEnd`` matches each scan against the current keyframe
target, step by step against map_builder.cc:
  first cloud → becomes target + first keyframe at identity  (cc:281-293)
  guess = pose_target⁻¹ · extrapolated(t), normalized        (cc:302-309)
  motion-compensate source by accum⁻¹·guess                  (cc:313-328)
  align; optionally average(align_result, guess) and
  re-compensate with accum⁻¹·average                         (cc:330-354)
  pose_source = pose_target · align_result; accum = result   (cc:356-357)
  motion filter: translation ≥ range OR Σ|euler|° ≥ range →
  new keyframe, source becomes target (re-normal-ed)         (cc:369-392)

Matcher type 6 runs the point-to-plane ``icp_fast`` against a normals
target in one device function per scan; types 1, 3 and 5 take their
matcher from ``registration.factory.create_matcher`` (the CreateMatcher
role, interface.cc:139-173) against the compacted scan, with the guess
averaging done on the host in float64.  The chunked device front end is
``builder/pipeline.py``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from .. import resolve_device
from ..common import np_se3, prof, se3
from ..data import cloud as cloud_lib
from ..data.cloud import PointCloud
from ..ops.normals import estimate_normals
from ..registration.factory import create_matcher
from ..registration.icp_fast import align_point_to_plane
from .frame import Frame
from .pose_extrapolator import PoseExtrapolator


@dataclasses.dataclass
class MotionFilterOptions:
    """front_end::Options::motion_filter (map_builder.h:79-83)."""

    translation_range: float = 0.35
    angle_range: float = 1.5       # degrees (sum of |euler|)
    time_range: float = 0.0


@dataclasses.dataclass
class FrontEndOptions:
    """front_end::Options (map_builder.h:68-91)."""

    motion_filter: MotionFilterOptions = dataclasses.field(
        default_factory=MotionFilterOptions)
    accumulate_cloud_num: int = 1
    motion_compensation: bool = True
    use_average: bool = True
    # matcher knobs (icp_fast.h:56-60)
    matcher_type: int = 6          # registrator::Type (interface.h:41-50)
    max_iteration: int = 100
    dist_outlier_ratio: float = 0.7
    # shape knobs
    scan_capacity: int = 32768
    target_leaf_size: int = 8
    nn_tile: int = 1024
    # chunked front end: gyro-driven rotation prediction in the scan step
    # (pose_extrapolator.cc:177-197)
    use_imu: bool = False


def _target_normals(pc: PointCloud, leaf_size: int):
    """compact + normal estimation of a scan or submap cloud: the ICP
    target."""
    return estimate_normals(pc.compact(), leaf_size=leaf_size)


def _frontend_align(pc: PointCloud, target, guess: torch.Tensor,
                    accum_inv: torch.Tensor, compensation: bool,
                    use_average: bool, dist_outlier_ratio: float,
                    max_iteration: int, tile: int):
    """The per-scan device work (map_builder.cc:311-354): motion-compensate
    by accum⁻¹·guess, align (the while-form ICP), optionally average with
    the guess, re-compensate the raw cloud by accum⁻¹·result.  Returns
    ``(T_align, score, source_out)`` on the device."""
    src = pc.motion_compensate(accum_inv @ guess) if compensation else pc
    T, score = align_point_to_plane(
        src, target, guess, dist_outlier_ratio=dist_outlier_ratio,
        max_iteration=max_iteration, tile=tile)
    if compensation and use_average:
        T = se3.average_transforms(torch.stack([T, guess]))
    if compensation:
        src = pc.motion_compensate(accum_inv @ T)
    return T, score, src


class FrontEnd:
    """Feed scans in time order via :meth:`process`; returns a new keyframe
    ``Frame`` when the motion filter fires, else None.  Clouds live on
    ``device`` (the GPU unless named); poses are host float64."""

    def __init__(self, options: FrontEndOptions = None,
                 filter_chain: Optional[Callable[[PointCloud],
                                                 PointCloud]] = None,
                 extrapolator: Optional[PoseExtrapolator] = None,
                 device=None):
        self.options = options or FrontEndOptions()
        self.device = resolve_device(device)
        self.filter_chain = filter_chain
        self.extrapolator = (extrapolator
                             or PoseExtrapolator.initial_simple_ctrv())
        self.pose_target = np.eye(4)
        self.accumulative = np.eye(4)
        self.target = None            # NormalCloud on the device
        self.got_first = False
        self.last_score = 1.0
        self.num_scans = 0
        # types 1, 3 and 5 go through the factory; type 6 keeps the
        # normals target and the fused per-scan function below
        self.matcher = (None if self.options.matcher_type == 6
                        else create_matcher(self.options.matcher_type))

    # ------------------------------------------------------------------
    def _prepare(self, points: np.ndarray) -> PointCloud:
        pc = cloud_lib.from_numpy(points, capacity=self.options.scan_capacity,
                                  device=self.device)
        if self.filter_chain is not None:
            pc = self.filter_chain(pc)
        return pc

    def _set_target(self, pc: PointCloud) -> None:
        # "scan match:target" block (map_builder.cc:316)
        with prof.block("scan match:target"):
            if self.matcher is None:
                self.target = _target_normals(
                    pc, leaf_size=self.options.target_leaf_size)
            else:
                self.target = pc.compact()
                self.matcher.set_input_target(self.target)

    def _device_pose(self, T: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.asarray(T, dtype=np.float32),
                               device=self.device)

    def process(self, stamp: float, points: np.ndarray) -> Optional[Frame]:
        # "FrontEndOneFrame" block (map_builder.cc:295)
        with prof.block("FrontEndOneFrame"):
            return self._process(stamp, points)

    def _process(self, stamp: float, points: np.ndarray) -> Optional[Frame]:
        opts = self.options
        self.num_scans += 1
        pc = self._prepare(points)

        if not self.got_first:
            self.got_first = True
            self._set_target(pc)
            self.extrapolator.add_pose(stamp, np.eye(4))
            self.pose_target = np.eye(4)
            return Frame(stamp=stamp, cloud=pc, global_pose=np.eye(4),
                         match_score=1.0)

        last_t = self.extrapolator.last_pose_time()
        if last_t is not None and stamp < last_t:
            # stale scan (map_builder.cc:296-301): resync target
            self._set_target(pc)
            return None

        pose_source = self.extrapolator.extrapolate_pose(stamp)
        guess = np_se3.normalize_rotation(
            np_se3.inverse(self.pose_target) @ pose_source)

        # "scan match:align" block (map_builder.cc:311-354)
        with prof.block("scan match:align"):
            accum_inv = np_se3.inverse(self.accumulative)
            if self.matcher is None:
                T_align, score, source = _frontend_align(
                    pc, self.target, self._device_pose(guess),
                    self._device_pose(accum_inv),
                    compensation=opts.motion_compensation,
                    use_average=opts.use_average,
                    dist_outlier_ratio=opts.dist_outlier_ratio,
                    max_iteration=opts.max_iteration, tile=opts.nn_tile)
            else:
                source = (pc.motion_compensate(
                    self._device_pose(accum_inv @ guess))
                    if opts.motion_compensation else pc)
                self.matcher.set_input_source(source)
                T_align, score = self.matcher.align(self._device_pose(guess))
            # T and score come back in one transfer: one sync per scan
            host = torch.cat([T_align.reshape(-1), score.reshape(1)]
                             ).cpu().double().numpy()
        align_result = np_se3.normalize_rotation(host[:16].reshape(4, 4))
        self.last_score = float(host[16])
        if self.matcher is not None and opts.motion_compensation:
            # average with the guess on the host in float64, then
            # re-compensate the raw scan by accum⁻¹·result
            if opts.use_average:
                align_result = np_se3.average_transforms(
                    [align_result, guess])
            source = pc.motion_compensate(
                self._device_pose(accum_inv @ align_result))

        pose_source = self.pose_target @ align_result
        self.accumulative = align_result
        self.extrapolator.add_pose(stamp, pose_source)

        # motion filter (map_builder.cc:369-392)
        accu_translation = np_se3.translation_norm(self.accumulative)
        accu_angles = np_se3.rotation_angles_abs_sum_deg(self.accumulative)
        mf = opts.motion_filter
        if (accu_translation >= mf.translation_range or
                (mf.angle_range > 1e-3 and accu_angles >= mf.angle_range)):
            frame = Frame(stamp=stamp, cloud=source,
                          global_pose=pose_source,
                          match_score=self.last_score)
            self.accumulative = np.eye(4)
            self._set_target(source)
            self.pose_target = pose_source
            return frame
        return None
