"""Plane detection and plane-aware random sampling — the PyTorch
counterpart of ``staticmapping_tpu.filters.plane_detector`` (reference:
pre_processors/plane_detector.h:43-171 and
random_sample_with_plane_detect.h:43-110):

  * voxelize at ``leaf_size``; voxels with ≥ ``min_point_num_in_voxel``
    points take part;
  * voxels at or below the sensor plane (z-index ≤ 0): all points are
    plane when the voxel's z-extent ≤ threshold (plane_detector.h:109-126);
  * voxels above: a plane fit with > 85% inliers at 0.1 m marks the
    inliers as plane (plane_detector.h:128-149).  Where the reference runs
    PCL RANSAC per voxel, the fit is a least-squares PCA plane, one
    batched ``torch.linalg.eigh`` over all voxels;
  * the sampler keeps plane points and samples the rest at
    ``sampling_rate`` (random_sample_with_plane_detect.h:80-105), its
    uniforms the JAX package's ``jax.random.uniform(jax.random.key(seed),
    mask.shape)`` bit for bit (``common/random.py``).
"""
from __future__ import annotations

import dataclasses
from typing import ClassVar, Dict, Tuple

import torch

from ..common import random
from ..data.cloud import PointCloud
from ..ops.voxel import _segment_max, _segment_sum, _sort_by_voxel
from .filters import Filter

_BIG = 1.0e9
# cuSOLVER's batched symmetric eigensolver refuses 32768 matrices or more a
# call (CUSOLVER_STATUS_INVALID_VALUE; torch 2.11, CUDA 12.8, H100), so the
# voxels go through ``torch.linalg.eigh`` in blocks of this many
_EIGH_BLOCK = 16384


def _plane_mask(xyz, mask, leaf_size: float, min_points: float,
                dist_threshold: float, ransac_dist: float,
                inlier_rate: float) -> torch.Tensor:
    f32 = torch.float32
    dev = xyz.device
    n = xyz.shape[0]
    key = torch.floor(xyz / torch.tensor(leaf_size, dtype=f32, device=dev)
                      ).to(torch.int32)
    # lexicographic (kx, ky, kz) order, invalid points last
    sk, pm, (sx, sy, sz, order), seg = _sort_by_voxel(
        key, mask, (xyz[:, 0], xyz[:, 1], xyz[:, 2],
                    torch.arange(n, device=dev)))
    pts = torch.stack([sx, sy, sz], dim=1)

    cnt = _segment_sum(pm.to(f32)[:, None], seg, n, pm)[:, 0]
    denom = cnt.clamp_min(1.0)
    mean = _segment_sum(pts, seg, n, pm) / denom[:, None]
    d = pts - mean[seg]
    cov = (_segment_sum((d[:, :, None] * d[:, None, :]).flatten(1), seg, n,
                        pm)
           .unflatten(1, (3, 3)) / denom[:, None, None])
    zmax, neg_zmin = _segment_max(
        torch.stack([torch.where(pm, pts[:, 2], -_BIG),
                     torch.where(pm, -pts[:, 2], -_BIG)], 1),
        seg, n, -_BIG).unbind(1)

    # smallest-eigenvector normal per voxel (batched PCA)
    normal = torch.cat([torch.linalg.eigh(c).eigenvectors[:, :, 0]
                        for c in cov.split(_EIGH_BLOCK)])      # [N, 3]

    # per-point residual to its voxel plane
    resid = torch.abs(torch.sum(d * normal[seg], dim=1))
    inl = (resid <= ransac_dist) & pm
    inl_cnt = _segment_sum(inl.to(f32)[:, None], seg, n, pm)[:, 0]
    voxel_inlier_rate = inl_cnt / denom

    enough = cnt[seg] >= min_points
    low = sk[:, 2] <= 0
    flat = (zmax[seg] + neg_zmin[seg]) <= dist_threshold
    plane_low = low & flat & enough & pm
    plane_high = ((~low) & (cnt[seg] >= 2 * min_points)
                  & (voxel_inlier_rate[seg] > inlier_rate) & inl & pm)
    out = torch.zeros(n, dtype=torch.bool, device=dev)
    out[order] = plane_low | plane_high
    return out


@dataclasses.dataclass
class PlaneDetector:
    """Detect(ground_indices) role (plane_detector.h:92-155)."""

    leaf_size: float = 0.8
    min_point_num_in_voxel: int = 10
    distance_threshold: float = 0.2
    ransac_distance: float = 0.1
    inlier_rate: float = 0.85

    def plane_mask(self, cloud: PointCloud) -> torch.Tensor:
        return _plane_mask(cloud.xyz, cloud.mask, self.leaf_size,
                           float(self.min_point_num_in_voxel),
                           self.distance_threshold, self.ransac_distance,
                           self.inlier_rate)


@dataclasses.dataclass
class RandomSampleWithPlaneDetectFilter(Filter):
    """Keep plane points, sample the rest at ``sampling_rate``
    (random_sample_with_plane_detect.h:80-105)."""

    sampling_rate: float = 1.0
    ground_height_threshold: float = 0.2
    leaf_size: float = 0.8
    min_point_num_in_voxel: int = 10
    seed: int = 0

    NAME: ClassVar[str] = "RandomSamplerWithPlaneDetect"
    PARAMS: ClassVar[Dict[str, Tuple[str, type]]] = {
        "sampling_rate": ("sampling_rate", float),
        "ground_height_threshold": ("ground_height_threshold", float),
        "leaf_size": ("leaf_size", float),
        "min_point_num_in_voxel": ("min_point_num_in_voxel", int),
    }

    def configs_valid(self) -> bool:
        return 1e-6 <= self.sampling_rate <= 1.0 and self.leaf_size > 0

    def __call__(self, cloud: PointCloud) -> PointCloud:
        if self.sampling_rate > 0.999999:
            return cloud
        det = PlaneDetector(
            leaf_size=self.leaf_size,
            min_point_num_in_voxel=self.min_point_num_in_voxel,
            distance_threshold=self.ground_height_threshold)
        plane = det.plane_mask(cloud)
        u = random.uniform(self.seed, cloud.mask.shape,
                           cloud.mask.device)
        return cloud.with_mask(plane | (u < self.sampling_rate))
