"""Point-cloud pre-processing filters — the PyTorch counterpart of
``staticmapping_tpu.filters.filters`` (reference: pre_processors/,
registry filter_factory.cc:43-52).

Each filter is a configured callable ``PointCloud → PointCloud``; point
removal clears mask bits (VoxelGrid replaces the points by voxel
centroids), so chains keep a fixed shape.  Parameter names match the
reference XML names.  The three large pre-processors (GroundRemoval2,
RangeImage, RandomSamplerWithPlaneDetect) live in their own modules and are
registered by the package's ``__init__``.
"""
from __future__ import annotations

import dataclasses
from typing import ClassVar, Dict, Tuple

import torch

from ..common import random
from ..data.cloud import PointCloud
from ..ops import nn_search, voxel as voxel_ops


class Filter:
    """Base: subclasses define PARAMS {xml_name: (py_field, type)} and
    implement __call__(cloud) -> cloud."""

    NAME: ClassVar[str] = ""
    PARAMS: ClassVar[Dict[str, Tuple[str, type]]] = {}

    def configs_valid(self) -> bool:
        return True

    def __call__(self, cloud: PointCloud) -> PointCloud:  # pragma: no cover
        raise NotImplementedError


@dataclasses.dataclass
class RangeFilter(Filter):
    """Keep points with min_range <= |p| <= max_range
    (pre_processors/filter_range.cc:59-66)."""

    min_range: float = 0.0
    max_range: float = 3.4e38

    NAME = "Range"
    PARAMS = {"min_range": ("min_range", float),
              "max_range": ("max_range", float)}

    def configs_valid(self) -> bool:
        return 0.0 <= self.min_range < self.max_range

    def __call__(self, cloud: PointCloud) -> PointCloud:
        r = torch.linalg.vector_norm(cloud.xyz, dim=-1)
        return cloud.with_mask((r >= self.min_range) & (r <= self.max_range))


@dataclasses.dataclass
class AxisRangeFilter(Filter):
    """Keep points with axis value in [min, max]
    (pre_processors/filter_axis_range.h:37,56-60; axis x:0 y:1 z:2)."""

    min: float = -3.4e38
    max: float = 3.4e38
    axis_index: int = 2

    NAME = "AxisRange"
    PARAMS = {"min": ("min", float), "max": ("max", float),
              "axis_index": ("axis_index", int)}

    def configs_valid(self) -> bool:
        return self.axis_index in (0, 1, 2) and self.min < self.max

    def __call__(self, cloud: PointCloud) -> PointCloud:
        v = cloud.xyz[..., self.axis_index]
        return cloud.with_mask((v >= self.min) & (v <= self.max))


@dataclasses.dataclass
class BoundingBoxRemovalFilter(Filter):
    """Remove points inside the axis-aligned box (e.g. the ego vehicle)
    (pre_processors/filter_bounding_box.h:53-58)."""

    min_x: float = -3.4e38
    min_y: float = -3.4e38
    min_z: float = -3.4e38
    max_x: float = 3.4e38
    max_y: float = 3.4e38
    max_z: float = 3.4e38

    NAME = "BoundingBoxRemoval"
    PARAMS = {n: (n, float)
              for n in ("min_x", "min_y", "min_z", "max_x", "max_y", "max_z")}

    def configs_valid(self) -> bool:
        return (self.min_x < self.max_x and self.min_y < self.max_y
                and self.min_z < self.max_z)

    def __call__(self, cloud: PointCloud) -> PointCloud:
        x, y, z = cloud.xyz[..., 0], cloud.xyz[..., 1], cloud.xyz[..., 2]
        inside = ((x >= self.min_x) & (x <= self.max_x)
                  & (y >= self.min_y) & (y <= self.max_y)
                  & (z >= self.min_z) & (z <= self.max_z))
        return cloud.with_mask(~inside)


@dataclasses.dataclass
class RandomSamplerFilter(Filter):
    """Keep each point with probability sampling_rate
    (pre_processors/filter_random_sample.h:53).  Deterministic per seed:
    the uniforms are the JAX package's ``jax.random.uniform(
    jax.random.key(seed), mask.shape)`` bit for bit (``common/random.py``),
    so the same points go."""

    sampling_rate: float = 1.0
    seed: int = 0

    NAME = "RandomSampler"
    PARAMS = {"sampling_rate": ("sampling_rate", float)}

    def configs_valid(self) -> bool:
        return 0.0 < self.sampling_rate <= 1.0

    def __call__(self, cloud: PointCloud) -> PointCloud:
        u = random.uniform(self.seed, cloud.mask.shape,
                           cloud.mask.device)
        return cloud.with_mask(u < self.sampling_rate)


@dataclasses.dataclass
class VoxelGridFilter(Filter):
    """Centroid per voxel; voxel index is lround(p / voxel_size)
    (pre_processors/filter_voxel_grid.cc:38-80)."""

    voxel_size: float = 0.1

    NAME = "VoxelGrid"
    PARAMS = {"voxel_size": ("voxel_size", float)}

    def configs_valid(self) -> bool:
        return self.voxel_size > 1.0e-6

    def __call__(self, cloud: PointCloud) -> PointCloud:
        return voxel_ops.voxel_downsample(cloud, self.voxel_size, mode="round")


@dataclasses.dataclass
class StatisticRemovalFilter(Filter):
    """Statistical outlier removal: per-point mean distance to its
    ``point_num_meank`` nearest neighbours; points whose mean distance
    exceeds global_mean + std_mul · global_std go (PCL semantics; the
    reference wraps pcl::StatisticalOutlierRemoval,
    filter_statistic_removal.h:49-50)."""

    point_num_meank: int = 10
    std_mul: float = 1.0
    tile: int = 1024

    NAME = "StatisticRemoval"
    PARAMS = {"point_num_meank": ("point_num_meank", int),
              "std_mul": ("std_mul", float)}

    def configs_valid(self) -> bool:
        return self.point_num_meank > 0 and self.std_mul > 0

    def __call__(self, cloud: PointCloud) -> PointCloud:
        # k + 1: a point is its own nearest neighbour, at distance 0
        d2, _ = nn_search.knn(cloud.xyz, cloud.xyz, cloud.mask,
                              k=self.point_num_meank + 1, tile=self.tile)
        mean_d = torch.mean(torch.sqrt(torch.clamp_min(d2[:, 1:], 0.0)),
                            dim=1)
        valid = cloud.mask
        n = torch.sum(valid).clamp_min(1)
        g_mean = torch.sum(torch.where(valid, mean_d, 0.0)) / n
        g_var = torch.sum(torch.where(valid, (mean_d - g_mean) ** 2,
                                      0.0)) / n
        thresh = g_mean + self.std_mul * torch.sqrt(g_var)
        return cloud.with_mask(mean_d <= thresh)


@dataclasses.dataclass
class GroundRemovalFilter(Filter):
    """Voxel height-histogram ground removal
    (pre_processors/filter_ground_removal.cc:47-105): bucket points into
    ``leaf_size`` voxels (truncating index cast); voxels with fewer than
    ``min_point_num_in_voxel`` points go entirely; voxels with z-index
    <= 0 whose z-extent <= height_threshold are ground and go."""

    min_point_num_in_voxel: int = 10
    leaf_size: float = 0.5
    height_threshold: float = 0.1

    NAME = "GroundRemoval"
    PARAMS = {"min_point_num_in_voxel": ("min_point_num_in_voxel", int),
              "leaf_size": ("leaf_size", float),
              "height_threshold": ("height_threshold", float)}

    def configs_valid(self) -> bool:
        return (self.min_point_num_in_voxel > 0 and self.leaf_size > 0
                and self.height_threshold > 0)

    def __call__(self, cloud: PointCloud) -> PointCloud:
        n = cloud.capacity
        keys = voxel_ops.voxel_indices(cloud.xyz, self.leaf_size,
                                       mode="trunc")
        point_idx = torch.arange(n, device=cloud.device)
        _, smask, (sz, skz, sidx), seg_id = voxel_ops._sort_by_voxel(
            keys, cloud.mask,
            (cloud.xyz[:, 2], keys[:, 2].to(torch.float32), point_idx))
        inf = torch.tensor(float("inf"), device=cloud.device)
        count = voxel_ops._segment_sum(smask.to(torch.float32)[:, None],
                                       seg_id, n, smask)[:, 0]
        # per voxel: z max, −(z min), and its z-index, all maxima
        per_point = torch.stack([torch.where(smask, sz, -inf),
                                 torch.where(smask, -sz, -inf),
                                 torch.where(smask, skz, -2.0 ** 30)], -1)
        zmax, neg_zmin, z_index = voxel_ops._segment_max(
            per_point, seg_id, n, -float("inf")).unbind(-1)
        delta = zmax + neg_zmin
        is_ground = ((z_index <= 0) & (delta >= 0)
                     & (delta <= self.height_threshold))
        voxel_keep = (count >= self.min_point_num_in_voxel) & ~is_ground
        keep_sorted = voxel_keep[seg_id] & smask
        # decisions back to the points' own order
        keep = torch.zeros(n, dtype=torch.bool, device=cloud.device)
        keep[sidx] = keep_sorted
        return cloud.with_mask(keep)


# ---------------------------------------------------------------------------
# factory — name registry of filter_factory.cc:43-52
# ---------------------------------------------------------------------------

# the large pre-processors live in modules of their own, which import
# Filter from here
from .ground_removal2 import GroundRemoval2Filter  # noqa: E402
from .plane_detector import RandomSampleWithPlaneDetectFilter  # noqa: E402
from .range_image import RangeImageFilter  # noqa: E402

FILTER_REGISTRY: Dict[str, type] = {
    c.NAME: c
    for c in (RangeFilter, AxisRangeFilter, BoundingBoxRemovalFilter,
              RandomSamplerFilter, VoxelGridFilter, StatisticRemovalFilter,
              GroundRemovalFilter, GroundRemoval2Filter, RangeImageFilter,
              RandomSampleWithPlaneDetectFilter)
}


def create_filter(name: str, params: dict | None = None) -> Filter:
    """Instantiate a filter by its reference XML name with reference param
    names (filter_factory.cc:63-80)."""
    if name not in FILTER_REGISTRY:
        raise KeyError(f"unknown filter: {name!r}; "
                       f"known: {sorted(FILTER_REGISTRY)}")
    cls = FILTER_REGISTRY[name]
    kwargs = {}
    for xml_name, value in (params or {}).items():
        if xml_name not in cls.PARAMS:
            raise KeyError(f"filter {name!r} has no param {xml_name!r}")
        field, typ = cls.PARAMS[xml_name]
        kwargs[field] = typ(value)
    f = cls(**kwargs)
    if not f.configs_valid():
        raise ValueError(f"invalid config for filter {name!r}: {f}")
    return f


@dataclasses.dataclass
class FilterChain:
    """Ordered filter chain (filter_factory.cc:84-107)."""

    filters: list

    def __call__(self, cloud: PointCloud) -> PointCloud:
        for f in self.filters:
            cloud = f(cloud)
        return cloud
