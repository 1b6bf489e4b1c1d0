"""Fixed-capacity masked point-cloud types — the PyTorch counterpart of
``staticmapping_tpu.data.cloud`` (reference: builder/data/cloud_types.h).

Clouds are padded tensors plus a validity mask, so every stage keeps a
static shape and tensors compare one to one with the JAX package:

  * ``xyz``       ``[..., N, 3] float32``  point coordinates
  * ``intensity`` ``[..., N]  float32``
  * ``factor``    ``[..., N]  float32``  per-point motion-compensation
                  factor in [0, 1) (``InnerPointType::factor``)
  * ``mask``      ``[..., N]  bool``     True for real points

Filters produce new masks rather than resizing.  Leading batch dims are
allowed on every field.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .. import resolve_device
from ..common import se3

# Padding coordinate pushed far away so padded points never match anything.
PAD_COORD = 1.0e6


def pad_capacity(n: int, multiple: int = 2048) -> int:
    """Round up to a capacity bucket."""
    if n <= 0:
        return multiple
    return ((n + multiple - 1) // multiple) * multiple


def _take(x: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    """Gather along the point axis of ``x`` (``[..., N]`` or ``[..., N, 3]``)
    by ``order [..., N]``."""
    if x.dim() == order.dim():
        return torch.gather(x, -1, order)
    return torch.gather(x, -2, order[..., None].expand(order.shape
                                                       + x.shape[-1:]))


def valid_first_order(mask: torch.Tensor) -> torch.Tensor:
    """Stable argsort of ``~mask`` along the last axis: valid slots first,
    each group in its original order.  The bool is cast to an integer
    because sorting bools is not supported on every device."""
    return torch.argsort((~mask).to(torch.uint8), dim=-1, stable=True)


@dataclasses.dataclass
class PointCloud:
    """Padded cloud. Leading batch dims are allowed on every field."""

    xyz: torch.Tensor        # [..., N, 3]
    intensity: torch.Tensor  # [..., N]
    factor: torch.Tensor     # [..., N]
    mask: torch.Tensor       # [..., N] bool

    @property
    def capacity(self) -> int:
        return self.xyz.shape[-2]

    @property
    def device(self) -> torch.device:
        return self.xyz.device

    def num_valid(self) -> torch.Tensor:
        return torch.sum(self.mask, dim=-1)

    def with_mask(self, mask: torch.Tensor) -> "PointCloud":
        return dataclasses.replace(self, mask=mask & self.mask)

    def transform(self, T: torch.Tensor) -> "PointCloud":
        """Rigid transform of all points (cloud_types.cc ApplyTransform)."""
        return dataclasses.replace(self, xyz=se3.apply(T, self.xyz))

    def motion_compensate(self, T: torch.Tensor) -> "PointCloud":
        """Per-point pose interpolation between identity and ``T`` by
        ``factor`` (cloud_types.cc:306-321 ApplyMotionCompensation — slerp
        rotation, lerp translation, per point)."""
        q = se3.matrix_to_quat(se3.rotation(T))
        qi = se3.quat_identity(q.dtype, q.device).expand(q.shape)
        f = self.factor[..., None]                      # [..., N, 1]
        q_per_point = se3.slerp(qi[..., None, :], q[..., None, :], f)
        t_per_point = se3.translation(T)[..., None, :] * f
        new_xyz = se3.quat_rotate(q_per_point, self.xyz) + t_per_point
        return dataclasses.replace(self, xyz=new_xyz)

    def masked_xyz(self, fill: float = PAD_COORD) -> torch.Tensor:
        """xyz with padded points moved to ``fill`` (so reductions/NN ignore
        them without extra masking)."""
        return torch.where(self.mask[..., None], self.xyz,
                           torch.full_like(self.xyz, fill))

    def centroid(self) -> torch.Tensor:
        n = torch.clamp_min(self.num_valid(), 1)
        s = torch.sum(torch.where(self.mask[..., None], self.xyz, 0.0),
                      dim=-2)
        return s / n[..., None]

    def compact(self) -> "PointCloud":
        """Stable-sort valid points to the front (keeps relative order, so
        the per-point ``factor`` time ordering survives)."""
        order = valid_first_order(self.mask)
        return PointCloud(xyz=_take(self.xyz, order),
                          intensity=_take(self.intensity, order),
                          factor=_take(self.factor, order),
                          mask=_take(self.mask, order))

    def slots(self, index) -> "PointCloud":
        """The same index applied to the point axis of every field (a slice
        such as ``slice(None, None, 4)``)."""
        return PointCloud(xyz=self.xyz[..., index, :],
                          intensity=self.intensity[..., index],
                          factor=self.factor[..., index],
                          mask=self.mask[..., index])

    def __getitem__(self, b) -> "PointCloud":
        """Batch element(s) ``b`` of a batched cloud."""
        return PointCloud(xyz=self.xyz[b], intensity=self.intensity[b],
                          factor=self.factor[b], mask=self.mask[b])


def stack(clouds, dim: int = 0) -> PointCloud:
    """Stack clouds of equal capacity along a new batch axis."""
    return PointCloud(
        xyz=torch.stack([c.xyz for c in clouds], dim),
        intensity=torch.stack([c.intensity for c in clouds], dim),
        factor=torch.stack([c.factor for c in clouds], dim),
        mask=torch.stack([c.mask for c in clouds], dim))


def from_numpy(points: np.ndarray,
               intensity: Optional[np.ndarray] = None,
               capacity: Optional[int] = None,
               stamp_factors: bool = True,
               device=None) -> PointCloud:
    """Build a padded ``PointCloud`` from host arrays on ``device`` (the GPU
    unless named).

    ``stamp_factors`` mirrors DataCollector accumulation: factor_i = i / N
    (data_collector.h:170-204)."""
    dev = resolve_device(device)
    points = np.asarray(points, dtype=np.float32)
    n = points.shape[0]
    cap = capacity if capacity is not None else pad_capacity(n)
    if n > cap:
        raise ValueError(f"cloud of {n} points exceeds capacity {cap}")
    xyz = np.full((cap, 3), PAD_COORD, dtype=np.float32)
    xyz[:n] = points[:, :3]
    inten = np.zeros((cap,), dtype=np.float32)
    if intensity is not None:
        inten[:n] = np.asarray(intensity, dtype=np.float32)[:n]
    elif points.shape[1] > 3:
        inten[:n] = points[:n, 3]
    factor = np.zeros((cap,), dtype=np.float32)
    if stamp_factors and n > 0:
        factor[:n] = np.arange(n, dtype=np.float32) / float(n)
    mask = np.zeros((cap,), dtype=bool)
    mask[:n] = True
    return PointCloud(xyz=torch.from_numpy(xyz).to(dev),
                      intensity=torch.from_numpy(inten).to(dev),
                      factor=torch.from_numpy(factor).to(dev),
                      mask=torch.from_numpy(mask).to(dev))


def to_numpy(cloud: PointCloud) -> np.ndarray:
    """Return ``[n_valid, 4]`` (x, y, z, intensity) on host."""
    mask = cloud.mask.cpu().numpy()
    xyz = cloud.xyz.cpu().numpy()[mask]
    inten = cloud.intensity.cpu().numpy()[mask]
    return np.concatenate([xyz, inten[:, None]], axis=1)


def empty(capacity: int, device=None) -> PointCloud:
    """A cloud of ``capacity`` padded slots on ``device`` (the GPU unless
    named)."""
    dev = resolve_device(device)
    return PointCloud(
        xyz=torch.full((capacity, 3), PAD_COORD, dtype=torch.float32,
                       device=dev),
        intensity=torch.zeros((capacity,), dtype=torch.float32, device=dev),
        factor=torch.zeros((capacity,), dtype=torch.float32, device=dev),
        mask=torch.zeros((capacity,), dtype=torch.bool, device=dev))


def concat(a: PointCloud, b: PointCloud,
           capacity: Optional[int] = None) -> PointCloud:
    """Concatenate along the point axis (then compact into ``capacity``)."""
    out = PointCloud(
        xyz=torch.cat([a.xyz, b.xyz], dim=-2),
        intensity=torch.cat([a.intensity, b.intensity], dim=-1),
        factor=torch.cat([a.factor, b.factor], dim=-1),
        mask=torch.cat([a.mask, b.mask], dim=-1),
    ).compact()
    if capacity is not None:
        out = out.slots(slice(None, capacity))
    return out


@dataclasses.dataclass
class NormalCloud:
    """Downsampled cloud with per-point normals — the output of the kd-split
    normal estimator (EigenPointCloud with normals, cloud_types.cc:347-368)."""

    xyz: torch.Tensor      # [..., M, 3]
    normals: torch.Tensor  # [..., M, 3]
    mask: torch.Tensor     # [..., M] bool

    @property
    def capacity(self) -> int:
        return self.xyz.shape[-2]

    def num_valid(self) -> torch.Tensor:
        return torch.sum(self.mask, dim=-1)

    def transform(self, T: torch.Tensor) -> "NormalCloud":
        return dataclasses.replace(
            self, xyz=se3.apply(T, self.xyz),
            normals=self.normals @ se3.rotation(T).transpose(-1, -2))

    def masked_xyz(self, fill: float = PAD_COORD) -> torch.Tensor:
        return torch.where(self.mask[..., None], self.xyz,
                           torch.full_like(self.xyz, fill))

    def __getitem__(self, b) -> "NormalCloud":
        return NormalCloud(xyz=self.xyz[b], normals=self.normals[b],
                           mask=self.mask[b])


def stack_normals(clouds, dim: int = 0) -> NormalCloud:
    """Stack normal clouds of equal capacity along a new batch axis."""
    return NormalCloud(xyz=torch.stack([c.xyz for c in clouds], dim),
                       normals=torch.stack([c.normals for c in clouds], dim),
                       mask=torch.stack([c.mask for c in clouds], dim))
