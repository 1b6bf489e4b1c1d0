"""Voxel-grid downsampling and per-voxel Gaussians by sort + segment sums —
the PyTorch counterpart of ``staticmapping_tpu.ops.voxel`` (reference:
pre_processors/filter_voxel_grid.cc:38-80; pclomp ``VoxelGridCovariance``).

Points are sorted lexicographically by their integer voxel index and each
run of equal keys is summed in point order (``scatter_reduce`` takes
maxima).  Every shape is static.  All functions take an optional leading
batch axis.
"""
from __future__ import annotations

import torch

from ..data.cloud import PointCloud, PAD_COORD

_INVALID_KEY = 2**31 - 1


def voxel_indices(xyz: torch.Tensor, voxel_size: float, mode: str = "round"):
    """Integer voxel index per point: ``'round'`` is ``std::lround(p/voxel)``
    (filter_voxel_grid.cc:47-49), ``'floor'`` the floor lattice, ``'trunc'``
    the reference's ``static_cast<int>`` (filter_ground_removal.cc:59-61)."""
    # a 0-dim tensor divisor keeps this a true f32 division on every device
    # (a Python-scalar divisor may become a multiply by its reciprocal,
    # which moves points that sit on a rounding boundary)
    scaled = xyz / torch.as_tensor(voxel_size, dtype=xyz.dtype,
                                   device=xyz.device)
    if mode == "round":
        idx = torch.round(scaled)
    elif mode == "floor":
        idx = torch.floor(scaled)
    elif mode == "trunc":
        idx = torch.trunc(scaled)
    else:
        raise ValueError(mode)
    return idx.to(torch.int32)


def _sort_by_voxel(keys: torch.Tensor, mask: torch.Tensor, payload: tuple):
    """Lexicographic stable sort by (kx, ky, kz) along the point axis;
    invalid points sort last.

    Three successive stable sorts, least significant key first, give the
    order of one stable 3-key sort exactly (the invalid key 2³¹−1 still
    sorts last).  Returns sorted keys ``[..., N, 3]``, sorted mask, sorted
    payload tuple and ``segment_id [..., N]`` (0-based, contiguous per
    row; invalid points share trailing segments the caller masks out).
    """
    k = torch.where(mask[..., None], keys, _INVALID_KEY)
    order = torch.arange(k.shape[-2], device=k.device).expand(mask.shape)
    for axis in (2, 1, 0):
        key = torch.gather(k[..., axis], -1, order)
        perm = torch.sort(key, dim=-1, stable=True).indices
        order = torch.gather(order, -1, perm)
    skeys = torch.gather(k, -2, order[..., None].expand(k.shape))
    smask = torch.gather(mask, -1, order)
    spayload = tuple(torch.gather(p, -1, order) for p in payload)
    change = (skeys[..., 1:, :] != skeys[..., :-1, :]).any(-1)
    new_seg = torch.cat([torch.ones_like(change[..., :1]), change], dim=-1)
    seg_id = torch.cumsum(new_seg.to(torch.int64), dim=-1) - 1
    return skeys, smask, spayload, seg_id


def _flat_segments(seg_id: torch.Tensor, n: int) -> torch.Tensor:
    """``seg_id [..., N]`` of each row offset by ``n`` per row, flat: the
    output slots of the per-row segment reductions."""
    rows = seg_id.reshape(-1, seg_id.shape[-1]).shape[0]
    return (seg_id.reshape(rows, -1)
            + n * torch.arange(rows, device=seg_id.device)[:, None]
            ).reshape(-1)


def _segment_sum(data: torch.Tensor, seg_id: torch.Tensor, n: int,
                 mask: torch.Tensor):
    """Per-row segment sums of the rows where ``mask`` holds: ``data [..., N,
    C]`` by ``seg_id [..., N]`` into ``[..., n, C]``, ``n >= N``.
    ``seg_id`` and ``mask`` come as :func:`_sort_by_voxel` gives them:
    ``seg_id`` non-decreasing along each row, the masked rows last.

    Each segment is summed from 0 in point order on every device, so the
    GPU's sums are the CPU's bit for bit: ``segment_reduce`` walks each
    (segment, column) of a 2-D input in one thread.  ``index_add_`` adds
    with atomics on the GPU, in a run-dependent order, which on NDT's
    raw-moment voxel Gaussians moves a trajectory by metres from run to
    run.  The masked rows, one long segment that a thread would walk alone
    (millions of rows in the MRVM), go each to its own slot past every
    valid segment's, its position, and add 0 there."""
    pos = torch.arange(seg_id.shape[-1], device=seg_id.device)
    flat_ids = _flat_segments(torch.where(mask, seg_id, pos), n)
    lengths = torch.zeros(flat_ids.numel() // seg_id.shape[-1] * n,
                          dtype=torch.int64, device=data.device)
    lengths.index_add_(0, flat_ids, torch.ones_like(flat_ids))
    src = torch.where(mask[..., None], data, 0.0)
    out = torch.segment_reduce(src.reshape(-1, data.shape[-1]), "sum",
                               lengths=lengths, axis=0, unsafe=True)
    return out.reshape(seg_id.shape[:-1] + (n,) + data.shape[-1:])


def _segment_max(data: torch.Tensor, seg_id: torch.Tensor, n: int,
                 fill) -> torch.Tensor:
    """Per-row segment maxima, laid out as :func:`_segment_sum`'s; a segment
    that no entry reaches holds ``fill`` (``jax.ops.segment_max`` leaves the
    identity of max there, the least value of the type)."""
    flat_ids = _flat_segments(seg_id, n)
    src = data.reshape(-1, data.shape[-1])
    out = torch.full((flat_ids.numel() // seg_id.shape[-1] * n,)
                     + data.shape[-1:], fill, dtype=data.dtype,
                     device=data.device)
    out.scatter_reduce_(0, flat_ids[:, None].expand(src.shape), src, "amax",
                        include_self=True)
    return out.reshape(seg_id.shape[:-1] + (n,) + data.shape[-1:])


def voxel_downsample(cloud: PointCloud, voxel_size,
                     mode: str = "round") -> PointCloud:
    """Replace each voxel's points by their centroid (x, y, z, intensity and
    factor averaged — filter_voxel_grid.cc get_average_point).  Output keeps
    the input capacity; occupied voxels fill slots 0..k-1 in key order."""
    n = cloud.capacity
    keys = voxel_indices(cloud.xyz, voxel_size, mode)
    _, smask, (sx, sy, sz, si, sf), seg_id = _sort_by_voxel(
        keys, cloud.mask,
        (cloud.xyz[..., 0], cloud.xyz[..., 1], cloud.xyz[..., 2],
         cloud.intensity, cloud.factor))
    vals = torch.stack([smask.to(torch.float32), sx, sy, sz, si, sf], dim=-1)
    sums = _segment_sum(vals, seg_id, n, smask)
    count = sums[..., 0]
    mean = sums[..., 1:] / count.clamp_min(1.0)[..., None]
    valid = count > 0
    xyz = torch.where(valid[..., None], mean[..., :3],
                      torch.full_like(mean[..., :3], PAD_COORD))
    return PointCloud(xyz=xyz, intensity=mean[..., 3] * valid,
                      factor=mean[..., 4] * valid, mask=valid)


def voxel_stats(cloud: PointCloud, voxel_size, mode: str = "round",
                origin=None):
    """Per-voxel Gaussian statistics (count, mean, covariance), the building
    block of NDT (pclomp ``VoxelGridCovariance``).

    ``origin`` (optional ``[3]``) shifts the lattice so indices are relative
    to it; the statistics are taken on the unshifted coordinates, and the
    covariance is the raw f32 second moment minus mean², as in the JAX
    package.  Returns a dict with one slot per input point: count [..., N],
    mean [..., N, 3], cov [..., N, 3, 3], valid [..., N] (count > 0) and
    voxel_key [..., N, 3] int32 (the lattice index of each occupied slot;
    an unoccupied slot holds the least int32)."""
    n = cloud.capacity
    xyz = cloud.xyz if origin is None else cloud.xyz - origin
    keys = voxel_indices(xyz, voxel_size, mode)
    skeys, smask, (sx, sy, sz), seg_id = _sort_by_voxel(
        keys, cloud.mask,
        (cloud.xyz[..., 0], cloud.xyz[..., 1], cloud.xyz[..., 2]))
    pts = torch.stack([sx, sy, sz], dim=-1)
    count = _segment_sum(smask.to(torch.float32)[..., None], seg_id, n,
                         smask)[..., 0]
    denom = count.clamp_min(1.0)
    mean = _segment_sum(pts, seg_id, n, smask) / denom[..., None]
    outer = pts[..., :, None] * pts[..., None, :]
    m2 = _segment_sum(outer.flatten(-2), seg_id, n,
                      smask).unflatten(-1, (3, 3))
    m2 = m2 / denom[..., None, None]
    cov = m2 - mean[..., :, None] * mean[..., None, :]
    # masked points already carry the invalid key from the sort
    return {"count": count, "mean": mean, "cov": cov, "valid": count > 0,
            "voxel_key": _segment_max(skeys, seg_id, n,
                                      torch.iinfo(torch.int32).min)}


def voxel_stats_floor(cloud: PointCloud, voxel_size, origin):
    """Floor-lattice voxel Gaussians anchored at ``origin``: pclomp's
    binning, leaf index = floor((p − min_bound) / leaf_size).  Consumed by
    :mod:`..registration.ndt`."""
    return voxel_stats(cloud, voxel_size, mode="floor", origin=origin)
