"""Spatial-split normal estimation + surface-aware downsampling — the
PyTorch counterpart of ``staticmapping_tpu.ops.normals``.

The reference (builder/data/cloud_types.cc:73-144) recursively median-splits
the cloud along its widest dimension down to leaves of <= 7 points, then per
leaf computes one representative point (the mean) whose normal solves the
unconstrained least squares ``(Σ d dᵀ) n = Σ d``.  Two groupings, as in the
JAX package:

* ``kdsplit`` (default): the recursion as ``log2`` rounds of segment-wise
  stable sorts (one ``torch.sort`` along the segment axis per round).
* ``morton``: one stable sort by a 30-bit Morton code of the points
  quantized into a 1024³ lattice over their bounding box; leaves are
  consecutive Z-order runs.  Cheaper, but a run can mix surfaces, so the
  JAX package keeps it off every path where normal quality matters.

Either way the leaf solves are one batched closed-form 3×3 solve.  Every
function takes an optional leading batch axis.
"""
from __future__ import annotations

import math

import torch

from ..data.cloud import PointCloud, NormalCloud, PAD_COORD

_INF = float("inf")
_MORTON_BITS = 10  # 10 bits/axis → 30-bit code
_MORTON_INVALID = 0x7FFFFFFF  # invalid points sort to the end


def _morton_interleave(q: torch.Tensor) -> torch.Tensor:
    """``[..., 3]`` int32 in [0, 1024) → ``[...]`` int32 Morton code
    (bit-interleaved x, y, z), with the JAX package's magic masks."""
    def spread(v):
        # spread 10 bits to every 3rd position
        v = (v | (v << 16)) & 0x030000FF
        v = (v | (v << 8)) & 0x0300F00F
        v = (v | (v << 4)) & 0x030C30C3
        v = (v | (v << 2)) & 0x09249249
        return v

    return (spread(q[..., 0]) | (spread(q[..., 1]) << 1)
            | (spread(q[..., 2]) << 2))


def morton_keys(cloud: PointCloud) -> torch.Tensor:
    """``[..., N]`` int32 Morton key of every slot: valid points quantized
    into a 1024³ lattice over their bounding box in f32 (truncating, as
    ``astype(int32)`` does), invalid slots ``0x7FFFFFFF``."""
    xyz, mask = cloud.xyz, cloud.mask
    lo = torch.amin(torch.where(mask[..., None], xyz, _INF), dim=-2)
    hi = torch.amax(torch.where(mask[..., None], xyz, -_INF), dim=-2)
    lo = torch.where(torch.isfinite(lo), lo, 0.0)
    hi = torch.where(torch.isfinite(hi), hi, 1.0)
    top = (1 << _MORTON_BITS) - 1
    span = torch.clamp_min(hi - lo, 1e-6)
    # a tensor quotient: ``top / span`` is reciprocal-then-multiply in
    # torch, which rounds some keys one step lower than the JAX package
    scale = torch.full_like(span, top) / span
    q = torch.clamp(((xyz - lo[..., None, :]) * scale[..., None, :])
                    .to(torch.int32), 0, top)
    key = _morton_interleave(q)
    return torch.where(mask, key, torch.full_like(key, _MORTON_INVALID))


def _sym3_eigvals(A: torch.Tensor) -> torch.Tensor:
    """Closed-form eigenvalues of batched symmetric 3×3 matrices, descending
    ``[..., 3]`` (Cardano trigonometric form)."""
    a00, a11, a22 = A[..., 0, 0], A[..., 1, 1], A[..., 2, 2]
    a01, a02, a12 = A[..., 0, 1], A[..., 0, 2], A[..., 1, 2]
    q = (a00 + a11 + a22) / 3.0
    p1 = a01 * a01 + a02 * a02 + a12 * a12
    p2 = ((a00 - q) ** 2 + (a11 - q) ** 2 + (a22 - q) ** 2 + 2.0 * p1)
    p = torch.sqrt(torch.clamp_min(p2 / 6.0, 1e-30))
    b00, b11, b22 = (a00 - q) / p, (a11 - q) / p, (a22 - q) / p
    b01, b02, b12 = a01 / p, a02 / p, a12 / p
    detB = (b00 * (b11 * b22 - b12 * b12)
            - b01 * (b01 * b22 - b12 * b02)
            + b02 * (b01 * b12 - b11 * b02))
    r = torch.clamp(detB / 2.0, -1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    e1 = q + 2.0 * p * torch.cos(phi)
    e3 = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    e2 = 3.0 * q - e1 - e3
    iso = p2 < 1e-24                 # near-isotropic: all eigenvalues = q
    e1 = torch.where(iso, q, e1)
    e2 = torch.where(iso, q, e2)
    e3 = torch.where(iso, q, e3)
    return torch.stack([e1, e2, e3], dim=-1)


def smallest_eigvec3(A: torch.Tensor) -> torch.Tensor:
    """Unit eigenvector of the smallest eigenvalue of batched symmetric 3×3
    matrices ``[..., 3, 3] → [..., 3]``: the best-conditioned cross product
    of two rows of ``A − λ₃I``."""
    lam3 = _sym3_eigvals(A)[..., 2]
    B = A - lam3[..., None, None] * torch.eye(3, dtype=A.dtype,
                                              device=A.device)
    r0, r1, r2 = B[..., 0, :], B[..., 1, :], B[..., 2, :]
    stack = torch.stack([torch.linalg.cross(r0, r1, dim=-1),
                         torch.linalg.cross(r0, r2, dim=-1),
                         torch.linalg.cross(r1, r2, dim=-1)], dim=-2)
    norms = torch.sum(stack * stack, dim=-1)               # [..., 3]
    best = torch.argmax(norms, dim=-1)
    v = torch.gather(stack, -2,
                     best[..., None, None].expand(best.shape + (1, 3)))[..., 0, :]
    nrm = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    fallback = v.new_tensor([0.0, 0.0, 1.0]).expand(v.shape)
    return torch.where(nrm > 1e-20, v / torch.clamp_min(nrm, 1e-20), fallback)


def _solve3(A: torch.Tensor, b: torch.Tensor):
    """Batched 3×3 solve by adjugate/Cramer. Returns (x, det)."""
    a00, a01, a02 = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    a10, a11, a12 = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    a20, a21, a22 = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    c00 = a11 * a22 - a12 * a21
    c01 = a12 * a20 - a10 * a22
    c02 = a10 * a21 - a11 * a20
    det = a00 * c00 + a01 * c01 + a02 * c02
    inv_det = 1.0 / torch.where(torch.abs(det) > 1e-30, det,
                                torch.ones_like(det))
    c10 = a02 * a21 - a01 * a22
    c11 = a00 * a22 - a02 * a20
    c12 = a01 * a20 - a00 * a21
    c20 = a01 * a12 - a02 * a11
    c21 = a02 * a10 - a00 * a12
    c22 = a00 * a11 - a01 * a10
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    x0 = (c00 * b0 + c10 * b1 + c20 * b2) * inv_det
    x1 = (c01 * b0 + c11 * b1 + c21 * b2) * inv_det
    x2 = (c02 * b0 + c12 * b1 + c22 * b2) * inv_det
    return torch.stack([x0, x1, x2], dim=-1), det


def _leaf_normals(x, y, z, mask, leaf_size: int) -> NormalCloud:
    """Per-leaf mean + unconstrained-LS normal (cloud_types.cc:73-103) over
    consecutive runs of ``leaf_size`` slots of ``[..., N]`` coordinates."""
    lead = x.shape[:-1]
    m_leaves = x.shape[-1] // leaf_size
    pts = torch.stack([x, y, z], dim=-1).reshape(lead + (m_leaves,
                                                         leaf_size, 3))
    lm = mask.reshape(lead + (m_leaves, leaf_size))
    w = lm.to(torch.float32)[..., None]                   # [..., M, L, 1]
    count = torch.sum(lm, dim=-1)                         # [..., M]
    denom = count.clamp_min(1)[..., None].to(torch.float32)

    d = pts * w                                           # zero out invalid
    b_wave = torch.sum(d, dim=-2)                         # [..., M, 3]
    mean = b_wave / denom
    # raw, uncentered Σ d dᵀ over valid points (reference parity)
    M_wave = d.transpose(-1, -2) @ (pts * w)              # [..., M, 3, 3]
    # rank >= 2 check on the centered covariance (cloud_types.cc:86-91) via
    # the second invariant I2 = Σ 2×2 principal minors
    centered = (pts - mean[..., None, :]) * w
    C = centered.transpose(-1, -2) @ centered
    c00, c11, c22 = C[..., 0, 0], C[..., 1, 1], C[..., 2, 2]
    c01, c02, c12 = C[..., 0, 1], C[..., 0, 2], C[..., 1, 2]
    i2 = ((c00 * c11 - c01 * c01) + (c00 * c22 - c02 * c02)
          + (c11 * c22 - c12 * c12))
    tr = c00 + c11 + c22
    rank_ok = i2 > 1e-5 * torch.clamp_min(tr * tr, 1e-20)

    # Jacobi-preconditioned 3×3 Cramer solve in f32
    diag = torch.diagonal(M_wave, dim1=-2, dim2=-1)
    s = 1.0 / torch.sqrt(torch.clamp_min(diag, 1e-12))
    A = M_wave * s[..., :, None] * s[..., None, :]
    A = A + 1e-7 * torch.eye(3, dtype=A.dtype, device=A.device)
    sol, det = _solve3(A, b_wave * s)
    sol = sol * s
    norm = torch.linalg.vector_norm(sol, dim=-1, keepdim=True)
    normal = sol / torch.clamp_min(norm, 1e-12)

    valid = ((count >= 3) & rank_ok & (torch.abs(det) > 1e-30)
             & torch.isfinite(normal).all(dim=-1))
    out_xyz = torch.where(valid[..., None], mean,
                          torch.full_like(mean, PAD_COORD))
    out_normal = torch.where(valid[..., None], normal, 0.0)
    return NormalCloud(xyz=out_xyz, normals=out_normal, mask=valid)


def estimate_normals(cloud: PointCloud, leaf_size: int = 8,
                     method: str = "kdsplit") -> NormalCloud:
    """Split-to-leaves normal estimation.

    Args:
      cloud: ``[..., N]`` with ``N`` a multiple of ``leaf_size`` (and a
        power of two for ``kdsplit``).
      leaf_size: points per leaf (a power of two; the reference stops at
        <= 7, cloud_types.cc:111-115).
      method: ``'kdsplit'`` (median splits along the widest valid dimension
        of every segment) or ``'morton'`` (one stable sort by Morton key).
    Returns:
      NormalCloud of capacity ``N / leaf_size``: per-leaf mean point + unit
      normal; leaves with < 3 valid points or rank < 2 are masked out.
    """
    n = cloud.capacity
    if leaf_size & (leaf_size - 1) or leaf_size < 2:
        raise ValueError("leaf_size must be a power of two >= 2")
    if n % leaf_size:
        raise ValueError(f"capacity {n} not a multiple of leaf {leaf_size}")
    if method == "morton":
        perm = torch.sort(morton_keys(cloud), dim=-1, stable=True).indices
        xyz = torch.gather(cloud.xyz, -2,
                           perm[..., None].expand(cloud.xyz.shape))
        return _leaf_normals(xyz[..., 0], xyz[..., 1], xyz[..., 2],
                             torch.gather(cloud.mask, -1, perm), leaf_size)
    if method != "kdsplit":
        raise ValueError(f"unknown method {method!r}")
    if n & (n - 1):
        raise ValueError(f"capacity {n} must be a power of two for kdsplit")

    c = cloud.compact()
    lead = c.mask.shape[:-1]
    x, y, z, mask = c.xyz[..., 0], c.xyz[..., 1], c.xyz[..., 2], c.mask

    seg = 1
    while n // seg > leaf_size:
        L = n // seg
        shape = lead + (seg, L)
        stack = torch.stack([x.reshape(shape), y.reshape(shape),
                             z.reshape(shape)], dim=-2)   # [..., S, 3, L]
        ms = mask.reshape(shape)
        big = torch.where(ms[..., None, :], stack, -_INF)
        small = torch.where(ms[..., None, :], stack, _INF)
        extent = torch.amax(big, dim=-1) - torch.amin(small, dim=-1)
        extent = torch.where(torch.isfinite(extent), extent, 0.0)
        cut_dim = torch.argmax(extent, dim=-1)            # [..., S]
        cut_vals = torch.gather(
            stack, -2, cut_dim[..., None, None].expand(shape[:-1] + (1, L))
        )[..., 0, :]                                      # [..., S, L]
        keys = torch.where(ms, cut_vals, _INF)  # invalid sorts to the end
        perm = torch.sort(keys, dim=-1, stable=True).indices
        stack = torch.gather(stack, -1,
                             perm[..., None, :].expand(stack.shape))
        ms = torch.gather(ms, -1, perm)
        flat = lead + (n,)
        x, y, z = (stack[..., 0, :].reshape(flat),
                   stack[..., 1, :].reshape(flat),
                   stack[..., 2, :].reshape(flat))
        mask = ms.reshape(flat)
        seg *= 2

    return _leaf_normals(x, y, z, mask, leaf_size)
