"""M2DP global cloud descriptor for loop detection — the PyTorch counterpart
of ``staticmapping_tpu.descriptor.m2dp`` (reference: descriptor/m2dp.{h,cc};
He et al., "M2DP: A Novel 3D Point Cloud Descriptor and Its Application in
Loop Closure Detection").

Pipeline (m2dp.cc:45-148):
  1. PCA-align the cloud (center, rotate into the principal axes), each axis
     signed so the projections have positive skew;
  2. drop points beyond ``max_distance``;
  3. for p×q view directions m(θ,φ): project the points onto the plane ⊥ m
     and histogram them into l×t polar bins, with the reference's |p·axis|
     for both plane coordinates (m2dp.cc:100-103);
  4. stack the rows into the signature A [p·q, l·t]; SVD; descriptor =
     [u1; v1], signed so that v1 sums to ≥ 0;
  5. match score = |Pearson correlation| (m2dp.cc:151-169).

All views are binned by one scatter-add of integer counts, so A is exact in
f32; the SVD is one small [64, 512] decomposition.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..data.cloud import PointCloud

# defaults: m2dp.h:48-49
R_BIN = 0.1
MAX_DISTANCE = 100.0
T_BINS = 16
P_VIEWS = 4
Q_VIEWS = 16


@functools.lru_cache(maxsize=None)
def _view_axes(p_views: int, q_views: int):
    """Per-view projection axes (host, float32)."""
    theta_step = np.pi / p_views
    phi_step = (np.pi / 2) / q_views
    axes_x, axes_y = [], []
    for p in range(p_views):
        for q in range(q_views):
            theta, phi = p * theta_step, q * phi_step
            m = np.array([np.cos(theta) * np.cos(phi),
                          np.cos(theta) * np.sin(phi),
                          np.sin(theta)])
            # projected_x_axis = x̂ − |x̂·m|·m  (m2dp.cc:79-82)
            px = np.array([1.0, 0, 0]) - abs(m[0]) * m
            axes_x.append(px)
            axes_y.append(np.cross(m, px))
    return (np.stack(axes_x).astype(np.float32),
            np.stack(axes_y).astype(np.float32))


def pca_align(cloud: PointCloud) -> torch.Tensor:
    """The valid points centred and rotated into their principal axes
    (m2dp.cc preProcess), ``[N, 3]``; padding rows are 0."""
    xyz, mask = cloud.xyz, cloud.mask
    n_valid = torch.sum(mask).clamp_min(1)
    mean = torch.sum(torch.where(mask[:, None], xyz, 0.0), dim=0) / n_valid
    centered = torch.where(mask[:, None], xyz - mean, 0.0)
    cov = (centered.T @ centered) / n_valid
    _, eigvecs = torch.linalg.eigh(cov)          # ascending
    E = eigvecs.flip(-1)                         # descending, as PCL's PCA
    # deterministic sign: positive skew of the projections
    proj = centered @ E
    skew = torch.sum(torch.where(mask[:, None], proj ** 3, 0.0), dim=0)
    E = E * torch.where(skew < 0, -1.0, 1.0)[None, :]
    return centered @ E


def signature(cloud: PointCloud, r: float = R_BIN,
              max_distance: float = MAX_DISTANCE, t: int = T_BINS,
              p: int = P_VIEWS, q: int = Q_VIEWS) -> torch.Tensor:
    """The signature matrix A ``[p*q, l*t]``: per view, the count of points
    in each polar bin."""
    return histogram(pca_align(cloud), cloud.mask, r, max_distance, t, p, q)


def histogram(pts: torch.Tensor, mask: torch.Tensor, r: float = R_BIN,
              max_distance: float = MAX_DISTANCE, t: int = T_BINS,
              p: int = P_VIEWS, q: int = Q_VIEWS) -> torch.Tensor:
    """A of PCA-aligned points ``pts [N, 3]``: every view's polar bins
    filled by one scatter-add of the points within ``max_distance``."""
    l = int(np.ceil(np.sqrt(max_distance / r)))
    n_views, n_bins = p * q, l * t
    keep = mask & (torch.linalg.vector_norm(pts, dim=1) <= max_distance)
    ax, ay = (torch.from_numpy(a).to(pts.device) for a in _view_axes(p, q))
    # [V, N] plane coordinates; the reference takes abs of both
    u = torch.abs(ax @ pts.T)
    v = torch.abs(ay @ pts.T)
    length = torch.sqrt(u * u + v * v)
    angle = torch.atan2(v, u)                    # ∈ [0, π/2]: abs coords
    angle = torch.where(angle < 0, angle + 2 * np.pi, angle)
    l_index = torch.floor(torch.sqrt(length / r)).to(torch.int64).clamp(0, l - 1)
    t_index = torch.floor(angle / (2 * np.pi / t)).to(torch.int64).clamp(0, t - 1)
    view = torch.arange(n_views, device=pts.device)[:, None]
    flat = (view * n_bins + l_index * t + t_index).reshape(-1)
    w = keep[None, :].expand(n_views, -1).reshape(-1).to(torch.float32)
    A = torch.zeros(n_views * n_bins, dtype=torch.float32, device=pts.device)
    return A.index_add_(0, flat, w).reshape(n_views, n_bins)


def compute_descriptor(cloud: PointCloud, r: float = R_BIN,
                       max_distance: float = MAX_DISTANCE, t: int = T_BINS,
                       p: int = P_VIEWS, q: int = Q_VIEWS) -> torch.Tensor:
    """The descriptor ``[p*q + l*t]`` (f32) of an unbatched cloud, on its
    device."""
    A = signature(cloud, r, max_distance, t, p, q)
    # --- SVD → [u1; v1] (m2dp.cc:140-148) ---
    U, _, Vh = torch.linalg.svd(A, full_matrices=False)
    u1, v1 = U[:, 0], Vh[0, :]
    # SVD sign ambiguity: the first singular pair has a non-negative sum
    sgn = torch.where(torch.sum(v1) < 0, -1.0, 1.0)
    return torch.cat([u1 * sgn, v1 * sgn])


def match_descriptors(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """|Pearson correlation| of descriptors over the last axis
    (m2dp.cc:151-169)."""
    n = a.shape[-1]
    num = n * torch.sum(a * b, -1) - torch.sum(a, -1) * torch.sum(b, -1)
    den = torch.sqrt(
        (n * torch.sum(a * a, -1) - torch.sum(a, -1) ** 2)
        * (n * torch.sum(b * b, -1) - torch.sum(b, -1) ** 2))
    return torch.abs(num / den.clamp_min(1e-12))


def match_many(query: torch.Tensor, bank: torch.Tensor) -> torch.Tensor:
    """Score one descriptor against a bank ``[M, D]`` in one pass."""
    return match_descriptors(query[None, :], bank)
