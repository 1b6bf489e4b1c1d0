"""NDT registration — the PyTorch counterpart of
``staticmapping_tpu.registration.ndt``: the reference's "type 5" matcher
(registrators/ndt.{h,cc}, pclomp NDT, ndt.cc:29-64) and the NDT half of
"type 3" (registrators/ndt_gicp.cc:55-112).

The target is voxelized into per-voxel Gaussians (:func:`build_ndt_map`,
pclomp ``VoxelGridCovariance``: resolution 1.0, at least 4 points a voxel)
and the pose is optimized against that field (transformation epsilon 0.01,
at most 35 iterations, ndt_gicp.cc:41-44) by the JAX package's design, not
pclomp's Newton + More-Thuente line search:

* the voxel Gaussians come from one sort and segment sums
  (:mod:`..ops.voxel`), regularized by ``1e-2·tr(C)/3·I`` before a
  closed-form inverse;
* each iteration looks its points' voxels up by binary search
  (``torch.searchsorted``) in the Morton-sorted keys, in the containing
  voxel and its six face neighbours (DIRECT7);
* the step is iteratively reweighted Gauss-Newton on the Mahalanobis
  residuals with the Magnusson weight ``exp(−d2/2·qᵀΛq)``, a 1e-6 ridge and
  a 0.1 m / 0.05 rad trust region; the best-seen iterate is returned.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

from ..common import se3
from ..common.trips import TripCounter
from ..data.cloud import PointCloud
from ..ops import voxel as voxel_ops

_MORTON_BITS = 10
_INVALID = 2 ** 30 - 1
# trips between host reads of ``converged`` in the while form
_WHILE_CHECK_EVERY = 4

# NDT trips executed ("run") and trips to convergence ("needed") since the
# last ``trips.reset()``
trips = TripCounter()


class NdtMap(NamedTuple):
    """Sorted voxel-Gaussian field of a target cloud."""

    key: torch.Tensor         # [V] int32 Morton-packed voxel coords, sorted
    mean: torch.Tensor        # [V, 3]
    inv_cov: torch.Tensor     # [V, 3, 3] regularized inverse covariance
    valid: torch.Tensor       # [V] bool (count >= min_points)
    origin: torch.Tensor      # [3] f32 voxel-lattice origin
    resolution: torch.Tensor  # f32 scalar


def _spread(v: torch.Tensor) -> torch.Tensor:
    v = (v | (v << 16)) & 0x030000FF
    v = (v | (v << 8)) & 0x0300F00F
    v = (v | (v << 4)) & 0x030C30C3
    v = (v | (v << 2)) & 0x09249249
    return v


def _pack_key(ijk: torch.Tensor, in_range: torch.Tensor) -> torch.Tensor:
    """[N, 3] int32 lattice coords (0..1023) → int32 Morton key;
    out-of-range or invalid → ``_INVALID`` (sorts last, never matches)."""
    s = _spread(ijk)
    k = s[:, 0] | (s[:, 1] << 1) | (s[:, 2] << 2)
    return torch.where(in_range, k, _INVALID)


def _lattice(xyz: torch.Tensor, origin: torch.Tensor, resolution):
    ijk = torch.floor((xyz - origin) / resolution).to(torch.int32)
    in_range = torch.all((ijk >= 0) & (ijk < (1 << _MORTON_BITS)), dim=1)
    return ijk, in_range


def _sym3_inv_regularized(cov: torch.Tensor, rel_floor: float = 1e-2):
    """Regularized inverse of batched symmetric 3×3 covariances: add
    ``rel_floor·tr(C)/3·I`` (pclomp clamps small eigenvalues to
    ``1e-2·λ_max`` for the same conditioning), then the closed-form
    adjugate inverse.  Returns ``(inverse, ok)``; a singular slot gets I."""
    tr = cov[..., 0, 0] + cov[..., 1, 1] + cov[..., 2, 2]
    lam = (rel_floor * tr.clamp_min(1e-9) / 3.0)[..., None, None]
    eye = torch.eye(3, dtype=cov.dtype, device=cov.device)
    A = cov + lam * eye
    a00, a01, a02 = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    a11, a12, a22 = A[..., 1, 1], A[..., 1, 2], A[..., 2, 2]
    c00 = a11 * a22 - a12 * a12
    c01 = a02 * a12 - a01 * a22
    c02 = a01 * a12 - a02 * a11
    c11 = a00 * a22 - a02 * a02
    c12 = a01 * a02 - a00 * a12
    c22 = a00 * a11 - a01 * a01
    det = a00 * c00 + a01 * c01 + a02 * c02
    ok = det.abs() > 1e-30
    inv_det = 1.0 / torch.where(ok, det, 1.0)
    row0 = torch.stack([c00, c01, c02], dim=-1)
    row1 = torch.stack([c01, c11, c12], dim=-1)
    row2 = torch.stack([c02, c12, c22], dim=-1)
    inv = torch.stack([row0, row1, row2], dim=-2) * inv_det[..., None, None]
    return torch.where(ok[..., None, None], inv, eye), ok


def build_ndt_map(cloud: PointCloud, resolution, min_points: int = 4
                  ) -> NdtMap:
    """Voxelize ``cloud`` into per-voxel Gaussians on a floor lattice
    anchored at the cloud's least corner (pclomp ``VoxelGridCovariance``,
    ``min_points_per_voxel_`` 4), sorted by Morton key."""
    dev = cloud.device
    resolution = torch.as_tensor(resolution, dtype=torch.float32, device=dev)
    masked = torch.where(cloud.mask[:, None], cloud.xyz,
                         torch.full_like(cloud.xyz, 1e9))
    origin = torch.amin(masked, dim=0)
    origin = torch.where(torch.isfinite(origin), origin, 0.0)
    stats = voxel_ops.voxel_stats_floor(cloud, resolution, origin)
    ijk = stats["voxel_key"]
    in_range = (stats["valid"] & (stats["count"] >= min_points)
                & torch.all((ijk >= 0) & (ijk < (1 << _MORTON_BITS)), dim=1))
    key = _pack_key(ijk, in_range)
    inv_cov, inv_ok = _sym3_inv_regularized(stats["cov"])
    valid = in_range & inv_ok
    key = torch.where(valid, key, _INVALID)
    # stable, as jnp.argsort: the _INVALID rows tie and are never hit
    key, order = torch.sort(key, stable=True)
    return NdtMap(key=key, mean=stats["mean"][order],
                  inv_cov=inv_cov[order], valid=valid[order],
                  origin=origin, resolution=resolution)


# face-neighbour offsets (containing voxel + 6 faces): pclomp's DIRECT7
# neighbour search (ndt_omp.h:52)
_DIRECT7 = np.array([[0, 0, 0], [1, 0, 0], [-1, 0, 0], [0, 1, 0],
                     [0, -1, 0], [0, 0, 1], [0, 0, -1]], dtype=np.int32)


class _NdtState(NamedTuple):
    T_iter: torch.Tensor
    it: torch.Tensor
    converged: torch.Tensor
    score: torch.Tensor
    best_T: torch.Tensor       # iterate with the highest NDT objective
    best_obj: torch.Tensor
    best_score: torch.Tensor


def _hat_batch(v: torch.Tensor) -> torch.Tensor:
    """[N, 3] → [N, 3, 3] skew-symmetric (cross-product) matrices."""
    z = torch.zeros_like(v[:, 0])
    return torch.stack([
        torch.stack([z, -v[:, 2], v[:, 1]], dim=1),
        torch.stack([v[:, 2], z, -v[:, 0]], dim=1),
        torch.stack([-v[:, 1], v[:, 0], z], dim=1),
    ], dim=1)


def _gauss_d1_d2(outlier_ratio: float, resolution: torch.Tensor):
    """The Magnusson weight constants d1 < 0 and d2, in f32 as the JAX
    package computes them (pclomp ndt_omp_impl.hpp computeTransformation:
    c1 = 10(1−or), c2 = or/res³, d3 = −log c2, d1 = −log(c1+c2) − d3,
    d2 = −2 log((−log(c1·e^−½ + c2) − d3)/d1))."""
    f32 = torch.float32
    c1 = torch.tensor(10.0 * (1.0 - outlier_ratio), dtype=f32,
                      device=resolution.device)
    c2 = outlier_ratio / resolution ** 3
    d3 = -torch.log(c2)
    d1 = -torch.log(c1 + c2) - d3
    half = torch.exp(torch.tensor(-0.5, dtype=f32, device=c1.device))
    d2 = -2.0 * torch.log((-torch.log(c1 * half + c2) - d3) / d1)
    return d1, d2


def align_ndt(source: PointCloud, ndt_map: NdtMap, guess: torch.Tensor,
              outlier_ratio: float = 0.55,
              transformation_epsilon: float = 0.01,
              max_iteration: int = 35,
              step_damping: float = 1.0,
              direct7: bool = True,
              check_every: int = _WHILE_CHECK_EVERY):
    """Align ``source`` onto the NDT field; returns ``(T [4, 4], score)`` on
    the device, ``score`` = exp(−mean distance of the hit points to their
    voxel mean) (the fitness of interface.h:61).

    The while form stops once converged or after ``max_iteration`` trips.
    A converged state passes through the frozen body unchanged (its
    best-seen pose too), so the host reads ``converged`` only every
    ``check_every`` trips and the result is the one a check every trip
    gives."""
    f32 = torch.float32
    dev = source.xyz.device
    guess = guess.to(f32)
    res = ndt_map.resolution
    d1, d2 = _gauss_d1_d2(outlier_ratio, res)

    src = source.xyz
    src_mask = source.mask
    n_off = _DIRECT7.shape[0] if direct7 else 1
    offsets = torch.from_numpy(_DIRECT7[:n_off]).to(dev)
    n_keys = ndt_map.key.shape[0]

    def lookup(pts):
        """Per (point, neighbour offset): the voxel Gaussian and a hit."""
        ijk, in_range = _lattice(pts, ndt_map.origin, res)
        ijk_n = ijk[:, None, :] + offsets[None, :, :]          # [N, K, 3]
        in_r = in_range[:, None] & torch.all(
            (ijk_n >= 0) & (ijk_n < (1 << _MORTON_BITS)), dim=2)
        keys = _pack_key(ijk_n.reshape(-1, 3), in_r.reshape(-1))
        pos = torch.searchsorted(ndt_map.key, keys).clamp(0, n_keys - 1)
        hit = (ndt_map.key[pos] == keys) & (keys != _INVALID)
        mu = ndt_map.mean[pos].reshape(-1, n_off, 3)
        lam = ndt_map.inv_cov[pos].reshape(-1, n_off, 3, 3)
        return mu, lam, hit.reshape(-1, n_off)

    def residuals(T_iter):
        pts = se3.apply(T_iter @ guess, src)
        mu, lam, hit = lookup(pts)
        hit = hit & src_mask[:, None]
        q = pts[:, None, :] - mu                               # [N, K, 3]
        lam_q = torch.einsum("nkij,nkj->nki", lam, q)          # Λq
        md2 = torch.sum(q * lam_q, dim=2)                      # qᵀΛq
        # the Magnusson eq. 6.9 likelihood up to the factor −d1 > 0
        obj = torch.sum(torch.where(hit, torch.exp(-0.5 * d2 * md2), 0.0))
        n_hit = torch.sum(hit[:, 0]).clamp_min(1)
        avg_d = torch.sum(torch.where(
            hit[:, 0], torch.linalg.vector_norm(q[:, 0, :], dim=1),
            0.0)) / n_hit
        return pts, lam, hit, lam_q, md2, obj, torch.exp(-avg_d)

    def body(state: _NdtState) -> _NdtState:
        pts, lam, hit, lam_q, md2, obj_here, score = residuals(state.T_iter)
        # IRLS weight −d1·d2·exp(−d2/2·qᵀΛq) > 0 (Magnusson eq. 6.12)
        w = torch.where(hit, -d1 * d2 * torch.exp(-0.5 * d2 * md2), 0.0)
        # Gauss-Newton on r(ξ) = q with metric w·Λ, J = [−[p]ₓ | I]:
        # JᵀΛq has rotation block p × Λq and translation block Λq
        rot_g = torch.linalg.cross(pts[:, None, :].expand_as(lam_q), lam_q,
                                   dim=-1)
        g = torch.cat([rot_g, lam_q], dim=2)                   # [N, K, 6]
        b_vec = -torch.sum(w[..., None] * g, dim=(0, 1))       # [6]
        eye3 = torch.eye(3, dtype=f32, device=dev)
        J = torch.cat([-_hat_batch(pts), eye3.expand(pts.shape[0], 3, 3)],
                      dim=2)                                   # [N, 3, 6]
        lamw = torch.sum(w[..., None, None] * lam, dim=1)      # [N, 3, 3]
        JT_lam = torch.einsum("nij,nik->njk", J, lamw)         # [N, 6, 3]
        A = torch.einsum("njk,nkl->jl", JT_lam, J)             # [6, 6]
        A = A + 1e-6 * torch.eye(6, dtype=f32, device=dev)
        dx, info = torch.linalg.solve_ex(A, b_vec[:, None])
        dx = dx[:, 0] * step_damping
        finite = torch.isfinite(dx).all() & (info == 0)
        dx = torch.where(finite, dx, torch.zeros_like(dx))
        # trust region: pclomp bounds each update through its line search
        # (step 0.1 m); an unclamped step on a near-singular Hessian can
        # jump metres.  Translation and rotation blocks separately.
        t_n = torch.linalg.vector_norm(dx[3:])
        r_n = torch.linalg.vector_norm(dx[:3])
        scale = torch.minimum(
            torch.clamp_max(0.1 / t_n.clamp_min(1e-9), 1.0),
            torch.clamp_max(0.05 / r_n.clamp_min(1e-9), 1.0))
        dx = dx * scale
        dT = se3.from_rt(se3.axis_angle_to_matrix(dx[:3]), dx[3:])
        # a non-finite solve must not read as converged
        converged = finite & (torch.linalg.vector_norm(dx)
                              < transformation_epsilon)
        better = obj_here > state.best_obj
        return _NdtState(
            dT @ state.T_iter, state.it + 1, converged, score,
            torch.where(better, state.T_iter, state.best_T),
            torch.where(better, obj_here, state.best_obj),
            torch.where(better, score, state.best_score))

    def frozen_body(state: _NdtState) -> _NdtState:
        new = body(state)
        return _NdtState(*(torch.where(state.converged, o, nw)
                           for o, nw in zip(state, new)))

    eye4 = torch.eye(4, dtype=f32, device=dev)
    zero = torch.zeros((), dtype=f32, device=dev)
    state = _NdtState(eye4, torch.zeros((), dtype=torch.int32, device=dev),
                      torch.zeros((), dtype=torch.bool, device=dev), zero,
                      eye4, torch.full((), -math.inf, device=dev), zero)
    run = 0
    while run < max_iteration:
        for _ in range(min(check_every, max_iteration - run)):
            state = frozen_body(state)
            run += 1
        if run < max_iteration and bool(state.converged):
            break
    trips.add(run, state.it)
    # give the last iterate its evaluation, then return the best-seen pose
    obj_f, score_f = residuals(state.T_iter)[5:]
    last_wins = obj_f > state.best_obj
    T_best = torch.where(last_wins, state.T_iter, state.best_T)
    return T_best @ guess, torch.where(last_wins, score_f, state.best_score)


@dataclasses.dataclass
class Ndt:
    """Stateful "type 5" matcher (registrators/ndt.{h,cc}: pclomp NDT at
    resolution 1.0)."""

    resolution: float = 1.0
    transformation_epsilon: float = 0.01
    max_iteration: int = 35
    min_points_per_voxel: int = 4

    TYPE = 5  # registrator::Type::kNdt (interface.h:41-50)

    _source: PointCloud = None
    _map: NdtMap = None
    final_score: float = 0.0

    def set_input_source(self, cloud: PointCloud):
        self._source = cloud

    def set_input_target(self, target: PointCloud):
        self._map = build_ndt_map(target, self.resolution,
                                  min_points=self.min_points_per_voxel)

    def align(self, guess: torch.Tensor):
        if self._source is None or self._map is None:
            raise ValueError("set the source and the target before align")
        T, score = align_ndt(
            self._source, self._map, guess,
            transformation_epsilon=self.transformation_epsilon,
            max_iteration=self.max_iteration)
        self.final_score = score
        return T, score
