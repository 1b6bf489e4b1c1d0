"""Generalized ICP (plane-to-plane) — the PyTorch counterpart of
``staticmapping_tpu.registration.gicp``, the GICP half of the reference's
"type 3" matcher (registrators/ndt_gicp.cc:96-102 wraps
``pcl::GeneralizedIterativeClosestPoint``; rotation epsilon 1e-3, 35
iterations, ndt_gicp.cc:51-52).  The back end uses it as the loop
detector's independent acceptance gate.

Design (not PCL's BFGS scheme):

* per-point disk covariances: k-NN neighbourhoods (``ops.nn_search.knn``)
  → batched 3×3 covariance → unit normal by the closed-form smallest
  eigenvector (``ops.normals.smallest_eigvec3``).  Segal's regularized
  covariance ``R·diag(1,1,ε)·Rᵀ`` is ``I − (1−ε)·n nᵀ``, so only the normal
  is kept;
* per iteration: 1-NN correspondences (the nn_search kernel), combined
  information ``W = (C_B + R C_A Rᵀ)⁻¹`` by batched adjugate inverse,
  Gauss-Newton on the Mahalanobis point residuals with the left-perturbation
  Jacobian ``J = [−[p]ₓ | I]`` — one 6×6 reduce;
* the iterate of best fitness is kept, and the last iterate is evaluated
  too: plain GN without PCL's line search can step off a near-perfect guess.

``score`` = exp(−mean matched distance), the fitness of the other matchers
(interface.h:61; ndt_gicp.cc:104).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ..common import se3
from ..common.trips import TripCounter
from ..data.cloud import PAD_COORD, PointCloud
from ..ops import nn_search
from ..ops.normals import smallest_eigvec3

_EPS_DISK = 1e-3   # Segal's ε: covariance thickness along the normal
# trips between host reads of ``converged`` in the while form
_WHILE_CHECK_EVERY = 4

# GICP trips executed ("run") and trips to convergence ("needed") since the
# last ``trips.reset()``
trips = TripCounter()


class GicpCloud(NamedTuple):
    """Points + per-point unit normals defining disk covariances."""

    xyz: torch.Tensor      # [N, 3]
    normals: torch.Tensor  # [N, 3]
    mask: torch.Tensor     # [N] bool


def compute_point_normals(cloud: PointCloud, k: int = 20) -> GicpCloud:
    """Per-point normals from k-NN covariances, at full resolution (unlike
    the leaf-downsampled ``ops.normals.estimate_normals``)."""
    pts = torch.where(cloud.mask[:, None], cloud.xyz,
                      torch.full_like(cloud.xyz, PAD_COORD))
    d2, idx = nn_search.knn(pts, pts, cloud.mask, k=k,
                            tile=min(1024, cloud.capacity))
    idx = idx.long()
    nbrs = pts[idx]                                     # [N, k, 3]
    valid_nbr = cloud.mask[idx] & torch.isfinite(d2)    # [N, k]
    w = valid_nbr.to(torch.float32)[..., None]
    count = torch.sum(valid_nbr, dim=1).clamp_min(1)[:, None]
    mean = torch.sum(nbrs * w, dim=1) / count
    centered = (nbrs - mean[:, None, :]) * w
    C = centered.mT @ centered
    ok = cloud.mask & (torch.sum(valid_nbr, dim=1) >= 3)
    return GicpCloud(xyz=cloud.xyz, normals=smallest_eigvec3(C), mask=ok)


def _disk_cov_sum_inv(n_a_rot: torch.Tensor, n_b: torch.Tensor
                      ) -> torch.Tensor:
    """(C_B + R C_A Rᵀ)⁻¹ with disk covariances: M = 2I − (1−ε)(mmᵀ + nnᵀ),
    m = R·n_A.  Batched adjugate inverse."""
    one_m_eps = 1.0 - _EPS_DISK
    eye = torch.eye(3, dtype=torch.float32, device=n_b.device)
    M = (2.0 * eye
         - one_m_eps * (n_a_rot[..., :, None] * n_a_rot[..., None, :]
                        + n_b[..., :, None] * n_b[..., None, :]))
    a00, a01, a02 = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    a11, a12, a22 = M[..., 1, 1], M[..., 1, 2], M[..., 2, 2]
    c00 = a11 * a22 - a12 * a12
    c01 = a02 * a12 - a01 * a22
    c02 = a01 * a12 - a02 * a11
    c11 = a00 * a22 - a02 * a02
    c12 = a01 * a02 - a00 * a12
    c22 = a00 * a11 - a01 * a01
    det = a00 * c00 + a01 * c01 + a02 * c02
    inv_det = 1.0 / torch.where(det.abs() > 1e-20, det, 1.0)
    row0 = torch.stack([c00, c01, c02], dim=-1)
    row1 = torch.stack([c01, c11, c12], dim=-1)
    row2 = torch.stack([c02, c12, c22], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2) * inv_det[..., None, None]


def _hat(v: torch.Tensor) -> torch.Tensor:
    z = torch.zeros_like(v[:, 0])
    return torch.stack([
        torch.stack([z, -v[:, 2], v[:, 1]], dim=1),
        torch.stack([v[:, 2], z, -v[:, 0]], dim=1),
        torch.stack([-v[:, 1], v[:, 0], z], dim=1),
    ], dim=1)


class _GicpState(NamedTuple):
    T_iter: torch.Tensor
    it: torch.Tensor
    converged: torch.Tensor
    score: torch.Tensor
    best_T: torch.Tensor       # iterate with the best fitness seen so far
    best_obj: torch.Tensor
    best_score: torch.Tensor


def align_gicp(source: GicpCloud, target: GicpCloud, guess: torch.Tensor,
               max_correspondence_dist: float = 1.0e3,
               rotation_epsilon: float = 1e-3, max_iteration: int = 35,
               check_every: int = _WHILE_CHECK_EVERY):
    """Align ``source`` onto ``target``; returns ``(T [4,4], score)`` on the
    device.  ``T`` maps source-frame points into the target frame (the
    Align contract, registrators/interface.h:84-89).

    The while form stops once converged or after ``max_iteration`` trips.
    A converged state passes through the frozen body unchanged, so the host
    reads ``converged`` only every ``check_every`` trips and the result is
    the one a check every trip gives; ``check_every >= max_iteration`` runs
    with no host read at all."""
    f32 = torch.float32
    dev = source.xyz.device
    guess = guess.to(f32)
    tgt_pts = torch.where(target.mask[:, None], target.xyz,
                          torch.full_like(target.xyz, nn_search._FAR))
    tgt_payload = torch.cat([tgt_pts, target.normals], dim=1)
    src0 = source.xyz
    src_mask = source.mask
    max_d2 = max_correspondence_dist ** 2

    def fitness(d2, keep):
        """(objective, score) of an iterate: exp(−avg matched distance),
        with a match-count floor on the objective.  Plain GN without PCL's
        line search can step off a near-perfect guess and re-lock ~1 m
        away; the avg-distance fitness ranks the true pose above such an
        aliased one, where the mean weighted residual cannot (the trimmed
        correspondence set changes with the pose)."""
        kept_n = torch.clamp_min(torch.sum(keep), 1.0)
        avg_d = torch.sum(torch.sqrt(torch.clamp_min(d2, 0.0)) * keep) / kept_n
        score = torch.exp(-avg_d)
        return score - 10.0 * (kept_n < 32).to(f32), score

    def match(T_iter):
        pts = se3.apply(T_iter @ guess, src0)
        d2, _, sel = nn_search.nearest_select(pts, tgt_pts, target.mask,
                                              tgt_payload)
        keep = (src_mask & (d2 <= max_d2)).to(f32)
        return pts, d2, sel, keep

    def body(state: _GicpState) -> _GicpState:
        R = se3.rotation(state.T_iter @ guess)
        pts, d2, sel, keep = match(state.T_iter)
        n_a_rot = source.normals @ R.T
        q, n_b = sel[:, :3], sel[:, 3:6]

        W = _disk_cov_sum_inv(n_a_rot, n_b) * keep[:, None, None]
        Wd = (W @ (pts - q)[..., None])[..., 0]            # [N, 3]
        obj_here, score = fitness(d2, keep)

        # J = [−[p]ₓ | I]; JᵀWd rotation block = p × Wd
        rot_g = torch.linalg.cross(pts, Wd, dim=-1)
        b_vec = -torch.cat([torch.sum(rot_g, 0), torch.sum(Wd, 0)])
        eye = torch.eye(3, dtype=f32, device=dev).expand(pts.shape[0], 3, 3)
        J = torch.cat([-_hat(pts), eye], dim=2)            # [N, 3, 6]
        A = torch.einsum("nij,nik,nkl->jl", J, W, J)        # [6, 6]
        A = A + 1e-6 * torch.eye(6, dtype=f32, device=dev)
        dx, info = torch.linalg.solve_ex(A, b_vec[:, None])
        dx = dx[:, 0]
        dx = torch.where(torch.isfinite(dx).all() & (info == 0), dx,
                         torch.zeros_like(dx))
        dT = se3.from_rt(se3.axis_angle_to_matrix(dx[:3]), dx[3:])

        better = obj_here > state.best_obj
        return _GicpState(
            dT @ state.T_iter, state.it + 1,
            torch.linalg.vector_norm(dx) < rotation_epsilon, score,
            torch.where(better, state.T_iter, state.best_T),
            torch.where(better, obj_here, state.best_obj),
            torch.where(better, score, state.best_score))

    def frozen_body(state: _GicpState) -> _GicpState:
        new = body(state)
        return _GicpState(*(torch.where(state.converged, o, nw)
                            for o, nw in zip(state, new)))

    eye4 = torch.eye(4, dtype=f32, device=dev)
    zero = torch.zeros((), dtype=f32, device=dev)
    state = _GicpState(eye4, torch.zeros((), dtype=torch.int32, device=dev),
                       torch.zeros((), dtype=torch.bool, device=dev), zero,
                       eye4, torch.full((), -float("inf"), device=dev), zero)
    run = 0
    while run < max_iteration:
        for _ in range(min(check_every, max_iteration - run)):
            state = frozen_body(state)
            run += 1
        if run < max_iteration and bool(state.converged):
            break
    trips.add(run, state.it)
    # evaluate the last iterate too, then return the best-seen pose
    _, d2, _, keep = match(state.T_iter)
    obj_f, score_f = fitness(d2, keep)
    last_wins = obj_f > state.best_obj
    T_best = torch.where(last_wins, state.T_iter, state.best_T)
    return T_best @ guess, torch.where(last_wins, score_f, state.best_score)


@dataclasses.dataclass
class Gicp:
    """Stateful plane-to-plane matcher (the PCL GICP role in type 3)."""

    knn: int = 20
    # PCL's Registration default is effectively unlimited (the reference
    # never calls setMaxCorrespondenceDistance, ndt_gicp.cc:46-52); a tight
    # gate rejects the far-field matches whose leverage corrects a rotated
    # initial guess
    max_correspondence_dist: float = 1.0e3
    rotation_epsilon: float = 1e-3
    max_iteration: int = 35

    _source: GicpCloud = None
    _target: GicpCloud = None
    final_score: float = 0.0

    def set_input_source(self, cloud: PointCloud):
        self._source = compute_point_normals(cloud, k=self.knn)

    def set_input_target(self, target: PointCloud):
        self._target = compute_point_normals(target, k=self.knn)

    def align(self, guess: torch.Tensor):
        if self._source is None or self._target is None:
            raise ValueError("set the source and the target before align")
        T, score = align_gicp(
            self._source, self._target, guess,
            max_correspondence_dist=self.max_correspondence_dist,
            rotation_epsilon=self.rotation_epsilon,
            max_iteration=self.max_iteration)
        self.final_score = score
        return T, score
