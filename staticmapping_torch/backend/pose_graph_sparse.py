"""Block-sparse SE(3) pose-graph solver: Gauss-Newton + preconditioned CG —
the PyTorch counterpart of ``staticmapping_tpu.backend.pose_graph_sparse``.

The dense solver in :mod:`pose_graph` builds an ``[6n, 6n]`` normal matrix,
which is unusable past ~10³ nodes.  This module solves the same factor model
without ever building H:

* linearization produces only the nonzero 6×6 (between), 18×18 (GPS),
  12×12 (odom) and 6×6 (prior) blocks, one batched pass per factor type;
* ``H dx = −b`` is solved by conjugate gradients with ``H·v`` computed
  matrix-free: gather the per-factor slices of ``v``, multiply by the
  cached blocks, scatter-add;
* the preconditioner is block-Jacobi — the ``[n, 6, 6]`` diagonal blocks of
  H (LM damping and the gauge prior included), inverted once per GN trip;
* the Levenberg–Marquardt accept/reject on the true cost is the dense
  path's.

The JAX package runs CG as a device ``while_loop`` on ``‖r‖ > tol·‖rhs‖``.
Here a system that meets the test (or the trip cap) freezes its state, and
the host reads the flag only between blocks of ``_CG_CHECK_EVERY`` trips:
the result is the one a check every trip gives, with a tenth of the syncs.

Distribution: :func:`solve_sharded` gives each rank of a mesh
(``parallel/multihost.py``) a contiguous shard of the between factors.
Every rank linearizes its shard, and the partial sums of the cost, the
gradient, the block diagonal, every matvec and the final χ² are summed
over the mesh (``all_reduce``, the JAX package's ``psum``); the PCG state
stays replicated.  The small factor types (GPS, odom, prior) are
replicated and scaled by 1/D before the sum, as in the JAX package, so it
counts them once.  Both host decisions, the CG's "still running" and the
LM accept, come from summed values, so every rank takes the same branch.
"""
from __future__ import annotations

import torch

from ..common import se3
from ..parallel.multihost import all_reduce, check_mesh
from .pose_graph import (_between_cost, _F32, _lin_aux, _lin_between,
                         _lm_update, _make_total_cost)

# CG trips between host reads of the "still running" flag
_CG_CHECK_EVERY = 25


def _bmv(B: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Batched block · vector: [F,a,b] · [F,b] → [F,a]."""
    return (B @ v[..., None])[..., 0]


def _add_rows(out: torch.Tensor, idx, vals: torch.Tensor) -> torch.Tensor:
    """``out[idx[f]] += vals[f]``; an int ``idx`` takes the sum over f."""
    if isinstance(idx, int):
        out[idx:idx + 1] += vals.sum(0, keepdim=True)
        return out
    return out.index_add_(0, idx, vals)


def _pcg_core(poses, node_mask,
              fi, fj, T_meas, inv_sigmas, fmask,
              gi, g_enu, g_ptg, g_inv_s, g_use_err, gmask,
              gps_coord_idx, gps_calib_idx,
              oi, o_T, o_inv_s, omask, odom_calib_idx, huber_k,
              pi, p_T, p_inv_s, pmask,
              num_iters: int = 8, cg_iters: int = 250,
              damping: float = 1e-6, gauge_weight: float = 1e8,
              cg_tol: float = 1e-8, mesh=None):
    """GN/LM + PCG on this rank's between factors; with a ``mesh`` the
    partial sums are summed over its ranks (see the module note)."""
    n = poses.shape[0]
    dev = poses.device
    total_local = _make_total_cost(
        fi, fj, T_meas, inv_sigmas, fmask,
        gi, g_enu, g_ptg, g_inv_s, g_use_err, gmask,
        gps_coord_idx, gps_calib_idx,
        oi, o_T, o_inv_s, omask, odom_calib_idx, huber_k,
        pi, p_T, p_inv_s, pmask)
    if mesh is None:
        total_cost = total_local
    else:
        inv_d = 1.0 / mesh.size

        def total_cost(p):
            # between factors sharded, the rest replicated (scaled by 1/D)
            c_btw = _between_cost(p, fi, fj, T_meas, inv_sigmas, fmask)
            return all_reduce(
                (c_btw + (total_local(p) - c_btw) * inv_d).reshape(1),
                mesh)[0]

    def small(t):
        """The accumulator of the replicated factors' share of ``t``."""
        return t if mesh is None else torch.zeros_like(t)

    def combine(t, t_small):
        """The mesh's sum of the between share ``t`` and the replicated
        share ``t_small`` (one copy of it)."""
        if mesh is None:
            return t
        return all_reduce(t + t_small * inv_d, mesh)
    eye6 = torch.eye(6, dtype=_F32, device=dev)
    base = torch.full((n, 6), damping, dtype=_F32, device=dev)
    base[0] += gauge_weight
    base = base + (~node_mask).to(_F32)[:, None]

    lam = torch.full((), 1e-4, dtype=_F32, device=dev)
    trace = []
    for _ in range(num_iters):
        # ---- linearize all factor types → blocks ----
        H_ii, H_ij, H_jj, b_i, b_j = _lin_between(
            poses[fi], poses[fj], T_meas, inv_sigmas,
            fmask.to(_F32)[:, None])
        # (block row, slice of the factor's tangent) of each auxiliary
        # type; an int row is a special node shared by the type's factors
        aux = _lin_aux(
            poses, gi, g_enu, g_ptg, g_inv_s, g_use_err, gmask,
            gps_coord_idx, gps_calib_idx, oi, o_T, o_inv_s, omask,
            odom_calib_idx, huber_k, pi, p_T, p_inv_s, pmask,
            ([(gi, slice(0, 6)), (gps_coord_idx, slice(6, 12)),
              (gps_calib_idx, slice(12, 18))],
             [(oi, slice(0, 6)), (odom_calib_idx, slice(6, 12))],
             [(pi, slice(0, 6))]))

        # ---- gradient b [n, 6] and block diagonal D [n, 6, 6] ----
        b = torch.zeros((n, 6), dtype=_F32, device=dev)
        D = torch.zeros((n, 6, 6), dtype=_F32, device=dev)
        _add_rows(b, fi, b_i)
        _add_rows(b, fj, b_j)
        _add_rows(D, fi, H_ii)
        _add_rows(D, fj, H_jj)
        b_s, D_s = small(b), small(D)
        for spec, (Hk, bk) in aux:
            for idx, sl in spec:
                _add_rows(b_s, idx, bk[:, sl])
                _add_rows(D_s, idx, Hk[:, sl, sl])
        b, D = combine(b, b_s), combine(D, D_s)

        # ---- scalar diagonal: damping, gauge, inactive nodes, LM ----
        diag_h = torch.diagonal(D, dim1=1, dim2=2)
        extra = base + lam * torch.clamp_min(diag_h, 1e-6)
        # invert the block-Jacobi preconditioner once per GN trip
        D_inv = torch.linalg.inv_ex(D + extra[:, :, None] * eye6)[0]
        D_inv = torch.where(torch.isfinite(D_inv), D_inv, 0.0)
        H_ji = H_ij.mT

        def matvec(v):
            """H·v [n, 6], matrix-free."""
            vi, vj = v[fi], v[fj]
            u = torch.zeros((n, 6), dtype=_F32, device=dev)
            u.index_add_(0, fi, _bmv(H_ii, vi) + _bmv(H_ij, vj))
            u.index_add_(0, fj, _bmv(H_ji, vi) + _bmv(H_jj, vj))
            u_s = small(u)
            for spec, (Hk, _) in aux:
                f = Hk.shape[0]
                uk = _bmv(Hk, torch.cat([v[idx].expand(f, 6)
                                         for idx, _ in spec], dim=1))
                for idx, sl in spec:
                    _add_rows(u_s, idx, uk[:, sl])
            return combine(u, u_s) + extra * v

        # ---- PCG on H dx = −b, frozen once converged ----
        rhs = -b
        limit = cg_tol * torch.sqrt(torch.sum(rhs * rhs))
        x = torch.zeros((n, 6), dtype=_F32, device=dev)
        r = rhs
        z = _bmv(D_inv, r)
        p = z
        rz = torch.sum(r * z)
        k = torch.zeros((), dtype=torch.int64, device=dev)
        for start in range(0, cg_iters, _CG_CHECK_EVERY):
            for _ in range(min(_CG_CHECK_EVERY, cg_iters - start)):
                active = (k < cg_iters) & (torch.sqrt(torch.sum(r * r))
                                           > limit)
                Hp_ = matvec(p)
                denom = torch.sum(p * Hp_)
                alpha = rz / torch.where(denom.abs() < 1e-20, 1e-20, denom)
                x_n = x + alpha * p
                r_n = r - alpha * Hp_
                z = _bmv(D_inv, r_n)
                rz_n = torch.sum(r_n * z)
                beta = rz_n / torch.where(rz.abs() < 1e-20, 1e-20, rz)
                p_n = z + beta * p
                x = torch.where(active, x_n, x)
                r = torch.where(active, r_n, r)
                p = torch.where(active, p_n, p)
                rz = torch.where(active, rz_n, rz)
                k = k + active.to(torch.int64)
            running = ((k < cg_iters)
                       & (torch.sqrt(torch.sum(r * r)) > limit))
            if mesh is not None:
                # the state is replicated; the sum keeps every rank in
                # step even if one read it otherwise
                running = all_reduce(running.to(torch.int32).reshape(1),
                                     mesh)[0] > 0
            if not bool(running):
                break
        dx = torch.where(torch.isfinite(x), x, 0.0)

        cand = poses @ se3.exp_se3(dx)
        cand = torch.where(node_mask[:, None, None], cand, poses)
        poses, lam, t = _lm_update(poses, cand, lam, total_cost)
        trace.append(t)

    chi2 = _between_cost(poses, fi, fj, T_meas, inv_sigmas, fmask)
    if mesh is not None:
        chi2 = all_reduce(chi2.reshape(1), mesh)[0]
    return poses, chi2, torch.stack(trace, dim=1)


def gauss_newton_pcg(poses, node_mask,
                     fi, fj, T_meas, inv_sigmas, fmask,
                     gi, g_enu, g_ptg, g_inv_s, g_use_err, gmask,
                     gps_coord_idx, gps_calib_idx,
                     oi, o_T, o_inv_s, omask, odom_calib_idx, huber_k,
                     pi, p_T, p_inv_s, pmask,
                     num_iters: int = 8, cg_iters: int = 250,
                     damping: float = 1e-6, gauge_weight: float = 1e8,
                     cg_tol: float = 1e-8):
    """Single-device matrix-free GN/LM + PCG (the argument list of
    :func:`pose_graph.gauss_newton`); returns ``(poses, chi2, trace)``."""
    return _pcg_core(poses, node_mask,
                     fi, fj, T_meas, inv_sigmas, fmask,
                     gi, g_enu, g_ptg, g_inv_s, g_use_err, gmask,
                     gps_coord_idx, gps_calib_idx,
                     oi, o_T, o_inv_s, omask, odom_calib_idx, huber_k,
                     pi, p_T, p_inv_s, pmask,
                     num_iters=num_iters, cg_iters=cg_iters, damping=damping,
                     gauge_weight=gauge_weight, cg_tol=cg_tol)


def solve_sharded(mesh, poses, node_mask,
                  fi, fj, T_meas, inv_sigmas, fmask,
                  *rest, num_iters: int = 8, cg_iters: int = 250,
                  damping: float = 1e-6, gauge_weight: float = 1e8,
                  cg_tol: float = 1e-8):
    """Distributed solve: rank r of ``mesh`` takes the contiguous shard
    ``[r·F/D, (r+1)·F/D)`` of the five between-factor arrays; ``poses``,
    ``node_mask`` and ``rest`` (the GPS, odom and prior factors of
    :func:`gauss_newton_pcg`'s argument list) are the same on every rank.
    The between-factor capacity F must be divisible by the mesh size D
    (pad with masked factors).  Returns ``(poses, chi2, trace)``, the same
    on every rank."""
    check_mesh(mesh)
    if poses.device != mesh.device:
        raise ValueError(f"the graph lies on {poses.device}, the mesh's "
                         f"rank computes on {mesh.device}")
    f = fi.shape[0]
    if f % mesh.size:
        raise ValueError(f"between-factor capacity {f} not divisible by "
                         f"mesh size {mesh.size}")
    per = f // mesh.size
    shard = slice(mesh.rank * per, (mesh.rank + 1) * per)
    return _pcg_core(poses, node_mask,
                     *(a[shard] for a in (fi, fj, T_meas, inv_sigmas,
                                          fmask)),
                     *rest, num_iters=num_iters, cg_iters=cg_iters,
                     damping=damping, gauge_weight=gauge_weight,
                     cg_tol=cg_tol, mesh=mesh)
