"""Batched SE(3) pose-graph Gauss-Newton — the PyTorch counterpart of
``staticmapping_tpu.backend.pose_graph`` (it replaces the reference's GTSAM
iSAM2 back end, back_end/isam_optimizer.{h,cc}): every factor is linearized
in one batched pass and the normal equations are re-solved whole.

Factor model (isam_optimizer.cc:78-94, 127-288):
  * prior on node 0 (gauge) — heavy diagonal
  * between factors (sequential submap matches + loop closures) with
    per-factor 6-vector sigmas; residual r = log(T_meas⁻¹ · T_i⁻¹ · T_j)
  * GPS-ENU point factors: (T_coord · T_i) ∘ (p_tracking_gps + tf_err) = enu
    on the shared special nodes GPS_COORD (SE3) and GPS_CALIB (translation
    only, when extrinsic calibration is on) — isam_optimizer.cc:238-262
  * odometry extrinsic-calibration factors: calib⁻¹ · T_i · calib = T_odom
    on the shared ODOM_CALIB node, Huber(k=1) — isam_optimizer.cc:92-94,
    209-224
  * SE(3) priors on the special nodes

The tangent order is (rho=trans, phi=rot), and sigma vectors are given in
the same order (gtsam's Pose3 order is (rot, trans)).

Between-factor Jacobians are analytic (right perturbation T·exp(ξ)):
``J_j = Jr⁻¹(r)``, ``J_i = −Jr⁻¹(r)·Ad(T_j⁻¹ T_i)`` with the series
``Jr⁻¹(r) ≈ I + ½ad(r) + 1/12 ad(r)²``.  The GPS, odometry and prior
factors linearize by forward-mode autodiff of the residual at ξ = 0
(``torch.func.jacfwd`` under ``torch.func.vmap``).

The dense solver keeps every Levenberg–Marquardt trip on the device: the
accept/reject on the true cost is a ``torch.where``, and nothing is read on
the host until the solve ends.  H and b are summed in factor order, the
order of the JAX package's ``.at[].add`` (:class:`_OrderedSum`), so a
solve gives the same bits from run to run on every device.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch.func import jacfwd, vmap

from .. import resolve_device
from ..common import np_se3, se3

# special shared nodes appended after the regular pose nodes
NUM_SPECIAL_NODES = 3
SPECIAL_GPS_COORD = 0   # map origin expressed in the ENU/GPS frame
SPECIAL_ODOM_CALIB = 1  # lidar→odom extrinsic
SPECIAL_GPS_CALIB = 2   # tracking→gps translation error (translation only)

_F32 = torch.float32


def _ad_se3(xi: torch.Tensor) -> torch.Tensor:
    """ad(xi) for order (rho, phi): [[S(phi), S(rho)], [0, S(phi)]]."""
    Sp = se3.skew(xi[..., 3:])
    Sr = se3.skew(xi[..., :3])
    top = torch.cat([Sp, Sr], dim=-1)
    bot = torch.cat([torch.zeros_like(Sp), Sp], dim=-1)
    return torch.cat([top, bot], dim=-2)


def _adjoint(T: torch.Tensor) -> torch.Tensor:
    """Ad(T) for order (rho, phi): [[R, S(t)R], [0, R]]."""
    R = se3.rotation(T)
    StR = se3.skew(se3.translation(T)) @ R
    top = torch.cat([R, StR], dim=-1)
    bot = torch.cat([torch.zeros_like(R), R], dim=-1)
    return torch.cat([top, bot], dim=-2)


def _jr_inv(r: torch.Tensor) -> torch.Tensor:
    ad = _ad_se3(r)
    eye = torch.eye(6, dtype=r.dtype, device=r.device)
    return eye + 0.5 * ad + (1.0 / 12.0) * (ad @ ad)


# --------------------------------------------------------------------------
# residuals of the autodiff-linearized factor types (one factor each)
# --------------------------------------------------------------------------

def _gps_residual(xi, T_i, T_c, T_e, p_tg, enu, use_err):
    """xi = concat(ξ_i, ξ_c, ξ_e). r = (T_c·T_i)∘(p_tg + err) − enu."""
    Ti = T_i @ se3.exp_se3(xi[0:6])
    Tc = T_c @ se3.exp_se3(xi[6:12])
    Te = T_e @ se3.exp_se3(xi[12:18])
    offset = p_tg + use_err * se3.translation(Te)
    p_map = se3.rotation(Ti) @ offset + se3.translation(Ti)
    return se3.rotation(Tc) @ p_map + se3.translation(Tc) - enu


def _odom_residual(xi, T_i, T_k, T_odom):
    """xi = concat(ξ_i, ξ_k). r = log(T_odom⁻¹ · K⁻¹·T_i·K)."""
    Ti = T_i @ se3.exp_se3(xi[0:6])
    Tk = T_k @ se3.exp_se3(xi[6:12])
    return se3.log_se3(se3.inverse(T_odom) @ se3.inverse(Tk) @ Ti @ Tk)


def _prior_residual(xi, T, T_prior):
    return se3.log_se3(se3.inverse(T_prior) @ (T @ se3.exp_se3(xi)))


def _huber_weight(rw: torch.Tensor, k) -> torch.Tensor:
    """IRLS weight of Huber(k) on a whitened residual (last axis)."""
    norm = torch.sqrt(torch.clamp_min(torch.sum(rw * rw, dim=-1), 1e-12))
    return torch.sqrt(torch.clamp(k / norm, max=1.0))


# --------------------------------------------------------------------------
# host-side factor containers with fixed-capacity device export
# --------------------------------------------------------------------------

def _pad_pow2(n: int, floor: int) -> int:
    return max(floor, 1 << (max(n, 1) - 1).bit_length())


def _stack_rows(rows, n: int, capacity: int, fill: np.ndarray) -> np.ndarray:
    out = np.tile(fill.astype(np.float32), (capacity,) + (1,) * fill.ndim)
    if n:
        out[:n] = np.stack(rows).astype(np.float32)
    return out


def _index_mask(idx, capacity: int):
    i = np.zeros(capacity, dtype=np.int64)
    i[:len(idx)] = idx
    mask = np.zeros(capacity, dtype=bool)
    mask[:len(idx)] = True
    return i, mask


def _tensors(device, *arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                 for a in arrays)


@dataclasses.dataclass
class FactorBatch:
    """Between factors."""

    i: list
    j: list
    T_meas: list          # 4x4 np
    sigmas: list          # [6] np (rho, phi)

    @classmethod
    def empty(cls):
        return cls([], [], [], [])

    def add(self, i: int, j: int, T_meas: np.ndarray, sigmas: np.ndarray):
        self.i.append(i)
        self.j.append(j)
        self.T_meas.append(np.asarray(T_meas, dtype=np.float64))
        self.sigmas.append(np.asarray(sigmas, dtype=np.float64))

    def __len__(self):
        return len(self.i)

    def device_arrays(self, capacity: int, device):
        f = len(self.i)
        if f > capacity:
            raise ValueError(f"{f} factors exceed capacity {capacity}")
        fi, mask = _index_mask(self.i, capacity)
        fj, _ = _index_mask(self.j, capacity)
        Tm = _stack_rows(self.T_meas, f, capacity, np.eye(4))
        si = _stack_rows(self.sigmas, f, capacity, np.ones(6))
        return _tensors(device, fi, fj, Tm, 1.0 / si, mask)


@dataclasses.dataclass
class GpsFactorBatch:
    i: list          # pose node index
    enu: list        # [3]
    p_tg: list       # [3] tracking→gps translation
    sigmas: list     # [3]
    use_err: list    # bool — include the GPS_CALIB translation error

    @classmethod
    def empty(cls):
        return cls([], [], [], [], [])

    def add(self, i, enu, p_tg, sigmas, use_err=False):
        self.i.append(i)
        self.enu.append(np.asarray(enu, dtype=np.float64))
        self.p_tg.append(np.asarray(p_tg, dtype=np.float64))
        self.sigmas.append(np.asarray(sigmas, dtype=np.float64))
        self.use_err.append(bool(use_err))

    def __len__(self):
        return len(self.i)

    def device_arrays(self, capacity: int, device):
        f = len(self.i)
        gi, mask = _index_mask(self.i, capacity)
        enu = _stack_rows(self.enu, f, capacity, np.zeros(3))
        ptg = _stack_rows(self.p_tg, f, capacity, np.zeros(3))
        si = _stack_rows(self.sigmas, f, capacity, np.ones(3))
        ue = np.zeros(capacity, dtype=np.float32)
        ue[:f] = self.use_err
        return _tensors(device, gi, enu, ptg, 1.0 / si, ue, mask)


@dataclasses.dataclass
class OdomFactorBatch:
    i: list
    T_odom: list
    sigmas: list      # [6] (rho, phi)

    @classmethod
    def empty(cls):
        return cls([], [], [])

    def add(self, i, T_odom, sigmas):
        self.i.append(i)
        self.T_odom.append(np.asarray(T_odom, dtype=np.float64))
        self.sigmas.append(np.asarray(sigmas, dtype=np.float64))

    def __len__(self):
        return len(self.i)

    def device_arrays(self, capacity: int, device):
        f = len(self.i)
        oi, mask = _index_mask(self.i, capacity)
        To = _stack_rows(self.T_odom, f, capacity, np.eye(4))
        si = _stack_rows(self.sigmas, f, capacity, np.ones(6))
        return _tensors(device, oi, To, 1.0 / si, mask)


@dataclasses.dataclass
class PriorFactorBatch:
    i: list
    T_prior: list
    sigmas: list      # [6]

    @classmethod
    def empty(cls):
        return cls([], [], [])

    def add(self, i, T_prior, sigmas):
        self.i.append(i)
        self.T_prior.append(np.asarray(T_prior, dtype=np.float64))
        self.sigmas.append(np.asarray(sigmas, dtype=np.float64))

    def __len__(self):
        return len(self.i)

    def device_arrays(self, capacity: int, device):
        f = len(self.i)
        pi, mask = _index_mask(self.i, capacity)
        Tp = _stack_rows(self.T_prior, f, capacity, np.eye(4))
        si = _stack_rows(self.sigmas, f, capacity, np.ones(6))
        return _tensors(device, pi, Tp, 1.0 / si, mask)


# --------------------------------------------------------------------------
# per-factor linearizations shared by the dense and the PCG solver; each
# takes a batch of factors on its leading axis
# --------------------------------------------------------------------------

def _normal_blocks(J: torch.Tensor, r: torch.Tensor, w: torch.Tensor):
    """``(JᵀW²J, JᵀW²r)`` of whitened rows: ``J [F, d, k]``, ``r, w [F, d]``."""
    JW = J * w[..., None]
    return JW.mT @ JW, (JW.mT @ (r * w)[..., None])[..., 0]


def _lin_between(T_i, T_j, Tm, w, valid):
    M = se3.inverse(Tm) @ se3.inverse(T_i) @ T_j
    r = se3.log_se3(M)
    Jri = _jr_inv(r)
    Ji = -Jri @ _adjoint(se3.inverse(T_j) @ T_i)
    w = w * valid
    Wr = r * w
    JiW = Ji * w[..., None]
    JjW = Jri * w[..., None]
    return (JiW.mT @ JiW, JiW.mT @ JjW, JjW.mT @ JjW,
            (JiW.mT @ Wr[..., None])[..., 0],
            (JjW.mT @ Wr[..., None])[..., 0])


def _jac_at_zero(residual, dim: int):
    """``vmap`` over factors of ``(r, ∂r/∂ξ)`` at ξ = 0 (``dim`` tangents)."""
    def one(*args):
        xi0 = torch.zeros(dim, dtype=_F32, device=args[0].device)
        return residual(xi0, *args), jacfwd(residual)(xi0, *args)
    return vmap(one)


def _lin_gps(T_i, T_c, T_e, ptg, enu, use_err, w3, valid):
    r, J = _jac_at_zero(_gps_residual, 18)(T_i, T_c, T_e, ptg, enu, use_err)
    return _normal_blocks(J, r, w3 * valid)


def _lin_odom(T_i, T_k, To, w6, valid, k):
    r, J = _jac_at_zero(_odom_residual, 12)(T_i, T_k, To)
    # Huber(k) IRLS weight on the whitened residual
    # (NM::Robust Huber(1), isam_optimizer.cc:92)
    wh = _huber_weight(r * w6, k)
    return _normal_blocks(J, r, w6 * valid * wh[:, None])


def _lin_prior(T, Tp, w6, valid):
    r, J = _jac_at_zero(_prior_residual, 6)(T, Tp)
    return _normal_blocks(J, r, w6 * valid)


def _lin_aux(poses, gi, g_enu, g_ptg, g_inv_s, g_use_err, gmask,
             gps_coord_idx, gps_calib_idx, oi, o_T, o_inv_s, omask,
             odom_calib_idx, huber_k, pi, p_T, p_inv_s, pmask):
    """``[(H, b)]`` of the GPS, odom and prior factors, in that order; a
    type with no rows is left out."""
    G, O = gi.shape[0], oi.shape[0]
    out = []
    if G:
        out.append(_lin_gps(
            poses[gi], poses[gps_coord_idx].expand(G, 4, 4),
            poses[gps_calib_idx].expand(G, 4, 4), g_ptg, g_enu, g_use_err,
            g_inv_s, gmask.to(_F32)[:, None]))
    if O:
        out.append(_lin_odom(
            poses[oi], poses[odom_calib_idx].expand(O, 4, 4), o_T, o_inv_s,
            omask.to(_F32)[:, None], huber_k))
    if pi.shape[0]:
        out.append(_lin_prior(poses[pi], p_T, p_inv_s,
                              pmask.to(_F32)[:, None]))
    return out


def _at_zero(residual, dim: int):
    """``vmap`` over factors of the residual at ξ = 0."""
    def one(*args):
        return residual(torch.zeros(dim, dtype=_F32, device=args[0].device),
                        *args)
    return vmap(one)


def _between_cost(poses, fi, fj, T_meas, inv_sigmas, fmask):
    r = se3.log_se3(se3.inverse(T_meas) @ se3.inverse(poses[fi]) @ poses[fj])
    wr = r * inv_sigmas * fmask.to(_F32)[:, None]
    return torch.sum(wr * wr)


def _make_total_cost(fi, fj, T_meas, inv_sigmas, fmask,
                     gi, g_enu, g_ptg, g_inv_s, g_use_err, gmask,
                     gps_coord_idx, gps_calib_idx,
                     oi, o_T, o_inv_s, omask, odom_calib_idx, huber_k,
                     pi, p_T, p_inv_s, pmask):
    """Weighted SSE over every factor type (for the LM accept/reject).
    Huber on the odom factors is applied as its IRLS weight."""
    G, O = gi.shape[0], oi.shape[0]

    def total_cost(poses):
        c = _between_cost(poses, fi, fj, T_meas, inv_sigmas, fmask)
        if G:
            r = _at_zero(_gps_residual, 18)(
                poses[gi], poses[gps_coord_idx].expand(G, 4, 4),
                poses[gps_calib_idx].expand(G, 4, 4), g_ptg, g_enu,
                g_use_err)
            wr = r * g_inv_s * gmask.to(_F32)[:, None]
            c = c + torch.sum(wr * wr)
        if O:
            r = _at_zero(_odom_residual, 12)(
                poses[oi], poses[odom_calib_idx].expand(O, 4, 4), o_T)
            rw = r * o_inv_s
            wr = rw * _huber_weight(rw, huber_k)[:, None] \
                * omask.to(_F32)[:, None]
            c = c + torch.sum(wr * wr)
        if pi.shape[0]:
            r = _at_zero(_prior_residual, 6)(poses[pi], p_T)
            wr = r * p_inv_s * pmask.to(_F32)[:, None]
            c = c + torch.sum(wr * wr)
        return c

    return total_cost


def _lm_update(poses, cand, lam, total_cost):
    """Accept the candidate iff it lowers the true cost; returns
    ``(poses, lam, (c_cur, c_cand, lam_used))`` with no host read."""
    c_cand = total_cost(cand)
    c_cur = total_cost(poses)
    accept = c_cand < c_cur
    new_poses = torch.where(accept, cand, poses)
    new_lam = torch.where(accept, torch.clamp_min(lam / 3.0, 1e-7), lam * 8.0)
    return new_poses, new_lam, torch.stack([c_cur, c_cand, lam])


# --------------------------------------------------------------------------
# the dense solver (small graphs — one linear solve a trip)
# --------------------------------------------------------------------------

class _OrderedSum:
    """``out[idx[k]] += vals[k]`` over every k into a zero ``[size, ...]``,
    each slot summed from 0 in the order of k: the JAX package's sequence
    of ``.at[].add`` scatters, one after another, when their index and
    value arrays are concatenated in that sequence.

    The order is fixed once from ``idx`` (a stable sort, and each slot's
    segment of it; the factor indices do not change within a solve), and
    every call sums in it with ``segment_reduce``, which walks each
    (segment, column) of a 2-D input in one thread on the GPU, so the
    GPU's sums are the CPU's bit for bit, and writes each slot once, an
    empty segment as 0.  ``index_add_`` adds with atomics on the GPU, in
    an order that changes from run to run."""

    def __init__(self, idx: torch.Tensor, size: int):
        sidx, self.order = torch.sort(idx.reshape(-1), stable=True)
        self.offsets = torch.searchsorted(
            sidx, torch.arange(size + 1, device=sidx.device))

    def __call__(self, vals: torch.Tensor) -> torch.Tensor:
        """``vals [K, ...]`` (K = ``idx.numel()``) → ``[size, ...]``."""
        v = (vals.flatten(1) if vals.dim() > 1 else vals[:, None])[self.order]
        out = torch.segment_reduce(v, "sum", offsets=self.offsets, axis=0,
                                   unsafe=True)
        return out.reshape(out.shape[:1] + vals.shape[1:])


def _block_index(rows: torch.Tensor, cols: torch.Tensor,
                 width: int) -> torch.Tensor:
    """Flat index of ``H[rows[f, a], cols[f, b]]`` in a ``[., width]`` H."""
    return rows[:, :, None] * width + cols[:, None, :]


def gauss_newton(poses, node_mask,
                 fi, fj, T_meas, inv_sigmas, fmask,
                 gi, g_enu, g_ptg, g_inv_s, g_use_err, gmask,
                 gps_coord_idx, gps_calib_idx,
                 oi, o_T, o_inv_s, omask, odom_calib_idx, huber_k,
                 pi, p_T, p_inv_s, pmask,
                 num_iters: int = 8, damping: float = 1e-6,
                 gauge_weight: float = 1e8):
    """Run ``num_iters`` LM trips over all factor types; returns ``(poses,
    chi2, trace [num_iters, 3])`` on the device.

    poses: ``[N, 4, 4]`` f32 (regular nodes + special nodes, whose indices
    are passed as data).  Node 0 is gauge-fixed by a heavy diagonal prior.
    Every factor array is padded to capacity with masks."""
    n = poses.shape[0]
    n6 = n * 6
    dev = poses.device
    rows6 = torch.arange(6, device=dev)
    G, O = gi.shape[0], oi.shape[0]
    total_cost = _make_total_cost(
        fi, fj, T_meas, inv_sigmas, fmask,
        gi, g_enu, g_ptg, g_inv_s, g_use_err, gmask,
        gps_coord_idx, gps_calib_idx,
        oi, o_T, o_inv_s, omask, odom_calib_idx, huber_k,
        pi, p_T, p_inv_s, pmask)
    ri = fi[:, None] * 6 + rows6
    rj = fj[:, None] * 6 + rows6
    gidx = torch.cat([gi[:, None] * 6 + rows6,
                      (gps_coord_idx * 6 + rows6).expand(G, 6),
                      (gps_calib_idx * 6 + rows6).expand(G, 6)], dim=1)
    oidx = torch.cat([oi[:, None] * 6 + rows6,
                      (odom_calib_idx * 6 + rows6).expand(O, 6)], dim=1)
    pidx = pi[:, None] * 6 + rows6
    # base damping, gauge prior on node 0, inactive-node regularization
    diag0 = torch.full((n6,), damping, dtype=_F32, device=dev)
    diag0[:6] += gauge_weight
    diag0 = diag0 + torch.repeat_interleave((~node_mask).to(_F32), 6)

    # every H and b entry of every factor type, in the JAX package's
    # order of scatters: between (ii, ij, ji, jj), GPS, odom, prior
    aux_idx = [idx for idx in (gidx, oidx, pidx) if idx.shape[0]]
    sum_H = _OrderedSum(torch.cat(
        [_block_index(a, c, n6).reshape(-1)
         for a, c in ((ri, ri), (ri, rj), (rj, ri), (rj, rj))]
        + [_block_index(idx, idx, n6).reshape(-1) for idx in aux_idx]),
        n6 * n6)
    sum_b = _OrderedSum(torch.cat(
        [ri.reshape(-1), rj.reshape(-1)]
        + [idx.reshape(-1) for idx in aux_idx]), n6)

    lam = torch.full((), 1e-4, dtype=_F32, device=dev)
    trace = []
    for _ in range(num_iters):
        H_ii, H_ij, H_jj, b_i, b_j = _lin_between(
            poses[fi], poses[fj], T_meas, inv_sigmas,
            fmask.to(_F32)[:, None])
        aux = _lin_aux(
            poses, gi, g_enu, g_ptg, g_inv_s, g_use_err, gmask,
            gps_coord_idx, gps_calib_idx, oi, o_T, o_inv_s, omask,
            odom_calib_idx, huber_k, pi, p_T, p_inv_s, pmask)
        H = sum_H(torch.cat(
            [B.reshape(-1) for B in (H_ii, H_ij, H_ij.mT, H_jj)]
            + [Hk.reshape(-1) for Hk, _ in aux])).reshape(n6, n6)
        b = sum_b(torch.cat([b_i.reshape(-1), b_j.reshape(-1)]
                            + [bk.reshape(-1) for _, bk in aux]))

        H.diagonal().add_(diag0)
        # Levenberg-Marquardt: multiplicative damping bounds the step along
        # weakly observable directions (an extrinsic-calib DoF barely
        # excited by the motion); plain GN oscillates there
        H.diagonal().add_(lam * torch.clamp_min(H.diagonal(), 1e-6))
        # Jacobi-scaled solve: the gauge weight makes κ(H) ~ 1e8, beyond
        # f32; scaling by 1/sqrt(diag) restores the conditioning
        s = 1.0 / torch.sqrt(torch.clamp_min(torch.diagonal(H), 1e-12))
        Hs = H * s[:, None] * s[None, :]
        dx, _ = torch.linalg.solve_ex(Hs, -(b * s)[:, None])
        dx = dx[:, 0] * s
        dx = torch.where(torch.isfinite(dx), dx, 0.0)
        cand = poses @ se3.exp_se3(dx.reshape(n, 6))
        cand = torch.where(node_mask[:, None, None], cand, poses)
        poses, lam, t = _lm_update(poses, cand, lam, total_cost)
        trace.append(t)

    # final chi2 for reporting (between factors only — the graph backbone)
    chi2 = _between_cost(poses, fi, fj, T_meas, inv_sigmas, fmask)
    return poses, chi2, torch.stack(trace, dim=1)


class PoseGraph:
    """Host wrapper: collect factors, optimize with capacity bucketing
    (capacities round up to powers of two).  The state carries
    NUM_SPECIAL_NODES shared calibration nodes after the regular pose nodes
    (GPS coord transform, odom extrinsic, GPS translation error).  Solves
    run on ``device``: the GPU unless the caller names another."""

    # past this node count the dense [6n, 6n] solve is replaced by the
    # matrix-free block-sparse PCG solver (pose_graph_sparse.py)
    DENSE_NODE_LIMIT = 192

    def __init__(self, device=None):
        self.device = resolve_device(device)
        self.factors = FactorBatch.empty()
        self.gps_factors = GpsFactorBatch.empty()
        self.odom_factors = OdomFactorBatch.empty()
        self.prior_factors = PriorFactorBatch.empty()  # special-node priors
        self.num_nodes = 0
        # special node values (host f64), updated by optimize()
        self.special_values = [np.eye(4) for _ in range(NUM_SPECIAL_NODES)]
        self.last_chi2 = 0.0
        self.last_trace = None

    def add_node(self) -> int:
        idx = self.num_nodes
        self.num_nodes += 1
        return idx

    def add_between(self, i: int, j: int, T_ij: np.ndarray,
                    sigmas=(0.15, 0.15, 0.15, 0.1, 0.1, 0.1)):
        """sigmas order (trans xyz, rot xyz) — the reference's frame-match
        noise by default (isam_optimizer.cc:81-83, order converted)."""
        self.factors.add(i, j, T_ij, np.asarray(sigmas))

    def add_gps(self, i: int, enu, p_tracking_gps=(0.0, 0.0, 0.0),
                sigma: float = 0.15, use_calib_error: bool = False):
        """GPS-ENU point factor (gps_noise iso 0.15, isam_optimizer.cc:79)."""
        self.gps_factors.add(i, enu, p_tracking_gps,
                             np.full(3, sigma), use_calib_error)

    def add_odom(self, i: int, T_odom,
                 sigmas=(1.5, 1.5, 2.0, 0.2, 0.2, 0.2)):
        """Odom extrinsic-calibration factor (odom_noise Huber(1) over
        rot(0.2)/trans(1.5,1.5,2), isam_optimizer.cc:92-94; order converted
        to (trans, rot))."""
        self.odom_factors.add(i, T_odom, np.asarray(sigmas))

    def add_special_prior(self, which: int, T_prior, sigmas):
        """Prior on a special node (which ∈ {SPECIAL_GPS_COORD,
        SPECIAL_ODOM_CALIB, SPECIAL_GPS_CALIB}); its index is resolved at
        solve time.  sigmas order (trans, rot)."""
        self.prior_factors.add(-(which + 1), T_prior, np.asarray(sigmas))

    def set_special_value(self, which: int, T: np.ndarray):
        self.special_values[which] = np.asarray(T, dtype=np.float64)

    def get_special_value(self, which: int) -> np.ndarray:
        return self.special_values[which]

    @property
    def has_aux_factors(self) -> bool:
        return (len(self.gps_factors) + len(self.odom_factors)
                + len(self.prior_factors)) > 0

    def solver_args(self, poses_np: np.ndarray, min_fcap: int = 16):
        """The solver argument tuple ``(poses, node_mask, fi, fj, T_meas,
        inv_sigmas, fmask, …)`` shared by the dense and the PCG solver, with
        the padded node count and the first special node's index."""
        n = self.num_nodes
        if poses_np.shape[0] != n:
            raise ValueError(f"{poses_np.shape[0]} poses for {n} nodes")
        dev = self.device
        ncap = _pad_pow2(n + NUM_SPECIAL_NODES, 8)
        fcap = _pad_pow2(len(self.factors), min_fcap)
        # a factor type with no factors gets no rows at all (the JAX package
        # pads it to 4 masked rows): the solvers then skip its batched
        # autodiff linearization, whose masked rows would add exact zeros
        gcap, ocap, pcap = (_pad_pow2(len(f), 4) if len(f) else 0
                            for f in (self.gps_factors, self.odom_factors,
                                      self.prior_factors))

        # special nodes live at indices n .. n+2
        sp_base = n
        poses = np.tile(np.eye(4, dtype=np.float32), (ncap, 1, 1))
        poses[:n] = poses_np.astype(np.float32)
        for k in range(NUM_SPECIAL_NODES):
            poses[sp_base + k] = self.special_values[k].astype(np.float32)
        node_mask = np.zeros(ncap, dtype=bool)
        node_mask[:n] = True
        node_mask[sp_base + SPECIAL_GPS_COORD] = len(self.gps_factors) > 0
        node_mask[sp_base + SPECIAL_ODOM_CALIB] = len(self.odom_factors) > 0
        node_mask[sp_base + SPECIAL_GPS_CALIB] = any(self.gps_factors.use_err)

        # resolve special-node references (stored as -(which+1))
        pf = PriorFactorBatch([sp_base - i - 1 if i < 0 else i
                               for i in self.prior_factors.i],
                              self.prior_factors.T_prior,
                              self.prior_factors.sigmas)
        args = (*_tensors(dev, poses, node_mask),
                *self.factors.device_arrays(fcap, dev),
                *self.gps_factors.device_arrays(gcap, dev),
                sp_base + SPECIAL_GPS_COORD, sp_base + SPECIAL_GPS_CALIB,
                *self.odom_factors.device_arrays(ocap, dev),
                sp_base + SPECIAL_ODOM_CALIB, 1.0,
                *pf.device_arrays(pcap, dev))
        return args, ncap, sp_base

    def finish_optimize(self, out, chi2, sp_base, node_mask) -> np.ndarray:
        """Post-solve bookkeeping: record chi², pull the special-node
        estimates, re-orthonormalize after the f32 accumulation."""
        n = self.num_nodes
        self.last_chi2 = float(chi2)
        out = out.cpu().double().numpy()
        node_mask = np.asarray(node_mask.cpu() if torch.is_tensor(node_mask)
                               else node_mask)
        for k in range(NUM_SPECIAL_NODES):
            if node_mask[sp_base + k]:
                self.special_values[k] = np_se3.normalize_rotation(
                    out[sp_base + k])
        return np.stack([np_se3.normalize_rotation(T) for T in out[:n]])

    def optimize(self, poses_np: np.ndarray, num_iters: int = 8,
                 solver: str = "auto", mesh=None) -> np.ndarray:
        """poses_np [n, 4, 4] f64 → optimized [n, 4, 4] f64.  The special
        nodes' estimates are updated in ``self.special_values``.

        solver: "dense" (one linear solve a trip — small graphs), "pcg"
        (matrix-free block-sparse GN+PCG — large graphs), or "auto" (by node
        count).  A ``mesh`` (``parallel.multihost``) turns the PCG path into
        the sharded solve (between factors sharded over the mesh's ranks,
        every rank calling with the same graph); the dense solver ignores
        it, as in the JAX package."""
        from . import pose_graph_sparse
        args, ncap, sp_base = self.solver_args(poses_np)
        if solver == "auto":
            solver = "dense" if ncap <= self.DENSE_NODE_LIMIT else "pcg"
        if solver == "dense":
            out, chi2, self.last_trace = gauss_newton(
                *args, num_iters=num_iters)
        elif solver == "pcg" and mesh is not None:
            out, chi2, self.last_trace = pose_graph_sparse.solve_sharded(
                mesh, *args, num_iters=num_iters)
        elif solver == "pcg":
            out, chi2, self.last_trace = pose_graph_sparse.gauss_newton_pcg(
                *args, num_iters=num_iters)
        else:
            raise ValueError(f"unknown solver {solver!r}")
        return self.finish_optimize(out, chi2, sp_base, args[1])
