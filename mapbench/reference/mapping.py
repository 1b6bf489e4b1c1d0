"""Plain reference of what the window's path computes, for one scan or one
submap pair at a time: a frozen copy, in plain torch, of the port's
type-6 front end step (input quantisation, the Range / AxisRange /
RandomSampler filters, the kd-split target normals, the while-form
point-to-plane ICP) and of its pair match (the submap merge with its
voxel filter, the target normals, the fixed-trip point-to-plane ICP on a
strided source, the acceptance score).

It imports nothing of the program.  Every function computes in the
``Precision`` it is given: the check runs the reference in float32, the
configuration's precision, and the control with every matrix product's
operands rounded to TF32 (10 bits of mantissa), as the tensor cores read
them; cuBLAS would run products as narrow as these (three columns) in
plain float32 even with TF32 allowed.  The nearest neighbours come
from the ``|q|^2 + |t|^2 - 2 q.t`` expansion, tile by tile, ties to the
lowest index, as the port's plain 1-NN does.
"""
from __future__ import annotations

import numpy as np
import torch

PAD = 1.0e6            # coordinate of a padded slot
FAR = 1.0e6            # coordinate of a target the 1-NN must not pick
QXYZ = 256.0           # the chunk's int16 xyz quantum: 1/256 m
SMOOTH = 4             # convergence window of the ICP (trips)
RING = SMOOTH + 2
CONV_ROT = 1.0e-3
CONV_TRANS = 1.0e-2
NN_TILE = 4096
NN_ROWS = 16384


class Precision:
    """The dtype of the computation, and whether the operands of its
    matrix products are rounded to TF32 first."""

    def __init__(self, dtype=torch.float32, tf32: bool = False):
        self.dtype = dtype
        self.tf32 = tf32

    def mm(self, a, b):
        if self.tf32:
            a, b = to_tf32(a), to_tf32(b)
        return a @ b


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to the nearest TF32 value (10 mantissa bits)."""
    i = x.contiguous().view(torch.int32)
    return ((i + 0x1000) & -0x2000).view(torch.float32)


# ------------------------------------------------------------ rotations --
def _qnorm(q):
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True).clamp_min(
        1e-12)


def quat_to_matrix(q):
    w, x, y, z = _qnorm(q).unbind(-1)
    m = torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], -1)
    return m.reshape(m.shape[:-1] + (3, 3))


def matrix_to_quat(m):
    """Shepperd's method, the largest of the four candidates, w >= 0."""
    def e(i, j):
        return m[..., i, j:j + 1]
    m00, m01, m02 = e(0, 0), e(0, 1), e(0, 2)
    m10, m11, m12 = e(1, 0), e(1, 1), e(1, 2)
    m20, m21, m22 = e(2, 0), e(2, 1), e(2, 2)
    q2 = [1.0 + m00 + m11 + m22, 1.0 + m00 - m11 - m22,
          1.0 - m00 + m11 - m22, 1.0 - m00 - m11 + m22]
    s = [torch.sqrt(v.clamp_min(1e-12)) * 2.0 for v in q2]
    cands = torch.stack([
        torch.cat([0.25 * s[0], (m21 - m12) / s[0], (m02 - m20) / s[0],
                   (m10 - m01) / s[0]], -1),
        torch.cat([(m21 - m12) / s[1], 0.25 * s[1], (m01 + m10) / s[1],
                   (m02 + m20) / s[1]], -1),
        torch.cat([(m02 - m20) / s[2], (m01 + m10) / s[2], 0.25 * s[2],
                   (m12 + m21) / s[2]], -1),
        torch.cat([(m10 - m01) / s[3], (m02 + m20) / s[3], (m12 + m21) / s[3],
                   0.25 * s[3]], -1)], -2)
    idx = torch.argmax(torch.cat(q2, -1), -1)
    q = torch.gather(cands, -2, idx[..., None, None].expand(
        idx.shape + (1, 4)))[..., 0, :]
    q = torch.where(q[..., :1] < 0, -q, q)
    return _qnorm(q)


def euler_to_matrix(e):
    """(roll, pitch, yaw), ZYX."""
    cr, sr = torch.cos(e[..., 0] * 0.5), torch.sin(e[..., 0] * 0.5)
    cp, sp = torch.cos(e[..., 1] * 0.5), torch.sin(e[..., 1] * 0.5)
    cy, sy = torch.cos(e[..., 2] * 0.5), torch.sin(e[..., 2] * 0.5)
    return quat_to_matrix(torch.stack([
        cy * cp * cr + sy * sp * sr, cy * cp * sr - sy * sp * cr,
        cy * sp * cr + sy * cp * sr, sy * cp * cr - cy * sp * sr], -1))


def matrix_to_euler(R):
    sy = torch.sqrt(R[..., 0, 0] ** 2 + R[..., 1, 0] ** 2)
    singular = sy < 1e-6
    x = torch.where(singular, torch.atan2(-R[..., 1, 2], R[..., 1, 1]),
                    torch.atan2(R[..., 2, 1], R[..., 2, 2]))
    y = torch.atan2(-R[..., 2, 0], sy)
    z = torch.where(singular, torch.zeros_like(sy),
                    torch.atan2(R[..., 1, 0], R[..., 0, 0]))
    return torch.stack([x, y, z], -1)


def _skew(v):
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    o = torch.zeros_like(x)
    m = torch.stack([o, -z, y, z, o, -x, -y, x, o], -1)
    return m.reshape(m.shape[:-1] + (3, 3))


def axis_angle_to_matrix(w, prec):
    sq = torch.sum(w * w, -1, keepdim=True)[..., None]
    small = sq < 1e-2
    theta = torch.sqrt(torch.where(small, torch.ones_like(sq), sq))
    a = torch.where(small, 1.0 - sq / 6.0 + sq * sq / 120.0,
                    torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - sq / 24.0 + sq * sq / 720.0,
                    (1.0 - torch.cos(theta)) / sq)
    S = _skew(w)
    return (torch.eye(3, dtype=w.dtype, device=w.device) + a * S
            + b * prec.mm(S, S))


def from_rt(R, t):
    T = torch.eye(4, dtype=R.dtype, device=R.device).repeat(
        R.shape[:-2] + (1, 1))
    T[..., :3, :3] = R
    T[..., :3, 3] = t
    return T


def inverse(T, prec):
    Rt = T[..., :3, :3].transpose(-1, -2)
    return from_rt(Rt, -prec.mm(Rt, T[..., :3, 3:])[..., 0])


def apply(T, pts, prec):
    return prec.mm(pts, T[..., :3, :3].transpose(-1, -2)) + T[..., None, :3, 3]


def normalize_rotation(T):
    return from_rt(quat_to_matrix(matrix_to_quat(T[..., :3, :3])),
                   T[..., :3, 3])


# ---------------------------------------------------------------- inputs --
def quantized(points: np.ndarray, capacity: int, prec, device):
    """A host scan as the chunked front end sees it: xyz at 1/256 m in
    ``capacity`` slots, ``(xyz [C, 3], valid [C])``."""
    n = min(len(points), capacity)
    q = np.clip(np.round(points[:n, :3] * np.float32(QXYZ)), -32767, 32767)
    xyz = np.full((capacity, 3), PAD)
    xyz[:n] = q.astype(np.int16).astype(np.float64) / QXYZ
    mask = np.arange(capacity) < n
    return (torch.as_tensor(xyz, dtype=prec.dtype, device=device),
            torch.as_tensor(mask, device=device))


_MASK32 = 0xFFFFFFFF


def _threefry_uniform(seed: int, n: int, device) -> torch.Tensor:
    """``jax.random.uniform(jax.random.key(seed), (n,))``, float32: the
    RandomSampler's draw."""
    def rotl(x, d):
        return ((x << d) | (x >> (32 - d))) & _MASK32
    k1, k2 = 0, int(seed) & _MASK32
    ks = (k1, k2, (k1 ^ k2 ^ 0x1BD11BDA) & _MASK32)
    c = torch.arange(n, dtype=torch.int64, device=device)
    x0 = ((c >> 32) + ks[0]) & _MASK32
    x1 = ((c & _MASK32) + ks[1]) & _MASK32
    rots = ((13, 15, 26, 6), (17, 29, 16, 24))
    for i in range(5):
        for r in rots[i % 2]:
            x0 = (x0 + x1) & _MASK32
            x1 = rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _MASK32
    bits = ((x0 ^ x1) >> 9) | 0x3F800000
    return bits.to(torch.int32).view(torch.float32) - 1.0


def filtered(xyz, mask, filters: dict):
    """The configuration's filter chain: Range, AxisRange (z), then the
    RandomSampler's draw of seed 0 over the slots."""
    r = torch.linalg.vector_norm(xyz, dim=-1)
    mask = mask & (r >= filters["min_range_m"]) & (r <= 3.4e38)
    z = xyz[:, 2]
    mask = mask & (z >= filters["min_z_m"]) & (z <= 3.4e38)
    u = _threefry_uniform(0, mask.shape[0], xyz.device)
    return mask & (u < filters["sampling_rate"])


def compact(xyz, mask):
    order = torch.argsort((~mask).to(torch.uint8), stable=True)
    return xyz[order], mask[order]


# --------------------------------------------------------------- normals --
def _solve3(A, b):
    a = [[A[..., i, j] for j in range(3)] for i in range(3)]
    c00 = a[1][1] * a[2][2] - a[1][2] * a[2][1]
    c01 = a[1][2] * a[2][0] - a[1][0] * a[2][2]
    c02 = a[1][0] * a[2][1] - a[1][1] * a[2][0]
    det = a[0][0] * c00 + a[0][1] * c01 + a[0][2] * c02
    inv = 1.0 / torch.where(torch.abs(det) > 1e-30, det,
                            torch.ones_like(det))
    c10 = a[0][2] * a[2][1] - a[0][1] * a[2][2]
    c11 = a[0][0] * a[2][2] - a[0][2] * a[2][0]
    c12 = a[0][1] * a[2][0] - a[0][0] * a[2][1]
    c20 = a[0][1] * a[1][2] - a[0][2] * a[1][1]
    c21 = a[0][2] * a[1][0] - a[0][0] * a[1][2]
    c22 = a[0][0] * a[1][1] - a[0][1] * a[1][0]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    x = torch.stack([(c00 * b0 + c10 * b1 + c20 * b2) * inv,
                     (c01 * b0 + c11 * b1 + c21 * b2) * inv,
                     (c02 * b0 + c12 * b1 + c22 * b2) * inv], -1)
    return x, det


def _leaf_normals(pts, mask, leaf: int, prec):
    m = pts.shape[0] // leaf
    pts = pts.reshape(m, leaf, 3)
    lm = mask.reshape(m, leaf)
    w = lm.to(pts.dtype)[..., None]
    count = torch.sum(lm, -1)
    d = pts * w
    b = torch.sum(d, -2)
    mean = b / count.clamp_min(1)[:, None].to(pts.dtype)
    M = prec.mm(d.transpose(-1, -2), pts * w)
    cen = (pts - mean[:, None]) * w
    C = prec.mm(cen.transpose(-1, -2), cen)
    i2 = ((C[:, 0, 0] * C[:, 1, 1] - C[:, 0, 1] ** 2)
          + (C[:, 0, 0] * C[:, 2, 2] - C[:, 0, 2] ** 2)
          + (C[:, 1, 1] * C[:, 2, 2] - C[:, 1, 2] ** 2))
    tr = C[:, 0, 0] + C[:, 1, 1] + C[:, 2, 2]
    rank_ok = i2 > 1e-5 * torch.clamp_min(tr * tr, 1e-20)
    s = 1.0 / torch.sqrt(torch.clamp_min(torch.diagonal(M, dim1=-2,
                                                        dim2=-1), 1e-12))
    A = M * s[:, :, None] * s[:, None, :] + 1e-7 * torch.eye(
        3, dtype=pts.dtype, device=pts.device)
    sol, det = _solve3(A, b * s)
    sol = sol * s
    normal = sol / torch.clamp_min(torch.linalg.vector_norm(
        sol, dim=-1, keepdim=True), 1e-12)
    valid = ((count >= 3) & rank_ok & (torch.abs(det) > 1e-30)
             & torch.isfinite(normal).all(-1))
    return (torch.where(valid[:, None], mean, torch.full_like(mean, PAD)),
            torch.where(valid[:, None], normal, 0.0), valid)


def kdsplit_normals(xyz, mask, leaf: int, prec):
    """Median splits along each segment's widest valid extent down to
    leaves of ``leaf`` slots, one mean point and normal a leaf:
    ``(xyz [C/leaf, 3], normal, valid)``."""
    x, mask = compact(xyz, mask)
    n = x.shape[0]
    seg = 1
    inf = float("inf")
    while n // seg > leaf:
        L = n // seg
        st = x.reshape(seg, L, 3).transpose(1, 2)          # [S, 3, L]
        ms = mask.reshape(seg, L)
        ext = (torch.amax(torch.where(ms[:, None], st, -inf), -1)
               - torch.amin(torch.where(ms[:, None], st, inf), -1))
        ext = torch.where(torch.isfinite(ext), ext, 0.0)
        cut = torch.argmax(ext, -1)
        vals = torch.gather(st, 1, cut[:, None, None].expand(seg, 1, L))[:, 0]
        perm = torch.sort(torch.where(ms, vals, inf), dim=-1,
                          stable=True).indices
        st = torch.gather(st, 2, perm[:, None].expand(st.shape))
        ms = torch.gather(ms, 1, perm)
        x = st.transpose(1, 2).reshape(n, 3)
        mask = ms.reshape(n)
        seg *= 2
    return _leaf_normals(x, mask, leaf, prec)


# ------------------------------------------------------------------- ICP --
def nearest(query, tgt, tmask, prec):
    """Index of the nearest valid target of every query row."""
    t = torch.where(tmask[:, None], tgt, torch.full_like(tgt, FAR))
    t2 = torch.sum(t * t, -1).masked_fill(~tmask, float("inf"))
    out = []
    for q0 in range(0, query.shape[0], NN_ROWS):
        q = query[q0:q0 + NN_ROWS]
        q2 = torch.sum(q * q, -1, keepdim=True)
        best_d = torch.full(q.shape[:1], float("inf"), dtype=q.dtype,
                            device=q.device)
        best_i = torch.zeros(q.shape[:1], dtype=torch.int64, device=q.device)
        for a in range(0, t.shape[0], NN_TILE):
            d2 = (q2 + t2[None, a:a + NN_TILE]
                  - 2.0 * prec.mm(q, t[a:a + NN_TILE].T)).clamp_min(0.0)
            d, i = torch.min(d2, -1)
            take = d < best_d
            best_d = torch.where(take, d, best_d)
            best_i = torch.where(take, i + a, best_i)
        out.append(best_i)
    return torch.cat(out)


def _quantile_fast(values, mask, q, rounds: int = 16):
    v = torch.where(mask, values, 0.0)
    hi = torch.amax(v) + 1e-12
    lo = torch.zeros_like(hi)
    want = q * torch.sum(mask).to(values.dtype)
    for _ in range(rounds):
        mid = 0.5 * (lo + hi)
        below = torch.sum((v <= mid) & mask).to(values.dtype) < want
        lo = torch.where(below, mid, lo)
        hi = torch.where(below, hi, mid)
    return hi


def _solve6(A, b):
    s = 1.0 / torch.sqrt(torch.clamp_min(torch.diagonal(A), 1e-10))
    As = A * s[:, None] * s[None, :] + 1e-8 * torch.eye(
        6, dtype=A.dtype, device=A.device)
    x, info = torch.linalg.solve_ex(As, (b * s)[:, None])
    x = x[:, 0] * s
    return torch.where(torch.isfinite(x).all() & (info == 0), x,
                       torch.zeros_like(x))


def point_to_plane(src, smask, tgt, tnormal, tmask, guess, prec,
                   ratio: float = 0.7, max_trips: int = 100,
                   fixed_trips: int = 0):
    """``(T, score, trips)``: ``src`` onto the target's planes from
    ``guess``, trimmed at the ``ratio`` quantile of the squared matches;
    ``fixed_trips > 0`` runs that many trips, else up to ``max_trips``
    until converged.  A converged pair keeps its state."""
    dt = src.dtype
    # the masked rows add nothing to any sum: leave them out
    src, smask = src[smask], smask[smask]
    cnt = torch.sum(tmask).clamp_min(1).to(dt)
    mean = torch.sum(torch.where(tmask[:, None], tgt, 0.0), 0) / cnt
    tpts = torch.where(tmask[:, None], tgt - mean, torch.full_like(tgt, FAR))
    eye3 = torch.eye(3, dtype=dt, device=src.device)
    T_mean = from_rt(eye3, mean)
    T_init = prec.mm(inverse(T_mean, prec), guess)
    src0 = apply(T_init, src, prec)
    T_it = torch.eye(4, dtype=dt, device=src.device)
    quats = torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=dt,
                         device=src.device).repeat(RING, 1)
    trans = torch.zeros((RING, 3), dtype=dt, device=src.device)
    it, score, converged = 0, None, False
    trips = fixed_trips if fixed_trips > 0 else max_trips
    for _ in range(trips):
        if converged:
            break
        step = apply(T_it, src0, prec)
        j = nearest(step, tpts, tmask, prec)
        q, n = tpts[j], tnormal[j]
        diff = step - q
        d2 = torch.where(smask, torch.sum(diff * diff, -1), float("inf"))
        lim = _quantile_fast(d2, smask, ratio)
        w = ((d2 <= lim) & smask).to(dt)
        F = torch.cat([torch.linalg.cross(step, n, dim=-1), n], -1)
        wF = F * w[:, None]
        A = prec.mm(wF.T, F)
        b = -prec.mm(wF.T, torch.sum(diff * n, -1)[:, None])[:, 0]
        x = _solve6(A, b)
        T_it = prec.mm(from_rt(axis_angle_to_matrix(x[:3], prec), x[3:]),
                       T_it)
        quats = torch.cat([quats[1:], matrix_to_quat(T_it[:3, :3])[None]])
        trans = torch.cat([trans[1:], T_it[None, :3, 3]])
        it += 1
        dots = torch.abs(torch.sum(quats[-SMOOTH:] * quats[-SMOOTH - 1:-1],
                                   -1)).clamp(0.0, 1.0)
        rot_d = torch.mean(2.0 * torch.arccos(dots))
        trans_d = torch.mean(torch.linalg.vector_norm(
            trans[-SMOOTH:] - trans[-SMOOTH - 1:-1], dim=-1))
        converged = bool((it >= SMOOTH + 1) & (rot_d < CONV_ROT)
                         & (trans_d < CONV_TRANS))
        kept = torch.clamp_min(torch.sum(w), 1.0)
        dist = torch.sqrt(torch.clamp_min(d2, 0.0))
        score = torch.exp(-torch.sum(torch.where(w > 0, dist, 0.0)) / kept)
    return prec.mm(prec.mm(T_mean, T_it), T_init), float(score), it


# ------------------------------------------------------------ the steps --
def ctrv_guess(F_prev2: np.ndarray, F_prev: np.ndarray, prec, device):
    """The chunked front end's guess for a scan whose two predecessors
    were keyframes at ``F_prev2``, ``F_prev``: the last step's rotation
    (as Euler angles, at most 0.5 rad) and translation (at most 5 m),
    relative to the newer."""
    A = torch.as_tensor(F_prev2, dtype=prec.dtype, device=device)
    B = torch.as_tensor(F_prev, dtype=prec.dtype, device=device)
    ang = matrix_to_euler(prec.mm(A[:3, :3].T, B[:3, :3]))
    an = torch.linalg.vector_norm(ang)
    ang = ang * (torch.clamp_max(an, 0.5) / torch.clamp_min(an, 1e-9))
    step = B[:3, 3] - A[:3, 3]
    tn = torch.linalg.vector_norm(step)
    step = step * (torch.clamp_max(tn, 5.0) / torch.clamp_min(tn, 1e-9))
    return from_rt(euler_to_matrix(ang),
                   prec.mm(B[:3, :3].T, step[:, None])[:, 0])


def frontend_step(scan_prev: np.ndarray, scan: np.ndarray, F_prev2, F_prev,
                  cfg: dict, prec, device):
    """Registration of ``scan`` onto the keyframe ``scan_prev``:
    ``(T, source xyz, source mask)``."""
    cap = cfg["scan_capacity"]
    tx, tm = quantized(scan_prev, cap, prec, device)
    tm = filtered(tx, tm, cfg["filters"])
    t_xyz, t_n, t_ok = kdsplit_normals(tx, tm, cfg["target_leaf"], prec)
    sx, sm = quantized(scan, cap, prec, device)
    sm = filtered(sx, sm, cfg["filters"])
    guess = ctrv_guess(F_prev2, F_prev, prec, device)
    T, _, _ = point_to_plane(sx, sm, t_xyz, t_n, t_ok, guess, prec,
                             ratio=cfg["dist_outlier_ratio"],
                             max_trips=cfg["max_iteration"])
    return T, sx, sm


def is_keyframe(T, motion_filter: dict) -> bool:
    """The motion filter: a step of at least ``translation_m``, or of at
    least ``angle_deg`` summed over its Euler angles, makes a keyframe."""
    accu_t = float(torch.linalg.vector_norm(T[:3, 3]))
    accu_a = float(torch.sum(torch.abs(matrix_to_euler(T[:3, :3])))) * (
        180.0 / np.pi)
    return (accu_t >= motion_filter["translation_m"]
            or (motion_filter["angle_deg"] > 1e-3
                and accu_a >= motion_filter["angle_deg"]))


def voxel_downsample(xyz, mask, voxel: float):
    """Centroid of each occupied voxel (index ``round(p / voxel)``), in the
    order of their (x, y, z) indices, summed in point order."""
    keys = torch.round(xyz / torch.as_tensor(voxel, dtype=xyz.dtype,
                                             device=xyz.device)).to(
        torch.int64)
    keys = torch.where(mask[:, None], keys, torch.full_like(keys, 2**31 - 1))
    order = torch.arange(keys.shape[0], device=xyz.device)
    for axis in (2, 1, 0):
        perm = torch.sort(keys[order, axis], stable=True).indices
        order = order[perm]
    sk, sm, sx = keys[order], mask[order], xyz[order]
    change = (sk[1:] != sk[:-1]).any(-1)
    seg = torch.cumsum(torch.cat([torch.ones_like(change[:1]), change]).to(
        torch.int64), 0) - 1
    n = xyz.shape[0]
    sums = torch.zeros((n, 3), dtype=xyz.dtype, device=xyz.device)
    count = torch.zeros((n,), dtype=xyz.dtype, device=xyz.device)
    # sequential sums per voxel in point order, as the port's segment sum
    seg_v, sx_v = seg[sm], sx[sm]
    lengths = torch.bincount(seg_v, minlength=n)
    red = torch.segment_reduce(sx_v, "sum", lengths=lengths, axis=0,
                               unsafe=True)
    sums[:red.shape[0]] = red
    count[:lengths.shape[0]] = lengths.to(xyz.dtype)
    valid = count > 0
    mean = sums / count.clamp_min(1.0)[:, None]
    return torch.where(valid[:, None], mean, torch.full_like(mean, PAD)), \
        valid


def merged_submap(scans, poses, cfg: dict, prec, device):
    """A submap's cloud: its scans (filtered, as the front end keeps
    them) moved by their poses within the submap, compacted into
    ``submap_capacity`` slots and voxel-filtered."""
    cap = cfg["submap_capacity"]
    base = np.linalg.inv(poses[0])
    xs, ms = [], []
    for pts, F in zip(scans, poses):
        x, m = quantized(pts, cfg["scan_capacity"], prec, device)
        m = filtered(x, m, cfg["filters"])
        L = torch.as_tensor(base @ F, dtype=prec.dtype, device=device)
        xs.append(apply(L, x, prec))
        ms.append(m)
    x, m = torch.cat(xs), torch.cat(ms)
    if x.shape[0] > cap:
        x, m = compact(x, m)
    x, m = x[:cap], m[:cap]
    return voxel_downsample(x, m, cfg["voxel_size"])


def pair_match(scans_src, poses_src, scans_tgt, poses_tgt, cfg: dict,
               prec, device):
    """A submap's matched transform to its predecessor, as stored, and
    the match's score: ``(T, score, source xyz, source mask)``; a score
    under the acceptance threshold keeps the guess."""
    sx, sm = merged_submap(scans_src, poses_src, cfg, prec, device)
    tx, tm = merged_submap(scans_tgt, poses_tgt, cfg, prec, device)
    t_xyz, t_n, t_ok = kdsplit_normals(tx, tm, cfg["submap_leaf"], prec)
    stride = cfg["pair_stride"]
    sx, sm = sx[::stride], sm[::stride]
    guess = torch.as_tensor(np.linalg.inv(poses_tgt[0]) @ poses_src[0],
                            dtype=prec.dtype, device=device)
    T, score, _ = point_to_plane(sx, sm, t_xyz, t_n, t_ok, guess, prec,
                                 ratio=cfg["dist_outlier_ratio"],
                                 fixed_trips=cfg["pair_trips"])
    T = normalize_rotation(T) if score >= cfg["pair_min_score"] else guess
    return T, score, sx, sm


def mean_gap_m(xyz, mask, A, B) -> float:
    """Mean distance (m, float64) between ``A p`` and ``B p`` over the
    valid points ``p``."""
    p = xyz[mask].to(torch.float64)
    A = torch.as_tensor(A, dtype=torch.float64, device=p.device)
    B = torch.as_tensor(B, dtype=torch.float64, device=p.device)
    d = p @ (A[:3, :3] - B[:3, :3]).T + (A[:3, 3] - B[:3, 3])
    return float(torch.mean(torch.linalg.vector_norm(d, dim=-1)))
