"""SE(3) math on batched tensors — the PyTorch counterpart of
``staticmapping_tpu.common.se3`` (reference: common/math.h:107-246).

Poses are ``[..., 4, 4]`` homogeneous matrices; every function follows its
input's dtype and device.  Quaternions are ``[..., 4]`` in ``[w, x, y, z]``
order.  Euler angles follow the reference convention ``(roll=x, pitch=y,
yaw=z)`` with ``R = Rz(yaw) @ Ry(pitch) @ Rx(roll)`` (common/math.h:128-138).
No function branches on tensor values, so all of them batch freely.
"""
from __future__ import annotations

import torch

_EPS = 1e-12


# ---------------------------------------------------------------------------
# quaternion primitives  (w, x, y, z)
# ---------------------------------------------------------------------------

def quat_identity(dtype=torch.float32, device=None) -> torch.Tensor:
    return torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=dtype, device=device)


def quat_normalize(q: torch.Tensor) -> torch.Tensor:
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True).clamp_min(_EPS)


def quat_conj(q: torch.Tensor) -> torch.Tensor:
    return q * torch.tensor([1.0, -1.0, -1.0, -1.0], dtype=q.dtype,
                            device=q.device)


def quat_mul(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Hamilton product, batched over leading dims."""
    w1, x1, y1, z1 = q1.unbind(-1)
    w2, x2, y2, z2 = q2.unbind(-1)
    return torch.stack([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
    ], dim=-1)


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vectors ``v [..., 3]`` by quaternions ``q [..., 4]``."""
    w = q[..., :1]
    u = q[..., 1:]
    uv = _cross(u, v)
    return v + 2.0 * (w * uv + _cross(u, uv))


def quat_to_matrix(q: torch.Tensor) -> torch.Tensor:
    q = quat_normalize(q)
    w, x, y, z = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack([
        1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
        2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
        2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
    ], dim=-1)
    return m.reshape(m.shape[:-1] + (3, 3))


def matrix_to_quat(m: torch.Tensor) -> torch.Tensor:
    """Rotation matrix ``[..., 3, 3]`` → quaternion, branch-free (batched
    Shepperd's method: all four candidates, pick the largest diagonal
    combination).  Entries are taken as ``[..., 1]`` slices, not 0-d
    tensors: under ``torch.func.jacfwd`` a Python float times a 0-d tensor
    gives a float64 tangent."""
    def e(i, j):
        return m[..., i, j:j + 1]
    m00, m01, m02 = e(0, 0), e(0, 1), e(0, 2)
    m10, m11, m12 = e(1, 0), e(1, 1), e(1, 2)
    m20, m21, m22 = e(2, 0), e(2, 1), e(2, 2)

    qw2 = 1.0 + m00 + m11 + m22
    qx2 = 1.0 + m00 - m11 - m22
    qy2 = 1.0 - m00 + m11 - m22
    qz2 = 1.0 - m00 - m11 + m22

    def safe_sqrt(x):
        return torch.sqrt(x.clamp_min(_EPS))

    sw = safe_sqrt(qw2) * 2.0
    cand_w = torch.cat(
        [0.25 * sw, (m21 - m12) / sw, (m02 - m20) / sw, (m10 - m01) / sw], -1)
    sx = safe_sqrt(qx2) * 2.0
    cand_x = torch.cat(
        [(m21 - m12) / sx, 0.25 * sx, (m01 + m10) / sx, (m02 + m20) / sx], -1)
    sy = safe_sqrt(qy2) * 2.0
    cand_y = torch.cat(
        [(m02 - m20) / sy, (m01 + m10) / sy, 0.25 * sy, (m12 + m21) / sy], -1)
    sz = safe_sqrt(qz2) * 2.0
    cand_z = torch.cat(
        [(m10 - m01) / sz, (m02 + m20) / sz, (m12 + m21) / sz, 0.25 * sz], -1)

    scores = torch.cat([qw2, qx2, qy2, qz2], dim=-1)
    idx = torch.argmax(scores, dim=-1)
    cands = torch.stack([cand_w, cand_x, cand_y, cand_z], dim=-2)
    gather_idx = idx[..., None, None].expand(idx.shape + (1, 4))
    q = torch.gather(cands, -2, gather_idx)[..., 0, :]
    q = torch.where(q[..., :1] < 0, -q, q)      # canonical sign: w >= 0
    return quat_normalize(q)


def quat_angular_distance(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Angle of the relative rotation (Eigen ``angularDistance`` parity)."""
    d = torch.abs(torch.sum(q1 * q2, dim=-1)).clamp(0.0, 1.0)
    return 2.0 * torch.arccos(d)


def slerp(q0: torch.Tensor, q1: torch.Tensor, t) -> torch.Tensor:
    """Spherical interpolation (Eigen ``slerp`` parity, shortest path)."""
    dot = torch.sum(q0 * q1, dim=-1, keepdim=True)
    q1 = torch.where(dot < 0, -q1, q1)
    dot = torch.abs(dot).clamp(-1.0, 1.0)
    theta = torch.arccos(dot)
    sin_theta = torch.sin(theta)
    small = sin_theta < 1e-5           # lerp for nearly parallel quaternions
    safe_sin = torch.where(small, torch.ones_like(sin_theta), sin_theta)
    w0 = torch.where(small, 1.0 - t, torch.sin((1.0 - t) * theta) / safe_sin)
    w1 = torch.where(small, t, torch.sin(t * theta) / safe_sin)
    return quat_normalize(w0 * q0 + w1 * q1)


# ---------------------------------------------------------------------------
# axis-angle
# ---------------------------------------------------------------------------

def _theta_safe(sq: torch.Tensor):
    """(small-mask, safe-theta): below theta = 0.1 the f32 quotient forms
    lose digits, so callers switch to 3-term series there.  The double
    ``where`` (the square root never sees the small ``sq``, and the series
    branch never divides) keeps the autodiff tangents finite at theta = 0
    too: a NaN in the branch not taken would still poison the gradient."""
    small = sq < 1e-2
    theta = torch.sqrt(torch.where(small, torch.ones_like(sq), sq))
    return small, theta


def skew(v: torch.Tensor) -> torch.Tensor:
    """``[..., 3] → [..., 3, 3]`` cross-product matrix."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    m = torch.stack([zero, -z, y, z, zero, -x, -y, x, zero], dim=-1)
    return m.reshape(m.shape[:-1] + (3, 3))


def axis_angle_to_matrix(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues: rotation vector ``[..., 3]`` → matrix, as
    ``R = I + a·S + b·S²`` with ``S = skew(w)``."""
    sq = torch.sum(w * w, dim=-1, keepdim=True)[..., None]
    small, theta = _theta_safe(sq)
    s, c = torch.sin(theta), torch.cos(theta)
    a = torch.where(small, 1.0 - sq / 6.0 + sq * sq / 120.0, s / theta)
    b = torch.where(small, 0.5 - sq / 24.0 + sq * sq / 720.0, (1.0 - c) / sq)
    S = skew(w)
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(S.shape)
    return eye + a * S + b * (S @ S)


def matrix_to_axis_angle(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix → rotation vector, through the quaternion."""
    q = matrix_to_quat(R)
    w = q[..., :1]
    v = q[..., 1:]
    sq = torch.sum(v * v, dim=-1, keepdim=True)
    small, n = _theta_safe(sq)
    # angle/|v| = 2·atan2(|v|, w)/|v|; for small |v| the atan series
    # 2/w · (1 − x²/3 + x⁴/5), x = |v|/w  (w ≥ 0.995 inside the guard)
    ws = torch.clamp_min(w, 0.5)
    x2 = sq / (ws * ws)
    scale = torch.where(small,
                        (2.0 / ws) * (1.0 - x2 / 3.0 + x2 * x2 / 5.0),
                        2.0 * torch.atan2(n, w) / n)
    return v * scale


# ---------------------------------------------------------------------------
# euler (roll, pitch, yaw) — reference convention math.h:106-139
# ---------------------------------------------------------------------------

def euler_to_quat(eulers: torch.Tensor) -> torch.Tensor:
    roll, pitch, yaw = eulers[..., 0], eulers[..., 1], eulers[..., 2]
    cr, sr = torch.cos(roll * 0.5), torch.sin(roll * 0.5)
    cp, sp = torch.cos(pitch * 0.5), torch.sin(pitch * 0.5)
    cy, sy = torch.cos(yaw * 0.5), torch.sin(yaw * 0.5)
    return torch.stack([
        cy * cp * cr + sy * sp * sr,
        cy * cp * sr - sy * sp * cr,
        cy * sp * cr + sy * cp * sr,
        sy * cp * cr - cy * sp * sr,
    ], dim=-1)


def euler_to_matrix(eulers: torch.Tensor) -> torch.Tensor:
    return quat_to_matrix(euler_to_quat(eulers))


def matrix_to_euler(R: torch.Tensor) -> torch.Tensor:
    """ZYX extraction including the singular branch
    (RotationMatrixToEulerAngles, common/math.h:106-126)."""
    sy = torch.sqrt(R[..., 0, 0] ** 2 + R[..., 1, 0] ** 2)
    singular = sy < 1e-6
    x = torch.where(singular,
                    torch.atan2(-R[..., 1, 2], R[..., 1, 1]),
                    torch.atan2(R[..., 2, 1], R[..., 2, 2]))
    y = torch.atan2(-R[..., 2, 0], sy)
    z = torch.where(singular, torch.zeros_like(sy),
                    torch.atan2(R[..., 1, 0], R[..., 0, 0]))
    return torch.stack([x, y, z], dim=-1)


def quat_to_euler(q: torch.Tensor) -> torch.Tensor:
    return matrix_to_euler(quat_to_matrix(q))


# ---------------------------------------------------------------------------
# rigid transforms [..., 4, 4]
# ---------------------------------------------------------------------------

def identity(dtype=torch.float32, device=None) -> torch.Tensor:
    return torch.eye(4, dtype=dtype, device=device)


def from_rt(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Built by concatenation, not by writing into a buffer, so that
    ``torch.func`` transforms (``vmap``, ``jacfwd``) pass through it."""
    batch = torch.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    top = torch.cat([R.expand(batch + (3, 3)),
                     t.expand(batch + (3,))[..., None]], dim=-1)
    bottom = torch.eye(4, dtype=R.dtype, device=R.device)[3:].expand(
        batch + (1, 4))
    return torch.cat([top, bottom], dim=-2)


def rotation(T: torch.Tensor) -> torch.Tensor:
    return T[..., :3, :3]


def translation(T: torch.Tensor) -> torch.Tensor:
    return T[..., :3, 3]


def inverse(T: torch.Tensor) -> torch.Tensor:
    Rt = rotation(T).transpose(-1, -2)
    return from_rt(Rt, -(Rt @ translation(T)[..., None])[..., 0])


def compose(*Ts: torch.Tensor) -> torch.Tensor:
    out = Ts[0]
    for T in Ts[1:]:
        out = out @ T
    return out


def apply(T: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply ``[..., 4, 4]`` to points ``[..., N, 3]``."""
    return (pts @ rotation(T).transpose(-1, -2)
            + translation(T)[..., None, :])


def transform_to_vector6(T: torch.Tensor) -> torch.Tensor:
    """``[tx, ty, tz, roll, pitch, yaw]`` (math.h:157-166)."""
    return torch.cat([translation(T), matrix_to_euler(rotation(T))], dim=-1)


def vector6_to_transform(v: torch.Tensor) -> torch.Tensor:
    return from_rt(euler_to_matrix(v[..., 3:]), v[..., :3])


def interpolate(T1: torch.Tensor, T2: torch.Tensor, factor) -> torch.Tensor:
    """slerp rotation + lerp translation (common/math.h:198-211)."""
    factor = torch.as_tensor(factor, dtype=T1.dtype, device=T1.device)
    f = factor[..., None] if factor.ndim else factor
    q = slerp(matrix_to_quat(rotation(T1)), matrix_to_quat(rotation(T2)), f)
    t = translation(T1) + (translation(T2) - translation(T1)) * f
    return from_rt(quat_to_matrix(q), t)


def _sign_aligned_quats(Ts: torch.Tensor) -> torch.Tensor:
    qs = matrix_to_quat(rotation(Ts))
    q0 = qs[0]
    return torch.where(torch.sum(qs * q0, dim=-1, keepdim=True) < 0, -qs, qs)


def average_transforms(Ts: torch.Tensor, weights=None) -> torch.Tensor:
    """Mean translation + chordal-mean rotation over axis 0
    (common/math.h AverageTransforms)."""
    qs = _sign_aligned_quats(Ts)
    if weights is None:
        t = torch.mean(translation(Ts), dim=0)
        q = quat_normalize(torch.mean(qs, dim=0))
    else:
        w = weights / torch.sum(weights).clamp_min(_EPS)
        t = torch.sum(translation(Ts) * w[:, None], dim=0)
        q = quat_normalize(torch.sum(qs * w[:, None], dim=0))
    return from_rt(quat_to_matrix(q), t)


def normalize_rotation(T: torch.Tensor) -> torch.Tensor:
    """Re-orthonormalize the rotation block (math.h NormalizeRotation)."""
    return from_rt(quat_to_matrix(matrix_to_quat(rotation(T))), translation(T))


# ---------------------------------------------------------------------------
# se(3) exp/log for the pose-graph optimizer
# ---------------------------------------------------------------------------

def exp_se3(xi: torch.Tensor) -> torch.Tensor:
    """``xi = [rho(3), phi(3)] → [..., 4, 4]`` (the full SE(3) exponential),
    ``V = I + b·S + c·S²`` with ``S = skew(phi)``."""
    rho, phi = xi[..., :3], xi[..., 3:]
    R = axis_angle_to_matrix(phi)
    sq = torch.sum(phi * phi, dim=-1, keepdim=True)[..., None]
    small, theta = _theta_safe(sq)
    s, c = torch.sin(theta), torch.cos(theta)
    b = torch.where(small, 0.5 - sq / 24.0 + sq * sq / 720.0, (1.0 - c) / sq)
    cc = torch.where(small, 1.0 / 6.0 - sq / 120.0 + sq * sq / 5040.0,
                     (theta - s) / (sq * theta))
    S = skew(phi)
    eye = torch.eye(3, dtype=xi.dtype, device=xi.device).expand(R.shape)
    V = eye + b * S + cc * (S @ S)
    return from_rt(R, (V @ rho[..., None])[..., 0])


def log_se3(T: torch.Tensor) -> torch.Tensor:
    """``[..., 4, 4] → [rho, phi]`` with ``V⁻¹ = I − S/2 + e·S²``."""
    phi = matrix_to_axis_angle(rotation(T))
    sq = torch.sum(phi * phi, dim=-1, keepdim=True)[..., None]
    small, theta = _theta_safe(sq)
    s, c = torch.sin(theta), torch.cos(theta)
    e = torch.where(
        small, 1.0 / 12.0 + sq / 720.0 + sq * sq / 30240.0,
        (1.0 - 0.5 * theta * s / torch.clamp_min(1.0 - c, _EPS)) / sq)
    S = skew(phi)
    eye = torch.eye(3, dtype=T.dtype, device=T.device).expand(S.shape)
    Vinv = eye - 0.5 * S + e * (S @ S)
    rho = (Vinv @ translation(T)[..., None])[..., 0]
    return torch.cat([rho, phi], dim=-1)
