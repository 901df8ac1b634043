"""SE(3) Lie-group operations on torch tensors (port of ``macvo_tpu/geometry/se3.py``).

A pose is a ``(..., 7)`` tensor ``[tx, ty, tz, qx, qy, qz, qw]`` (translation +
unit quaternion, scalar-last); a twist is ``(..., 6)`` ``[rho(3), phi(3)]``.
Every function broadcasts over leading batch dims, keeps the input dtype and
device, and has no data-dependent control flow (small-angle branches are
``torch.where`` with Taylor fallbacks), so it never syncs with the host.
"""

from __future__ import annotations

import torch

_EPS = 1e-8


def _safe_norm(v: torch.Tensor, keepdim: bool = False) -> torch.Tensor:
    return torch.sqrt(torch.sum(v * v, dim=-1, keepdim=keepdim) + 1e-24)


def identity(batch_shape: tuple[int, ...] = (), dtype=torch.float32, device="cpu") -> torch.Tensor:
    pose = torch.zeros(batch_shape + (7,), dtype=dtype, device=device)
    pose[..., 6] = 1.0
    return pose


def translation(pose: torch.Tensor) -> torch.Tensor:
    return pose[..., :3]


def quaternion(pose: torch.Tensor) -> torch.Tensor:
    return pose[..., 3:7]


def from_t_q(t: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    shape = torch.broadcast_shapes(t.shape[:-1], q.shape[:-1])
    return torch.cat([t.expand(shape + (3,)), q.expand(shape + (4,))], dim=-1)


# -- quaternion algebra (scalar-last xyzw) -------------------------------------

def quat_mul(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    x1, y1, z1, w1 = q1.unbind(-1)
    x2, y2, z2, w2 = q2.unbind(-1)
    return torch.stack(
        [
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        ],
        dim=-1,
    )


def quat_conj(q: torch.Tensor) -> torch.Tensor:
    return q * q.new_tensor([-1.0, -1.0, -1.0, 1.0])


def quat_normalize(q: torch.Tensor) -> torch.Tensor:
    return q / torch.clamp(_safe_norm(q, keepdim=True), min=_EPS)


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vectors v (...,3) by quaternions q (...,4): R(q) v."""
    qv = q[..., :3]
    qw = q[..., 3:4]
    uv = _cross(qv, v)
    uuv = _cross(qv, uv)
    return v + 2.0 * (qw * uv + uuv)


def quat_to_matrix(q: torch.Tensor) -> torch.Tensor:
    x, y, z, w = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    row0 = torch.stack([1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)], dim=-1)
    row1 = torch.stack([2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)], dim=-1)
    row2 = torch.stack([2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


# -- SO(3) exp/log -------------------------------------------------------------

def quat_from_matrix(m: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (...,3,3) -> unit quaternion, branch-free: Shepperd's
    four candidates, the one of the largest diagonal term taken by ``torch.where``."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22

    def safe_sqrt(x):
        return torch.sqrt(torch.clamp(x, min=_EPS))

    qw0 = 0.5 * safe_sqrt(1.0 + tr)
    s0 = 4.0 * qw0
    cand0 = torch.stack([(m21 - m12) / s0, (m02 - m20) / s0, (m10 - m01) / s0, qw0], -1)
    qx1 = 0.5 * safe_sqrt(1.0 + m00 - m11 - m22)
    s1 = 4.0 * qx1
    cand1 = torch.stack([qx1, (m01 + m10) / s1, (m02 + m20) / s1, (m21 - m12) / s1], -1)
    qy2 = 0.5 * safe_sqrt(1.0 - m00 + m11 - m22)
    s2 = 4.0 * qy2
    cand2 = torch.stack([(m01 + m10) / s2, qy2, (m12 + m21) / s2, (m02 - m20) / s2], -1)
    qz3 = 0.5 * safe_sqrt(1.0 - m00 - m11 + m22)
    s3 = 4.0 * qz3
    cand3 = torch.stack([(m02 + m20) / s3, (m12 + m21) / s3, qz3, (m10 - m01) / s3], -1)
    q = torch.where((tr > 0.0)[..., None], cand0,
                    torch.where(((m00 >= m11) & (m00 >= m22))[..., None], cand1,
                                torch.where((m11 >= m22)[..., None], cand2, cand3)))
    return quat_normalize(q)


def so3_exp(phi: torch.Tensor) -> torch.Tensor:
    """Rotation vector (...,3) -> quaternion."""
    angle = _safe_norm(phi, keepdim=True)
    half = 0.5 * angle
    small = angle < 1e-6
    k = torch.where(small, 0.5 - angle * angle / 48.0,
                    torch.sin(half) / torch.clamp(angle, min=_EPS))
    qv = phi * k
    qw = torch.where(small, 1.0 - half * half / 2.0, torch.cos(half))
    return quat_normalize(torch.cat([qv, qw], dim=-1))


def so3_log(q: torch.Tensor) -> torch.Tensor:
    """Quaternion -> rotation vector (...,3)."""
    q = quat_normalize(q)
    q = torch.where(q[..., 3:4] < 0, -q, q)
    qv = q[..., :3]
    qw = q[..., 3]
    sin_half = _safe_norm(qv)
    half = torch.atan2(sin_half, qw)
    small = sin_half < 1e-6
    k = torch.where(small, 2.0 / torch.clamp(qw, min=_EPS),
                    2.0 * half / torch.clamp(sin_half, min=_EPS))
    return qv * k[..., None]


def skew(v: torch.Tensor) -> torch.Tensor:
    x, y, z = v.unbind(-1)
    zero = torch.zeros_like(x)
    return torch.stack(
        [
            torch.stack([zero, -z, y], -1),
            torch.stack([z, zero, -x], -1),
            torch.stack([-y, x, zero], -1),
        ],
        dim=-2,
    )


def _eye_like(K: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=K.dtype, device=K.device).expand(K.shape)


def _left_jacobian(phi: torch.Tensor) -> torch.Tensor:
    """SO(3) left Jacobian J_l(phi), (...,3,3)."""
    angle = _safe_norm(phi)
    small = angle < 1e-6
    a = torch.clamp(angle, min=_EPS)
    K = skew(phi / a[..., None])
    sin_a, cos_a = torch.sin(a), torch.cos(a)
    c1 = torch.where(small, 0.5 - angle**2 / 24.0, (1 - cos_a) / (a * a))
    c2 = torch.where(small, 1.0 / 6.0 - angle**2 / 120.0, (a - sin_a) / (a**3))
    Ka = K * a[..., None, None]
    return _eye_like(K) + c1[..., None, None] * Ka + c2[..., None, None] * (Ka @ Ka)


def _left_jacobian_inv(phi: torch.Tensor) -> torch.Tensor:
    angle = _safe_norm(phi)
    small = angle < 1e-6
    a = torch.clamp(angle, min=_EPS)
    K = skew(phi)
    cot_term = torch.where(
        small,
        1.0 / 12.0 + angle**2 / 720.0,
        (1.0 / (a * a)) - (1.0 + torch.cos(a)) / (2.0 * a * torch.sin(a) + _EPS),
    )
    return _eye_like(K) - 0.5 * K + cot_term[..., None, None] * (K @ K)


# -- SE(3) ---------------------------------------------------------------------

def exp(twist: torch.Tensor) -> torch.Tensor:
    """se3 twist (...,6) [rho, phi] -> SE3 pose (...,7)."""
    rho, phi = twist[..., :3], twist[..., 3:6]
    q = so3_exp(phi)
    t = (_left_jacobian(phi) @ rho[..., None])[..., 0]
    return from_t_q(t, q)


def log(pose: torch.Tensor) -> torch.Tensor:
    """SE3 pose (...,7) -> se3 twist (...,6)."""
    phi = so3_log(quaternion(pose))
    rho = (_left_jacobian_inv(phi) @ translation(pose)[..., None])[..., 0]
    return torch.cat([rho, phi], dim=-1)


def mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Compose poses: (a @ b)."""
    qa, qb = quaternion(a), quaternion(b)
    t = translation(a) + quat_rotate(qa, translation(b))
    return from_t_q(t, quat_normalize(quat_mul(qa, qb)))


def inv(pose: torch.Tensor) -> torch.Tensor:
    q_inv = quat_conj(quaternion(pose))
    t_inv = -quat_rotate(q_inv, translation(pose))
    return from_t_q(t_inv, q_inv)


def act(pose: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Apply pose to points (...,3): R p + t."""
    return quat_rotate(quaternion(pose), points) + translation(pose)


def rotmat(pose: torch.Tensor) -> torch.Tensor:
    return quat_to_matrix(quaternion(pose))


def normalize(pose: torch.Tensor) -> torch.Tensor:
    """Renormalize the quaternion part."""
    return from_t_q(translation(pose), quat_normalize(quaternion(pose)))


def matrix(pose: torch.Tensor) -> torch.Tensor:
    """Pose -> homogeneous (...,4,4)."""
    out = torch.zeros(pose.shape[:-1] + (4, 4), dtype=pose.dtype, device=pose.device)
    out[..., :3, :3] = rotmat(pose)
    out[..., :3, 3] = translation(pose)
    out[..., 3, 3] = 1.0
    return out


def from_matrix(m: torch.Tensor) -> torch.Tensor:
    """Homogeneous (...,4,4) -> pose."""
    return from_t_q(m[..., :3, 3], quat_from_matrix(m[..., :3, :3]))


def relative(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a^-1 @ b: the motion taking frame a to frame b."""
    return mul(inv(a), b)
