"""Pure-numpy SE(3) ops (copy of ``macvo_tpu/geometry/se3_np.py``) — host-side use only.

Dataset construction and result writing stay on the host. These functions
follow the conventions of ``geometry/se3.py`` exactly — pose ``(...,7)`` =
``[t, q_xyzw]``, twist ``(...,6)`` = ``[rho, phi]``.

Reference semantics: pypose SE3 layout (Module/Map/Template.py:5-43).
"""

from __future__ import annotations

import numpy as np

_EPS = 1e-8


def _safe_norm(v: np.ndarray, keepdims: bool = False) -> np.ndarray:
    sq = np.sum(v * v, axis=-1, keepdims=keepdims)
    return np.sqrt(sq + 1e-24)


def identity(batch_shape: tuple[int, ...] = (), dtype=np.float32) -> np.ndarray:
    pose = np.zeros(batch_shape + (7,), dtype=dtype)
    pose[..., 6] = 1.0
    return pose


def from_t_q(t: np.ndarray, q: np.ndarray) -> np.ndarray:
    return np.concatenate([t, q], axis=-1)


def quat_mul(q1: np.ndarray, q2: np.ndarray) -> np.ndarray:
    x1, y1, z1, w1 = np.moveaxis(q1, -1, 0)
    x2, y2, z2, w2 = np.moveaxis(q2, -1, 0)
    return np.stack(
        [
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        ],
        axis=-1,
    )


def quat_normalize(q: np.ndarray) -> np.ndarray:
    return q / np.maximum(_safe_norm(q, keepdims=True), _EPS)


def quat_rotate(q: np.ndarray, v: np.ndarray) -> np.ndarray:
    qv = q[..., :3]
    qw = q[..., 3:4]
    uv = np.cross(qv, v)
    uuv = np.cross(qv, uv)
    return v + 2.0 * (qw * uv + uuv)


def quat_to_matrix(q: np.ndarray) -> np.ndarray:
    x, y, z, w = np.moveaxis(q, -1, 0)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    row0 = np.stack([1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)], axis=-1)
    row1 = np.stack([2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)], axis=-1)
    row2 = np.stack([2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)], axis=-1)
    return np.stack([row0, row1, row2], axis=-2)


def so3_exp(phi: np.ndarray) -> np.ndarray:
    angle = _safe_norm(phi, keepdims=True)
    half = 0.5 * angle
    small = angle < 1e-6
    k = np.where(small, 0.5 - angle * angle / 48.0, np.sin(half) / np.maximum(angle, _EPS))
    qv = phi * k
    qw = np.where(small, 1.0 - half * half / 2.0, np.cos(half))
    return quat_normalize(np.concatenate([qv, qw], axis=-1))


def skew(v: np.ndarray) -> np.ndarray:
    x, y, z = np.moveaxis(v, -1, 0)
    zero = np.zeros_like(x)
    return np.stack(
        [
            np.stack([zero, -z, y], -1),
            np.stack([z, zero, -x], -1),
            np.stack([-y, x, zero], -1),
        ],
        axis=-2,
    )


def _left_jacobian(phi: np.ndarray) -> np.ndarray:
    angle = _safe_norm(phi)
    small = angle < 1e-6
    a = np.maximum(angle, _EPS)
    K = skew(phi / a[..., None])
    sin_a, cos_a = np.sin(a), np.cos(a)
    c1 = np.where(small, 0.5 - angle**2 / 24.0, (1 - cos_a) / (a * a))
    c2 = np.where(small, 1.0 / 6.0 - angle**2 / 120.0, (a - sin_a) / (a**3))
    eye = np.broadcast_to(np.eye(3, dtype=phi.dtype), K.shape)
    Ka = K * a[..., None, None]
    return eye + c1[..., None, None] * Ka + c2[..., None, None] * (Ka @ Ka)


def exp(twist: np.ndarray) -> np.ndarray:
    rho, phi = twist[..., :3], twist[..., 3:6]
    q = so3_exp(phi)
    t = np.einsum("...ij,...j->...i", _left_jacobian(phi), rho)
    return from_t_q(t, q)


def mul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    qa, qb = a[..., 3:7], b[..., 3:7]
    t = a[..., :3] + quat_rotate(qa, b[..., :3])
    return from_t_q(t, quat_normalize(quat_mul(qa, qb)))


def inv(pose: np.ndarray) -> np.ndarray:
    q_inv = pose[..., 3:7] * np.array([-1.0, -1.0, -1.0, 1.0], dtype=pose.dtype)
    t_inv = -quat_rotate(q_inv, pose[..., :3])
    return from_t_q(t_inv, q_inv)


def rotmat(pose: np.ndarray) -> np.ndarray:
    return quat_to_matrix(pose[..., 3:7])


def quat_from_matrix(m: np.ndarray) -> np.ndarray:
    """Rotation matrix (...,3,3) -> quaternion, branch-free Shepperd (mirrors
    se3.quat_from_matrix)."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22

    def safe_sqrt(x):
        return np.sqrt(np.maximum(x, _EPS))

    qw0 = 0.5 * safe_sqrt(1.0 + tr)
    s0 = 4.0 * qw0
    cand0 = np.stack([(m21 - m12) / s0, (m02 - m20) / s0, (m10 - m01) / s0, qw0], -1)
    qx1 = 0.5 * safe_sqrt(1.0 + m00 - m11 - m22)
    s1 = 4.0 * qx1
    cand1 = np.stack([qx1, (m01 + m10) / s1, (m02 + m20) / s1, (m21 - m12) / s1], -1)
    qy2 = 0.5 * safe_sqrt(1.0 - m00 + m11 - m22)
    s2 = 4.0 * qy2
    cand2 = np.stack([(m01 + m10) / s2, qy2, (m12 + m21) / s2, (m02 - m20) / s2], -1)
    qz3 = 0.5 * safe_sqrt(1.0 - m00 - m11 + m22)
    s3 = 4.0 * qz3
    cand3 = np.stack([(m02 + m20) / s3, (m12 + m21) / s3, qz3, (m10 - m01) / s3], -1)

    cond0 = tr > 0.0
    cond1 = (m00 >= m11) & (m00 >= m22)
    cond2 = m11 >= m22
    q = np.where(
        cond0[..., None],
        cand0,
        np.where(cond1[..., None], cand1, np.where(cond2[..., None], cand2, cand3)),
    )
    return quat_normalize(q)


def from_matrix(m: np.ndarray) -> np.ndarray:
    return from_t_q(m[..., :3, 3], quat_from_matrix(m[..., :3, :3]))


def so3_log(q: np.ndarray) -> np.ndarray:
    q = quat_normalize(q)
    q = np.where(q[..., 3:4] < 0, -q, q)
    qv = q[..., :3]
    qw = q[..., 3]
    sin_half = _safe_norm(qv)
    half = np.arctan2(sin_half, qw)
    small = sin_half < 1e-6
    k = np.where(small, 2.0 / np.maximum(qw, _EPS), 2.0 * half / np.maximum(sin_half, _EPS))
    return qv * k[..., None]


def _left_jacobian_inv(phi: np.ndarray) -> np.ndarray:
    angle = _safe_norm(phi)
    small = angle < 1e-6
    a = np.maximum(angle, _EPS)
    K = skew(phi)
    cot_term = np.where(
        small,
        1.0 / 12.0 + angle**2 / 720.0,
        (1.0 / (a * a)) - (1.0 + np.cos(a)) / (2.0 * a * np.sin(a) + _EPS),
    )
    eye = np.broadcast_to(np.eye(3, dtype=phi.dtype), K.shape)
    return eye - 0.5 * K + cot_term[..., None, None] * (K @ K)


def log(pose: np.ndarray) -> np.ndarray:
    phi = so3_log(pose[..., 3:7])
    rho = np.einsum("...ij,...j->...i", _left_jacobian_inv(phi), pose[..., :3])
    return np.concatenate([rho, phi], axis=-1)
