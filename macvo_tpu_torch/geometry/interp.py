"""Pose interpolation (port of ``macvo_tpu/geometry/interp.py``), numpy on the host.

Used by evaluation to align ground-truth timestamps to estimates. Poses are
``(N,7) [t, q_xyzw]``; the SE3 algebra is ``se3_np``.
"""

from __future__ import annotations

import numpy as np

from . import se3_np


def slerp(q0: np.ndarray, q1: np.ndarray, tau: np.ndarray, dot_threshold: float = 0.9995) -> np.ndarray:
    """Spherical linear interpolation of (N,4) quaternions."""
    dot = np.sum(q0 * q1, axis=-1)
    q1 = np.where(dot[..., None] < 0, -q1, q1)
    dot = np.abs(dot)

    # Near-parallel: linear interpolation, then renormalize.
    lin = q0 + tau[..., None] * (q1 - q0)
    lin = lin / np.maximum(np.linalg.norm(lin, axis=-1, keepdims=True), 1e-12)

    theta0 = np.arccos(np.clip(dot, -1.0, 1.0))
    sin_theta0 = np.maximum(np.sin(theta0), 1e-12)
    theta = theta0 * tau
    s0 = np.cos(theta) - dot * np.sin(theta) / sin_theta0
    s1 = np.sin(theta) / sin_theta0
    sph = s0[..., None] * q0 + s1[..., None] * q1
    sph = sph / np.maximum(np.linalg.norm(sph, axis=-1, keepdims=True), 1e-12)
    return np.where(dot[..., None] > dot_threshold, lin, sph)


def qinterp(qs: np.ndarray, t: np.ndarray, t_int: np.ndarray) -> np.ndarray:
    """Interpolate a quaternion series (N,4) at times t onto the times t_int."""
    idx1 = np.clip(np.searchsorted(t, t_int), 0, t.shape[0] - 1)
    idx0 = np.clip(idx1 - 1, 0, t.shape[0] - 1)
    t0, t1 = t[idx0], t[idx1]
    dt = np.where(idx0 == idx1, 1.0, t1 - t0)
    tau = np.where(idx0 == idx1, 0.0, (t_int - t0) / dt)
    return slerp(qs[idx0], qs[idx1], tau)


def interpolate_pose(poses: np.ndarray, ts: np.ndarray, ts_ev: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Geodesic (Log/Exp) interpolation of an SE3 series onto query times.

    poses (N,7), ts (N,) strictly increasing, ts_ev (M,). Returns (M,7) poses
    and an (M,) bool mask of the queries outside ``ts``, which take the end
    pose (clamped, not extrapolated)."""
    idx_end = np.clip(np.searchsorted(ts, ts_ev, side="left"), 1, ts.shape[0] - 1)
    idx_start = idx_end - 1
    p0, p1 = poses[idx_start], poses[idx_end]
    t0, t1 = ts[idx_start], ts[idx_end]
    tau = (ts_ev - t0) / np.maximum(t1 - t0, 1e-12)

    before = ts_ev <= ts[0]
    after = ts_ev >= ts[-1]
    tau = np.clip(np.where(before, 0.0, np.where(after, 1.0, tau)), 0.0, 1.0)

    delta = se3_np.log(se3_np.mul(p1, se3_np.inv(p0)))
    interp = se3_np.mul(se3_np.exp(tau[..., None] * delta), p0)
    interp = np.where(before[..., None], poses[0], interp)
    interp = np.where(after[..., None], poses[-1], interp)
    return interp, before | after


def cumulative_motions(init_pose: np.ndarray, motions: np.ndarray) -> np.ndarray:
    """Compose a motion sequence (M,7) into a trajectory (M+1,7):
    pose_i = pose_{i-1} @ m_i, the quaternion renormalized at every step
    (``se3_np.mul`` does)."""
    traj = [init_pose]
    for m in motions:
        traj.append(se3_np.mul(traj[-1], m))
    return np.stack(traj)
