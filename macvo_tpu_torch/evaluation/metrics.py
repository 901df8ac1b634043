"""Trajectory metrics: ATE / RTE / ROE / RPE (copy of ``macvo_tpu/evaluation/metrics.py``).

The reference delegates to the ``evo`` package (Evaluation/MetricsSeq.py:9-51):
each metric Umeyama-aligns the estimate to ground truth (``align=True``),
re-bases the origin (``align_origin=True``), and reports mean/std/RMSE.
``evo`` is not in this environment, so the same definitions are implemented
here directly:

* ATE — absolute pose error, translation part, after SE3 (optionally Sim3)
  Umeyama alignment.
* RTE — relative pose error, translation part, delta = 1 frame (m/frame).
* ROE — relative rotation angle, delta = 1 frame (deg/frame).
* RPE — relative full transformation: Frobenius norm of (E - I), evo's
  ``full_transformation`` relation.

Poses are (N,7) ``[t, q_xyzw]`` numpy arrays.
"""

from __future__ import annotations

import dataclasses

import numpy as np


def _quat_to_mat(q: np.ndarray) -> np.ndarray:
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = np.empty(q.shape[:-1] + (3, 3))
    m[..., 0, 0] = 1 - 2 * (yy + zz); m[..., 0, 1] = 2 * (xy - wz); m[..., 0, 2] = 2 * (xz + wy)
    m[..., 1, 0] = 2 * (xy + wz); m[..., 1, 1] = 1 - 2 * (xx + zz); m[..., 1, 2] = 2 * (yz - wx)
    m[..., 2, 0] = 2 * (xz - wy); m[..., 2, 1] = 2 * (yz + wx); m[..., 2, 2] = 1 - 2 * (xx + yy)
    return m


def poses_to_matrices(poses: np.ndarray) -> np.ndarray:
    """(N,7) -> (N,4,4) homogeneous."""
    n = poses.shape[0]
    out = np.tile(np.eye(4), (n, 1, 1))
    out[:, :3, :3] = _quat_to_mat(poses[:, 3:7])
    out[:, :3, 3] = poses[:, :3]
    return out


def umeyama(src: np.ndarray, dst: np.ndarray, with_scale: bool = False):
    """Least-squares similarity transform aligning src points to dst:
    returns (R, t, s) with dst ~= s R src + t."""
    mu_s, mu_d = src.mean(0), dst.mean(0)
    xs, xd = src - mu_s, dst - mu_d
    cov = xd.T @ xs / src.shape[0]
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    if with_scale:
        var_s = (xs**2).sum() / src.shape[0]
        s = float(np.trace(np.diag(D) @ S) / var_s)
    else:
        s = 1.0
    t = mu_d - s * R @ mu_s
    return R, t, s


def align_trajectory(
    est: np.ndarray, gt: np.ndarray, correct_scale: bool = False, align_origin: bool = True
) -> np.ndarray:
    """Umeyama-align the estimated (N,4,4) trajectory onto GT, then re-base so
    the first poses coincide (evo align + align_origin semantics)."""
    R, t, s = umeyama(est[:, :3, 3], gt[:, :3, 3], with_scale=correct_scale)
    out = est.copy()
    out[:, :3, :3] = R @ est[:, :3, :3]
    out[:, :3, 3] = s * (est[:, :3, 3] @ R.T) + t
    if align_origin:
        T0 = gt[0] @ np.linalg.inv(out[0])
        out = T0 @ out
    return out


@dataclasses.dataclass
class MetricStats:
    mean: float
    std: float
    rmse: float
    max: float
    min: float

    @classmethod
    def from_errors(cls, err: np.ndarray) -> "MetricStats":
        return cls(
            mean=float(err.mean()),
            std=float(err.std()),
            rmse=float(np.sqrt((err**2).mean())),
            max=float(err.max()),
            min=float(err.min()),
        )


def _rotation_angle(R: np.ndarray) -> np.ndarray:
    """Rotation angles (rad) of (N,3,3) matrices."""
    tr = np.clip((np.trace(R, axis1=-2, axis2=-1) - 1.0) / 2.0, -1.0, 1.0)
    return np.arccos(tr)


def _relative(mats: np.ndarray, delta: int = 1) -> np.ndarray:
    return np.linalg.inv(mats[:-delta]) @ mats[delta:]


def evaluate_ate(gt: np.ndarray, est: np.ndarray, correct_scale: bool = False) -> MetricStats:
    gt_m, est_m = poses_to_matrices(gt), poses_to_matrices(est)
    est_m = align_trajectory(est_m, gt_m, correct_scale)
    err = np.linalg.norm(gt_m[:, :3, 3] - est_m[:, :3, 3], axis=-1)
    return MetricStats.from_errors(err)


def evaluate_rte(gt: np.ndarray, est: np.ndarray, correct_scale: bool = False) -> MetricStats:
    gt_m, est_m = poses_to_matrices(gt), poses_to_matrices(est)
    est_m = align_trajectory(est_m, gt_m, correct_scale)
    rel_err = np.linalg.inv(_relative(gt_m)) @ _relative(est_m)
    err = np.linalg.norm(rel_err[:, :3, 3], axis=-1)
    return MetricStats.from_errors(err)


def evaluate_roe(gt: np.ndarray, est: np.ndarray, correct_scale: bool = False) -> MetricStats:
    gt_m, est_m = poses_to_matrices(gt), poses_to_matrices(est)
    est_m = align_trajectory(est_m, gt_m, correct_scale)
    rel_err = np.linalg.inv(_relative(gt_m)) @ _relative(est_m)
    err = np.degrees(_rotation_angle(rel_err[:, :3, :3]))
    return MetricStats.from_errors(err)


def evaluate_rpe(gt: np.ndarray, est: np.ndarray, correct_scale: bool = False) -> MetricStats:
    gt_m, est_m = poses_to_matrices(gt), poses_to_matrices(est)
    est_m = align_trajectory(est_m, gt_m, correct_scale)
    rel_err = np.linalg.inv(_relative(gt_m)) @ _relative(est_m)
    err = np.linalg.norm(rel_err - np.eye(4), axis=(-2, -1))
    return MetricStats.from_errors(err)


def evaluate_all(
    gt: np.ndarray, est: np.ndarray, correct_scale: bool = False
) -> dict[str, MetricStats]:
    return {
        "ATE": evaluate_ate(gt, est, correct_scale),
        "RTE": evaluate_rte(gt, est, correct_scale),
        "ROE": evaluate_roe(gt, est, correct_scale),
        "RPE": evaluate_rpe(gt, est, correct_scale),
    }
