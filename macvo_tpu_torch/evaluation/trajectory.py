"""Trajectories of a result directory, aligned in time (port of
``macvo_tpu/evaluation/trajectory.py``).

A trajectory is an (N,7) pose array with (N,) timestamps. The runner writes
``poses.npy`` and ``ref_poses.npy`` as (N,8) ``[time, t, q]``;
:func:`load_sandbox_trajectories` interpolates the ground truth onto the
estimate's timestamps where the two differ (a ground truth recorded at
another rate, as in EuRoC).
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np

from ..geometry.interp import interpolate_pose
from . import metrics


@dataclasses.dataclass
class Trajectory:
    poses: np.ndarray        # (N,7) [t, q_xyzw]
    times: np.ndarray        # (N,) seconds
    name: str = ""

    def __len__(self) -> int:
        return self.poses.shape[0]

    @classmethod
    def from_file(cls, path: str | Path, name: str = "") -> "Trajectory":
        """Load an (N,8) [time, t, q] npy file (the odometry's output layout)."""
        data = np.load(path)
        if data.ndim != 2 or data.shape[1] != 8:
            raise ValueError(f"{path}: expected (N,8), got {data.shape}")
        return cls(poses=data[:, 1:8], times=data[:, 0], name=name)

    def align_time_to(self, other: "Trajectory") -> "Trajectory":
        """This trajectory's poses interpolated onto ``other``'s timestamps."""
        interp, _ = interpolate_pose(self.poses.astype(np.float64), self.times.astype(np.float64),
                                     other.times.astype(np.float64))
        return Trajectory(interp, other.times.copy(), self.name)


def load_sandbox_trajectories(result_dir: str | Path) -> tuple[Trajectory, Trajectory]:
    """(gt, est) of a result directory, gt interpolated onto est's timestamps."""
    result_dir = Path(result_dir)
    est = Trajectory.from_file(result_dir / "poses.npy", name="est")
    gt = Trajectory.from_file(result_dir / "ref_poses.npy", name="gt")
    if gt.times.shape != est.times.shape or not np.allclose(gt.times, est.times):
        gt = gt.align_time_to(est)
    return gt, est


def evaluate_sandbox(result_dir: str | Path, correct_scale: bool = False) -> dict[str, metrics.MetricStats]:
    gt, est = load_sandbox_trajectories(result_dir)
    return metrics.evaluate_all(gt.poses.astype(np.float64), est.poses.astype(np.float64), correct_scale)
