"""Trajectory / error-analysis plotting suite (port of
``macvo_tpu/viz/plot_trajectory.py``; reference: Utility/Plot/PlotTraj.py:15-121, Evaluation/PlotSeq.py:18-114,
Evaluation/PlotSpeed.py:12-34).

Axes-level primitives (take a matplotlib Axes) + whole-figure builders used
by ``python -m macvo_tpu_torch.evaluation.plot_seq`` / ``plot_speed`` and
``python -m macvo_tpu_torch --saveplt``. All inputs are numpy.

Conventions: a *trajectory* is an (N,7) ``[t, q_xyzw]`` pose array; a
*motion* array is (M,4,4) relative transforms (``Trajectory.as_motions``).
"""

from __future__ import annotations

from pathlib import Path
from typing import Sequence

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt
import numpy as np

from ..evaluation.trajectory import Trajectory

_AXIS_NAMES = ("x", "y", "z")
# Simple qualitative palette (reference getColor cycles matplotlib colors).
_COLORS = ("#d55e00", "#0072b2", "#009e73", "#cc79a7", "#e69f00", "#56b4e9", "#f0e442")


def color_of(i: int) -> str:
    return _COLORS[i % len(_COLORS)]


def _positions(poses: np.ndarray) -> np.ndarray:
    return np.asarray(poses)[:, :3]


def _euler_zyx(mats: np.ndarray) -> np.ndarray:
    """(M,3,3) -> (M,3) intrinsic zyx euler angles in degrees."""
    from scipy.spatial.transform import Rotation

    return Rotation.from_matrix(mats).as_euler("zyx", degrees=True)


def _rotation_angles_deg(mats: np.ndarray) -> np.ndarray:
    tr = np.clip((np.trace(mats, axis1=-2, axis2=-1) - 1.0) / 2.0, -1.0, 1.0)
    return np.degrees(np.arccos(tr))


# -- axes-level primitives (PlotTraj.py) -------------------------------------

def plot_trajectory_2d(ax, poses: np.ndarray, axis_0: int = 0, axis_1: int = 1,
                       label: str = "", **kwargs):
    """Planar projection of a trajectory (PlotTraj.py:79-84)."""
    pos = _positions(poses)
    (line,) = ax.plot(pos[:, axis_0], pos[:, axis_1], label=label, **kwargs)
    ax.set_xlabel(_AXIS_NAMES[axis_0] + " (m)")
    ax.set_ylabel(_AXIS_NAMES[axis_1] + " (m)")
    ax.set_aspect("equal", adjustable="datalim")
    return line


def plot_losttrack_2d(ax, poses: np.ndarray, need_interp: np.ndarray,
                      axis_0: int = 0, axis_1: int = 1):
    """Mark interpolated (lost-track) frames on a planar plot
    (PlotTraj.py:86-96)."""
    pos = _positions(poses)[np.asarray(need_interp, bool)]
    if len(pos):
        ax.scatter(pos[:, axis_0], pos[:, axis_1], marker="x", s=30,
                   color="#d62728", zorder=5, label="lost track")


def plot_translation_axes(ax, poses: np.ndarray, axis: int, label: str = "", **kwargs):
    """Per-frame translation along one axis (PlotTraj.py:43-49)."""
    pos = _positions(poses)
    (line,) = ax.plot(pos[:, axis], label=label, **kwargs)
    ax.set_ylabel(f"{_AXIS_NAMES[axis]} (m)")
    return line


def plot_rotation_axes(ax, motions: np.ndarray, axis: int, label: str = "", **kwargs):
    """Per-frame relative rotation (euler component) (PlotTraj.py:73-77)."""
    eul = _euler_zyx(np.asarray(motions)[:, :3, :3])
    (line,) = ax.plot(eul[:, axis], label=label, **kwargs)
    ax.set_ylabel(f"d{_AXIS_NAMES[axis]} (deg/frame)")
    return line


def _motion_errors(ref_motions: np.ndarray, est_motions: np.ndarray) -> np.ndarray:
    return np.linalg.inv(np.asarray(ref_motions)) @ np.asarray(est_motions)


def plot_motion_rte(ax, ref_motions: np.ndarray, est_motions: np.ndarray,
                    label: str = "", axis: int | None = None, **kwargs):
    """Per-frame relative translation error (PlotTraj.py:21-41)."""
    err = _motion_errors(ref_motions, est_motions)
    if axis is None:
        vals = np.linalg.norm(err[:, :3, 3], axis=-1)
    else:
        vals = np.abs(err[:, axis, 3])
    (line,) = ax.plot(vals, label=label, **kwargs)
    ax.set_ylabel("RTE (m/frame)" if axis is None else f"|RTE {_AXIS_NAMES[axis]}| (m/frame)")
    return line


def plot_motion_roe(ax, ref_motions: np.ndarray, est_motions: np.ndarray,
                    label: str = "", axis: int | None = None, **kwargs):
    """Per-frame relative rotation error (PlotTraj.py:51-71)."""
    err = _motion_errors(ref_motions, est_motions)
    if axis is None:
        vals = _rotation_angles_deg(err[:, :3, :3])
    else:
        vals = np.abs(_euler_zyx(err[:, :3, :3])[:, axis])
    (line,) = ax.plot(vals, label=label, **kwargs)
    ax.set_ylabel("ROE (deg/frame)")
    return line


def plot_cumulative_density(ax, values: np.ndarray, label: str = "", **kwargs):
    """Empirical CDF (reference plot_cumulative_density, used by
    PlotSpeed.py:25 and the RTE/ROE cdf analyses)."""
    v = np.sort(np.asarray(values))
    cdf = np.arange(1, len(v) + 1) / len(v)
    (line,) = ax.plot(v, cdf, label=label, **kwargs)
    ax.set_ylim(0.0, 1.0)
    return line


def plot_cumulative_rte(ax, ref_motions, est_motions, label: str = "", **kwargs):
    """RTE CDF curve (PlotTraj.py:111-121)."""
    err = _motion_errors(ref_motions, est_motions)
    return plot_cumulative_density(ax, np.linalg.norm(err[:, :3, 3], axis=-1),
                                   label=label, **kwargs)


def plot_cumulative_roe(ax, ref_motions, est_motions, label: str = "", **kwargs):
    """ROE CDF curve (PlotTraj.py:98-109)."""
    err = _motion_errors(ref_motions, est_motions)
    return plot_cumulative_density(ax, _rotation_angles_deg(err[:, :3, :3]),
                                   label=label, **kwargs)


# -- figure builders (PlotSeq.py figures) ------------------------------------

def plot_trajectory_figure(named_trajs: Sequence[tuple[str, np.ndarray]],
                           save_path: str | Path,
                           need_interp: np.ndarray | None = None) -> Path:
    """XY / XZ / YZ projections + 3D view of one or more trajectories
    (reference PlotTrajectory figure)."""
    fig = plt.figure(figsize=(11, 9), dpi=150)
    planes = [(0, 1), (0, 2), (1, 2)]
    for p, (a0, a1) in enumerate(planes):
        ax = fig.add_subplot(2, 2, p + 1)
        for i, (name, poses) in enumerate(named_trajs):
            style = {"linestyle": ":", "linewidth": 2.5} if i == 0 else {}
            plot_trajectory_2d(ax, poses, a0, a1, label=name,
                               color=color_of(i), **style)
            if need_interp is not None and i == len(named_trajs) - 1:
                plot_losttrack_2d(ax, poses, need_interp, a0, a1)
        if p == 0:
            ax.legend(frameon=False, fontsize=8)
    ax3 = fig.add_subplot(2, 2, 4, projection="3d")
    for i, (name, poses) in enumerate(named_trajs):
        pos = _positions(poses)
        ax3.plot(pos[:, 0], pos[:, 1], pos[:, 2], label=name, color=color_of(i))
    fig.tight_layout()
    save_path = Path(save_path)
    save_path.parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(save_path)
    plt.close(fig)
    return save_path


def _as_motions(poses: np.ndarray) -> np.ndarray:
    poses = np.asarray(poses)
    return Trajectory(poses, np.zeros(len(poses))).as_motions()


def analyze_translation(pairs: Sequence[tuple[str, np.ndarray, np.ndarray]],
                        save_path: str | Path) -> Path:
    """Per-axis translation + RTE rows for (name, gt_poses, est_poses) pairs
    (reference AnalyzeTranslation figure)."""
    fig, axes = plt.subplots(4, 1, figsize=(10, 10), dpi=150, sharex=True)
    for i, (name, gt, est) in enumerate(pairs):
        gm, em = _as_motions(gt), _as_motions(est)
        for axis in range(3):
            plot_translation_axes(axes[axis], est, axis, label=name, color=color_of(i))
            plot_translation_axes(axes[axis], gt, axis, label=f"{name} GT",
                                  color=color_of(i), linestyle=":", alpha=0.7)
        plot_motion_rte(axes[3], gm, em, label=name, color=color_of(i))
    axes[0].legend(frameon=False, fontsize=8)
    axes[3].set_xlabel("frame")
    fig.tight_layout()
    save_path = Path(save_path)
    save_path.parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(save_path)
    plt.close(fig)
    return save_path


def analyze_rotation(pairs: Sequence[tuple[str, np.ndarray, np.ndarray]],
                     save_path: str | Path) -> Path:
    """Per-axis relative rotation + ROE rows (reference AnalyzeRotation)."""
    fig, axes = plt.subplots(4, 1, figsize=(10, 10), dpi=150, sharex=True)
    for i, (name, gt, est) in enumerate(pairs):
        gm, em = _as_motions(gt), _as_motions(est)
        for axis in range(3):
            plot_rotation_axes(axes[axis], em, axis, label=name, color=color_of(i))
            plot_rotation_axes(axes[axis], gm, axis, label=f"{name} GT",
                               color=color_of(i), linestyle=":", alpha=0.7)
        plot_motion_roe(axes[3], gm, em, label=name, color=color_of(i))
    axes[0].legend(frameon=False, fontsize=8)
    axes[3].set_xlabel("frame")
    fig.tight_layout()
    save_path = Path(save_path)
    save_path.parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(save_path)
    plt.close(fig)
    return save_path


def analyze_rte_cdf(pairs: Sequence[tuple[str, np.ndarray, np.ndarray]],
                    save_path: str | Path) -> Path:
    fig, ax = plt.subplots(figsize=(5, 5), dpi=150)
    for i, (name, gt, est) in enumerate(pairs):
        plot_cumulative_rte(ax, _as_motions(gt), _as_motions(est),
                            label=name, color=color_of(i))
    ax.set_xlabel("RTE (m/frame)")
    ax.set_ylabel("Proportion of frames")
    ax.legend(frameon=False, fontsize=8)
    fig.tight_layout()
    save_path = Path(save_path)
    save_path.parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(save_path)
    plt.close(fig)
    return save_path


def analyze_roe_cdf(pairs: Sequence[tuple[str, np.ndarray, np.ndarray]],
                    save_path: str | Path) -> Path:
    fig, ax = plt.subplots(figsize=(5, 5), dpi=150)
    for i, (name, gt, est) in enumerate(pairs):
        plot_cumulative_roe(ax, _as_motions(gt), _as_motions(est),
                            label=name, color=color_of(i))
    ax.set_xlabel("ROE (deg/frame)")
    ax.set_ylabel("Proportion of frames")
    ax.legend(frameon=False, fontsize=8)
    fig.tight_layout()
    save_path = Path(save_path)
    save_path.parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(save_path)
    plt.close(fig)
    return save_path


def plot_speed_figure(named_elapsed: Sequence[tuple[str, np.ndarray]],
                      save_path: str | Path) -> Path:
    """Cumulative density of per-frame wall time, one curve per run
    (reference: Evaluation/PlotSpeed.py:12-34)."""
    fig, ax = plt.subplots(figsize=(5, 5), dpi=150)
    for i, (name, elapsed) in enumerate(named_elapsed):
        plot_cumulative_density(ax, np.asarray(elapsed), label=name, color=color_of(i))
    ax.set_xlim(left=0.0)
    ax.set_xlabel("Time elapsed (sec)")
    ax.set_ylabel("Proportion of frames")
    ax.legend(frameon=False, fontsize=8)
    fig.tight_layout()
    save_path = Path(save_path)
    save_path.parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(save_path)
    plt.close(fig)
    return save_path
