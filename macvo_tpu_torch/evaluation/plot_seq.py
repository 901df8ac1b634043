"""Trajectory comparison figures from result sandboxes (port of
``macvo_tpu/evaluation/plot_seq.py``; reference: Evaluation/PlotSeq.py:18-114).

Per-space figures (``<name>_Trajectory.png``, ``_TranslationErr.png``,
``_RotationErr.png``) plus joint comparison figures (``Combined_*.png``)
when multiple spaces are given:

    python -m macvo_tpu_torch.evaluation.plot_seq --spaces <sandbox...> \
        [--recursive] [--out Results]
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
from scipy.spatial.transform import Rotation

from ..utils.logging import Logger
from ..utils.sandbox import Sandbox
from ..viz.plot_trajectory import (
    analyze_rotation,
    analyze_roe_cdf,
    analyze_rte_cdf,
    analyze_translation,
    plot_trajectory_figure,
)
from .metrics import align_trajectory, poses_to_matrices
from .trajectory import load_sandbox_trajectories

# Monocular baselines need Sim3 scale alignment (reference: PlotSeq.py:10-15).
NEED_ALIGN_SCALE = ("dpvo", "droid", "tartanvo_mono", "mast3r")


def _load(space: str):
    box = Sandbox.load(space)
    gt, est = load_sandbox_trajectories(box)
    odom_cfg = getattr(box.config, "Odometry", None)
    name = getattr(odom_cfg, "name", None) or Path(space).name
    if any(k in name.lower() for k in NEED_ALIGN_SCALE):
        s = np.linalg.norm(np.diff(gt.poses[:, :3], axis=0), axis=1).sum() / max(
            np.linalg.norm(np.diff(est.poses[:, :3], axis=0), axis=1).sum(), 1e-12)
        est.poses = est.poses.copy()
        est.poses[:, :3] *= s
        Logger.info(f"{name}: dynamic scale alignment x{s:.4f}")
    # align_origin (reference: PlotSeq.py:40): re-base est so frame0 == GT.
    est_m = align_trajectory(poses_to_matrices(est.poses), poses_to_matrices(gt.poses))
    est.poses = np.concatenate(
        [est_m[:, :3, 3], Rotation.from_matrix(est_m[:, :3, :3]).as_quat()], axis=1)

    need_interp = None
    ni_path = box.path("need_interp.npy")
    if ni_path.exists():
        need_interp = np.load(ni_path)
    return name, gt, est, need_interp


def plot_separately(spaces: list[str], out: Path) -> None:
    for space in spaces:
        try:
            name, gt, est, need_interp = _load(space)
        except FileNotFoundError as e:
            Logger.warning(f"skipping {space}: {e}")
            continue
        plot_trajectory_figure([("GT", gt.poses), (name, est.poses)],
                               out / f"{name}_Trajectory.png", need_interp=need_interp)
        analyze_translation([(name, gt.poses, est.poses)], out / f"{name}_TranslationErr.png")
        analyze_rotation([(name, gt.poses, est.poses)], out / f"{name}_RotationErr.png")
        Logger.info(f"plotted {name} -> {out}")


def plot_jointly(spaces: list[str], out: Path) -> None:
    loaded = []
    for space in spaces:
        try:
            loaded.append(_load(space))
        except FileNotFoundError as e:
            Logger.warning(f"skipping {space}: {e}")
    if len(loaded) < 2:
        return
    gt0 = loaded[0][1]
    plot_trajectory_figure(
        [("GT", gt0.poses)] + [(name, est.poses) for name, _, est, _ in loaded],
        out / "Combined_Trajectory.png")
    pairs = [(name, gt.poses, est.poses) for name, gt, est, _ in loaded]
    analyze_translation(pairs, out / "Combined_trel.png")
    analyze_rotation(pairs, out / "Combined_rrel.png")
    analyze_rte_cdf(pairs, out / "Combined_RTEcdf.png")
    analyze_roe_cdf(pairs, out / "Combined_ROEcdf.png")
    Logger.info(f"plotted combined figures -> {out}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--spaces", type=str, nargs="+", required=True)
    ap.add_argument("--recursive", action="store_true",
                    help="expand to leaf sandboxes")
    ap.add_argument("--out", type=str, default="Results")
    args = ap.parse_args(argv)

    spaces = list(args.spaces)
    if args.recursive:
        expanded = []
        for space in spaces:
            expanded.extend(str(c.folder) for c in Sandbox.load(space).get_leaves())
        spaces = expanded
        Logger.info(f"found {len(spaces)} leaf spaces")

    out = Path(args.out)
    plot_separately(spaces, out)
    plot_jointly(spaces, out)


if __name__ == "__main__":
    main()
