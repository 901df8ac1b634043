"""rerun 3D streaming visualizer (port of ``macvo_tpu/viz/rerun_viz.py``;
reference: Utility/Visualize/Rerun_Visualize.py:25-163).

Trajectory linestrips, pinhole cameras, images, and map points with
covariance rendered as determinant-scaled radii. The rerun sdk is optional in
this image — every entry point no-ops (with one warning) when it is absent.
"""

from __future__ import annotations

import numpy as np

from ..utils.logging import Logger
from .interface import has_rerun

_WARNED = False


def _rr():
    global _WARNED
    if not has_rerun():
        if not _WARNED:
            Logger.warning("rerun-sdk not installed; 3D visualization disabled")
            _WARNED = True
        return None
    import rerun

    return rerun


def init(app_name: str = "macvo_tpu_torch", spawn: bool = False) -> bool:
    rr = _rr()
    if rr is None:
        return False
    rr.init(app_name, spawn=spawn)
    return True


def log_trajectory(path: str, positions: np.ndarray, color=(70, 130, 255)) -> None:
    rr = _rr()
    if rr is None:
        return
    rr.log(path, rr.LineStrips3D([positions.astype(np.float32)], colors=[color]))


def log_camera(path: str, pose7: np.ndarray, K: np.ndarray, width: int, height: int) -> None:
    rr = _rr()
    if rr is None:
        return
    rr.log(path, rr.Transform3D(
        translation=pose7[:3].astype(np.float32),
        rotation=rr.Quaternion(xyzw=pose7[3:7].astype(np.float32)),
    ))
    rr.log(f"{path}/pinhole", rr.Pinhole(
        image_from_camera=K.astype(np.float32), width=width, height=height,
    ))


def log_image(path: str, image: np.ndarray) -> None:
    rr = _rr()
    if rr is None:
        return
    rr.log(path, rr.Image((image * 255).astype(np.uint8)))


def log_points(path: str, positions: np.ndarray, colors: np.ndarray | None = None,
               covariances: np.ndarray | None = None,
               cov_mode: str = "sphere") -> None:
    """Map points with covariance rendering (reference:
    Rerun_Visualize.py:108-152). ``cov_mode``:

    * ``none``   — points only
    * ``sphere`` — radius = sqrt(det) * 1e2, clamped [0.03, 0.5]
    * ``axis``   — three eigen-axis line segments per point, scaled by
                   sqrt(eigenvalue)
    * ``color``  — plasma colormap over det, normalized to the 99th pctile
    """
    rr = _rr()
    if rr is None:
        return
    positions = positions.astype(np.float32)
    rr.log(path, rr.Points3D(positions, colors=colors))
    if covariances is None or cov_mode == "none":
        return
    cov = covariances.astype(np.float64)
    if cov_mode == "sphere":
        det = np.clip(np.linalg.det(cov), 0.0, None)
        radii = np.clip(np.sqrt(det) * 1e2, 0.03, 0.5).astype(np.float32)
        rr.log(f"{path}/cov", rr.Points3D(positions, colors=colors, radii=radii))
    elif cov_mode == "axis":
        segs_a, segs_b = cov_eigen_axes(positions, cov)
        strips = np.stack([segs_a, segs_b], axis=1).astype(np.float32)
        seg_colors = None
        if colors is not None:
            seg_colors = np.repeat(np.asarray(colors), 3, axis=0)
        rr.log(f"{path}/cov",
               rr.LineStrips3D(strips, radii=[0.003], colors=seg_colors))
    elif cov_mode == "color":
        rr.log(f"{path}/cov", rr.Points3D(positions, colors=cov_det_colormap(cov)))
    else:
        raise ValueError(f"unknown cov_mode {cov_mode!r}")


def cov_eigen_axes(positions: np.ndarray, cov: np.ndarray
                   ) -> tuple[np.ndarray, np.ndarray]:
    """Endpoints of the three sqrt-eigenvalue-scaled principal axes per point
    (reference 'axis' mode, Rerun_Visualize.py:119-137). Returns (a, b) each
    (3N, 3)."""
    eigen_val, eigen_vec = np.linalg.eigh(cov)          # symmetric: eigh
    eigen_val = np.clip(eigen_val, 0.0, None)
    # (N,3,3) column eigenvectors -> per-axis rows scaled by sqrt(eigenvalue)
    axes = eigen_vec.transpose(0, 2, 1) * np.sqrt(eigen_val)[..., None]
    delta = np.repeat(positions, 3, axis=0)
    axes = axes.reshape(-1, 3)
    return delta + 0.1 * axes, delta - 0.1 * axes


def cov_det_colormap(cov: np.ndarray) -> np.ndarray:
    """Plasma colormap over covariance determinant, normalized to the 99th
    percentile (reference 'color' mode, Rerun_Visualize.py:145-152)."""
    import matplotlib.pyplot as plt
    from matplotlib.colors import Normalize

    det = np.clip(np.linalg.det(cov), 0.0, None)
    hi = np.quantile(det, 0.99) if det.size else 1.0
    normed = Normalize(vmin=0.0, vmax=max(hi, 1e-12))(det)
    return plt.cm.plasma(normed)[..., :3]
