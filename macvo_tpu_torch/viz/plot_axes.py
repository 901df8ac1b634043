"""Axes-level plotting primitives (port of ``macvo_tpu/viz/plot_axes.py``;
reference: Utility/Plot/PlotAxes.py).

Flow color-wheel rendering, 2D covariance confidence ellipses, and keypoint
correspondence overlays — pure numpy/matplotlib, consumed by the figure
builders in matplotlib_viz.py.
"""

from __future__ import annotations

import numpy as np


def flow_to_color(flow: np.ndarray, max_mag: float | None = None) -> np.ndarray:
    """(H,W,2) flow -> (H,W,3) float RGB via the standard HSV color wheel."""
    import matplotlib.colors as mcolors

    u, v = flow[..., 0], flow[..., 1]
    mag = np.sqrt(u**2 + v**2)
    ang = np.arctan2(-v, -u) / np.pi  # [-1, 1]
    if max_mag is None:
        max_mag = max(float(np.nanmax(mag)), 1e-6)
    hsv = np.stack(
        [(ang + 1.0) / 2.0, np.clip(mag / max_mag, 0, 1), np.ones_like(mag)], axis=-1
    )
    return mcolors.hsv_to_rgb(np.nan_to_num(hsv))


def plot_gaussian_conf(ax, mean: np.ndarray, cov: np.ndarray, n_std: float = 2.0,
                       color="tab:orange", alpha: float = 0.5) -> None:
    """Draw an n-sigma confidence ellipse of a 2x2 covariance at ``mean``
    (reference: PlotAxes.py plot_gaussian_conf)."""
    from matplotlib.patches import Ellipse

    vals, vecs = np.linalg.eigh(cov)
    vals = np.maximum(vals, 0.0)
    angle = float(np.degrees(np.arctan2(vecs[1, 1], vecs[0, 1])))
    width, height = 2.0 * n_std * np.sqrt(vals[::-1])
    ax.add_patch(Ellipse(mean, width, height, angle=angle,
                         facecolor="none", edgecolor=color, alpha=alpha))


def plot_correspondences(ax, img0: np.ndarray, img1: np.ndarray,
                         kp0: np.ndarray, kp1: np.ndarray, max_lines: int = 50) -> None:
    """Side-by-side images with correspondence lines."""
    h = max(img0.shape[0], img1.shape[0])
    canvas = np.zeros((h, img0.shape[1] + img1.shape[1], 3), dtype=img0.dtype)
    canvas[: img0.shape[0], : img0.shape[1]] = img0
    canvas[: img1.shape[0], img0.shape[1] :] = img1
    ax.imshow(canvas)
    offset = img0.shape[1]
    step = max(1, len(kp0) // max_lines)
    for a, b in zip(kp0[::step], kp1[::step]):
        ax.plot([a[0], b[0] + offset], [a[1], b[1]], lw=0.5, color="lime")
    ax.scatter(kp0[::step, 0], kp0[::step, 1], s=2, c="red")
    ax.scatter(kp1[::step, 0] + offset, kp1[::step, 1], s=2, c="red")
    ax.axis("off")


def plot_scalar_map(ax, data: np.ndarray, title: str = "", cmap: str = "viridis") -> None:
    im = ax.imshow(data, cmap=cmap)
    ax.set_title(title)
    ax.axis("off")
    ax.figure.colorbar(im, ax=ax, fraction=0.046)
