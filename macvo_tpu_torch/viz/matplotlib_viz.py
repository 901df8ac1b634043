"""Matplotlib figure builders (port of ``macvo_tpu/viz/matplotlib_viz.py``;
reference: Utility/Visualize/Matplotlib_Visualize.py:37-328).

Grid figures for matcher / stereo / full-pipeline outputs plus trajectory
plots, saved as numbered PNGs through the gated registry (viz/interface.py).
Inputs are the port's tensors (on any device, any float type) or numpy arrays.
"""

from __future__ import annotations

import numpy as np
import torch

from .interface import fig_plt
from .plot_axes import (flow_to_color, plot_correspondences, plot_gaussian_conf,
                        plot_scalar_map)


def _np(x):
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.float() if x.dtype in (torch.bfloat16, torch.float16) else x).numpy()
    return None if x is None else np.asarray(x)


def _save_or_show(fig, save_path):
    import matplotlib.pyplot as plt

    if save_path is not None:
        fig.savefig(save_path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return save_path


@fig_plt.register
def plot_imatcher(match_out, frame0, frame1, mode=None, save_path=None):
    """Flow / flow-cov grid (reference: Matplotlib_Visualize.py plot_imatcher)."""
    import matplotlib.pyplot as plt

    flow = _np(match_out.flow)[0]
    cov = _np(match_out.cov)
    fig, axes = plt.subplots(2, 2, figsize=(10, 6))
    axes[0, 0].imshow(_np(frame0.imageL)[0])
    axes[0, 0].set_title("image t")
    axes[0, 0].axis("off")
    axes[0, 1].imshow(_np(frame1.imageL)[0])
    axes[0, 1].set_title("image t+1")
    axes[0, 1].axis("off")
    axes[1, 0].imshow(flow_to_color(flow))
    axes[1, 0].set_title("flow")
    axes[1, 0].axis("off")
    if cov is not None:
        plot_scalar_map(axes[1, 1], cov[0, ..., 0] + cov[0, ..., 1], "flow cov (tr)")
    else:
        axes[1, 1].axis("off")
    return _save_or_show(fig, save_path)


@fig_plt.register
def plot_istereo(depth_out, frame, mode=None, save_path=None):
    """Depth / depth-cov grid (reference: plot_istereo)."""
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(1, 3, figsize=(14, 4))
    axes[0].imshow(_np(frame.imageL)[0])
    axes[0].set_title("imageL")
    axes[0].axis("off")
    plot_scalar_map(axes[1], _np(depth_out.depth)[0, ..., 0], "depth", cmap="turbo")
    if depth_out.cov is not None:
        plot_scalar_map(axes[2], np.log10(np.maximum(_np(depth_out.cov)[0, ..., 0], 1e-9)),
                        "log10 depth cov")
    else:
        axes[2].axis("off")
    return _save_or_show(fig, save_path)


@fig_plt.register
def plot_macvo(obs: dict, frame0, frame1, depth_out=None, match_out=None,
               mode=None, save_path=None):
    """Full-pipeline 2x2 grid (reference: Matplotlib_Visualize.py:284-314):
    frame0, frame1 with tracked keypoints + flow-cov ellipses, sqrt depth
    cov, and log flow cov-det."""
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(2, 2, figsize=(12, 8))
    axes[0, 0].imshow(_np(frame0.imageL)[0])
    axes[0, 0].set_title("frame t left", loc="left")
    axes[0, 0].axis("off")

    img1 = _np(frame1.imageL)[0]
    axes[0, 1].imshow(0.25 + 0.75 * img1)  # whiten=0.75 (reference :297)
    kp2 = _np(obs["pixel2_uv"])
    uv_cov = _np(obs.get("pixel2_uv_cov"))
    if uv_cov is not None:
        for i in range(0, len(kp2), max(1, len(kp2) // 64)):
            c = np.array([[uv_cov[i, 0], uv_cov[i, 2]], [uv_cov[i, 2], uv_cov[i, 1]]])
            plot_gaussian_conf(axes[0, 1], kp2[i], c)
    axes[0, 1].scatter(kp2[:, 0], kp2[:, 1], s=2, marker=".", color="#d55e00")
    axes[0, 1].set_title("frame t+1 keypoints + flow cov", loc="left")
    axes[0, 1].axis("off")

    if depth_out is not None and depth_out.cov is not None:
        plot_scalar_map(axes[1, 0], np.sqrt(np.maximum(_np(depth_out.cov)[0, ..., 0], 0.0)),
                        "depth cov (sqrt)")
    else:
        axes[1, 0].axis("off")
    if match_out is not None and match_out.cov is not None:
        mc = _np(match_out.cov)[0]
        det = np.maximum(mc[..., 0] * mc[..., 1] - mc[..., 2] ** 2, 1e-12)
        plot_scalar_map(axes[1, 1], np.log10(det), "pred cov_det (log)")
    else:
        axes[1, 1].axis("off")
    return _save_or_show(fig, save_path)


@fig_plt.register
def plot_reprojerr(proj_kp1, kp2, cov2x2, frame1, mode=None, save_path=None):
    """Reprojection-error overlay (reference: Matplotlib_Visualize.py:318-328):
    whitened frame, predicted-cov ellipses at kp2, both keypoint sets, and
    green correspondence segments."""
    import matplotlib.pyplot as plt

    proj_kp1, kp2, cov2x2 = _np(proj_kp1), _np(kp2), _np(cov2x2)
    fig, ax = plt.subplots(figsize=(10, 7))
    ax.imshow(0.25 + 0.75 * _np(frame1.imageL)[0])
    for i in range(len(kp2)):
        plot_gaussian_conf(ax, kp2[i], cov2x2[i])
    ax.scatter(proj_kp1[:, 0], proj_kp1[:, 1], s=0.5, color="#0072b2")
    ax.scatter(kp2[:, 0], kp2[:, 1], s=0.5, color="#d55e00")
    for a, b in zip(proj_kp1, kp2):
        ax.plot([a[0], b[0]], [a[1], b[1]], color="green", linewidth=1.0)
    ax.set_title("Reprojection Error")
    ax.axis("off")
    return _save_or_show(fig, save_path)


@fig_plt.register
def plot_correspondence(obs: dict, frame0, frame1, mode=None, save_path=None):
    """Side-by-side tracked-keypoint correspondences."""
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(12, 5))
    plot_correspondences(
        ax, _np(frame0.imageL)[0], _np(frame1.imageL)[0],
        _np(obs["pixel1_uv"]), _np(obs["pixel2_uv"]),
    )
    return _save_or_show(fig, save_path)


@fig_plt.register
def plot_trajectory(trajectories: dict, mode=None, save_path=None):
    """Top-down (x-y) trajectory comparison (reference: Utility/Plot/PlotTraj.py)."""
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(7, 7))
    for name, poses in trajectories.items():
        poses = _np(poses)
        ax.plot(poses[:, 0], poses[:, 1], label=name, lw=1.2)
    ax.set_aspect("equal")
    ax.legend()
    ax.set_xlabel("x [m]")
    ax.set_ylabel("y [m]")
    return _save_or_show(fig, save_path)
