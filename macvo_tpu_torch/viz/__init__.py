"""Visualization (port of ``macvo_tpu/viz``; reference: Utility/Visualize/ +
Utility/Plot/). matplotlib is imported where a figure is drawn, so this
package imports without it; ``rerun`` streams only where ``has_rerun()``."""

from . import rerun_viz
from .interface import VisualizerRegistry, fig_plt, has_rerun
from .matplotlib_viz import plot_imatcher, plot_istereo, plot_macvo, plot_trajectory
from .plot_axes import flow_to_color, plot_correspondences, plot_gaussian_conf, plot_scalar_map

__all__ = [
    "VisualizerRegistry", "fig_plt", "has_rerun", "rerun_viz",
    "plot_imatcher", "plot_istereo", "plot_macvo", "plot_trajectory",
    "flow_to_color", "plot_correspondences", "plot_gaussian_conf", "plot_scalar_map",
]
