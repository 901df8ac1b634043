from .metrics import MetricStats, evaluate_all
from .trajectory import Trajectory, evaluate_sandbox, load_sandbox_trajectories

__all__ = ["MetricStats", "Trajectory", "evaluate_all", "evaluate_sandbox", "load_sandbox_trajectories"]
