from .dense import (
    DepthCovPerformance,
    DepthPerformance,
    FlowCovPerformance,
    FlowPerformance,
    evaluate_depth,
    evaluate_depthcov,
    evaluate_flow,
    evaluate_flowcov,
)
from .metrics import MetricStats, evaluate_all
from .trajectory import Trajectory, evaluate_sandbox, load_sandbox_trajectories

__all__ = ["DepthCovPerformance", "DepthPerformance", "FlowCovPerformance", "FlowPerformance", "MetricStats",
           "Trajectory", "evaluate_all", "evaluate_depth", "evaluate_depthcov", "evaluate_flow",
           "evaluate_flowcov", "evaluate_sandbox", "load_sandbox_trajectories"]
