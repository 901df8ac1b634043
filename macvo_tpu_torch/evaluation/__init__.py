from .metrics import MetricStats, evaluate_all

__all__ = ["MetricStats", "evaluate_all"]
