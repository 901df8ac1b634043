"""Multi-process and multi-sequence execution: process groups and meshes,
the observation-sharded solve, batched odometry."""

from .batch_odometry import BatchedFrontend, BatchedOdometry
from .mesh import init_distributed, make_mesh, replicated, sharded
from .sharded_ba import make_sharded_solver, pad_to_multiple

__all__ = [
    "BatchedFrontend", "BatchedOdometry", "init_distributed", "make_mesh",
    "make_sharded_solver", "pad_to_multiple", "replicated", "sharded",
]
