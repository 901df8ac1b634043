"""Motion models — initial pose guess per frame (port of ``macvo_tpu/modules/motion.py``)."""

from __future__ import annotations

from types import SimpleNamespace
from typing import Optional

import torch

from ..geometry import se3
from ..utils.registry import RegisteredConfigTestable


class IMotionModel(RegisteredConfigTestable, register=False):
    def __init__(self, config: SimpleNamespace) -> None:
        self.config = config

    def predict(self, frame, flow: Optional[torch.Tensor], depth: Optional[torch.Tensor]) -> torch.Tensor:
        """Predicted world-frame SE3 pose (7,) of ``frame``."""
        raise NotImplementedError

    def update(self, pose: torch.Tensor) -> None:
        raise NotImplementedError


class StaticMotionModel(IMotionModel):
    """Constant-pose model: predicts the previous (optimized) pose."""

    def __init__(self, config: SimpleNamespace) -> None:
        super().__init__(config)
        self.prev_pose: Optional[torch.Tensor] = None

    def predict(self, frame, flow, depth) -> torch.Tensor:
        if self.prev_pose is None:
            device = depth.device if depth is not None else "cpu"
            self.prev_pose = se3.identity(device=device)
        return self.prev_pose

    def update(self, pose: torch.Tensor) -> None:
        self.prev_pose = pose

    @classmethod
    def is_valid_config(cls, config) -> None:
        return
