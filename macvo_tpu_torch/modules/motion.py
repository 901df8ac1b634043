"""Motion models — initial pose guess per frame (port of ``macvo_tpu/modules/motion.py``)."""

from __future__ import annotations

from pathlib import Path
from types import SimpleNamespace
from typing import Optional

import numpy as np
import torch

from ..geometry import se3
from ..utils.device import resolve_device
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


class GTMotionwithNoise(IMotionModel):
    """Ground-truth inter-frame motion, optionally perturbed by an se3 twist
    of ``noise_std``, applied to the previous (optimized) pose on ``device``.
    The noise comes from a ``torch.Generator`` seeded with ``seed`` (default
    0): not the JAX package's ``jax.random`` draws; at ``noise_std: 0`` the
    two agree."""

    def __init__(self, config: SimpleNamespace, device: str | torch.device = "cuda") -> None:
        super().__init__(config)
        self.device = resolve_device(device)
        self.generator = torch.Generator().manual_seed(int(getattr(config, "seed", 0)))
        self.prev_pose: Optional[torch.Tensor] = None
        self.prev_gt_pose: Optional[torch.Tensor] = None

    def _noise(self) -> torch.Tensor:
        if self.config.noise_std == 0.0:
            return se3.identity(device=self.device)
        twist = self.config.noise_std * torch.randn(6, generator=self.generator)
        return se3.exp(twist.to(self.device))

    def predict(self, frame, flow, depth) -> torch.Tensor:
        if frame.gt_pose is None:
            raise ValueError("GTMotionwithNoise needs frames with gt_pose")
        gt = torch.as_tensor(np.asarray(frame.gt_pose, np.float32).reshape(7), device=self.device)
        if self.prev_pose is None or self.prev_gt_pose is None:
            self.prev_pose, self.prev_gt_pose = se3.identity(device=self.device), gt
            return self.prev_pose
        gt_motion = se3.mul(se3.inv(self.prev_gt_pose), gt)
        self.prev_pose = se3.mul(self.prev_pose, se3.mul(gt_motion, self._noise()))
        self.prev_gt_pose = gt
        return self.prev_pose

    def update(self, pose: torch.Tensor) -> None:
        self.prev_pose = torch.as_tensor(pose, dtype=torch.float32, device=self.device).reshape(7)

    @classmethod
    def is_valid_config(cls, config) -> None:
        cls._enforce_config_spec(config, {"noise_std": lambda n: isinstance(n, (int, float)) and n >= 0.0})


class ReadPoseFile(IMotionModel):
    """An external (N,7) pose file (``.npy`` or ``.txt``) as the motion
    source: the motion between consecutive file poses is applied to the
    previous (optimized) pose on ``device``."""

    def __init__(self, config: SimpleNamespace, device: str | torch.device = "cuda") -> None:
        super().__init__(config)
        self.device = resolve_device(device)
        self.poses = torch.as_tensor(self._load(Path(config.pose_file)), device=self.device)
        self.prev_pose: Optional[torch.Tensor] = None
        self.prev_file_pose: Optional[torch.Tensor] = None

    @staticmethod
    def _load(path: Path) -> np.ndarray:
        if not path.exists():
            raise FileNotFoundError(f"Cannot read pose file at {path}")
        if path.suffix == ".npy":
            data = np.load(str(path))
        elif path.suffix == ".txt":
            data = np.loadtxt(str(path))
        else:
            raise NameError(f"Cannot handle pose file with suffix '{path.suffix}'")
        if data.ndim != 2 or data.shape[1] != 7:
            raise ValueError(f"{path}: expected an (N,7) pose array, got {data.shape}")
        return data.astype(np.float32)

    def predict(self, frame, flow, depth) -> torch.Tensor:
        file_pose = self.poses[frame.frame_idx]
        if self.prev_pose is None or self.prev_file_pose is None:
            self.prev_pose, self.prev_file_pose = se3.identity(device=self.device), file_pose
            return self.prev_pose
        motion = se3.mul(se3.inv(self.prev_file_pose), file_pose)
        self.prev_pose = se3.mul(self.prev_pose, motion)
        self.prev_file_pose = file_pose
        return self.prev_pose

    def update(self, pose: torch.Tensor) -> None:
        self.prev_pose = torch.as_tensor(pose, dtype=torch.float32, device=self.device).reshape(7)

    @classmethod
    def is_valid_config(cls, config) -> None:
        cls._enforce_config_spec(config, {"pose_file": lambda s: isinstance(s, str)})
