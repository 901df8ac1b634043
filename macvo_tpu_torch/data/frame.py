"""Frame data model: plain dataclasses of torch tensors
(port of ``macvo_tpu/data/frame.py``, whose classes are jax pytrees).

Images are channel-last ``(B,H,W,3)`` float32 in [0,1], as in the JAX
package. Calibration (``K``, ``baseline``, ``T_BS``, ``time_ns``) and the
ground-truth pose stay host numpy: the per-frame driver reads them on the
host. :meth:`StereoFrame.to` moves the dense maps to a device; the IMU and
attitude leaves of a :class:`StereoInertialFrame` are small and stay host
numpy, as the JAX package's ``to_device`` leaves small leaves.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, TypeVar

import numpy as np
import torch

T = TypeVar("T")


def _collate(items: Sequence[T]) -> T:
    """Concatenate single-item dataclasses of numpy arrays along the batch
    axis; a field that is None in any item is None."""
    fields = {}
    for f in dataclasses.fields(items[0]):
        leaves = [getattr(x, f.name) for x in items]
        fields[f.name] = None if any(x is None for x in leaves) else np.concatenate(
            [np.asarray(x) for x in leaves], axis=0)
    return type(items[0])(**fields)


@dataclasses.dataclass
class StereoData:
    """One (batched) stereo observation.

    T_BS (B,7); K (B,3,3); baseline (B,); time_ns (B,) int64 — numpy.
    imageL/imageR (B,H,W,3); optional gt_flow (B,H,W,2), flow_mask (B,H,W,1),
    gt_depth (B,H,W,1) — torch.
    """

    T_BS: np.ndarray
    K: np.ndarray
    baseline: np.ndarray
    time_ns: np.ndarray
    imageL: torch.Tensor
    imageR: torch.Tensor
    gt_flow: Optional[torch.Tensor] = None
    flow_mask: Optional[torch.Tensor] = None
    gt_depth: Optional[torch.Tensor] = None

    @property
    def height(self) -> int:
        return int(self.imageL.shape[1])

    @property
    def width(self) -> int:
        return int(self.imageL.shape[2])

    @property
    def fx(self) -> float:
        return float(self.K[0, 0, 0])

    @property
    def fy(self) -> float:
        return float(self.K[0, 1, 1])

    @property
    def cx(self) -> float:
        return float(self.K[0, 0, 2])

    @property
    def cy(self) -> float:
        return float(self.K[0, 1, 2])

    @property
    def frame_baseline(self) -> float:
        return float(self.baseline[0])

    def to(self, device: torch.device) -> "StereoData":
        """Copy the dense maps to ``device``; to a card through pinned memory,
        asynchronously on the current stream."""
        device = torch.device(device)

        def move(x):
            if x is None:
                return None
            if x.device.type == "cpu" and device.type == "cuda":
                return x.pin_memory().to(device, non_blocking=True)
            return x.to(device)

        return dataclasses.replace(
            self, imageL=move(self.imageL), imageR=move(self.imageR), gt_flow=move(self.gt_flow),
            flow_mask=move(self.flow_mask), gt_depth=move(self.gt_depth))


@dataclasses.dataclass
class StereoFrame:
    """idx (B,), stereo data, optional gt_pose (B,7) numpy."""

    idx: np.ndarray
    stereo: StereoData
    gt_pose: Optional[np.ndarray] = None

    @property
    def frame_idx(self) -> int:
        return int(self.idx[0])

    @property
    def time_ns(self) -> np.ndarray:
        return self.stereo.time_ns

    def to(self, device: torch.device) -> "StereoFrame":
        return dataclasses.replace(self, stereo=self.stereo.to(device))


@dataclasses.dataclass
class IMUData:
    """Inertial samples between two frames: time_ns (B,M) int64, acc (B,M,3),
    gyro (B,M,3), gravity (B,3) — numpy."""

    time_ns: np.ndarray
    acc: np.ndarray
    gyro: np.ndarray
    gravity: np.ndarray

    @classmethod
    def collate(cls, items: Sequence["IMUData"]) -> "IMUData":
        return _collate(items)


@dataclasses.dataclass
class AttitudeData:
    """Ground-truth kinematics at the IMU samples: time_ns (B,M), gt_pos /
    gt_vel (B,M,3), gt_rot (B,M,4) quaternion xyzw, and the first sample's
    init_pos / init_vel (B,3), init_rot (B,4) — numpy."""

    time_ns: np.ndarray
    gt_pos: np.ndarray
    gt_vel: np.ndarray
    gt_rot: np.ndarray
    init_pos: np.ndarray
    init_vel: np.ndarray
    init_rot: np.ndarray

    @classmethod
    def collate(cls, items: Sequence["AttitudeData"]) -> "AttitudeData":
        return _collate(items)


@dataclasses.dataclass
class StereoInertialFrame(StereoFrame):
    """A stereo frame with the IMU samples and attitude since the previous
    frame; :meth:`StereoFrame.to` keeps both (host numpy)."""

    imu: Optional[IMUData] = None
    attitude: Optional[AttitudeData] = None
