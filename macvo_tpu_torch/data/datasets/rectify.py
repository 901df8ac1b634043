"""Stereo rectification of raw (distorted) stereo rigs (port of
``macvo_tpu/data/datasets/rectify.py``), used by the EuRoC and VBR loaders.

The two cameras' timestamps are intersected, ``cv2.stereoRectify`` computes
the rectifying rotations from the L->R extrinsic, and each camera keeps its
undistort-rectify maps for a remap at read time.
"""

from __future__ import annotations

from pathlib import Path

import cv2
import numpy as np
import torch

from ...geometry import se3_np

EDN2NED_MAT = np.array(
    [[0.0, 0.0, 1.0, 0.0],
     [1.0, 0.0, 0.0, 0.0],
     [0.0, 1.0, 0.0, 0.0],
     [0.0, 0.0, 0.0, 1.0]]
)
# camera (EDN) <-> NED axis roll
NED2EDN_MAT = np.linalg.inv(EDN2NED_MAT)


class RectifiedCamera:
    """One camera of a rectified pair: its files, timestamps, calibration and
    (once :func:`rectify_pair` ran) its undistort-rectify maps."""

    def __init__(self, files: list[Path], times_ns: np.ndarray, K: np.ndarray,
                 distortion: np.ndarray, T_BS: np.ndarray) -> None:
        self.files = files
        self.times_ns = times_ns
        self.K = K.astype(np.float64)
        self.distortion = distortion.astype(np.float64)
        self.T_BS = T_BS.astype(np.float64)
        self.maps: tuple | None = None

    def apply_mask(self, mask: np.ndarray) -> None:
        self.files = [f for i, f in enumerate(self.files) if mask[i]]
        self.times_ns = self.times_ns[mask]

    def __len__(self) -> int:
        return len(self.files)

    def read(self, index: int) -> torch.Tensor:
        """(1,H,W,3) float32 [0,1] rectified RGB image (a gray file reads as
        three equal channels)."""
        img = cv2.imread(str(self.files[index]), cv2.IMREAD_COLOR)
        if img is None:
            raise FileNotFoundError(f"Unreadable image: {self.files[index]}")
        img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
        if self.maps is not None:
            img = cv2.remap(img, self.maps[0], self.maps[1], cv2.INTER_LINEAR)
        return torch.from_numpy(img.astype(np.float32) / 255.0)[None]


def rectify_pair(left: RectifiedCamera, right: RectifiedCamera, image_size: tuple[int, int]) -> np.ndarray:
    """Keep the timestamps both cameras have, rectify the pair and install
    the remap tables; returns the rectified left projection K (3,3)."""
    common = np.intersect1d(left.times_ns, right.times_ns)
    left.apply_mask(np.isin(left.times_ns, common, assume_unique=True))
    right.apply_mask(np.isin(right.times_ns, common, assume_unique=True))

    T_LR = np.linalg.inv(right.T_BS) @ left.T_BS
    R1, R2, P1, P2, _, _, _ = cv2.stereoRectify(
        left.K, left.distortion, right.K, right.distortion, image_size,
        np.ascontiguousarray(T_LR[:3, :3]),
        np.ascontiguousarray(T_LR[:3, 3]).reshape(3, 1),
        flags=cv2.CALIB_ZERO_DISPARITY, alpha=-1,
    )
    left.maps = cv2.initUndistortRectifyMap(left.K, left.distortion, R1, P1, image_size, cv2.CV_32FC1)
    right.maps = cv2.initUndistortRectifyMap(right.K, right.distortion, R2, P2, image_size, cv2.CV_32FC1)
    left.K = P1[:3, :3]
    right.K = P2[:3, :3]
    return P1[:3, :3]


def matrix_to_pose7(mat: np.ndarray) -> np.ndarray:
    """(4,4) -> (7,) float32 [t, q_xyzw]."""
    return np.asarray(se3_np.from_matrix(np.asarray(mat, np.float64)), dtype=np.float32)
