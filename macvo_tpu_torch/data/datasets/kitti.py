"""KITTI odometry stereo sequence loader (port of
``macvo_tpu/data/datasets/kitti.py``).

Reads the odometry layout: the ``image_2`` / ``image_3`` color pair,
``calib.txt`` projection matrices, ``times.txt``, and poses (rows of 3x4
matrices) under ``../../poses/<seq>.txt``. The baseline is the distance of
the decomposed P2 / P3 camera centres; ``T_BS`` composes the cam2 extrinsic
with the EDN->NED roll.
"""

from __future__ import annotations

from pathlib import Path

import cv2
import numpy as np

from ..frame import StereoData, StereoFrame
from ..sequence import SequenceBase
from .rectify import NED2EDN_MAT, matrix_to_pose7
from .tartanair import _tensor, load_image


def _decompose(p_line: str) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    P = np.array(list(map(float, p_line.split()[1:]))).reshape(3, 4)
    K, R, t_h = cv2.decomposeProjectionMatrix(P)[:3]
    t = (t_h[:3] / t_h[3]).reshape(3)
    return K, R, t


def load_kitti_gt_poses(path: Path) -> np.ndarray:
    """(N,12) row-major 3x4 matrices -> (N,7) [t, q] poses."""
    mats = np.loadtxt(path).reshape(-1, 3, 4)
    out = np.zeros((mats.shape[0], 4, 4))
    out[:, :3] = mats
    out[:, 3, 3] = 1.0
    return np.stack([matrix_to_pose7(m) for m in out])


class KITTI(SequenceBase[StereoFrame]):
    def __init__(self, config) -> None:
        cfg = self.config_dict2ns(config)
        root = Path(cfg.root)
        self.left_files = sorted((root / "image_2").glob("*.png"))
        self.right_files = sorted((root / "image_3").glob("*.png"))
        if len(self.left_files) != len(self.right_files):
            raise ValueError(f"KITTI: {len(self.left_files)} left and {len(self.right_files)} right images")

        with open(root / "calib.txt") as f:
            lines = f.read().strip().splitlines()
        K2, R2, t2 = _decompose(lines[2])
        _, _, t3 = _decompose(lines[3])
        self.K = K2.astype(np.float32)
        self.baseline = float(np.linalg.norm(t2 - t3))
        T = np.eye(4)
        T[:3, :3] = R2
        T[:3, 3] = t2
        self.T_BS = matrix_to_pose7(T @ NED2EDN_MAT)

        self.times_ns = (np.loadtxt(root / "times.txt") * 1e9).astype(np.int64)
        self.gt_poses = None
        if getattr(cfg, "gt_pose", False):
            self.gt_poses = load_kitti_gt_poses(root.parent.parent / "poses" / f"{root.name}.txt")
        super().__init__(len(self.left_files))

    def __getitem__(self, local_index: int) -> StereoFrame:
        index = self.get_index(local_index)
        return StereoFrame(
            idx=np.array([local_index]),
            gt_pose=None if self.gt_poses is None else self.gt_poses[index][None],
            stereo=StereoData(
                T_BS=self.T_BS[None],
                K=self.K[None],
                baseline=np.array([self.baseline], dtype=np.float32),
                time_ns=self.times_ns[index:index + 1],
                imageL=_tensor(load_image(self.left_files[index])),
                imageR=_tensor(load_image(self.right_files[index])),
            ),
        )

    @classmethod
    def is_valid_config(cls, config) -> None:
        cls._enforce_config_spec(config, {
            "root": lambda v: isinstance(v, str),
            "gt_pose": lambda b: isinstance(b, bool),
        })
