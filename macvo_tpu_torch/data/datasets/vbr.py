"""VBR (Vision Benchmark in Rome) stereo sequence loader (port of
``macvo_tpu/data/datasets/vbr.py``).

Reads ``vbr_calib.yaml`` (per camera: intrinsics, distortion and the body
extrinsic ``T_b``), rectifies the raw pair with the calibrated L->R
transform, and interpolates the TUM-format ground truth ``<seq>_gt.txt``
onto the camera timestamps.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import yaml

from ...geometry.interp import interpolate_pose
from ..frame import StereoData, StereoFrame
from ..sequence import SequenceBase
from .rectify import NED2EDN_MAT, RectifiedCamera, matrix_to_pose7, rectify_pair

VBR_SIZE = (1388, 700)


def _load_camera(cam_dir: Path, calib: dict) -> RectifiedCamera:
    fx, fy, cx, cy = calib["intrinsics"]
    K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], dtype=np.float64)
    T_b = np.array(calib["T_b"], dtype=np.float64)
    dist = np.array(calib["distortion_coeffs"], dtype=np.float64)
    files = sorted((cam_dir / "data").glob("*.png"))
    times = np.array([int(float(f.stem)) for f in files], dtype=np.int64)
    return RectifiedCamera(files, times, K, dist, T_b)


def load_vbr_gt_poses(path: Path, cam_times_ns: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """TUM-format ``t x y z qx qy qz qw`` -> poses interpolated onto the
    camera times (M,7) float32, and the (N,) mask of the times inside the span."""
    raw = np.loadtxt(path)
    pose_time = (raw[:, 0] * 1e9).astype(np.int64)
    poses = raw[:, 1:8]
    mask = (cam_times_ns > pose_time[0]) & (cam_times_ns < pose_time[-1])
    interp, _ = interpolate_pose(poses.astype(np.float64), pose_time.astype(np.float64),
                                 cam_times_ns[mask].astype(np.float64))
    return np.asarray(interp, dtype=np.float32), mask


class VBR_Stereo(SequenceBase[StereoFrame]):
    def __init__(self, config) -> None:
        cfg = self.config_dict2ns(config)
        root = Path(cfg.root)
        with open(root / "vbr_calib.yaml") as f:
            calib = yaml.safe_load(f)
        self.left = _load_camera(root / "camera_left", calib["cam_l"])
        self.right = _load_camera(root / "camera_right", calib["cam_r"])

        T_LR = np.linalg.inv(self.right.T_BS) @ self.left.T_BS
        self.baseline = float(np.linalg.norm(T_LR[:3, 3]))
        K = rectify_pair(self.left, self.right, VBR_SIZE)
        self.K = K.astype(np.float32)
        self.T_BS = matrix_to_pose7(self.left.T_BS @ NED2EDN_MAT)

        self.gt_poses = None
        if getattr(cfg, "gt_pose", False):
            self.gt_poses, mask = load_vbr_gt_poses(root / f"{root.name}_gt.txt", self.left.times_ns)
            self.left.apply_mask(mask)
            self.right.apply_mask(mask)
        super().__init__(len(self.left))

    def __getitem__(self, local_index: int) -> StereoFrame:
        index = self.get_index(local_index)
        return StereoFrame(
            idx=np.array([local_index]),
            gt_pose=None if self.gt_poses is None else self.gt_poses[index][None],
            stereo=StereoData(
                T_BS=self.T_BS[None],
                K=self.K[None],
                baseline=np.array([self.baseline], dtype=np.float32),
                time_ns=self.left.times_ns[index:index + 1],
                imageL=self.left.read(index),
                imageR=self.right.read(index),
            ),
        )

    @classmethod
    def is_valid_config(cls, config) -> None:
        cls._enforce_config_spec(config, {
            "root": lambda v: isinstance(v, str),
            "gt_pose": lambda b: isinstance(b, bool),
        })
