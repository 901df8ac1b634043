"""EuRoC MAV stereo(-inertial) sequence loaders (port of
``macvo_tpu/data/datasets/euroc.py``).

Reads the ASL layout (``cam0`` / ``cam1`` with ``sensor.yaml`` and
``data/<ns>.png``, ground truth in ``state_groundtruth_estimate0/data.csv``,
IMU in ``imu0/data.csv``), keeps the timestamps both cameras have,
rectifies the pair with the calibrated L->R extrinsic and interpolates the
ground-truth body poses onto the camera timestamps. ``T_BS`` composes the
body-to-cam0 extrinsic with the EDN->NED roll. The baseline is the
reference's constant (ORB-SLAM2's bf over fx).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import yaml

from ...geometry.interp import interpolate_pose
from ..frame import AttitudeData, IMUData, StereoData, StereoFrame, StereoInertialFrame
from ..sequence import SequenceBase
from .rectify import NED2EDN_MAT, RectifiedCamera, matrix_to_pose7, rectify_pair

EUROC_BASELINE = 0.1100778422
EUROC_SIZE = (752, 480)

# the standard EuRoC radial-tangential distortion of cam0 and cam1
DIST_CAM0 = np.array([-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05, 0.0])
DIST_CAM1 = np.array([-0.28368365, 0.07451284, -0.00010473, -3.555907e-05, 0.0])


def _load_camera(cam_dir: Path, distortion: np.ndarray) -> RectifiedCamera:
    with open(cam_dir / "sensor.yaml") as f:
        sensor = yaml.safe_load(f)
    fx, fy, cx, cy = sensor["intrinsics"]
    K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], dtype=np.float64)
    T_BS = np.array(sensor["T_BS"]["data"], dtype=np.float64).reshape(4, 4)
    files = sorted((cam_dir / "data").glob("*.png"))
    times = np.array([int(f.stem) for f in files], dtype=np.int64)
    return RectifiedCamera(files, times, K, distortion, T_BS)


def load_euroc_gt_poses(csv_path: Path, cam_times_ns: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Ground-truth body poses interpolated onto the camera timestamps:
    ((M,7) float32 poses, (N,) bool mask of the camera times strictly inside
    the ground truth's span)."""
    raw = np.loadtxt(csv_path, delimiter=",", skiprows=1)
    pose_time = raw[:, 0].astype(np.int64)
    txyz = raw[:, 1:4]
    q_xyzw = np.roll(raw[:, 4:8], shift=-1, axis=1)  # the file stores wxyz
    poses = np.concatenate([txyz, q_xyzw], axis=1)

    mask = (cam_times_ns > pose_time[0]) & (cam_times_ns < pose_time[-1])
    interp, _ = interpolate_pose(poses.astype(np.float64), pose_time.astype(np.float64),
                                 cam_times_ns[mask].astype(np.float64))
    return np.asarray(interp, dtype=np.float32), mask


class EuRoC(SequenceBase[StereoFrame]):
    """Stereo-only EuRoC sequence (also registered as ``EuRoC_NoIMU``)."""

    def __init__(self, config) -> None:
        cfg = self.config_dict2ns(config)
        root = Path(cfg.root)
        self.left = _load_camera(root / "cam0", DIST_CAM0)
        self.right = _load_camera(root / "cam1", DIST_CAM1)
        K = rectify_pair(self.left, self.right, EUROC_SIZE)
        self.K = K.astype(np.float32)
        self.baseline = EUROC_BASELINE
        self.T_BS = matrix_to_pose7(self.left.T_BS @ NED2EDN_MAT)

        self.gt_poses = None
        if getattr(cfg, "gt_pose", False):
            self.gt_poses, mask = load_euroc_gt_poses(
                root / "state_groundtruth_estimate0" / "data.csv", self.left.times_ns)
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


class EuRoC_NoIMU(EuRoC):
    """The reference's registry name of the stereo-only loader."""


class EuRoC_IMU(EuRoC):
    """Stereo-inertial EuRoC sequence: each frame also carries the IMU
    samples and the ground-truth kinematics between the previous camera
    timestamp and its own."""

    def __init__(self, config) -> None:
        super().__init__(config)
        root = Path(self.config_dict2ns(config).root)
        raw = np.genfromtxt(root / "imu0" / "data.csv", delimiter=",", skip_header=1)
        self._imu_time = raw[:, 0].astype(np.int64)
        self._gyro = raw[:, 1:4].astype(np.float32)
        self._acc = raw[:, 4:7].astype(np.float32)

        gt = np.genfromtxt(root / "state_groundtruth_estimate0" / "data.csv", delimiter=",", skip_header=1)
        self._gt_time = gt[:, 0].astype(np.int64)
        self._gt_pos = gt[:, 1:4].astype(np.float32)
        self._gt_rot = np.roll(gt[:, 4:8], shift=-1, axis=1).astype(np.float32)  # wxyz -> xyzw
        self._gt_vel = gt[:, 8:11].astype(np.float32)

    def _imu_between(self, t0_ns: int, t1_ns: int) -> tuple[IMUData, AttitudeData]:
        lo, hi = np.searchsorted(self._imu_time, (t0_ns, t1_ns))
        hi = max(hi, lo + 1)
        sl = slice(lo, hi)
        g_idx = np.clip(np.searchsorted(self._gt_time, self._imu_time[sl]), 0, self._gt_time.size - 1)
        imu = IMUData(
            time_ns=self._imu_time[None, sl],
            acc=self._acc[None, sl],
            gyro=self._gyro[None, sl],
            gravity=np.array([[0.0, 0.0, 9.81]], dtype=np.float32),
        )
        att = AttitudeData(
            time_ns=self._imu_time[None, sl],
            gt_pos=self._gt_pos[None, g_idx],
            gt_vel=self._gt_vel[None, g_idx],
            gt_rot=self._gt_rot[None, g_idx],
            init_pos=self._gt_pos[None, g_idx[0]],
            init_vel=self._gt_vel[None, g_idx[0]],
            init_rot=self._gt_rot[None, g_idx[0]],
        )
        return imu, att

    def __getitem__(self, local_index: int) -> StereoInertialFrame:
        frame = super().__getitem__(local_index)
        index = self.get_index(local_index)
        t1 = int(self.left.times_ns[index])
        t0 = int(self.left.times_ns[max(index - 1, 0)])
        imu, att = self._imu_between(t0, t1)
        return StereoInertialFrame(idx=frame.idx, stereo=frame.stereo, gt_pose=frame.gt_pose, imu=imu, attitude=att)
