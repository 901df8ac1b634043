"""IMU stack (port of ``macvo_tpu/data/imu.py``), host numpy and scipy.

* :class:`IMUNoiseGenerator`: biased random-walk noise with Epson M365-style
  defaults.
* :class:`IMUSimulator`: differentiates ground-truth poses to IMU rate,
  quartic splines for the translation and scipy's ``RotationSpline`` for the
  body rates, giving the specific force in the body frame, gyro samples and
  exact attitude labels.
* :func:`load_tartanair_imu`: reads a real TartanAir IMU directory
  (acc / gyro / time and the ground-truth kinematics).
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from types import SimpleNamespace
from typing import Optional

import numpy as np
from scipy import interpolate
from scipy.spatial.transform import Rotation, RotationSpline

from ..utils.registry import ConfigTestable
from .frame import AttitudeData, IMUData

GRAVITY = 9.81

# Epson M365 IMU noise defaults
EPSON_M365 = dict(
    acc_bias=(0.02, 0.02, 0.02),
    gyro_bias=(5e-4, 5e-4, 5e-4),
    acc_init_bias_noise=(0.01, 0.01, 0.01),
    gyro_init_bias_noise=(5e-5, 5e-5, 5e-5),
    acc_bias_instability=(1e-4, 1e-4, 1e-4),
    gyro_bias_instability=(1e-6, 1e-6, 1e-6),
    acc_random_walk=(1e-3, 1e-3, 1e-3),
    gyro_random_walk=(1e-5, 1e-5, 1e-5),
)


class IMUNoiseGenerator(ConfigTestable):
    """Biased random-walk IMU noise, drawn from a seeded numpy generator."""

    def __init__(
        self, acc_bias, gyro_bias, acc_init_bias_noise, acc_bias_instability,
        acc_random_walk, gyro_init_bias_noise, gyro_bias_instability,
        gyro_random_walk, seed: int = 0,
    ) -> None:
        self.rng = np.random.default_rng(seed)
        self.acc_bias = np.array(acc_bias) + self.rng.normal(0, acc_init_bias_noise)
        self.gyro_bias = np.array(gyro_bias) + self.rng.normal(0, gyro_init_bias_noise)
        self.acc_bias_instability = np.array(acc_bias_instability)
        self.gyro_bias_instability = np.array(gyro_bias_instability)
        self.acc_random_walk = np.array(acc_random_walk)
        self.gyro_random_walk = np.array(gyro_random_walk)

    def propagate(self, acc: np.ndarray, gyro: np.ndarray):
        """Add bias + white random-walk noise; evolve the biases."""
        acc = acc + self.acc_bias + self.rng.normal(0, self.acc_random_walk, acc.shape)
        gyro = gyro + self.gyro_bias + self.rng.normal(0, self.gyro_random_walk, gyro.shape)
        self.acc_bias = self.acc_bias + self.rng.normal(0, self.acc_bias_instability)
        self.gyro_bias = self.gyro_bias + self.rng.normal(0, self.gyro_bias_instability)
        return acc, gyro

    @classmethod
    def is_valid_config(cls, config: SimpleNamespace | None) -> None:
        def triplet(v):
            return hasattr(v, "__len__") and len(v) == 3

        cls._enforce_config_spec(config, {
            "acc_bias": triplet, "gyro_bias": triplet,
            "acc_init_bias_noise": triplet, "gyro_init_bias_noise": triplet,
            "acc_bias_instability": triplet, "gyro_bias_instability": triplet,
            "acc_random_walk": triplet, "gyro_random_walk": triplet,
        })


@dataclasses.dataclass
class SimulatedIMU:
    time_ns: np.ndarray     # (N,)
    acc: np.ndarray         # (N,3) specific force, body frame
    gyro: np.ndarray        # (N,3) body rates
    gt_pos: np.ndarray      # (N,3)
    gt_vel: np.ndarray      # (N,3)
    gt_rot: np.ndarray      # (N,4) quaternion xyzw
    cam_to_imu: np.ndarray  # (M,) index of the IMU sample at each camera time


class IMUSimulator:
    """Spline-differentiate ground-truth poses (N,7) at ``cam_fps`` to
    inertial measurements at ``imu_fps``."""

    def __init__(self, poses: np.ndarray, cam_fps: float = 10.0, imu_fps: float = 100.0,
                 noise: Optional[IMUNoiseGenerator] = None) -> None:
        self.cam_fps = cam_fps
        self.imu_fps = imu_fps
        self.noise = noise
        self.data = self._simulate(np.asarray(poses, dtype=np.float64))

    def _simulate(self, poses: np.ndarray) -> SimulatedIMU:
        n = poses.shape[0]
        cam_time = np.arange(n) / self.cam_fps
        imu_time = np.arange(round(cam_time.max() * self.imu_fps)) / self.imu_fps

        # Translation: quartic spline -> position, velocity, acceleration.
        pos, vel, acc = [], [], []
        for i in range(3):
            tck = interpolate.splrep(cam_time, poses[:, i], s=0, k=4)
            pos.append(interpolate.splev(imu_time, tck, der=0))
            vel.append(interpolate.splev(imu_time, tck, der=1))
            acc.append(interpolate.splev(imu_time, tck, der=2))
        pos = np.stack(pos, 1)
        vel = np.stack(vel, 1)
        acc = np.stack(acc, 1)

        # Rotation: RotationSpline -> attitude + body rates.
        spline = RotationSpline(cam_time, Rotation.from_quat(poses[:, 3:7]))
        rots = spline(imu_time)
        gyro = spline(imu_time, 1)

        # Specific force in the body frame: R^T (a + g), NED gravity +z down.
        g = np.array([0.0, 0.0, GRAVITY])
        acc_body = np.einsum("nij,nj->ni", rots.as_matrix().transpose(0, 2, 1), acc + g)

        if self.noise is not None:
            acc_body, gyro = self.noise.propagate(acc_body, gyro)

        cam_to_imu = np.searchsorted(imu_time, cam_time).clip(0, imu_time.size - 1)
        return SimulatedIMU(
            time_ns=(imu_time * 1e9).astype(np.int64),
            acc=acc_body.astype(np.float32),
            gyro=np.asarray(gyro, dtype=np.float32),
            gt_pos=pos.astype(np.float32),
            gt_vel=vel.astype(np.float32),
            gt_rot=rots.as_quat(canonical=False).astype(np.float32),
            cam_to_imu=cam_to_imu,
        )

    def between_frames(self, frame_idx: int) -> tuple[IMUData, AttitudeData]:
        """IMU samples between camera frames ``frame_idx-1`` and ``frame_idx``."""
        d = self.data
        lo = d.cam_to_imu[max(frame_idx - 1, 0)]
        hi = d.cam_to_imu[frame_idx]
        sl = slice(lo, max(hi, lo + 1))
        imu = IMUData(
            time_ns=d.time_ns[None, sl],
            acc=d.acc[None, sl],
            gyro=d.gyro[None, sl],
            gravity=np.array([[0.0, 0.0, GRAVITY]], dtype=np.float32),
        )
        att = AttitudeData(
            time_ns=d.time_ns[None, sl],
            gt_pos=d.gt_pos[None, sl],
            gt_vel=d.gt_vel[None, sl],
            gt_rot=d.gt_rot[None, sl],
            init_pos=d.gt_pos[None, lo],
            init_vel=d.gt_vel[None, lo],
            init_rot=d.gt_rot[None, lo],
        )
        return imu, att


def _load_first(imu_dir: Path, names: tuple[str, ...]) -> np.ndarray | None:
    for n in names:
        p = imu_dir / n
        if p.exists():
            return np.load(p)
    return None


def load_tartanair_imu(imu_dir: Path) -> SimulatedIMU:
    """Read a real TartanAir IMU directory (acc/gyro/time + GT kinematics).

    Accepts both file-name schemes: v1 (accel_left/gyro_left/xyz_left/
    vel_left/angles_left) and v2 (acc/gyro/pos_global/vel_global/ori_global,
    with ori_global as XYZ Euler angles)."""
    imu_dir = Path(imu_dir)
    acc = _load_first(imu_dir, ("accel_left.npy", "acc.npy"))
    gyro = _load_first(imu_dir, ("gyro_left.npy", "gyro.npy"))
    if acc is None or gyro is None:
        raise FileNotFoundError(f"no IMU data under {imu_dir}")
    acc = acc.astype(np.float32)
    gyro = gyro.astype(np.float32)
    imu_time = np.load(imu_dir / "imu_time.npy")
    cam_time = np.load(imu_dir / "cam_time.npy")
    gt_pos = _load_first(imu_dir, ("xyz_left.npy", "pos_global.npy"))
    gt_pos = gt_pos.astype(np.float32) if gt_pos is not None else np.zeros_like(acc)
    gt_vel = _load_first(imu_dir, ("vel_left.npy", "vel_global.npy"))
    gt_vel = gt_vel.astype(np.float32) if gt_vel is not None else np.zeros_like(acc)
    angles = _load_first(imu_dir, ("angles_left.npy", "ori_global.npy"))
    if angles is not None and angles.shape[-1] == 3:
        gt_rot = Rotation.from_euler("XYZ", angles, degrees=False).as_quat().astype(np.float32)
    elif angles is not None:
        gt_rot = angles.astype(np.float32)
    else:
        gt_rot = np.tile(np.array([0, 0, 0, 1], np.float32), (acc.shape[0], 1))
    # nearest-time alignment (searchsorted-left is off by one whenever the
    # float32 camera stamp rounds up past the float64 imu stamp)
    right = np.searchsorted(imu_time, cam_time.astype(np.float64)).clip(0, imu_time.size - 1)
    left = np.maximum(right - 1, 0)
    pick_left = (np.abs(imu_time[left] - cam_time) <= np.abs(imu_time[right] - cam_time))
    cam_to_imu = np.where(pick_left, left, right)
    return SimulatedIMU(
        time_ns=(imu_time * 1e9).astype(np.int64),
        acc=acc, gyro=gyro, gt_pos=gt_pos, gt_vel=gt_vel, gt_rot=gt_rot,
        cam_to_imu=cam_to_imu,
    )
