"""TartanAir sequence loaders (port of ``TartanAir`` and ``TartanAirV2`` in
``macvo_tpu/data/datasets/tartanair.py``).

v2 layout: ``<root>/image_{l,r}cam_front/*.png``, compressed depth
(float32 packed in rgba png) ``depth_lcam_front/``, 16-bit flow png
``flow_lcam_front/``, ``pose_lcam_front.txt`` rows ``tx ty tz qx qy qz qw``
(NED world, left camera). v2 intrinsics: fx=fy=320, cx=cy=320, 640x640,
baseline 0.25 m. Images load as ``(1,H,W,3)`` float32 in [0,1] torch tensors
on the CPU; depth ``(1,H,W,1)``; flow ``(1,H,W,2)`` + mask ``(1,H,W,1)``.
"""

from __future__ import annotations

from pathlib import Path

import cv2
import numpy as np
import torch

from ...geometry import se3_np
from ..frame import StereoData, StereoFrame
from ..sequence import SequenceBase


def load_image(path: Path) -> np.ndarray:
    bgr = cv2.imread(str(path), cv2.IMREAD_COLOR)
    if bgr is None:
        raise FileNotFoundError(f"Unreadable image: {path}")
    rgb = cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB)
    return (rgb.astype(np.float32) / 255.0)[None]


def load_depth(path: Path, compressed: bool) -> np.ndarray:
    if compressed:
        rgba = cv2.imread(str(path), cv2.IMREAD_UNCHANGED)
        if rgba is None:
            raise FileNotFoundError(f"Unreadable depth: {path}")
        depth = np.squeeze(rgba.view("<f4"), axis=-1)
    else:
        depth = np.load(str(path))
    return depth.astype(np.float32)[None, ..., None]


def load_flow(path: Path, compressed: bool) -> tuple[np.ndarray, np.ndarray]:
    if compressed:
        flow16 = cv2.imread(str(path), cv2.IMREAD_UNCHANGED)
        if flow16 is None:
            raise FileNotFoundError(f"Unreadable flow: {path}")
        flow = (flow16[:, :, :2].astype(np.float32) - 32768.0) / 64.0
        # TartanAir mask channel: 0 = valid; the framework's mask is True = valid.
        mask = (flow16[:, :, 2] == 0).astype(np.float32)[..., None]
    else:
        raw = np.load(str(path))
        flow = raw[:, :, :2].astype(np.float32)
        mask = raw[:, :, 2:3].astype(np.float32) if raw.shape[-1] > 2 else np.ones_like(raw[:, :, :1])
    return flow[None], mask[None]


def load_tartanair_poses(path: Path) -> np.ndarray:
    data = np.loadtxt(str(path), dtype=np.float64)
    if data.ndim == 1:
        data = data[None]
    return data.astype(np.float32)


def _sorted_files(directory: Path, suffix: str) -> list[Path]:
    if not directory.exists():
        raise FileNotFoundError(f"Missing directory: {directory}")
    files = sorted(p for p in directory.iterdir() if p.name.endswith(suffix))
    if not files:
        raise FileNotFoundError(f"No '*{suffix}' files under {directory}")
    return files


def _tensor(x):
    return None if x is None else torch.from_numpy(np.ascontiguousarray(x))


class _TartanAirBase(SequenceBase[StereoFrame], register=False):
    K: np.ndarray
    BASELINE: float
    LEFT_DIR: str
    RIGHT_DIR: str
    DEPTH_DIR: str
    FLOW_DIR: str
    POSE_FILE: str

    def __init__(self, config) -> None:
        cfg = self.config_dict2ns(config)
        root = Path(cfg.root)
        self.compressed = bool(getattr(cfg, "compressed", False))
        self.left_files = _sorted_files(root / self.LEFT_DIR, ".png")
        self.right_files = _sorted_files(root / self.RIGHT_DIR, ".png")
        self.depth_files = None
        if getattr(cfg, "gtDepth", False):
            self.depth_files = _sorted_files(root / self.DEPTH_DIR, ".png" if self.compressed else ".npy")
        self.flow_files = None
        length = len(self.left_files)
        if getattr(cfg, "gtFlow", False):
            suffix = "_flow.png" if self.compressed else "_flow.npy"
            self.flow_files = _sorted_files(root / self.FLOW_DIR, suffix)
            length = len(self.flow_files)
        self.gt_poses = load_tartanair_poses(root / self.POSE_FILE) if getattr(cfg, "gtPose", False) else None
        time_file = root / "imu" / "cam_time.npy"
        if time_file.exists():
            self.times_ns = (np.load(str(time_file)) * 1e9).astype(np.int64)
        else:
            self.times_ns = (np.arange(len(self.left_files)) * 0.1 * 1e9).astype(np.int64)
        super().__init__(length)

    def __getitem__(self, local_index: int) -> StereoFrame:
        index = self.get_index(local_index)
        flow, flow_mask = (None, None)
        if self.flow_files is not None:
            flow, flow_mask = load_flow(self.flow_files[index], self.compressed)
        depth = load_depth(self.depth_files[index], self.compressed) if self.depth_files is not None else None
        return StereoFrame(
            idx=np.array([local_index]),
            gt_pose=self.gt_poses[index][None] if self.gt_poses is not None else None,
            stereo=StereoData(
                T_BS=np.asarray(se3_np.identity((1,))),
                K=self.K[None].astype(np.float32),
                baseline=np.array([self.BASELINE], dtype=np.float32),
                time_ns=self.times_ns[index:index + 1],
                imageL=_tensor(load_image(self.left_files[index])),
                imageR=_tensor(load_image(self.right_files[index])),
                gt_flow=_tensor(flow),
                flow_mask=_tensor(flow_mask),
                gt_depth=_tensor(depth),
            ),
        )

    @classmethod
    def is_valid_config(cls, config) -> None:
        cls._enforce_config_spec(config, {
            "root": lambda s: isinstance(s, str),
            "gtFlow": lambda b: isinstance(b, bool),
            "gtDepth": lambda b: isinstance(b, bool),
            "gtPose": lambda b: isinstance(b, bool),
        })


class TartanAir(_TartanAirBase):
    """TartanAir v1 layout (image_left/right pngs, depth_left npy, flow npy,
    pose_left.txt), 640x480 with fx=fy=320, cx=320, cy=240, baseline 0.25 m."""

    K = np.array([[320.0, 0.0, 320.0], [0.0, 320.0, 240.0], [0.0, 0.0, 1.0]])
    BASELINE = 0.25
    LEFT_DIR, RIGHT_DIR = "image_left", "image_right"
    DEPTH_DIR, FLOW_DIR = "depth_left", "flow"
    POSE_FILE = "pose_left.txt"


class TartanAirV2(_TartanAirBase):
    K = np.array([[320.0, 0.0, 320.0], [0.0, 320.0, 320.0], [0.0, 0.0, 1.0]])
    BASELINE = 0.25
    LEFT_DIR, RIGHT_DIR = "image_lcam_front", "image_rcam_front"
    DEPTH_DIR, FLOW_DIR = "depth_lcam_front", "flow_lcam_front"
    POSE_FILE = "pose_lcam_front.txt"
