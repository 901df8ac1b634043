"""Stereo sequence of a user's own rig with intrinsics given in the config
(port of ``macvo_tpu/data/datasets/general.py``).

Config: ``root`` with ``<root>/left/*.png`` and ``<root>/right/*.png``,
``fx fy cx cy baseline``; times from ``<root>/times.txt`` (seconds, one a
frame) when it exists, else from ``fps`` (default 10); optional
``pose_file`` in the TartanAir format (rows ``t q_xyzw``).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from ...geometry import se3_np
from ..frame import StereoData, StereoFrame
from ..sequence import SequenceBase
from .tartanair import _sorted_files, _tensor, load_image, load_tartanair_poses


class GeneralStereo(SequenceBase[StereoFrame]):
    def __init__(self, config) -> None:
        cfg = self.config_dict2ns(config)
        root = Path(cfg.root)
        self.left_files = _sorted_files(root / "left", ".png")
        self.right_files = _sorted_files(root / "right", ".png")
        if len(self.left_files) != len(self.right_files):
            raise ValueError(f"GeneralStereo: {len(self.left_files)} left and {len(self.right_files)} right images")

        self.K = np.array([[cfg.fx, 0.0, cfg.cx], [0.0, cfg.fy, cfg.cy], [0.0, 0.0, 1.0]], dtype=np.float32)
        self.baseline = float(cfg.baseline)

        times_file = root / "times.txt"
        if times_file.exists():
            self.times_ns = (np.loadtxt(str(times_file)) * 1e9).astype(np.int64)
        else:
            fps = float(getattr(cfg, "fps", 10.0))
            self.times_ns = (np.arange(len(self.left_files)) / fps * 1e9).astype(np.int64)

        pose_file = getattr(cfg, "pose_file", None)
        self.gt_poses = load_tartanair_poses(Path(pose_file)) if pose_file else None
        super().__init__(len(self.left_files))

    def __getitem__(self, local_index: int) -> StereoFrame:
        index = self.get_index(local_index)
        return StereoFrame(
            idx=np.array([local_index]),
            gt_pose=self.gt_poses[index][None] if self.gt_poses is not None else None,
            stereo=StereoData(
                T_BS=np.asarray(se3_np.identity((1,))),
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
            "root": lambda s: isinstance(s, str),
            "fx": lambda v: isinstance(v, (int, float)) and v > 0,
            "fy": lambda v: isinstance(v, (int, float)) and v > 0,
            "cx": lambda v: isinstance(v, (int, float)) and v >= 0,
            "cy": lambda v: isinstance(v, (int, float)) and v >= 0,
            "baseline": lambda v: isinstance(v, (int, float)) and v > 0,
        })
