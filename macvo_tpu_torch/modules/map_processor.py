"""Terminal map post-processors that repair ``need_interp`` frame poses
(port of ``macvo_tpu/modules/map_processor.py``). Host-side numpy; each
processor rewrites the frame store's pose column in place and returns the
indices it interpolated."""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np

from ..geometry import se3_np
from ..geometry.interp import cumulative_motions, interpolate_pose
from ..utils.registry import RegisteredConfigTestable
from ..worldmap.storage import Store


class IMapProcessor(RegisteredConfigTestable, register=False):
    def __init__(self, config: SimpleNamespace | None) -> None:
        self.config = config

    def elaborate_map(self, frames: Store) -> np.ndarray:
        raise NotImplementedError


class Naive(IMapProcessor):
    """No-op processor."""

    def elaborate_map(self, frames: Store) -> np.ndarray:
        return np.zeros((0,), dtype=np.int64)

    @classmethod
    def is_valid_config(cls, config) -> None:
        return


class PoseInterpolate(IMapProcessor):
    """Geodesic interpolation of lost-track poses from the good frames, in
    float32 as the JAX package does it (poses and frame-index timestamps).
    The first and last 5 frames are never interpolated."""

    def elaborate_map(self, frames: Store) -> np.ndarray:
        poses = frames.data["pose"]
        bad = frames.data["need_interp"].copy()
        bad[:5] = False
        bad[-5:] = False
        bad_idx = np.nonzero(bad)[0]
        if bad_idx.size == 0:
            return bad_idx
        good_idx = np.nonzero(~bad)[0]
        interp, _ = interpolate_pose(poses[good_idx].astype(np.float32), good_idx.astype(np.float32),
                                     bad_idx.astype(np.float32))
        poses[bad_idx] = interp.astype(np.float32)
        return bad_idx

    @classmethod
    def is_valid_config(cls, config) -> None:
        cls._enforce_config_spec(config, {})


class MotionInterpolate(IMapProcessor):
    """Interpolate lost-track frames in motion space (float64), then rebuild
    the trajectory with a renormalized cumulative product."""

    def elaborate_map(self, frames: Store) -> np.ndarray:
        poses = frames.data["pose"]
        n = poses.shape[0]
        if n < 2:
            return np.zeros((0,), dtype=np.int64)
        bad = frames.data["need_interp"][1:].copy()
        bad[:2] = False
        bad[-2:] = False
        bad_idx = np.nonzero(bad)[0]
        if bad_idx.size == 0:
            return bad_idx
        all_poses = poses.astype(np.float64)
        motions = se3_np.mul(se3_np.inv(all_poses[:-1]), all_poses[1:])
        good_idx = np.nonzero(~bad)[0]
        motions[bad_idx], _ = interpolate_pose(motions[good_idx], good_idx.astype(np.float64),
                                               bad_idx.astype(np.float64))
        poses[:] = cumulative_motions(all_poses[0], motions).astype(np.float32)
        return bad_idx + 1

    @classmethod
    def is_valid_config(cls, config) -> None:
        cls._enforce_config_spec(config, {})
