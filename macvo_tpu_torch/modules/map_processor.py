"""Terminal map post-processors that repair ``need_interp`` frame poses
(port of ``macvo_tpu/modules/map_processor.py``). Host-side, float64 on the CPU."""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch

from ..geometry import se3
from ..utils.registry import RegisteredConfigTestable
from ..worldmap.storage import Store


def interpolate_pose(poses: torch.Tensor, ts: torch.Tensor, ts_ev: torch.Tensor) -> torch.Tensor:
    """Geodesic (Log/Exp) interpolation of an SE3 sequence (N,7)@ts onto ts_ev,
    clamped to the end poses outside [ts[0], ts[-1]]."""
    idx_end = torch.searchsorted(ts, ts_ev, side="left").clamp(1, ts.shape[0] - 1)
    idx_start = idx_end - 1
    p0, p1 = poses[idx_start], poses[idx_end]
    t0, t1 = ts[idx_start], ts[idx_end]
    tau = (ts_ev - t0) / torch.clamp(t1 - t0, min=1e-12)
    before, after = ts_ev <= ts[0], ts_ev >= ts[-1]
    tau = torch.where(before, torch.zeros_like(tau), torch.where(after, torch.ones_like(tau), tau)).clamp(0, 1)
    delta = se3.log(se3.mul(p1, se3.inv(p0)))
    interp = se3.mul(se3.exp(tau[..., None] * delta), p0)
    interp = torch.where(before[..., None], poses[0], interp)
    return torch.where(after[..., None], poses[-1], interp)


def cumulative_motions(init_pose: torch.Tensor, motions: torch.Tensor) -> torch.Tensor:
    """pose_i = normalize(pose_{i-1} @ m_i), starting from ``init_pose``."""
    traj = [init_pose]
    for m in motions:
        traj.append(se3.normalize(se3.mul(traj[-1], m)))
    return torch.stack(traj)


class IMapProcessor(RegisteredConfigTestable, register=False):
    def __init__(self, config: SimpleNamespace | None) -> None:
        self.config = config

    def elaborate_map(self, frames: Store) -> np.ndarray:
        raise NotImplementedError


class MotionInterpolate(IMapProcessor):
    """Interpolate lost-track frames in motion space, then rebuild the
    trajectory with a renormalized cumulative product."""

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
        all_poses = torch.from_numpy(np.asarray(poses, dtype=np.float64))
        motions = se3.mul(se3.inv(all_poses[:-1]), all_poses[1:])
        good_idx = np.nonzero(~bad)[0]
        motions[torch.from_numpy(bad_idx)] = interpolate_pose(
            motions[torch.from_numpy(good_idx)], torch.from_numpy(good_idx).double(),
            torch.from_numpy(bad_idx).double())
        poses[:] = cumulative_motions(all_poses[0], motions).numpy().astype(np.float32)
        return bad_idx + 1

    @classmethod
    def is_valid_config(cls, config) -> None:
        cls._enforce_config_spec(config, {})
