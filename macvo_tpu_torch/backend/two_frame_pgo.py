"""Two-frame pose-graph optimizers (port of ``macvo_tpu/backend/two_frame_pgo.py``).

``Local_TwoFrame_PGO`` optimizes the newest keyframe's pose against the
previous frame's landmarks, re-anchored in the previous keyframe's frame so
float32 suffices on the card. Two ways in:

* host path (``get_graph_data`` + ``start_optimize``): the problem is
  assembled from the host map into one packed array, one upload, one solve;
* device chain (``start_optimize_device``): the odometry's packed per-frame
  sync array is consumed on the device directly (:func:`solve_sync_packed`),
  so the pose problem never waits for the host.
"""

from __future__ import annotations

import dataclasses
from types import SimpleNamespace
from typing import Any, Optional

import numpy as np
import torch

from ..geometry import camera, se3
from ..odometry.layout import COL_KEEP, MIN_NUM_POINT, OBS_COLS
from ..utils.device import resolve_device
from ..worldmap import VisualMap
from .interface import IOptimizer
from .solver import PACKED_WIDTH, TwoFrameData, intrinsics, solve_two_frame, solve_two_frame_packed


def solve_sync_packed(sync: torch.Tensor, anchor: torch.Tensor, cam: torch.Tensor,
                      baseline: torch.Tensor, graph_type: str) -> torch.Tensor:
    """Device-chained two-frame solve on the (K+1, 52) sync array
    (``odometry/layout.py``); ``cam`` = (fx, fy, cx, cy). Returns the world pose
    of the new frame — the motion prediction when fewer than MIN_NUM_POINT
    observations survive (lost track)."""
    k = sync.shape[0] - 1
    rows, aux = sync[:k], sync[k]
    est_pose = aux[0:7]

    def col(name):
        lo, hi = OBS_COLS[name]
        return rows[:, lo:hi]

    K = intrinsics(cam[0], cam[1], cam[2], cam[3]).to(sync.dtype)
    keep = rows[:, COL_KEEP] > 0.5

    # Masked-out rows may carry NaN/Inf from the frontend; NaN * 0 would poison
    # the masked reductions, so they get benign values first.
    def clean(x, benign):
        k2 = keep if x.ndim == 1 else keep[:, None]
        x = torch.nan_to_num(x, nan=benign, posinf=benign, neginf=benign)
        return torch.where(k2, x, torch.full_like(x, benign))

    uv1 = clean(col("pixel1_uv"), 0.0)
    uv2 = clean(col("pixel2_uv"), 0.0)
    d1 = clean(col("pixel1_d")[:, 0], 1.0)
    d2 = clean(col("pixel2_d")[:, 0], 1.0)
    disp2 = clean(col("pixel2_disp")[:, 0], 1.0)
    # Re-anchored in the previous keyframe's camera frame, the landmarks are
    # just the camera-frame backprojections and their covariances.
    uvc = col("pixel2_uv_cov")
    cov_kp2 = torch.stack([torch.stack([uvc[:, 0], uvc[:, 2]], -1),
                           torch.stack([uvc[:, 2], uvc[:, 1]], -1)], -2)
    data = TwoFrameData(
        pose0=se3.mul(se3.inv(anchor), est_pose).to(sync.dtype),
        points_w=camera.pixel_to_point_ned(uv1, d1, K),
        points_c=camera.pixel_to_point_ned(uv2, d2, K),
        kp2=uv2,
        disp2=disp2,
        cov_obs_c=col("obs2_covTc").reshape(k, 3, 3),
        cov_pts_w=col("obs1_covTc").reshape(k, 3, 3),
        cov_kp2=cov_kp2,
        disp2_cov=col("pixel2_disp_cov")[:, 0],
        K=K,
        baseline=baseline.to(sync.dtype),
        mask=keep,
    )
    pose_w = se3.normalize(se3.mul(anchor, solve_two_frame(data, graph_type=graph_type)))
    lost = keep.sum() < MIN_NUM_POINT
    return torch.where(lost, se3.normalize(est_pose), pose_w)


def _np_quat_rotmat(q: np.ndarray) -> np.ndarray:
    x, y, z, w = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def _np_pose_inv(pose: np.ndarray) -> np.ndarray:
    q_inv = pose[3:7] * np.array([-1.0, -1.0, -1.0, 1.0])
    return np.concatenate([-_np_quat_rotmat(q_inv) @ pose[:3], q_inv])


def _np_pose_mul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    x1, y1, z1, w1 = a[3:7]
    x2, y2, z2, w2 = b[3:7]
    q = np.array([
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
    ])
    q /= max(np.linalg.norm(q), 1e-12)
    return np.concatenate([a[:3] + _np_quat_rotmat(a[3:7]) @ b[:3], q])


@dataclasses.dataclass
class GraphInput:
    frame_idx: int
    from_idx: int
    packed: np.ndarray           # (cap+1, 33) host array
    anchor: Optional[np.ndarray] = None


@dataclasses.dataclass
class GraphOutput:
    frame_idx: int
    from_idx: int
    pose: torch.Tensor           # (7,) device tensor until fetched


class TwoFrame_PGO(IOptimizer[GraphInput, GraphOutput]):
    DEFAULT_CAPACITY = 512

    def __init__(self, config: SimpleNamespace, device: str | torch.device = "cuda") -> None:
        super().__init__(config)
        self.device = resolve_device(device)
        self.capacity = int(getattr(config, "capacity", self.DEFAULT_CAPACITY))
        self.np_dtype = np.float64 if getattr(config, "use_fp64", False) else np.float32

    @staticmethod
    def init_context(config: SimpleNamespace) -> Any:
        return {"graph_type": config.graph_type}

    def _assemble(self, global_map: VisualMap, frame_idx: int) -> np.ndarray:
        """Newest frame's matches/points from the host map -> packed problem."""
        frame = global_map.frames[frame_idx]
        obs = global_map.get_frame2match(frame)
        pts = global_map.get_match2point(obs)
        n, cap = len(obs), self.capacity
        if n > cap:
            raise ValueError(f"TwoFrame_PGO: {n} observations exceed capacity {cap}")
        packed = np.zeros((cap + 1, PACKED_WIDTH), dtype=self.np_dtype)
        K = frame.data["K"][0].astype(np.float64)
        kp2 = obs.data["pixel2_uv"].astype(np.float64)
        d2 = obs.data["pixel2_d"][:, 0].astype(np.float64)
        packed[:n, 3] = d2
        packed[:n, 4] = (kp2[:, 0] - K[0, 2]) * d2 / K[0, 0]
        packed[:n, 5] = (kp2[:, 1] - K[1, 2]) * d2 / K[1, 1]
        packed[:n, 0:3] = pts.data["pos_Tw"]
        packed[:n, 6:8] = kp2
        packed[:n, 8] = obs.data["pixel2_disp"][:, 0]
        packed[:n, 9:18] = obs.data["obs2_covTc"].reshape(n, 9)
        packed[:n, 18:27] = pts.data["cov_Tw"].reshape(n, 9)
        uv_cov = obs.data["pixel2_uv_cov"]
        packed[:n, 27] = uv_cov[:, 0]
        packed[:n, 28] = uv_cov[:, 2]
        packed[:n, 29] = uv_cov[:, 2]
        packed[:n, 30] = uv_cov[:, 1]
        packed[:n, 31] = obs.data["pixel2_disp_cov"][:, 0]
        packed[n:cap, 8] = 1.0
        packed[n:cap, 31] = 1.0
        packed[:n, 32] = 1.0
        packed[cap, 0:7] = frame.data["pose"][0]
        packed[cap, 7:11] = (K[0, 0], K[1, 1], K[0, 2], K[1, 2])
        packed[cap, 11] = frame.data["baseline"][0]
        return packed

    def get_graph_data(self, global_map: VisualMap, frame_idx: int) -> GraphInput:
        return GraphInput(frame_idx=frame_idx, from_idx=frame_idx - 1,
                          packed=self._assemble(global_map, frame_idx))

    def _optimize(self, context: Any, graph_data: GraphInput) -> tuple[Any, GraphOutput]:
        packed = torch.from_numpy(graph_data.packed).to(self.device)
        pose = solve_two_frame_packed(packed, graph_type=context["graph_type"])
        return context, GraphOutput(graph_data.frame_idx, graph_data.from_idx, pose)

    def write_graph_data(self, result: Optional[GraphOutput], global_map: VisualMap) -> None:
        if result is not None:
            global_map.frames.data["pose"][result.frame_idx] = result.pose.cpu().numpy().astype(np.float32)

    @classmethod
    def is_valid_config(cls, config) -> None:
        cls._enforce_config_spec(config, {
            "graph_type": lambda s: s in {"icp", "reproj", "disp"},
            "parallel": lambda b: isinstance(b, bool),
        })


class Local_TwoFrame_PGO(TwoFrame_PGO):
    """Solve in the previous keyframe's frame; supports the device chain."""

    supports_device_chaining = True

    def start_optimize_device(self, sync_packed: torch.Tensor, anchor: torch.Tensor, cam: torch.Tensor,
                              baseline: torch.Tensor, frame_idx: int) -> None:
        if self._pending is not None:
            raise RuntimeError("start_optimize called while a job is pending")
        pose = solve_sync_packed(sync_packed, anchor, cam, baseline, self.context["graph_type"])
        self._pending = GraphOutput(frame_idx=frame_idx, from_idx=frame_idx - 1, pose=pose)

    def get_graph_data(self, global_map: VisualMap, frame_idx: int) -> GraphInput:
        gi = super().get_graph_data(global_map, frame_idx)
        anchor = global_map.frames.data["pose"][frame_idx - 1].astype(np.float64)
        T_w2o = _np_pose_inv(anchor)
        R = _np_quat_rotmat(T_w2o[3:7])
        cap, p = self.capacity, gi.packed
        p[:cap, 0:3] = (p[:cap, 0:3].astype(np.float64) @ R.T + T_w2o[:3]) * p[:cap, 32:33]
        covs = p[:cap, 18:27].reshape(cap, 3, 3).astype(np.float64)
        p[:cap, 18:27] = np.einsum("ij,njk,lk->nil", R, covs, R).reshape(cap, 9)
        p[cap, 0:7] = _np_pose_mul(T_w2o, p[cap, 0:7].astype(np.float64))
        gi.anchor = anchor
        return gi

    def _optimize(self, context: Any, graph_data: GraphInput) -> tuple[Any, GraphOutput]:
        context, out = super()._optimize(context, graph_data)
        anchor = torch.as_tensor(graph_data.anchor, dtype=out.pose.dtype, device=out.pose.device)
        out.pose = se3.normalize(se3.mul(anchor, out.pose))
        return context, out


class Empty_TwoFrame_PGO(TwoFrame_PGO):
    """No-op optimizer: the pose is the motion model's prediction, row ``cap``
    columns 0:7 of the packed problem."""

    def _optimize(self, context: Any, graph_data: GraphInput) -> tuple[Any, GraphOutput]:
        cap = graph_data.packed.shape[0] - 1
        pose = torch.as_tensor(graph_data.packed[cap, 0:7], dtype=torch.float32, device=self.device)
        return context, GraphOutput(graph_data.frame_idx, graph_data.from_idx, pose)
