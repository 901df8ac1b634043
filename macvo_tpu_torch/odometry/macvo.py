"""MAC-VO orchestrator (port of ``macvo_tpu/odometry/macvo.py``).

Per keyframe: frontend (joint depth + flow + cov) -> consume the previous
frame's sync -> motion prediction -> fixed-K masked keypoint selection ->
per-keypoint gathers -> 2D->3D covariance -> outlier masks -> one packed
(K+1, 52) array (``odometry/layout.py``) -> backend solve.

Every per-keypoint stage keeps ``(K,)`` tensors plus a validity mask, so the
device never waits for the host inside a frame. Each frame makes exactly one
device->host transfer of that packed array: a non-blocking copy into pinned
memory, consumed one frame later (after the next frame's frontend has been
launched) for the host map. With a frontend that gives covariances the
backend solve reads the packed array on the device (device chain) and its
pose feeds the next frame as a device tensor; otherwise (the GT oracle
frontend) the solve is assembled from the host map when the sync is consumed.
"""

from __future__ import annotations

import inspect
from collections import deque
from types import SimpleNamespace
from typing import Optional

import numpy as np
import torch

from ..backend.interface import IOptimizer
from ..data.frame import StereoData, StereoFrame
from ..geometry import camera, se3
from ..modules.covariance import ICovariance2to3
from ..modules.frontend import DepthOutput, IFrontend, retrieve_pixels
from ..modules.keyframe import IKeyframeSelector
from ..modules.keypoint import IKeypointSelector
from ..modules.map_processor import IMapProcessor
from ..modules.motion import IMotionModel
from ..modules.outlier import IObservationFilter
from ..utils.device import resolve_device
from ..utils.logging import Logger
from ..utils.registry import ConfigTestable
from ..worldmap import VisualMap
from .interface import IOdometry
from .layout import COL_COLOR, COL_COV, COL_KEEP, COL_POS, MIN_NUM_POINT, OBS_LAYOUT, PACKED_SYNC_WIDTH


class HostFetch:
    """A device tensor on its way to the host: a non-blocking copy into pinned
    memory plus an event (a plain reference on the CPU)."""

    def __init__(self, x: torch.Tensor) -> None:
        if x.device.type == "cuda":
            self._host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
            self._host.copy_(x, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._host, self._event = x, None

    def result(self) -> np.ndarray:
        if self._event is not None:
            self._event.synchronize()
        return self._host.numpy()


class MACVO(IOdometry[StereoFrame], ConfigTestable):
    def __init__(self, num_point: int, edgewidth: int, match_cov_default: float, profile: bool,
                 mapping: bool, frontend: IFrontend, motion_model: IMotionModel,
                 kp_selector: IKeypointSelector, map_selector: IKeypointSelector,
                 obs_filter: IObservationFilter, obs_covmodel: ICovariance2to3,
                 post_process: IMapProcessor, kf_selector: IKeyframeSelector, optimizer: IOptimizer,
                 num_map_point: int = 2000, device: str | torch.device = "cuda",
                 **_excessive_args) -> None:
        super().__init__(profile=profile)
        if _excessive_args:
            Logger.warning(f"MACVO: ignoring excessive config args {sorted(_excessive_args)}")
        self.device = resolve_device(device)
        self.graph = VisualMap()
        self.mapping = mapping
        self.match_cov_default = match_cov_default
        self.num_point = num_point
        self.num_map_point = num_map_point
        self.edge_width = edgewidth

        self.Frontend = frontend
        self.MotionEstimator = motion_model
        self.KeypointSelector = kp_selector
        self.MappointSelector = map_selector
        self.OutlierFilter = obs_filter
        self.ObsCovModel = obs_covmodel
        self.MapRefiner = post_process
        self.KeyframeSelector = kf_selector
        self.Optimizer = optimizer

        self.is_initiated = False
        self.prev_keyframe: Optional[tuple[StereoFrame, int, DepthOutput]] = None
        self.generator = torch.Generator(device=self.device).manual_seed(0)
        self._sync_queue: deque[dict] = deque()
        self._device_chain = bool(getattr(optimizer, "supports_device_chaining", False)
                                  and all(frontend.provide_cov))
        self._calib: Optional[tuple] = None          # (key, cam (4,), baseline ()) device tensors

    # -- config ---------------------------------------------------------------
    @classmethod
    def from_config(cls, cfg: SimpleNamespace, device: str | torch.device = "cuda") -> "MACVO":
        device = resolve_device(device)
        o = cfg.Odometry
        # A learned motion model (TartanMotionNet) runs on the odometry's device;
        # StaticMotionModel takes no device.
        motion_cls = IMotionModel.get_class(o.motion.type)
        motion_kw = {"device": device} if "device" in inspect.signature(motion_cls).parameters else {}
        return cls(
            frontend=IFrontend.instantiate(o.frontend.type, o.frontend.args, device=device),
            motion_model=IMotionModel.instantiate(o.motion.type, o.motion.args, **motion_kw),
            kp_selector=IKeypointSelector.instantiate(o.keypoint.type, o.keypoint.args),
            map_selector=IKeypointSelector.instantiate(o.mappoint.type, o.mappoint.args),
            obs_filter=IObservationFilter.instantiate(o.outlier.type, o.outlier.args),
            obs_covmodel=ICovariance2to3.instantiate(o.cov.obs.type, o.cov.obs.args),
            post_process=IMapProcessor.instantiate(o.postprocess.type, o.postprocess.args),
            kf_selector=IKeyframeSelector.instantiate(o.keyframe.type, o.keyframe.args),
            optimizer=IOptimizer.instantiate(o.optimizer.type, o.optimizer.args, device=device),
            device=device,
            **vars(o.args),
        )

    @classmethod
    def is_valid_config(cls, config: SimpleNamespace) -> None:
        IKeyframeSelector.is_valid_config(config.keyframe)
        IMapProcessor.is_valid_config(config.postprocess)
        IObservationFilter.is_valid_config(config.outlier)
        IMotionModel.is_valid_config(config.motion)
        IKeypointSelector.is_valid_config(config.keypoint)
        IKeypointSelector.is_valid_config(config.mappoint)
        ICovariance2to3.is_valid_config(config.cov.obs)
        IFrontend.is_valid_config(config.frontend)
        IOptimizer.is_valid_config(config.optimizer)
        cls._enforce_config_spec(config.args, {
            "num_point": lambda b: isinstance(b, int) and b > 0,
            "edgewidth": lambda b: isinstance(b, int) and b > 0,
            "match_cov_default": lambda b: isinstance(b, (int, float)) and b > 0.0,
            "profile": lambda b: isinstance(b, bool),
            "mapping": lambda b: isinstance(b, bool),
        })

    # -- pipeline -------------------------------------------------------------
    def initialize(self, frame0: StereoFrame) -> None:
        depth0 = self.Frontend.estimate_depth(frame0.stereo)
        est_pose = self.MotionEstimator.predict(frame0, None, depth0.depth)
        frame_idx = self.push_keyframe(frame0, est_pose.detach().cpu().numpy())
        self.OutlierFilter.set_meta(frame0.stereo)
        self.prev_keyframe = (frame0, frame_idx, depth0)

    def push_keyframe(self, frame: StereoFrame, est_pose: np.ndarray, need_interp: bool = False) -> int:
        idx = self.graph.frames.push({
            "pose": np.asarray(est_pose, dtype=np.float32).reshape(1, 7),
            "T_BS": np.asarray(frame.stereo.T_BS, dtype=np.float32).reshape(1, 7),
            "need_interp": np.array([need_interp]),
            "time_ns": np.asarray(frame.stereo.time_ns).reshape(1)[:1].astype(np.int64),
            "K": np.asarray(frame.stereo.K, dtype=np.float32).reshape(1, 3, 3),
            "baseline": np.asarray(frame.stereo.baseline, dtype=np.float32).reshape(1)[:1],
        })
        return int(idx[0])

    @torch.inference_mode()
    def run(self, frame: StereoFrame) -> None:
        if not self.is_initiated:
            self.initialize(frame)
            self.is_initiated = True
            return
        self.run_pair(self.prev_keyframe[0], frame)

    def _sigma_uv_default(self, n: int) -> torch.Tensor:
        sigma = torch.full((n, 3), self.match_cov_default, dtype=torch.float32, device=self.device)
        sigma[:, 2] = 0.0
        return sigma

    def keypoint_pipeline(self, stereo0: StereoData, stereo1: StereoData, depth0: DepthOutput,
                          depth1: DepthOutput, match01, prev_pose: torch.Tensor,
                          est_pose: torch.Tensor) -> torch.Tensor:
        """Selection -> gathers -> covariances -> outlier masks -> world
        registration, packed into one (K+1, 52) float32 tensor (see layout.py)."""
        kp0_uv, valid = self.KeypointSelector.select_point(
            stereo0, self.num_point, depth0, depth1, match01, self.generator)
        kp0_f = kp0_uv.float()
        kp1_f = kp0_f + retrieve_pixels(kp0_uv, match01.flow)
        valid = valid & camera.in_bounds(kp1_f, stereo1.width, stereo1.height, margin=self.edge_width)

        kp0_d = retrieve_pixels(kp0_uv, depth0.depth)[:, 0]
        kp1_d = retrieve_pixels(kp1_f, depth1.depth)[:, 0]
        kp0_sigma_dd = retrieve_pixels(kp0_uv, depth0.cov)
        kp1_sigma_dd = retrieve_pixels(kp1_f, depth1.cov)
        n = kp0_uv.shape[0]
        # kp0 was selected, not matched: its uv uncertainty is the quantization default.
        kp0_sigma_uv = self._sigma_uv_default(n)
        kp1_sigma_uv = retrieve_pixels(kp0_uv, match01.cov)
        kp0_color = (retrieve_pixels(kp0_uv, stereo0.imageL) * 255.0).to(torch.uint8)

        K0 = torch.as_tensor(stereo0.K[0], dtype=torch.float32, device=self.device)
        pos0_Tc = camera.pixel_to_point_ned(kp0_f, kp0_d, K0)
        pos0_covTc = self.ObsCovModel.estimate(
            stereo0, kp0_f, depth0, None if kp0_sigma_dd is None else kp0_sigma_dd[:, 0], kp0_sigma_uv)
        pos1_covTc = self.ObsCovModel.estimate(
            stereo1, kp1_f, depth1, None if kp1_sigma_dd is None else kp1_sigma_dd[:, 0], kp1_sigma_uv)

        def or_fill(x, width: int):
            return x if x is not None else torch.full((n, width), -1.0, device=self.device)

        obs = {
            "pixel1_uv": kp0_f, "pixel2_uv": kp1_f,
            "pixel1_d": kp0_d[:, None], "pixel2_d": kp1_d[:, None],
            "pixel1_disp": or_fill(retrieve_pixels(kp0_uv, depth0.disparity), 1),
            "pixel2_disp": or_fill(retrieve_pixels(kp1_f, depth1.disparity), 1),
            "pixel1_disp_cov": or_fill(retrieve_pixels(kp0_uv, depth0.disparity_uncertainty), 1),
            "pixel2_disp_cov": or_fill(retrieve_pixels(kp1_f, depth1.disparity_uncertainty), 1),
            "pixel1_uv_cov": kp0_sigma_uv, "pixel2_uv_cov": or_fill(kp1_sigma_uv, 3),
            "pixel1_d_cov": or_fill(kp0_sigma_dd, 1), "pixel2_d_cov": or_fill(kp1_sigma_dd, 1),
            "obs1_covTc": pos0_covTc, "obs2_covTc": pos1_covTc,
        }
        if not self.OutlierFilter.verify_shape(obs):
            raise KeyError(f"outlier filter needs {sorted(self.OutlierFilter.required_keys)}")
        keep = valid & self.OutlierFilter.filter(obs)

        prev_pose = prev_pose.to(pos0_covTc.dtype)
        prev_rot = se3.rotmat(prev_pose)
        pos0_Tw = se3.act(prev_pose, pos0_Tc)
        cov0_Tw = prev_rot @ pos0_covTc @ prev_rot.T
        cols = [obs[name].reshape(n, -1).float() for name, _ in OBS_LAYOUT]
        cols += [keep[:, None].float(), pos0_Tw.float(), cov0_Tw.reshape(n, 9).float(), kp0_color.float()]
        aux = torch.zeros((1, PACKED_SYNC_WIDTH), dtype=torch.float32, device=self.device)
        aux[0, 0:7] = est_pose.float()
        aux[0, 7:14] = prev_pose.float()
        return torch.cat([torch.cat(cols, dim=-1), aux], dim=0)

    def mapping_pipeline(self, stereo0: StereoData, depth0: DepthOutput, depth1: DepthOutput, match01,
                         prev_pose: torch.Tensor) -> torch.Tensor:
        """Dense-mapping points, packed (M,16): valid | pos_Tw 3 | cov_Tw 9 | color 3."""
        map_uv, map_valid = self.MappointSelector.select_point(
            stereo0, self.num_map_point, depth0, depth1, match01, self.generator)
        map_f = map_uv.float()
        map_d = retrieve_pixels(map_uv, depth0.depth)[:, 0]
        K0 = torch.as_tensor(stereo0.K[0], dtype=torch.float32, device=self.device)
        map_Tc = camera.pixel_to_point_ned(map_f, map_d, K0)
        map_sigma_dd = retrieve_pixels(map_uv, depth0.cov)
        n = map_uv.shape[0]
        map_cov_Tc = self.ObsCovModel.estimate(
            stereo0, map_f, depth0, None if map_sigma_dd is None else map_sigma_dd[:, 0],
            self._sigma_uv_default(n))
        map_color = retrieve_pixels(map_uv, stereo0.imageL) * 255.0
        map_Tw = se3.act(prev_pose.to(map_Tc.dtype), map_Tc)
        return torch.cat([map_valid[:, None].float(), map_Tw.float(), map_cov_Tc.reshape(n, 9).float(),
                          map_color.float()], dim=-1)

    @staticmethod
    def unpack_sync(packed: np.ndarray):
        """Host-side inverse of the keypoint pipeline's packing."""
        n = packed.shape[0] - 1
        obs, offset = {}, 0
        for name, width in OBS_LAYOUT:
            col = packed[:n, offset:offset + width]
            obs[name] = col.reshape(n, 3, 3).astype(np.float64) if name.endswith("covTc") else col
            offset += width
        keep = packed[:n, COL_KEEP] > 0.5
        pos0_Tw = packed[:n, COL_POS[0]:COL_POS[1]]
        cov0_Tw = packed[:n, COL_COV[0]:COL_COV[1]].reshape(n, 3, 3).astype(np.float64)
        color = packed[:n, COL_COLOR[0]:COL_COLOR[1]].astype(np.uint8)
        return obs, keep, pos0_Tw, cov0_Tw, color, packed[n, 0:7].copy(), packed[n, 7:14].copy()

    def _consume_pending_sync(self) -> None:
        while self._sync_queue:
            self._register_sync(self._sync_queue.popleft())

    def _register_sync(self, ctx: dict) -> None:
        """Register one frame's fetched sync into the host factor graph."""
        obs_np, keep, pos0_Tw, cov0_Tw, color, est_pose, prev_pose = self.unpack_sync(ctx["fetch"].result())
        prev_idx, frame_idx = ctx["prev_idx"], ctx["frame_idx"]
        self.graph.frames.data["pose"][frame_idx] = est_pose
        if ctx["backfill_idx"] is not None:
            self.graph.frames.data["pose"][ctx["backfill_idx"]] = prev_pose

        obs_np = {k: v[keep] for k, v in obs_np.items()}
        n_obs = int(keep.sum())
        point_idx = self.graph.points.push({"pos_Tw": pos0_Tw[keep], "cov_Tw": cov0_Tw[keep],
                                            "color": color[keep]})
        num_match_orig = len(self.graph.match)
        match_idx = self.graph.match.push(obs_np)
        self.graph.point2match.add(point_idx, match_idx)
        self.graph.match2point.set(match_idx, point_idx)
        self.graph.frame2match.add(np.array([prev_idx]), np.array([num_match_orig]), np.array([n_obs]))
        self.graph.frame2match.add(np.array([frame_idx]), np.array([num_match_orig]), np.array([n_obs]))
        self.graph.match2frame1.set(match_idx, np.full((n_obs,), prev_idx, dtype=np.int64))
        self.graph.match2frame2.set(match_idx, np.full((n_obs,), frame_idx, dtype=np.int64))

        if ctx["mapping"] is not None:
            packed = ctx["mapping"].result()
            valid = packed[:, 0] > 0.5
            num_map_orig = len(self.graph.map_points)
            self.graph.map_points.push({"pos_Tw": packed[valid, 1:4],
                                        "cov_Tw": packed[valid, 4:13].reshape(-1, 3, 3).astype(np.float64),
                                        "color": packed[valid, 13:16].astype(np.uint8)})
            self.graph.frame2map.add(np.array([frame_idx]), np.array([num_map_orig]),
                                     np.array([int(valid.sum())]))

        if n_obs < MIN_NUM_POINT:
            Logger.warning(f"VOLostTrack @ {ctx['seq_idx']} - only {n_obs} observations")
            self.graph.frames.data["need_interp"][frame_idx] = True
            return
        if not self._device_chain:
            self.Optimizer.start_optimize(self.Optimizer.get_graph_data(self.graph, frame_idx))

    def _calibration(self, stereo: StereoData) -> tuple[torch.Tensor, torch.Tensor]:
        K0 = np.asarray(stereo.K[0], np.float32)
        key = (K0.tobytes(), float(stereo.baseline[0]))
        if self._calib is None or self._calib[0] != key:
            cam = torch.tensor([K0[0, 0], K0[1, 1], K0[0, 2], K0[1, 2]], device=self.device)
            self._calib = (key, cam, torch.tensor(float(stereo.baseline[0]), device=self.device))
        return self._calib[1], self._calib[2]

    def run_pair(self, frame0: StereoFrame, frame1: StereoFrame) -> None:
        _, prev_idx, depth0 = self.prev_keyframe
        if not self.KeyframeSelector.is_keyframe(frame1):
            self._consume_pending_sync()
            self.push_keyframe(frame1, self.graph.frames.data["pose"][prev_idx], need_interp=True)
            return

        # 1. Launch this pair's frontend first: the card works on it while the
        #    host registers the previous frame's sync.
        depth1, match01 = self.Frontend.estimate_pair(frame0.stereo, frame1.stereo)
        # 2. Previous frame's sync (host path: this also launches its solve).
        self._consume_pending_sync()
        # 3. The anchor's optimized pose stays a device tensor.
        pending = self.Optimizer.take_pending()
        if pending is not None:
            prev_pose = pending.pose.float()
            backfill_idx = prev_idx
        else:
            prev_pose = torch.as_tensor(self.graph.frames.data["pose"][prev_idx], device=self.device)
            backfill_idx = None
        self.MotionEstimator.update(prev_pose)
        est_pose = self.MotionEstimator.predict(frame1, match01.flow, depth1.depth).float().reshape(7)

        packed = self.keypoint_pipeline(frame0.stereo, frame1.stereo, depth0, depth1, match01,
                                        prev_pose, est_pose)
        fetch = HostFetch(packed)
        mapping = None
        if self.mapping:
            mapping = HostFetch(self.mapping_pipeline(frame0.stereo, depth0, depth1, match01, prev_pose))
        frame_idx = self.push_keyframe(frame1, self.graph.frames.data["pose"][prev_idx])
        if self._device_chain:
            cam, baseline = self._calibration(frame1.stereo)
            self.Optimizer.start_optimize_device(packed, prev_pose, cam, baseline, frame_idx)
        self._sync_queue.append({"fetch": fetch, "mapping": mapping, "prev_idx": prev_idx,
                                 "frame_idx": frame_idx, "backfill_idx": backfill_idx,
                                 "seq_idx": frame1.frame_idx})
        self.prev_keyframe = (frame1, frame_idx, depth1)

    # -- lifecycle ------------------------------------------------------------
    def get_map(self) -> VisualMap:
        return self.graph

    def terminate(self) -> None:
        super().terminate()
        self._consume_pending_sync()
        if self.prev_keyframe is not None:
            self.Optimizer.write_map(self.graph)
        self.Optimizer.terminate()
        self.MapRefiner.elaborate_map(self.graph.frames)
