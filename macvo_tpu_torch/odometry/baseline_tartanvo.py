"""TartanVO baseline odometry (port of ``macvo_tpu/odometry/baseline_tartanvo.py``).

Pure learned odometry, no backend optimization: per keyframe, optical flow
(t-1 -> t) and stereo depth feed the TartanVO pose network, whose se3 output
is chained onto the previous pose. Non-keyframes copy the previous pose with
``need_interp`` set. The networks run on ``device`` (``cuda`` unless the
caller asks for the CPU); frames arrive on that device.
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch

from ..modules.frontend import IMatcher, IStereoDepth
from ..modules.frontend_tartanvo import TartanMotionNet
from ..modules.keyframe import IKeyframeSelector
from ..utils.device import resolve_device
from ..utils.registry import ConfigTestable
from ..worldmap import VisualMap
from .interface import IOdometry


class TartanVO(IOdometry, ConfigTestable):
    def __init__(self, match_estimator: IMatcher, depth_estimator: IStereoDepth, kf_selector: IKeyframeSelector,
                 tvo_cfg: SimpleNamespace, device: str | torch.device = "cuda") -> None:
        super().__init__()
        self.graph = VisualMap()
        self.tartanvo = TartanMotionNet(tvo_cfg, device=device)
        self.match_estimator = match_estimator
        self.depth_estimator = depth_estimator
        self.keyframe_select = kf_selector
        self.prev_frame = None

    @classmethod
    def from_config(cls, cfg: SimpleNamespace, device: str | torch.device = "cuda") -> "TartanVO":
        device = resolve_device(device)
        o = cfg.Odometry
        return cls(
            match_estimator=IMatcher.instantiate(o.match.type, o.match.args, device=device),
            depth_estimator=IStereoDepth.instantiate(o.depth.type, o.depth.args, device=device),
            kf_selector=IKeyframeSelector.instantiate(o.keyframe.type, o.keyframe.args),
            tvo_cfg=o.tartanvo.args,
            device=device,
        )

    def _push(self, frame, pose: np.ndarray, need_interp: bool) -> None:
        self.graph.frames.push({
            "K": np.asarray(frame.stereo.K, dtype=np.float32).reshape(1, 3, 3),
            "baseline": np.asarray(frame.stereo.baseline, np.float32).reshape(1)[:1],
            "need_interp": np.array([need_interp]),
            "time_ns": np.asarray(frame.stereo.time_ns).reshape(1)[:1].astype(np.int64),
            "pose": np.asarray(pose, dtype=np.float32).reshape(1, 7),
            "T_BS": np.asarray(frame.stereo.T_BS, np.float32).reshape(1, 7),
        })

    def run(self, frame) -> None:
        if not self.keyframe_select.is_keyframe(frame):
            self._push(frame, self.graph.frames.data["pose"][len(self.graph.frames) - 1], need_interp=True)
            return
        flow_map = None
        if self.prev_frame is not None:
            flow_map = self.match_estimator.estimate(self.prev_frame.stereo, frame.stereo).flow
        est_depth = self.depth_estimator.estimate(frame.stereo)
        est_pose = self.tartanvo.predict(frame, flow_map, est_depth.depth).numpy()
        self._push(frame, est_pose, need_interp=False)
        self.tartanvo.update(est_pose)
        self.prev_frame = frame

    def get_map(self) -> VisualMap:
        return self.graph

    @classmethod
    def is_valid_config(cls, config: SimpleNamespace) -> None:
        assert config is not None
        IMatcher.is_valid_config(config.match)
        IStereoDepth.is_valid_config(config.depth)
        IKeyframeSelector.is_valid_config(config.keyframe)
        TartanMotionNet.is_valid_config(config.tartanvo.args)
