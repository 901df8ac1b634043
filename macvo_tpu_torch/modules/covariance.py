"""ICovariance2to3 module family (port of ``macvo_tpu/modules/covariance.py``).

``estimate(frame, kp (N,2), depth_est, depth_cov (N,)|None, flow_cov (N,3)|None)
-> (N,3,3)`` camera-frame covariance per keypoint.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Optional

import torch

from ..data.frame import StereoData
from ..ops.cov_project import match_covariance
from ..utils.registry import RegisteredConfigTestable
from .frontend import DepthOutput

_POS_NUM = lambda v: isinstance(v, (int, float)) and v > 0
_ODD = lambda v: isinstance(v, int) and v > 0 and v % 2 == 1


class ICovariance2to3(RegisteredConfigTestable, register=False):
    def __init__(self, config: SimpleNamespace) -> None:
        self.config = config

    def estimate(self, frame: StereoData, kp: torch.Tensor, depth_est: DepthOutput,
                 depth_cov: Optional[torch.Tensor], flow_cov: Optional[torch.Tensor]) -> torch.Tensor:
        raise NotImplementedError


class MatchCovariance(ICovariance2to3):
    """MAC-VO covariance model (paper III.C)."""

    def estimate(self, frame, kp, depth_est, depth_cov, flow_cov) -> torch.Tensor:
        depth_map = depth_est.depth[0, ..., 0]
        n = kp.shape[0]
        zeros = torch.zeros((n,), dtype=depth_map.dtype, device=depth_map.device)
        return match_covariance(
            depth_map, kp.to(depth_map.dtype),
            depth_cov if depth_cov is not None else zeros,
            flow_cov if flow_cov is not None else zeros[:, None].expand(n, 3),
            frame.fx, frame.fy, frame.cx, frame.cy,
            int(self.config.kernel_size), float(self.config.match_cov_default),
            float(self.config.min_flow_cov), float(self.config.min_depth_cov),
            flow_cov is not None, depth_cov is not None,
        )

    @classmethod
    def is_valid_config(cls, config) -> None:
        cls._enforce_config_spec(config, {
            "kernel_size": _ODD,
            "match_cov_default": _POS_NUM,
            "min_flow_cov": _POS_NUM,
            "min_depth_cov": _POS_NUM,
        })
