"""Keypoint selectors — fixed-K masked selection (port of ``macvo_tpu/modules/keypoint.py``).

Every selector returns ``(uv (K,2) int32, valid (K,) bool)``. The selectors
with a quality rule split it into ``eligible(...) -> (H,W) bool mask`` and the
random K-subset draw (``ops.select.masked_random_topk``), so the mask can be
compared with the JAX package's exactly while the draws differ.
"""

from __future__ import annotations

import math
from types import SimpleNamespace
from typing import Optional

import torch

from ..data.frame import StereoData
from ..ops.select import border_mask, local_min_nms, masked_median, masked_random_topk
from ..utils.registry import RegisteredConfigTestable
from .frontend import DepthOutput, MatchOutput

_INT = lambda v: isinstance(v, int)
_POS_NUM = lambda v: isinstance(v, (int, float)) and v > 0
_ODD = lambda v: isinstance(v, int) and v > 0 and v % 2 == 1


def _squeeze_map(x: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """(B,H,W,C) -> (H,W) or (H,W,C) of batch 0."""
    if x is None:
        return None
    x = x[0]
    return x[..., 0] if x.shape[-1] == 1 else x


class IKeypointSelector(RegisteredConfigTestable, register=False):
    """``select_point(frame, num_point, depth0, depth1, match, generator) -> (uv, valid)``."""

    def __init__(self, config: SimpleNamespace) -> None:
        self.config = config

    def select_point(self, frame: StereoData, num_point: int, depth0_est: DepthOutput,
                     depth1_est: DepthOutput, match_est: Optional[MatchOutput],
                     generator: torch.Generator) -> tuple[torch.Tensor, torch.Tensor]:
        raise NotImplementedError


class RandomSelector(IKeypointSelector):
    """Uniform random keypoints inside the border margin."""

    def select_point(self, frame, num_point, depth0_est, depth1_est, match_est, generator):
        h, w, m = frame.height, frame.width, self.config.mask_width
        dev = frame.imageL.device
        u = torch.randint(m, w - m, (num_point,), generator=generator, device=dev)
        v = torch.randint(m, h - m, (num_point,), generator=generator, device=dev)
        return torch.stack([u, v], dim=-1).to(torch.int32), torch.ones(num_point, dtype=torch.bool, device=dev)

    @classmethod
    def is_valid_config(cls, config) -> None:
        cls._enforce_config_spec(config, {"mask_width": lambda m: _INT(m) and m >= 0})


class GridSelector(IKeypointSelector):
    """Strictly uniform grid, truncated / padded to ``num_point`` rows."""

    def select_point(self, frame, num_point, depth0_est, depth1_est, match_est, generator):
        m = self.config.mask_width
        h, w = frame.height - 2 * m, frame.width - 2 * m
        dev = frame.imageL.device
        unit = max(1, int(math.sqrt(num_point // 2)))
        vs = torch.arange(0, h, max(1, h // unit), device=dev)
        us = torch.arange(0, w, max(1, w // (unit * 2)), device=dev)
        vv, uu = torch.meshgrid(vs, us, indexing="ij")
        uv = (torch.stack([uu.reshape(-1), vv.reshape(-1)], dim=-1) + m).to(torch.int32)
        n = uv.shape[0]
        if n >= num_point:
            return uv[:num_point], torch.ones(num_point, dtype=torch.bool, device=dev)
        pad = torch.zeros((num_point - n, 2), dtype=torch.int32, device=dev)
        valid = torch.arange(num_point, device=dev) < n
        return torch.cat([uv, pad], dim=0), valid

    @classmethod
    def is_valid_config(cls, config) -> None:
        cls._enforce_config_spec(config, {"mask_width": lambda m: _INT(m) and m >= 0})


def cov_aware_nodepth_mask(flow_cov: torch.Tensor, model_mask: torch.Tensor, max_match_cov: float,
                           kernel_size: int, mask_width: int) -> torch.Tensor:
    """Eligibility of CovAwareSelector_NoDepth: local minima of the flow
    quality sigma_uu + sigma_vv - 2 sigma_uv inside the border, below
    min(max_match_cov, 1.5 x their median)."""
    flow_q = flow_cov[..., 0] + flow_cov[..., 1] - 2.0 * flow_cov[..., 2]
    nms = local_min_nms(flow_q, kernel_size)
    border = border_mask(*flow_q.shape, mask_width, device=flow_q.device)
    thresh = torch.clamp(masked_median(flow_q, nms) * 1.5, max=max_match_cov)
    return nms & border & (flow_q < thresh) & model_mask


class CovAwareSelector_NoDepth(IKeypointSelector):
    """Flow-cov-only selector of the Performant/Fast configs; grid fallback when
    the matcher gives no covariance."""

    def __init__(self, config: SimpleNamespace) -> None:
        super().__init__(config)
        self._fallback = GridSelector(SimpleNamespace(mask_width=config.mask_width))

    def eligible(self, match_est: MatchOutput) -> torch.Tensor:
        flow_cov = _squeeze_map(match_est.cov)
        model_mask = torch.ones(flow_cov.shape[:2], dtype=torch.bool, device=flow_cov.device)
        if match_est.mask is not None:
            model_mask = model_mask & _squeeze_map(match_est.mask).bool()
        return cov_aware_nodepth_mask(flow_cov, model_mask, float(self.config.max_match_cov),
                                      int(self.config.kernel_size), int(self.config.mask_width))

    def select_point(self, frame, num_point, depth0_est, depth1_est, match_est, generator):
        if match_est is None or match_est.cov is None:
            return self._fallback.select_point(frame, num_point, depth0_est, depth1_est, match_est, generator)
        return masked_random_topk(self.eligible(match_est), num_point, generator)

    @classmethod
    def is_valid_config(cls, config) -> None:
        cls._enforce_config_spec(config, {
            "mask_width": lambda m: _INT(m) and m >= 0,
            "kernel_size": _ODD,
            "max_match_cov": _POS_NUM,
        })


class MappingPointSelector(IKeypointSelector):
    """Dense-mapping points by depth / depth-cov thresholds."""

    def eligible(self, depth0_est: DepthOutput) -> torch.Tensor:
        if depth0_est.cov is None:
            raise ValueError("MappingPointSelector needs a depth covariance")
        depth, depth_cov = _squeeze_map(depth0_est.depth), _squeeze_map(depth0_est.cov)
        mask = (depth < float(self.config.max_depth)) & (depth_cov < float(self.config.max_depth_cov))
        return mask & border_mask(*depth.shape, int(self.config.mask_width), device=depth.device)

    def select_point(self, frame, num_point, depth0_est, depth1_est, match_est, generator):
        return masked_random_topk(self.eligible(depth0_est), num_point, generator)

    @classmethod
    def is_valid_config(cls, config) -> None:
        cls._enforce_config_spec(config, {
            "max_depth": lambda v: isinstance(v, (int, float)),
            "max_depth_cov": lambda v: isinstance(v, (int, float)),
            "mask_width": _INT,
        })
