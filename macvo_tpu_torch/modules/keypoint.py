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
from ..ops.select import (
    border_mask,
    laplacian_magnitude,
    local_max_nms,
    local_min_nms,
    masked_median,
    masked_random_topk,
)
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


def flow_quality(flow_cov: torch.Tensor) -> torch.Tensor:
    """sigma_uu + sigma_vv - 2 sigma_uv of an (H,W,3) flow covariance (lower = better)."""
    return flow_cov[..., 0] + flow_cov[..., 1] - 2.0 * flow_cov[..., 2]


def below_adaptive(values: torch.Tensor, nms: torch.Tensor, cap: float) -> torch.Tensor:
    """values < min(cap, 1.5 x their median over the NMS survivors)."""
    return values < torch.clamp(masked_median(values, nms) * 1.5, max=cap)


def cov_aware_nodepth_mask(flow_cov: torch.Tensor, model_mask: torch.Tensor, max_match_cov: float,
                           kernel_size: int, mask_width: int) -> torch.Tensor:
    """Eligibility of CovAwareSelector_NoDepth: local minima of the flow
    quality inside the border, below its adaptive threshold."""
    flow_q = flow_quality(flow_cov)
    nms = local_min_nms(flow_q, kernel_size)
    border = border_mask(*flow_q.shape, mask_width, device=flow_q.device)
    return nms & border & below_adaptive(flow_q, nms, max_match_cov) & model_mask


def cov_aware_mask(d0: torch.Tensor, d0_cov: torch.Tensor, d1: torch.Tensor, d1_cov: torch.Tensor,
                   flow_cov: Optional[torch.Tensor], model_mask: torch.Tensor, max_depth: float,
                   max_depth_cov: float, max_match_cov: float, kernel_size: int,
                   mask_width: int) -> torch.Tensor:
    """Eligibility of CovAwareSelector: local minima of the quality
    (sigma_d0 + sigma_d1) x flow quality inside the border, both depths below
    ``max_depth``, sigma_d0 and the flow quality below their adaptive
    thresholds."""
    quality = d0_cov + d1_cov
    if flow_cov is not None:
        flow_q = flow_quality(flow_cov)
        quality = quality * flow_q
    nms = local_min_nms(quality, kernel_size)
    mask = nms & border_mask(*quality.shape, mask_width, device=quality.device)
    mask = mask & (d0 < max_depth) & (d1 < max_depth) & below_adaptive(d0_cov, nms, max_depth_cov)
    if flow_cov is not None:
        mask = mask & below_adaptive(flow_q, nms, max_match_cov)
    return mask & model_mask


def gradient_mask(image: torch.Tensor, grad_std: float, mask_width: int, nms_size: int = 0) -> torch.Tensor:
    """Eligibility of the gradient selectors: |Laplacian| of the (H,W,3)
    image above mean + grad_std x std (population), inside the border, and,
    with ``nms_size``, a local maximum."""
    grad = laplacian_magnitude(image)
    mask = grad > (grad.mean() + grad_std * grad.std(correction=0))
    mask = mask & border_mask(*grad.shape, mask_width, device=grad.device)
    if nms_size > 0:
        mask = mask & local_max_nms(grad, nms_size)
    return mask


class GradientSelector(IKeypointSelector):
    """Random points with Laplacian magnitude above mean + grad_std x std."""

    def eligible(self, frame: StereoData) -> torch.Tensor:
        return gradient_mask(frame.imageL[0], float(self.config.grad_std), int(self.config.mask_width))

    def select_point(self, frame, num_point, depth0_est, depth1_est, match_est, generator):
        return masked_random_topk(self.eligible(frame), num_point, generator)

    @classmethod
    def is_valid_config(cls, config) -> None:
        cls._enforce_config_spec(config, {"mask_width": lambda m: _INT(m) and m >= 0, "grad_std": _POS_NUM})


class SparseGradientSelector(GradientSelector):
    """The gradient selector thinned by a local-maximum NMS of ``nms_size``.
    Also registered under the reference's name ``SparseGradienSelector``."""

    def eligible(self, frame: StereoData) -> torch.Tensor:
        return gradient_mask(frame.imageL[0], float(self.config.grad_std), int(self.config.mask_width),
                             int(self.config.nms_size))

    @classmethod
    def is_valid_config(cls, config) -> None:
        cls._enforce_config_spec(config, {
            "mask_width": lambda m: _INT(m) and m >= 0,
            "grad_std": _POS_NUM,
            "nms_size": _ODD,
        })


class SparseGradienSelector(SparseGradientSelector):
    """Alias of SparseGradientSelector under the reference's registry name."""


class CovAwareSelector(IKeypointSelector):
    """MAC-VO's selector (paper III.B): the eligibility of :func:`cov_aware_mask`
    with ``max_depth: auto`` = fx x baseline, then a random K-subset."""

    def eligible(self, frame: StereoData, depth0_est: DepthOutput, depth1_est: DepthOutput,
                 match_est: Optional[MatchOutput]) -> torch.Tensor:
        if depth0_est.cov is None or depth1_est.cov is None:
            raise ValueError("CovAwareSelector needs depth covariances of both frames")
        max_depth = self.config.max_depth
        if max_depth == "auto":
            max_depth = frame.fx * frame.frame_baseline
        d0 = _squeeze_map(depth0_est.depth)
        flow_cov = _squeeze_map(match_est.cov) if match_est is not None else None
        model_mask = torch.ones(d0.shape, dtype=torch.bool, device=d0.device)
        if depth0_est.mask is not None:
            model_mask = model_mask & _squeeze_map(depth0_est.mask).bool()
        if match_est is not None and match_est.mask is not None:
            model_mask = model_mask & _squeeze_map(match_est.mask).bool()
        return cov_aware_mask(d0, _squeeze_map(depth0_est.cov), _squeeze_map(depth1_est.depth),
                              _squeeze_map(depth1_est.cov), flow_cov, model_mask, float(max_depth),
                              float(self.config.max_depth_cov), float(self.config.max_match_cov),
                              int(self.config.kernel_size), int(self.config.mask_width))

    def select_point(self, frame, num_point, depth0_est, depth1_est, match_est, generator):
        return masked_random_topk(self.eligible(frame, depth0_est, depth1_est, match_est), num_point, generator)

    @classmethod
    def is_valid_config(cls, config) -> None:
        cls._enforce_config_spec(config, {
            "mask_width": lambda m: _INT(m) and m >= 0,
            "max_depth": lambda d: (d == "auto") or _POS_NUM(d),
            "kernel_size": _ODD,
            "max_depth_cov": _POS_NUM,
            "max_match_cov": _POS_NUM,
        })


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


class SelectorCompose(IKeypointSelector):
    """Split the keypoint budget over child selectors by weight. Child i
    draws from its own generator, seeded on first use from the parent
    generator's seed and i, so each child keeps one stream across frames."""

    def __init__(self, config: SimpleNamespace) -> None:
        super().__init__(config)
        self.selectors = [IKeypointSelector.instantiate(a.type, a.args) for a in config.selector_args]
        total = sum(config.weight)
        self.weights = [wgt / total for wgt in config.weight]
        self._generators: Optional[list[torch.Generator]] = None

    def _children(self, generator: torch.Generator) -> list[torch.Generator]:
        if self._generators is None:
            seed = generator.initial_seed()
            self._generators = [torch.Generator(device=generator.device).manual_seed(seed + 1 + i)
                                for i in range(len(self.selectors))]
        return self._generators

    def select_point(self, frame, num_point, depth0_est, depth1_est, match_est, generator):
        picks = [sel.select_point(frame, int(num_point * wgt), depth0_est, depth1_est, match_est, gen)
                 for sel, wgt, gen in zip(self.selectors, self.weights, self._children(generator))]
        return torch.cat([uv for uv, _ in picks], dim=0), torch.cat([valid for _, valid in picks], dim=0)

    @classmethod
    def is_valid_config(cls, config) -> None:
        for arg in config.selector_args:
            IKeypointSelector.is_valid_config(arg)
        if not isinstance(config.weight, list) or not all(isinstance(v, (int, float)) for v in config.weight):
            raise ValueError(f"SelectorCompose: weight must be a list of numbers, got {config.weight!r}")
