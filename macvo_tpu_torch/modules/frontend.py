"""Frontend interfaces: stereo depth, dense matching, the joint frontend
(port of ``macvo_tpu/modules/frontend.py``).

Channel-last layout as in the JAX package: depth maps ``(B,H,W,1)``, flow
``(B,H,W,2)``, flow covariance ``(B,H,W,3)`` with channels
``(sigma_uu, sigma_vv, sigma_uv)``, masks bool ``(B,H,W,1)``.
"""

from __future__ import annotations

import dataclasses
from types import SimpleNamespace
from typing import Optional

import torch

from ..data.frame import StereoData
from ..utils.registry import RegisteredConfigTestable


@dataclasses.dataclass
class DepthOutput:
    depth: torch.Tensor                                    # (B,H,W,1) float32
    disparity: Optional[torch.Tensor] = None               # (B,H,W,1)
    cov: Optional[torch.Tensor] = None                     # (B,H,W,1) depth variance
    mask: Optional[torch.Tensor] = None                    # (B,H,W,1) bool
    disparity_uncertainty: Optional[torch.Tensor] = None   # (B,H,W,1)


@dataclasses.dataclass
class MatchOutput:
    flow: torch.Tensor                      # (B,H,W,2) float32
    cov: Optional[torch.Tensor] = None      # (B,H,W,3) (sigma_uu, sigma_vv, sigma_uv)
    mask: Optional[torch.Tensor] = None     # (B,H,W,1) bool

    @classmethod
    def from_partial_cov(cls, flow: torch.Tensor, cov: torch.Tensor,
                         mask: Optional[torch.Tensor] = None) -> "MatchOutput":
        """Zero-fill the off-diagonal sigma_uv channel of a (B,H,W,2) diag cov."""
        zeros = torch.zeros(cov.shape[:-1] + (1,), dtype=cov.dtype, device=cov.device)
        return cls(flow=flow, cov=torch.cat([cov, zeros], dim=-1), mask=mask)


def retrieve_pixels(pixel_uv: torch.Tensor, scalar_map: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """Nearest gather of per-keypoint values from batch 0 of a dense map:
    pixel_uv (N,2) (u,v) -> (N,C). uv truncate toward zero and clamp."""
    if scalar_map is None:
        return None
    h, w = scalar_map.shape[1], scalar_map.shape[2]
    u = pixel_uv[..., 0].to(torch.int64).clamp(0, w - 1)
    v = pixel_uv[..., 1].to(torch.int64).clamp(0, h - 1)
    return scalar_map[0, v, u]


class IStereoDepth(RegisteredConfigTestable, register=False):
    """``estimate(frame: StereoData) -> DepthOutput``. Frames arrive on the
    module's device; ``device`` places any model."""

    def __init__(self, config: SimpleNamespace, device="cuda") -> None:
        self.config = config

    @property
    def provide_cov(self) -> bool:
        raise NotImplementedError

    def estimate(self, frame: StereoData) -> DepthOutput:
        raise NotImplementedError


class IMatcher(RegisteredConfigTestable, register=False):
    """``estimate(frame_t1, frame_t2) -> MatchOutput`` (left-image flow t1->t2).
    Frames arrive on the module's device; ``device`` places any model."""

    def __init__(self, config: SimpleNamespace, device="cuda") -> None:
        self.config = config

    @property
    def provide_cov(self) -> bool:
        raise NotImplementedError

    def estimate(self, frame_t1: StereoData, frame_t2: StereoData) -> MatchOutput:
        raise NotImplementedError


class GTDepth(IStereoDepth):
    """Ground-truth depth oracle."""

    @property
    def provide_cov(self) -> bool:
        return False

    def estimate(self, frame: StereoData) -> DepthOutput:
        if frame.gt_depth is None:
            raise ValueError("GTDepth requires frames with gt_depth")
        return DepthOutput(depth=frame.gt_depth)

    @classmethod
    def is_valid_config(cls, config) -> None:
        return


class GTMatcher(IMatcher):
    """Ground-truth optical-flow oracle."""

    @property
    def provide_cov(self) -> bool:
        return False

    def estimate(self, frame_t1: StereoData, frame_t2: StereoData) -> MatchOutput:
        if frame_t1.gt_flow is None:
            raise ValueError("GTMatcher requires frames with gt_flow")
        return MatchOutput(flow=frame_t1.gt_flow, mask=frame_t1.flow_mask)

    @classmethod
    def is_valid_config(cls, config) -> None:
        return


class ApplyGTDepthCov(IStereoDepth):
    """Modifier: wrap the depth module ``config.module``; its covariance becomes
    the squared error against the ground-truth depth."""

    def __init__(self, config: SimpleNamespace, device="cuda") -> None:
        super().__init__(config, device)
        self.internal = IStereoDepth.instantiate(config.module.type, config.module.args, device=device)

    @property
    def provide_cov(self) -> bool:
        return True

    def estimate(self, frame: StereoData) -> DepthOutput:
        if frame.gt_depth is None:
            raise ValueError("ApplyGTDepthCov requires frames with gt_depth")
        out = self.internal.estimate(frame)
        out.cov = torch.square(frame.gt_depth - out.depth)
        return out

    @classmethod
    def is_valid_config(cls, config) -> None:
        if config is None:
            raise ValueError(f"{cls.__name__}: config is None")
        IStereoDepth.is_valid_config(config.module)


class ApplyGTMatchCov(IMatcher):
    """Modifier: wrap the matcher ``config.module``; its diagonal covariance
    becomes the squared flow error against the ground truth."""

    def __init__(self, config: SimpleNamespace, device="cuda") -> None:
        super().__init__(config, device)
        self.internal = IMatcher.instantiate(config.module.type, config.module.args, device=device)

    @property
    def provide_cov(self) -> bool:
        return True

    def estimate(self, frame_t1: StereoData, frame_t2: StereoData) -> MatchOutput:
        if frame_t1.gt_flow is None:
            raise ValueError("ApplyGTMatchCov requires frames with gt_flow")
        out = self.internal.estimate(frame_t1, frame_t2)
        return MatchOutput.from_partial_cov(flow=out.flow, cov=torch.square(out.flow - frame_t1.gt_flow),
                                            mask=out.mask)

    @classmethod
    def is_valid_config(cls, config) -> None:
        if config is None:
            raise ValueError(f"{cls.__name__}: config is None")
        IMatcher.is_valid_config(config.module)


class ApplyGTMatchMask(IMatcher):
    """Modifier: wrap the matcher ``config.module``; its mask becomes the
    ground-truth flow mask."""

    def __init__(self, config: SimpleNamespace, device="cuda") -> None:
        super().__init__(config, device)
        self.internal = IMatcher.instantiate(config.module.type, config.module.args, device=device)

    @property
    def provide_cov(self) -> bool:
        return self.internal.provide_cov

    def estimate(self, frame_t1: StereoData, frame_t2: StereoData) -> MatchOutput:
        if frame_t1.flow_mask is None:
            raise ValueError("ApplyGTMatchMask requires frames with flow_mask")
        out = self.internal.estimate(frame_t1, frame_t2)
        out.mask = frame_t1.flow_mask
        return out

    @classmethod
    def is_valid_config(cls, config) -> None:
        if config is None:
            raise ValueError(f"{cls.__name__}: config is None")
        IMatcher.is_valid_config(config.module)


class IFrontend(RegisteredConfigTestable, register=False):
    """Joint depth+match estimation: ``estimate_pair(frame_t1, frame_t2) ->
    (DepthOutput_t2, MatchOutput_t1t2)``; ``estimate_depth(frame) -> DepthOutput``.
    Frames arrive on the frontend's device; ``device`` places any model."""

    def __init__(self, config: SimpleNamespace, device="cuda") -> None:
        self.config = config

    @property
    def provide_cov(self) -> tuple[bool, bool]:
        raise NotImplementedError

    def estimate_depth(self, frame: StereoData) -> DepthOutput:
        raise NotImplementedError

    def estimate_pair(self, frame_t1: StereoData, frame_t2: StereoData) -> tuple[DepthOutput, MatchOutput]:
        raise NotImplementedError


class FrontendCompose(IFrontend):
    """Glue an independent IStereoDepth and IMatcher into a frontend."""

    def __init__(self, config: SimpleNamespace, device="cuda") -> None:
        super().__init__(config, device)
        self.depth = IStereoDepth.instantiate(config.depth.type, config.depth.args, device=device)
        self.match = IMatcher.instantiate(config.match.type, config.match.args, device=device)

    @property
    def provide_cov(self) -> tuple[bool, bool]:
        return self.depth.provide_cov, self.match.provide_cov

    def estimate_depth(self, frame: StereoData) -> DepthOutput:
        return self.depth.estimate(frame)

    def estimate_pair(self, frame_t1: StereoData, frame_t2: StereoData) -> tuple[DepthOutput, MatchOutput]:
        return self.depth.estimate(frame_t2), self.match.estimate(frame_t1, frame_t2)

    @classmethod
    def is_valid_config(cls, config) -> None:
        IStereoDepth.is_valid_config(config.depth)
        IMatcher.is_valid_config(config.match)
