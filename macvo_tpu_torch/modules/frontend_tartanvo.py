"""TartanVO frontend modules and learned motion model
(port of ``macvo_tpu/modules/frontend_tartanvo.py``).

The networks of ``models/tartanvo`` as pipeline modules, with the reference's
adapter conventions: images are center-cropped to /64 multiples, network
outputs are NaN-padded back to full resolution with a validity mask over the
crop margin, and flow is un-normalized by ``1/FLOW_NORM`` and upsampled x4.

Each module loads its flax checkpoint (``weight``) in memory, or draws seeded
random weights for ``weight: "random[:<seed>]"`` (with a warning, as the JAX
host gives), and runs fp32 on its ``device`` (``cuda`` unless the caller asks
for the CPU), with TF32 off for cuDNN and cuBLAS on the card, as the JAX
record is fp32.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Optional

import torch
import torch.nn.functional as F

from ..data.frame import StereoData, StereoFrame
from ..geometry import se3
from ..geometry.camera import disparity_to_depth, disparity_to_depth_cov
from ..models.flowformer.weights import build_with_weights, random_seed
from ..models.tartanvo import (
    FLOW_NORM,
    POSE_DEPTH_NORM,
    POSE_NORM,
    POSENET_SIZE,
    STEREO_NORM,
    PWCFlowNet,
    RAFTFlowCovNet,
    StereoCovNet,
    VOFlowRes,
    make_intrinsics_layer,
    normalize_image,
    resize_bilinear,
)
from ..utils.device import resolve_device
from ..utils.logging import Logger
from ..utils.precision import tf32_off
from .frontend import DepthOutput, IMatcher, IStereoDepth, MatchOutput
from .motion import IMotionModel


def crop_margins(h: int, w: int, factor: int = 64) -> tuple[int, int, int, int]:
    """(top, left, height, width) of the centered /``factor`` crop."""
    h64, w64 = (h // factor) * factor, (w // factor) * factor
    return (h - h64) // 2, (w - w64) // 2, h64, w64


def nan_pad(x: torch.Tensor, h: int, w: int, mh: int, mw: int) -> torch.Tensor:
    """Pad a cropped (B,h64,w64,C) map back to (B,H,W,C) with NaN margins."""
    return F.pad(x, (0, 0, mw, w - mw - x.shape[2], mh, h - mh - x.shape[1]), value=float("nan"))


def margin_mask(h: int, w: int, mh: int, mw: int, h64: int, w64: int, device) -> torch.Tensor:
    """(1,H,W,1) bool: True inside the crop."""
    mask = torch.zeros((1, h, w, 1), dtype=torch.bool, device=device)
    mask[:, mh:mh + h64, mw:mw + w64] = True
    return mask


def load_network(net_class, weight: str, device: torch.device) -> torch.nn.Module:
    """Build ``net_class()`` with the flax checkpoint (or seeded random weights)
    of ``weight`` (``models/flowformer/weights.py: build_with_weights``) and
    place it on ``device`` (fp32, TF32 off)."""
    if random_seed(str(weight)) is not None:
        Logger.warning(
            f"{net_class.__name__}: RANDOM weights ({weight}) — no trained "
            "TartanVO-family checkpoint exists in this snapshot; outputs are "
            "not meaningful as a baseline (PARITY.md row 27)")
    model = build_with_weights(net_class, str(weight))
    if device.type == "cuda":
        tf32_off()
    return model.to(device).eval()


def _cropped(image: torch.Tensor, mh: int, mw: int, h64: int, w64: int) -> torch.Tensor:
    return normalize_image(image[:, mh:mh + h64, mw:mw + w64])


class TartanVOMatcher(IMatcher):
    """PWC flow matcher with a crop-margin mask."""

    def __init__(self, config: SimpleNamespace, device: str | torch.device = "cuda") -> None:
        super().__init__(config, device)
        self.device = resolve_device(device)
        self.net = load_network(PWCFlowNet, config.weight, self.device)

    @property
    def provide_cov(self) -> bool:
        return False

    @torch.inference_mode()
    def estimate(self, frame_t1: StereoData, frame_t2: StereoData) -> MatchOutput:
        h, w = frame_t1.height, frame_t1.width
        mh, mw, h64, w64 = crop_margins(h, w)
        flow_q = self.net(_cropped(frame_t1.imageL, mh, mw, h64, w64),
                          _cropped(frame_t2.imageL, mh, mw, h64, w64)) / FLOW_NORM   # 1/4 res
        flow = resize_bilinear(flow_q, (h64, w64))
        return MatchOutput(flow=nan_pad(flow, h, w, mh, mw),
                           mask=margin_mask(h, w, mh, mw, h64, w64, flow.device))

    @classmethod
    def is_valid_config(cls, config) -> None:
        cls._enforce_config_spec(config, {"weight": lambda s: isinstance(s, str)})


class TartanVOCovMatcher(IMatcher):
    """PWC flow with the RAFT-style recurrent covariance: the variance of the
    last iteration, exp(2 log_sigma), resized as the flow is (and, as in the
    JAX package, not rescaled by ``FLOW_NORM``)."""

    def __init__(self, config: SimpleNamespace, device: str | torch.device = "cuda") -> None:
        super().__init__(config, device)
        self.device = resolve_device(device)
        self.net = load_network(RAFTFlowCovNet, config.weight, self.device)

    @property
    def provide_cov(self) -> bool:
        return True

    @torch.inference_mode()
    def estimate(self, frame_t1: StereoData, frame_t2: StereoData) -> MatchOutput:
        h, w = frame_t1.height, frame_t1.width
        mh, mw, h64, w64 = crop_margins(h, w)
        flow_q, log_sigma = self.net(_cropped(frame_t1.imageL, mh, mw, h64, w64),
                                     _cropped(frame_t2.imageL, mh, mw, h64, w64))
        flow = resize_bilinear(flow_q / FLOW_NORM, (h64, w64))
        cov = resize_bilinear(torch.exp(2.0 * log_sigma[-1]), (h64, w64))
        return MatchOutput.from_partial_cov(flow=nan_pad(flow, h, w, mh, mw), cov=nan_pad(cov, h, w, mh, mw),
                                            mask=margin_mask(h, w, mh, mw, h64, w64, flow.device))

    @classmethod
    def is_valid_config(cls, config) -> None:
        cls._enforce_config_spec(config, {"weight": lambda s: isinstance(s, str)})


class TartanVODepth(IStereoDepth):
    """Hourglass stereo depth with the optional covariance decoder."""

    def __init__(self, config: SimpleNamespace, device: str | torch.device = "cuda") -> None:
        super().__init__(config, device)
        self.device = resolve_device(device)
        self.net = load_network(StereoCovNet, config.weight, self.device)
        self.use_cov = getattr(config, "cov_mode", "None") == "Est"

    @property
    def provide_cov(self) -> bool:
        return self.use_cov

    @torch.inference_mode()
    def estimate(self, frame: StereoData) -> DepthOutput:
        h, w = frame.height, frame.width
        mh, mw, h64, w64 = crop_margins(h, w)
        disparity, disparity_cov = self.net(_cropped(frame.imageL, mh, mw, h64, w64),
                                            _cropped(frame.imageR, mh, mw, h64, w64))
        depth = nan_pad(disparity_to_depth(disparity, frame.frame_baseline, frame.fx), h, w, mh, mw)
        mask = margin_mask(h, w, mh, mw, h64, w64, depth.device)
        if not self.use_cov:
            return DepthOutput(depth=depth, disparity=nan_pad(disparity, h, w, mh, mw), mask=mask)
        depth_cov = disparity_to_depth_cov(disparity, disparity_cov, frame.frame_baseline, frame.fx)
        return DepthOutput(depth=depth, cov=nan_pad(depth_cov, h, w, mh, mw),
                           disparity=nan_pad(disparity, h, w, mh, mw),
                           disparity_uncertainty=nan_pad(disparity_cov, h, w, mh, mw), mask=mask)

    @classmethod
    def is_valid_config(cls, config) -> None:
        cls._enforce_config_spec(config, {
            "weight": lambda s: isinstance(s, str),
            "cov_mode": lambda s: s in ("Est", "None"),
        })


class TartanMotionNet(IMotionModel):
    """Learned motion prior: VOFlowRes on (flow, normalized inverse depth,
    intrinsics layer) resized to 112x160; its se3 output, scaled by
    ``POSE_NORM``, is chained onto the previous pose. The network runs on
    ``device``, and so does the chain: the pose (7,) is fp32 on ``device``,
    whatever device the pose given to :meth:`update` came from."""

    def __init__(self, config: SimpleNamespace, device: str | torch.device = "cuda") -> None:
        super().__init__(config)
        self.device = resolve_device(device)
        self.net = load_network(VOFlowRes, config.weight, self.device)
        self.pose_norm = torch.tensor(POSE_NORM, device=self.device)
        self.prev_pose: Optional[torch.Tensor] = None

    def motion_input(self, frame: StereoFrame, flow: torch.Tensor, depth: torch.Tensor) -> torch.Tensor:
        """The (1,112,160,5) pose-net input. NaN flow counts as 0 and NaN depth
        as 1e6 m; the inverse depth is clipped at 0 and capped at 2 (0.5 m)."""
        meta = frame.stereo
        th, tw = POSENET_SIZE
        intr = make_intrinsics_layer(meta.height, meta.width, meta.fx, meta.fy, meta.cx, meta.cy, flow.device)
        intr = resize_bilinear(intr[None], (th, tw))
        flow_r = resize_bilinear(torch.nan_to_num(flow), (th, tw)) * FLOW_NORM
        depth_r = resize_bilinear(torch.nan_to_num(depth, nan=1e6), (th, tw))
        blfx = meta.frame_baseline * meta.fx
        stereo = torch.clamp(torch.nan_to_num(blfx / depth_r * STEREO_NORM), min=0.0)
        inv_depth = torch.clamp(stereo / blfx / STEREO_NORM, max=2.0) / POSE_DEPTH_NORM
        return torch.cat([flow_r, inv_depth, intr], dim=-1)

    @torch.inference_mode()
    def predict(self, frame: StereoFrame, flow, depth) -> torch.Tensor:
        if self.prev_pose is None:
            self.prev_pose = se3.identity(device=self.device)
            return self.prev_pose
        if flow is None or depth is None:
            raise ValueError("TartanMotionNet needs flow and depth after the first frame")
        twist = self.net(self.motion_input(frame, flow, depth))[0] * self.pose_norm
        # The network emits [trans, rot]; se3 twists are [rho, phi]: the same order.
        self.prev_pose = se3.mul(self.prev_pose, se3.exp(twist))
        return self.prev_pose

    def update(self, pose) -> None:
        self.prev_pose = torch.as_tensor(pose, dtype=torch.float32, device=self.device).reshape(7)

    @classmethod
    def is_valid_config(cls, config) -> None:
        cls._enforce_config_spec(config, {"weight": lambda s: isinstance(s, str)})
