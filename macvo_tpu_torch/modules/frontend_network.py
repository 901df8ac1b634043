"""FlowFormerCov frontend (port of ``FlowFormerCovFrontend`` in
``macvo_tpu/modules/frontend_network.py``).

One network does both tasks: each pair is one batched decode with B = 2
(stereo t2 and flow t1->t2). The left image's Twins features and context are
cached across frames, so a steady-state frame encodes only its two new images
(``pair_cached``); the first pair after ``estimate_depth`` of another frame
encodes all three (``pair_cold``).

Weights: ``weight`` is the flax npz, converted in memory (see
``models/flowformer/weights.py``).

Covariance recalibration: ``cov_calib`` (default ``"auto"``) names a JSON of
per-band variance temperatures (``log10_sigma_edges``, ``tau2``, written by
``scripts/fit_cov_temperature.py``); ``"auto"`` loads ``<weight>.calib.json``
when it exists, a path loads that file, ``"none"`` or null turns it off. The
temperature scales the unpadded, normalized covariance on every path.

Precision: fp32 configs run fp32 with TF32 off for both cuBLAS and cuDNN
(cuDNN convolutions default to TF32); this is the card's twin of the
HIGHEST-precision rule of the JAX frontend. bf16 configs run under autocast.
"""

from __future__ import annotations

import json
from pathlib import Path
from types import SimpleNamespace

import torch

from ..data.frame import StereoData
from ..geometry.camera import disparity_to_depth, disparity_to_depth_cov
from ..models.flowformer import FlowFormerConfig, FlowFormerCov, InputPadder, load_flax_checkpoint, normalize_cov
from ..utils.device import resolve_device
from .frontend import DepthOutput, IFrontend, MatchOutput

_DTYPES = ("fp32", "fp16", "bf16")


def flow_to_depth(flow, cov, baseline: float, fx: float, enforce_positive: bool) -> DepthOutput:
    """Stereo (L->R) flow -> depth: disparity = |flow_u|, cov propagated."""
    disparity = flow[..., 0:1].abs()
    disparity_cov = cov[..., 0:1]
    return DepthOutput(
        depth=disparity_to_depth(disparity, baseline, fx),
        cov=disparity_to_depth_cov(disparity, disparity_cov, baseline, fx),
        disparity=disparity, disparity_uncertainty=disparity_cov,
        mask=(flow[..., 0:1] > 0) if enforce_positive else None)


def load_cov_calib(calib, weight: str, device: torch.device | str = "cpu"):
    """(log10-sigma band edges, variance temperatures) as fp32 tensors on
    ``device``, or None: ``"auto"`` reads ``<weight>.calib.json`` if present,
    a path reads that file (``FileNotFoundError`` if missing), ``"none"`` /
    ``""`` / None disables."""
    if calib in (None, "none", ""):
        return None
    path = Path(weight).with_suffix(".calib.json") if calib == "auto" else Path(calib)
    if not path.exists():
        if calib != "auto":
            raise FileNotFoundError(f"cov_calib file not found: {path}")
        return None
    rec = json.loads(path.read_text())
    return tuple(torch.tensor(rec[k], dtype=torch.float32, device=device) for k in ("log10_sigma_edges", "tau2"))


def recalibrate(cov: torch.Tensor, calib) -> torch.Tensor:
    """Scale the (..., 2) variance by the temperature of its log10-sigma band
    (both channels together, so the correlation structure is kept). The band
    search takes the left side, as ``jnp.searchsorted`` does: a value on an
    edge belongs to the band below it."""
    if calib is None:
        return cov
    edges, tau2 = calib
    sigma2 = 0.5 * (cov[..., 0] + cov[..., 1])
    log_sigma = 0.5 * torch.log10(torch.clamp(sigma2.float(), min=1e-24))
    idx = torch.searchsorted(edges, log_sigma.contiguous(), right=False)
    return cov * tau2[idx][..., None].to(cov.dtype)


class _FlowFormerRunner:
    """Model host: builds the network on its device and runs the padded stages."""

    def __init__(self, config: SimpleNamespace, device: torch.device) -> None:
        self.device = device
        self.cfg = FlowFormerConfig(
            decoder_depth=int(getattr(config, "decoder_depth", 12)),
            encoder_dtype=getattr(config, "enc_dtype", "fp32"),
            decoder_dtype=getattr(config, "dec_dtype", "fp32"),
            inference_only=True,
        )
        model = FlowFormerCov(self.cfg)
        load_flax_checkpoint(model, str(config.weight))
        self.model = model.to(device).eval()
        self.calib = load_cov_calib(getattr(config, "cov_calib", "auto"), str(config.weight), device)
        self.fp32 = self.cfg.encoder_dtype == "fp32" and self.cfg.decoder_dtype == "fp32"
        if self.fp32 and device.type == "cuda":
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False

    def _decode_unpad(self, padder, feat_a, feat_b, ctx):
        out = self.model.decode(feat_a, feat_b, ctx)
        flow = padder.unpad(out["flow_final"])
        cov = recalibrate(padder.unpad(normalize_cov(out["cov_final"])), self.calib)
        return flow, cov

    def depth(self, img_l, img_r):
        """Stereo forward; also returns the left image's (features, context)."""
        padder = InputPadder(img_l.shape)
        pl, pr = padder.pad(img_l, img_r)
        f_l, f_r = torch.chunk(self.model.features(torch.cat([pl, pr], 0)), 2, 0)
        c_l = self.model.context(pl)
        flow, cov = self._decode_unpad(padder, f_l, f_r, c_l)
        return flow, cov, (f_l, c_l)

    def pair_cold(self, l1, l2, r2):
        """Flow(l1->l2) + stereo(l2->r2) with no cache: encode all three images."""
        padder = InputPadder(l1.shape)
        pl1, pl2, pr2 = padder.pad(l1, l2, r2)
        f_l1, f_l2, f_r2 = torch.chunk(self.model.features(torch.cat([pl1, pl2, pr2], 0)), 3, 0)
        c_l2, c_l1 = torch.chunk(self.model.context(torch.cat([pl2, pl1], 0)), 2, 0)
        flow, cov = self._decode_unpad(padder, torch.cat([f_l2, f_l1], 0),
                                       torch.cat([f_r2, f_l2], 0), torch.cat([c_l2, c_l1], 0))
        return flow, cov, (f_l2, c_l2)

    def pair_cached(self, l2, r2, f_l1, c_l1):
        """Flow(l1->l2) + stereo(l2->r2) reusing l1's cached features/context."""
        padder = InputPadder(l2.shape)
        pl2, pr2 = padder.pad(l2, r2)
        f_l2, f_r2 = torch.chunk(self.model.features(torch.cat([pl2, pr2], 0)), 2, 0)
        c_l2 = self.model.context(pl2)
        flow, cov = self._decode_unpad(padder, torch.cat([f_l2, f_l1], 0),
                                       torch.cat([f_r2, f_l2], 0), torch.cat([c_l2, c_l1], 0))
        return flow, cov, (f_l2, c_l2)


class FlowFormerCovFrontend(IFrontend):
    """Joint frontend: one FlowFormerCov decode for depth + matching."""

    def __init__(self, config: SimpleNamespace, device: str | torch.device = "cuda") -> None:
        super().__init__(config, device)
        self.device = resolve_device(device)
        self.runner = _FlowFormerRunner(config, self.device)
        self.enforce_positive = bool(getattr(config, "enforce_positive_disparity", False))
        # (source StereoData, fnet features, cnet context) of the latest frame
        self._feat_cache: tuple | None = None

    @property
    def provide_cov(self) -> tuple[bool, bool]:
        return True, True

    def _depth_output(self, flow, cov, frame: StereoData) -> DepthOutput:
        return flow_to_depth(flow, cov, frame.frame_baseline, frame.fx, self.enforce_positive)

    @torch.inference_mode()
    def estimate_depth(self, frame: StereoData) -> DepthOutput:
        flow, cov, cache = self.runner.depth(frame.imageL, frame.imageR)
        self._feat_cache = (frame, *cache)
        return self._depth_output(flow, cov, frame)

    @torch.inference_mode()
    def estimate_pair(self, frame_t1: StereoData, frame_t2: StereoData) -> tuple[DepthOutput, MatchOutput]:
        cache = self._feat_cache
        if cache is not None and cache[0] is frame_t1:
            flow, cov, new_cache = self.runner.pair_cached(frame_t2.imageL, frame_t2.imageR, cache[1], cache[2])
        else:
            flow, cov, new_cache = self.runner.pair_cold(frame_t1.imageL, frame_t2.imageL, frame_t2.imageR)
        self._feat_cache = (frame_t2, *new_cache)
        depth = self._depth_output(flow[0:1], cov[0:1], frame_t2)
        match = MatchOutput.from_partial_cov(flow=flow[1:2], cov=cov[1:2])
        return depth, match

    @classmethod
    def is_valid_config(cls, config) -> None:
        cls._enforce_config_spec(config, {
            "weight": lambda s: isinstance(s, str),
            "dec_dtype": lambda s: s in _DTYPES,
            "enc_dtype": lambda s: s in _DTYPES,
            "enforce_positive_disparity": lambda b: isinstance(b, bool),
            "decoder_depth": lambda v: isinstance(v, int),
        })
        calib = getattr(config, "cov_calib", None)
        if calib is not None and not isinstance(calib, str):
            raise ValueError(f"{cls.__name__}: config key 'cov_calib' has invalid value {calib!r}")
