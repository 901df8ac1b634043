"""Frame preprocessing transforms (port of ``macvo_tpu/data/transform.py``).

Host-side numpy/cv2 ops on the port's :class:`StereoFrame` (CPU tensors in,
CPU tensors out), the same arithmetic as the JAX package's: resizing rescales
intrinsics and dense ground truth (flow *values* scale with the image),
cropping shifts the principal point, plus sensor-noise injection, photometric
jitter and dtype casting. ``SmartResizeFrame`` = aspect-preserving scale then
center-crop to a target shape.
"""

from __future__ import annotations

from types import SimpleNamespace

import cv2
import numpy as np
import torch

from ..utils.registry import RegisteredConfigTestable
from .frame import StereoData, StereoFrame


class IDataTransform(RegisteredConfigTestable, register=False):
    def __init__(self, config: SimpleNamespace | dict | None = None) -> None:
        if isinstance(config, dict):
            config = SimpleNamespace(**config)
        self.config = config

    def __call__(self, frame: StereoFrame) -> StereoFrame:
        raise NotImplementedError


def _np(x):
    """A frame field as a host numpy array (None stays None)."""
    if x is None:
        return None
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _t(x):
    return None if x is None else torch.from_numpy(np.ascontiguousarray(x))


def _resize_batch(images: np.ndarray, w: int, h: int, interp=cv2.INTER_LINEAR) -> np.ndarray:
    """(B,H,W,C) or (B,H,W) resize via cv2, preserving batch and channels."""
    squeeze = images.ndim == 3
    if squeeze:
        images = images[..., None]
    out = np.stack([cv2.resize(img, (w, h), interpolation=interp) for img in images], axis=0)
    if out.ndim == 3:
        out = out[..., None]
    return out[..., 0] if squeeze else out


def _interp_name(config) -> str:
    """The config's ``interp`` key (values nearest/bilinear); the legacy
    ``interpolate`` key is also accepted."""
    return getattr(config, "interp", getattr(config, "interpolate", "bilinear"))


def _check_interp_key(config) -> None:
    name = _interp_name(config)
    if name not in ("nearest", "bilinear", "linear"):
        raise ValueError(f"bad interp mode {name!r}")


def _with_images(frame: StereoFrame, imageL, imageR) -> StereoFrame:
    s = frame.stereo
    return StereoFrame(idx=frame.idx, gt_pose=frame.gt_pose, stereo=StereoData(
        T_BS=s.T_BS, K=s.K, baseline=s.baseline, time_ns=s.time_ns, imageL=_t(imageL), imageR=_t(imageR),
        gt_flow=s.gt_flow, flow_mask=s.flow_mask, gt_depth=s.gt_depth))


class ScaleFrame(IDataTransform):
    """Resize the frame DOWN by a factor: target size = original / scale.
    K and flow values divide by the *rounded* scale recomputed from the
    integer target size."""

    def __call__(self, frame: StereoFrame) -> StereoFrame:
        su, sv = float(self.config.scale_u), float(self.config.scale_v)
        interp = cv2.INTER_NEAREST if _interp_name(self.config) == "nearest" else cv2.INTER_LINEAR
        s = frame.stereo
        H, W = s.imageL.shape[1:3]
        new_w, new_h = int(W / su), int(H / sv)
        round_su, round_sv = W / new_w, H / new_h
        K = np.asarray(s.K) / np.array(
            [[round_su, 1.0, round_su], [1.0, round_sv, round_sv], [1.0, 1.0, 1.0]], dtype=np.float32)

        def rs(x, nearest=False):
            if x is None:
                return None
            return _resize_batch(_np(x), new_w, new_h, cv2.INTER_NEAREST if nearest else interp)

        gt_flow = rs(s.gt_flow)
        if gt_flow is not None:
            gt_flow = gt_flow / np.array([round_su, round_sv], dtype=np.float32)
        return StereoFrame(idx=frame.idx, gt_pose=frame.gt_pose, stereo=StereoData(
            T_BS=s.T_BS, K=K.astype(np.float32), baseline=s.baseline, time_ns=s.time_ns,
            imageL=_t(rs(s.imageL)), imageR=_t(rs(s.imageR)), gt_flow=_t(gt_flow),
            flow_mask=_t(rs(s.flow_mask, nearest=True)), gt_depth=_t(rs(s.gt_depth, nearest=True))))

    @classmethod
    def is_valid_config(cls, config) -> None:
        cls._enforce_config_spec(config, {
            "scale_u": lambda v: isinstance(v, (int, float)) and v > 0,
            "scale_v": lambda v: isinstance(v, (int, float)) and v > 0,
        })
        _check_interp_key(config)


class CenterCropFrame(IDataTransform):
    """Center-crop to (width, height); the principal point shifts by the crop offset."""

    def __call__(self, frame: StereoFrame) -> StereoFrame:
        tw, th = int(self.config.width), int(self.config.height)
        s = frame.stereo
        H, W = s.imageL.shape[1:3]
        off_u, off_v = (W - tw) // 2, (H - th) // 2
        if off_u < 0 or off_v < 0:
            raise ValueError(f"crop {tw}x{th} larger than image {W}x{H}")

        def crop(x):
            return None if x is None else _t(_np(x)[:, off_v:off_v + th, off_u:off_u + tw])

        K = np.asarray(s.K).copy()
        K[:, 0, 2] -= off_u
        K[:, 1, 2] -= off_v
        return StereoFrame(idx=frame.idx, gt_pose=frame.gt_pose, stereo=StereoData(
            T_BS=s.T_BS, K=K, baseline=s.baseline, time_ns=s.time_ns, imageL=crop(s.imageL),
            imageR=crop(s.imageR), gt_flow=crop(s.gt_flow), flow_mask=crop(s.flow_mask),
            gt_depth=crop(s.gt_depth)))

    @classmethod
    def is_valid_config(cls, config) -> None:
        cls._enforce_config_spec(config, {
            "width": lambda v: isinstance(v, int) and v > 0,
            "height": lambda v: isinstance(v, int) and v > 0,
        })


class AddImageNoise(IDataTransform):
    """Additive Gaussian pixel noise on both images, seeded by the frame index
    (the same draws as the JAX package's)."""

    def __call__(self, frame: StereoFrame) -> StereoFrame:
        stdv = float(self.config.stdv)
        rng = np.random.default_rng(abs(hash(int(frame.idx[0]))) % (2**31))

        def noisy(img):
            n = rng.normal(0.0, stdv, size=img.shape).astype(np.float32)
            return np.clip(_np(img) + n, 0.0, 1.0)

        return _with_images(frame, noisy(frame.stereo.imageL), noisy(frame.stereo.imageR))

    @classmethod
    def is_valid_config(cls, config) -> None:
        cls._enforce_config_spec(config, {"stdv": lambda v: isinstance(v, (int, float)) and v >= 0})


class PhotometricJitter(IDataTransform):
    """Random brightness/contrast/gamma/color-gain jitter and mild defocus,
    drawn anew on every call from an unseeded generator, so the two frames of
    a pair get different parameters. ``strength`` in [0, 2] scales every
    range (default 1). Ground truth (flow/depth/pose/K) is untouched."""

    def __call__(self, frame: StereoFrame) -> StereoFrame:
        k = float(getattr(self.config, "strength", 1.0) if self.config else 1.0)
        rng = np.random.default_rng()

        def jitter(img):
            img = _np(img).astype(np.float32, copy=False)
            gain = 1.0 + rng.uniform(-0.3, 0.3) * k
            bias = rng.uniform(-0.12, 0.12) * k
            gamma = np.exp(rng.uniform(-0.35, 0.35) * k)
            color = 1.0 + rng.uniform(-0.15, 0.15, size=3).astype(np.float32) * k
            out = np.clip(img * gain * color + bias, 1e-4, 1.0) ** gamma
            if rng.random() < 0.5 * k:
                sigma = rng.uniform(0.4, 1.2)
                out = np.stack([cv2.GaussianBlur(b, (0, 0), sigma) for b in out], 0)
            return np.clip(out, 0.0, 1.0).astype(np.float32)

        return _with_images(frame, jitter(frame.stereo.imageL), jitter(frame.stereo.imageR))

    @classmethod
    def is_valid_config(cls, config) -> None:
        if config is not None and hasattr(config, "strength"):
            if not (isinstance(config.strength, (int, float)) and 0 <= config.strength <= 2):
                raise ValueError(f"PhotometricJitter: strength {config.strength!r} not in [0, 2]")


class CastDataType(IDataTransform):
    """Cast both images to float32, float16 or bfloat16 (round to nearest even)."""

    _DTYPES = {"float32": torch.float32, "float16": torch.float16, "bfloat16": torch.bfloat16}

    def __call__(self, frame: StereoFrame) -> StereoFrame:
        dtype = self._DTYPES[self.config.dtype]
        s = frame.stereo

        def cast(img):
            return (img if isinstance(img, torch.Tensor) else _t(np.asarray(img))).to(dtype)

        return StereoFrame(idx=frame.idx, gt_pose=frame.gt_pose, stereo=StereoData(
            T_BS=s.T_BS, K=s.K, baseline=s.baseline, time_ns=s.time_ns, imageL=cast(s.imageL),
            imageR=cast(s.imageR), gt_flow=s.gt_flow, flow_mask=s.flow_mask, gt_depth=s.gt_depth))

    @classmethod
    def is_valid_config(cls, config) -> None:
        cls._enforce_config_spec(config, {"dtype": lambda v: v in ("float32", "float16", "bfloat16")})


class SmartResizeFrame(IDataTransform):
    """Aspect-preserving scale then center-crop to exactly (width, height)."""

    def __call__(self, frame: StereoFrame) -> StereoFrame:
        tw, th = int(self.config.width), int(self.config.height)
        H, W = frame.stereo.imageL.shape[1:3]
        # Scale by the SMALLER shrink so both target dims stay covered, then crop.
        factor = min(H / th, W / tw)
        scale = ScaleFrame(SimpleNamespace(scale_u=factor, scale_v=factor, interp=_interp_name(self.config)))
        crop = CenterCropFrame(SimpleNamespace(width=tw, height=th))
        return crop(scale(frame))

    @classmethod
    def is_valid_config(cls, config) -> None:
        cls._enforce_config_spec(config, {
            "width": lambda v: isinstance(v, int) and v > 0,
            "height": lambda v: isinstance(v, int) and v > 0,
        })
        _check_interp_key(config)
