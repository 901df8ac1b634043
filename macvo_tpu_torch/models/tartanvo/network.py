"""TartanVO constants and input helpers (port of ``macvo_tpu/models/tartanvo/network.py``).

Images and maps are channel-last ``(B,H,W,C)`` here, as in the JAX package.
The adapter conventions of the reference TartanVO stack: images crop to /64
multiples, ``flow_norm = 0.05``, ``stereoNormFactor = 0.02``,
``poseDepthNormFactor = 0.25``, and the se3 output scaled by ``POSE_NORM``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

POSE_NORM = (0.13, 0.13, 0.13, 0.013, 0.013, 0.013)
FLOW_NORM = 0.05
STEREO_NORM = 0.02
POSE_DEPTH_NORM = 0.25
POSENET_SIZE = (112, 160)   # PoseNet input size (TartanVO paper)

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def normalize_image(img: torch.Tensor) -> torch.Tensor:
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=img.device)
    std = torch.tensor(IMAGENET_STD, dtype=torch.float32, device=img.device)
    return (img - mean) / std


def crop_to_multiple(img: torch.Tensor, factor: int = 64) -> torch.Tensor:
    """Center-crop H,W of a (B,H,W,C) map down to multiples of ``factor``."""
    h, w = img.shape[1], img.shape[2]
    h64, w64 = (h // factor) * factor, (w // factor) * factor
    mh, mw = (h - h64) // 2, (w - w64) // 2
    return img[:, mh:mh + h64, mw:mw + w64]


def make_intrinsics_layer(height: int, width: int, fx: float, fy: float, cx: float, cy: float,
                          device="cpu") -> torch.Tensor:
    """(H,W,2) normalized pixel-offset layer fed to the pose net."""
    xs = (torch.arange(width, dtype=torch.float32, device=device) - cx) / fx
    ys = (torch.arange(height, dtype=torch.float32, device=device) - cy) / fy
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    return torch.stack([gx, gy], dim=-1)


def resize_bilinear(x: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    """(B,H,W,C) -> (B,h,w,C) bilinear resize with ``jax.image.resize``'s
    semantics: half-pixel centers, and an antialiasing (widened triangle)
    filter where it shrinks."""
    y = F.interpolate(x.permute(0, 3, 1, 2), size=tuple(size), mode="bilinear", align_corners=False,
                      antialias=True)
    return y.permute(0, 2, 3, 1)
