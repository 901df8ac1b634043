"""Pinhole camera model in the NED convention (port of ``macvo_tpu/geometry/camera.py``).

Image uv is east-down (u right, v down); the camera frame is NED — x forward,
y right, z down; depth is the forward (x) coordinate:

    point = [d, (u - cx) d / fx, (v - cy) d / fy]
    u = fx * p_y / p_x + cx ,  v = fy * p_z / p_x + cy .
"""

from __future__ import annotations

import torch


def intrinsics(fx: float, fy: float, cx: float, cy: float, dtype=torch.float32, device="cpu") -> torch.Tensor:
    """The (3,3) pinhole matrix."""
    return torch.tensor([[fx, 0.0, cx], [0.0, fy, cy], [0.0, 0.0, 1.0]], dtype=dtype, device=device)


def pixel_to_point_ned(kp_uv: torch.Tensor, depth: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """(..., 2) pixels + (...,) depth -> (..., 3) NED camera points."""
    fx, fy = K[..., 0, 0], K[..., 1, 1]
    cx, cy = K[..., 0, 2], K[..., 1, 2]
    u, v = kp_uv[..., 0], kp_uv[..., 1]
    y = (u - cx) * depth / fx
    z = (v - cy) * depth / fy
    return torch.stack([depth, y, z], dim=-1)


def point_to_pixel_ned(points: torch.Tensor, K: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """(..., 3) NED camera points -> (..., 2) pixels."""
    fx, fy = K[..., 0, 0], K[..., 1, 1]
    cx, cy = K[..., 0, 2], K[..., 1, 2]
    x = torch.where(points[..., 0].abs() < eps, torch.full_like(points[..., 0], eps), points[..., 0])
    u = fx * points[..., 1] / x + cx
    v = fy * points[..., 2] / x + cy
    return torch.stack([u, v], dim=-1)


def in_bounds(kp_uv: torch.Tensor, width: int, height: int, margin: float = 0.0) -> torch.Tensor:
    """Boolean mask of pixels inside the image with an optional border margin."""
    u, v = kp_uv[..., 0], kp_uv[..., 1]
    return (u >= margin) & (u <= width - 1 - margin) & (v >= margin) & (v <= height - 1 - margin)


def disparity_to_depth(disparity: torch.Tensor, baseline, fx, eps: float = 1e-6) -> torch.Tensor:
    """depth = baseline * fx / disparity."""
    return baseline * fx / torch.clamp(disparity, min=eps)


def disparity_to_depth_cov(disparity: torch.Tensor, disparity_cov: torch.Tensor, baseline, fx,
                           eps: float = 1e-6) -> torch.Tensor:
    """sigma_d = (bl*fx)^2 * sigma_disp / disp^4 (first-order propagation)."""
    disp4 = torch.clamp(disparity, min=eps) ** 4
    return (baseline * fx) ** 2 * disparity_cov / disp4
