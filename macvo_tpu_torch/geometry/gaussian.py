"""Anisotropic Gaussian patch kernels and mixture statistics (port of ``macvo_tpu/geometry/gaussian.py``)."""

from __future__ import annotations

import torch


def inv_2x2(cov: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Closed-form inverse of (...,2,2) SPD matrices with determinant guard."""
    a, b = cov[..., 0, 0], cov[..., 0, 1]
    c, d = cov[..., 1, 0], cov[..., 1, 1]
    det = a * d - b * c
    det = torch.where(det.abs() < eps, torch.full_like(det, eps), det)
    inv = torch.stack([torch.stack([d, -b], -1), torch.stack([-c, a], -1)], dim=-2)
    return inv / det[..., None, None]


def gaussian_full_kernels(cov_2x2: torch.Tensor, kernel_size: int) -> torch.Tensor:
    """(N,2,2) flow covariances -> (N,K,K) Gaussian kernels normalized to sum 1.

    ``kernel[n, x, y]`` weighs the offset ``(x - K//2, y - K//2)`` with x the
    u-offset, matching the patch layout of ``ops.cov_project.gather_patches``.
    """
    half = (kernel_size - 1) / 2.0
    coords = torch.linspace(-half, half, kernel_size, dtype=cov_2x2.dtype, device=cov_2x2.device)
    gx, gy = torch.meshgrid(coords, coords, indexing="ij")
    inv_cov = inv_2x2(cov_2x2)
    quad = (inv_cov[:, None, None, 0, 0] * gx * gx
            + (inv_cov[:, None, None, 0, 1] + inv_cov[:, None, None, 1, 0]) * gx * gy
            + inv_cov[:, None, None, 1, 1] * gy * gy)
    z = torch.exp(-0.5 * quad)
    total = torch.sum(z, dim=(-1, -2), keepdim=True)
    return z / torch.clamp(total, min=1e-12)


def gaussian_mixture_mean_var(means: torch.Tensor, variances: torch.Tensor, probs: torch.Tensor,
                              prob_threshold: float = 1e-3) -> tuple[torch.Tensor, torch.Tensor]:
    """Mean and variance of B Gaussian mixtures of N components, (B,N) inputs.

    Components below ``prob_threshold`` are dropped and the rest renormalized;
    the variance E[v + m^2] - mean^2 is halved, the reference's damping, so
    covariance magnitudes match."""
    probs = torch.where(probs < prob_threshold, torch.zeros_like(probs), probs)
    probs = probs / torch.clamp(probs.sum(dim=1, keepdim=True), min=1e-12)
    mean = torch.sum(means * probs, dim=1)
    var = torch.sum((variances + means * means) * probs, dim=1) - mean * mean
    return mean, var / 2.0
