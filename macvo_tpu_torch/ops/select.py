"""Fixed-shape selection primitives (port of ``macvo_tpu/ops/select.py``).

Selection is a fixed-K top-k over randomized scores: masked positions get
i.i.d. uniform scores from a ``torch.Generator``, the rest ``-inf``, so the
top-K is a uniform random K-subset of the masked set with no host sync. The
draws differ from ``jax.random``'s; the eligibility masks are what the tests
hold to the JAX package.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def border_mask(height: int, width: int, margin: int, device="cpu") -> torch.Tensor:
    """(H,W) mask that is True at least ``margin`` pixels away from the border."""
    mask = torch.zeros((height, width), dtype=torch.bool, device=device)
    if margin <= 0:
        return mask.fill_(True)
    mask[margin:height - margin, margin:width - margin] = True
    return mask


def max_pool2d(x: torch.Tensor, kernel_size: int) -> torch.Tensor:
    """Same-size max pool of an (H,W) map (-inf padding; NaN propagates)."""
    return F.max_pool2d(x[None, None], kernel_size, stride=1, padding=kernel_size // 2)[0, 0]


def min_pool2d(x: torch.Tensor, kernel_size: int) -> torch.Tensor:
    """Same-size min pool of an (H,W) map."""
    return -max_pool2d(-x, kernel_size)


def local_min_nms(quality: torch.Tensor, kernel_size: int) -> torch.Tensor:
    """True where ``quality`` is the local minimum (lower = better) and not NaN."""
    eroded = min_pool2d(quality, kernel_size)
    return (quality == eroded) & ~torch.isnan(quality)


def local_max_nms(score: torch.Tensor, kernel_size: int) -> torch.Tensor:
    """True where ``score`` is the local maximum (higher = better) and not NaN."""
    return (score == max_pool2d(score, kernel_size)) & ~torch.isnan(score)


def laplacian_magnitude(image: torch.Tensor) -> torch.Tensor:
    """|Laplacian| of an (H,W,3) image, the 4-neighbour kernel applied per
    channel with zero padding and summed over RGB -> (H,W)."""
    x = F.pad(image, (0, 0, 1, 1, 1, 1))
    lap = x[:-2, 1:-1] + x[2:, 1:-1] + x[1:-1, :-2] + x[1:-1, 2:] - 4.0 * x[1:-1, 1:-1]
    return lap.sum(dim=-1).abs()


def masked_median(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """numpy-style median (mean of the two middle values) of ``values`` where
    ``mask`` holds and the value is not NaN; NaN when nothing is selected.
    A 0-d tensor on the input's device, computed without a host sync."""
    keep = mask & ~torch.isnan(values)
    vals = torch.where(keep, values, torch.full_like(values, float("inf"))).reshape(-1)
    srt = torch.sort(vals).values
    n = keep.sum()
    lo = torch.clamp((n - 1) // 2, min=0)
    hi = torch.clamp(n // 2, max=srt.numel() - 1)
    med = 0.5 * (srt[lo] + srt[hi])
    return torch.where(n > 0, med, torch.full_like(med, float("nan")))


def masked_random_topk(mask: torch.Tensor, k: int, generator: torch.Generator) -> tuple[torch.Tensor, torch.Tensor]:
    """Uniform random K-subset of the True positions of an (H,W) mask.

    Returns (uv (K,2) int32 in (u,v) order, valid (K,) bool); when fewer than K
    positions are masked the tail is invalid with uv 0.
    """
    h, w = mask.shape
    scores = torch.rand((h * w,), generator=generator, device=mask.device)
    scores = torch.where(mask.reshape(-1), scores, torch.full_like(scores, -float("inf")))
    vals, flat_idx = torch.topk(scores, k)
    valid = torch.isfinite(vals)
    uv = torch.stack([flat_idx % w, flat_idx // w], dim=-1).to(torch.int32)
    return torch.where(valid[:, None], uv, torch.zeros_like(uv)), valid


def masked_score_topk(score: torch.Tensor, mask: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-K positions of an (H,W) score where ``mask`` holds and the score is
    not NaN (higher = better): (uv (K,2) int32, valid (K,) bool), as
    :func:`masked_random_topk` returns them."""
    w = score.shape[1]
    scores = torch.where(mask & ~torch.isnan(score), score, torch.full_like(score, -float("inf"))).reshape(-1)
    vals, flat_idx = torch.topk(scores, k)
    valid = torch.isfinite(vals)
    uv = torch.stack([flat_idx % w, flat_idx // w], dim=-1).to(torch.int32)
    return torch.where(valid[:, None], uv, torch.zeros_like(uv)), valid
