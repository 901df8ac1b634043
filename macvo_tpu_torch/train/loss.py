"""Training losses of the FlowFormerCov covariance head
(port of ``macvo_tpu/train/loss.py``).

Every loss takes the decoder's per-step stacks ``(depth, B, H, W, 2)``
channel-last. NaN-masked means give what ``jnp.nanmean`` gives: the mean of
the entries that are not NaN, and NaN where every entry is.
"""

from __future__ import annotations

from typing import Optional

import torch


def _iteration_weights(n: int, gamma: float, like: torch.Tensor) -> torch.Tensor:
    """gamma^(n-i-1) sequence weighting."""
    i = torch.arange(n, dtype=like.dtype, device=like.device)
    return gamma ** (n - i - 1.0)


def _nanmean(x: torch.Tensor, dim=None) -> torch.Tensor:
    keep = ~torch.isnan(x)
    return torch.nansum(x, dim=dim) / keep.sum(dim=dim)


def flow_loss(gamma: float, preds: torch.Tensor, gt: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Gamma-weighted masked L1 over the decoder steps."""
    w = _iteration_weights(preds.shape[0], gamma, preds)
    err = torch.abs(preds - gt[None])
    masked = torch.where(mask[None], err, torch.nan)
    per_iter = _nanmean(masked, dim=(1, 2, 3, 4))
    return torch.sum(w * per_iter)


def cov_loss(gamma: float, preds: torch.Tensor, gt: torch.Tensor, cov_preds: torch.Tensor,
             mask: Optional[torch.Tensor] = None, eps: float = 1e-7,
             tail_weight: float = 0.0) -> tuple[torch.Tensor, torch.Tensor]:
    """Gamma-weighted Gaussian NLL err^2/sigma^2 + log sigma^2, with the
    squared error detached so only the covariance head learns.

    ``tail_weight`` > 0 up-weights the pixels above the batch's 90th
    percentile of EPE^2 (linear interpolation, NaN-masked, as
    ``jnp.nanquantile``) by (1 + tail_weight), renormalized to mean weight 1."""
    w = _iteration_weights(preds.shape[0], gamma, preds)
    exp_cov = cov_preds + eps
    error = torch.square(preds - gt[None]).detach()
    nll = error / exp_cov + torch.log(exp_cov)
    if mask is not None:
        nll = torch.where(mask[None], nll, 0.0)
    if tail_weight > 0.0:
        epe2 = torch.sum(error[-1], dim=-1, keepdim=True)                  # (B,H,W,1)
        masked_epe2 = torch.where(mask, epe2, torch.nan) if mask is not None else epe2
        thr = torch.nanquantile(masked_epe2.flatten(), 0.9)
        w_pix = torch.where(epe2 > thr, 1.0 + tail_weight, 1.0)
        if mask is not None:
            denom = torch.clamp(torch.mean(torch.where(mask, w_pix, 0.0))
                                / torch.clamp(torch.mean(mask.to(w_pix.dtype)), min=eps), min=eps)
        else:
            denom = torch.clamp(torch.mean(w_pix), min=eps)
        nll = nll * (w_pix / denom)[None]
    loss = torch.mean(torch.sum(w[:, None, None, None, None] * nll, dim=0))
    return loss, error[-1]


def final_cov_loss(preds, gt, cov_preds, mask=None, eps: float = 1e-7):
    """NLL on the final step only."""
    return cov_loss(1.0, preds[-1:], gt, cov_preds[-1:], mask, eps)


def sequence_loss(preds: torch.Tensor, cov_preds: Optional[torch.Tensor], gt: torch.Tensor,
                  flow_mask: Optional[torch.Tensor], gamma: float = 0.85, max_flow: float = 400.0,
                  training_mode: str = "flow", tail_weight: float = 0.0) -> tuple[torch.Tensor, dict]:
    """Loss by training mode: ``flow`` trains the flow branch; ``cov`` and
    ``finalcov`` train the covariance head with the NLL."""
    mask = torch.linalg.vector_norm(gt, dim=-1, keepdim=True) < max_flow
    if flow_mask is not None:
        mask = mask & flow_mask.bool()

    metrics: dict = {}
    if training_mode == "flow":
        loss = flow_loss(gamma, preds, gt, mask)
    elif training_mode in ("cov", "finalcov"):
        if cov_preds is None:
            raise ValueError(f"training mode {training_mode!r} needs cov_preds")
        if training_mode == "cov":
            loss, error = cov_loss(gamma, preds, gt, cov_preds, mask, tail_weight=tail_weight)
        else:
            loss, error = final_cov_loss(preds, gt, cov_preds, mask)
        metrics["error"] = torch.mean(error)
        metrics["cov"] = torch.mean(cov_preds[-1]).detach()
    else:
        raise ValueError(f"Unavailable training mode {training_mode}")
    return loss, metrics


def sequence_metrics(preds: torch.Tensor, gt: torch.Tensor, flow_mask=None, max_flow: float = 400.0) -> dict:
    """EPE and 1/3/5-px accuracy of the final step over the valid pixels."""
    epe = torch.sqrt(torch.sum(torch.square(preds[-1] - gt), dim=-1))
    mask = torch.linalg.vector_norm(gt, dim=-1) < max_flow
    if flow_mask is not None:
        mask = mask & flow_mask[..., 0].bool()

    def mean(x):
        return _nanmean(torch.where(mask, x, torch.nan))

    return {"epe": mean(epe), "1px": mean((epe < 1).float()), "3px": mean((epe < 3).float()),
            "5px": mean((epe < 5).float())}
