"""Training losses of the FlowFormerCov covariance head
(port of ``macvo_tpu/train/loss.py``).

Every loss takes the decoder's per-step stacks ``(depth, B, H, W, 2)``
channel-last. NaN-masked means give what ``jnp.nanmean`` gives: the mean of
the entries that are not NaN, and NaN where every entry is.

Data-parallel training passes a :class:`GlobalBatch`: each process then
holds its rows of the global batch, and each loss returns this process's
share of the global batch's loss, so that the shares (and their gradients)
sum over the processes to the loss of the global batch, as the JAX
package's step over a mesh computes it. The statistics that span the batch
are taken over all of it: the masked-pixel count of the flow loss, the 90th
percentile and the renormaliser of the tail weighting, the metrics. With
one process every share is the single-process value, bit for bit.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist


class GlobalBatch:
    """The reductions over a global batch split in equal row blocks over the
    processes of ``group`` (the default group when None)."""

    def __init__(self, group=None) -> None:
        self.group = group
        self.size = dist.get_world_size(group)

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` summed over the processes (no gradient)."""
        x = x.detach().clone()
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=self.group)
        return x

    def mean(self, local_mean: torch.Tensor) -> torch.Tensor:
        """The global mean from each process's mean of its equal block (no gradient)."""
        return self.sum(local_mean / self.size)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every process's ``x`` concatenated along dim 0 in rank order (no gradient)."""
        parts = [torch.empty_like(x) for _ in range(self.size)]
        dist.all_gather(parts, x.detach().contiguous(), group=self.group)
        return torch.cat(parts, dim=0)


def _mean(x: torch.Tensor, batch: Optional[GlobalBatch]) -> torch.Tensor:
    return torch.mean(x) if batch is None else batch.mean(torch.mean(x))


def _iteration_weights(n: int, gamma: float, like: torch.Tensor) -> torch.Tensor:
    """gamma^(n-i-1) sequence weighting."""
    i = torch.arange(n, dtype=like.dtype, device=like.device)
    return gamma ** (n - i - 1.0)


def _nanmean(x: torch.Tensor, dim=None) -> torch.Tensor:
    keep = ~torch.isnan(x)
    return torch.nansum(x, dim=dim) / keep.sum(dim=dim)


def flow_loss(gamma: float, preds: torch.Tensor, gt: torch.Tensor, mask: torch.Tensor,
              batch: Optional[GlobalBatch] = None) -> torch.Tensor:
    """Gamma-weighted masked L1 over the decoder steps. With ``batch``, each
    step's masked sum is divided by the global batch's masked count."""
    w = _iteration_weights(preds.shape[0], gamma, preds)
    err = torch.abs(preds - gt[None])
    masked = torch.where(mask[None], err, torch.nan)
    dims = (1, 2, 3, 4)
    if batch is None:
        per_iter = _nanmean(masked, dim=dims)
    else:
        per_iter = torch.nansum(masked, dim=dims) / batch.sum((~torch.isnan(masked)).sum(dim=dims))
    return torch.sum(w * per_iter)


def cov_loss(gamma: float, preds: torch.Tensor, gt: torch.Tensor, cov_preds: torch.Tensor,
             mask: Optional[torch.Tensor] = None, eps: float = 1e-7,
             tail_weight: float = 0.0, batch: Optional[GlobalBatch] = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Gamma-weighted Gaussian NLL err^2/sigma^2 + log sigma^2, with the
    squared error detached so only the covariance head learns.

    ``tail_weight`` > 0 up-weights the pixels above the batch's 90th
    percentile of EPE^2 (linear interpolation, NaN-masked, as
    ``jnp.nanquantile``) by (1 + tail_weight), renormalized to mean weight 1.
    With ``batch``, the percentile is that of the gathered global batch and
    the renormaliser and the mean are global."""
    w = _iteration_weights(preds.shape[0], gamma, preds)
    exp_cov = cov_preds + eps
    error = torch.square(preds - gt[None]).detach()
    nll = error / exp_cov + torch.log(exp_cov)
    if mask is not None:
        nll = torch.where(mask[None], nll, 0.0)
    if tail_weight > 0.0:
        epe2 = torch.sum(error[-1], dim=-1, keepdim=True)                  # (B,H,W,1)
        masked_epe2 = torch.where(mask, epe2, torch.nan) if mask is not None else epe2
        pool = masked_epe2 if batch is None else batch.gather(masked_epe2)
        thr = torch.nanquantile(pool.flatten(), 0.9)
        w_pix = torch.where(epe2 > thr, 1.0 + tail_weight, 1.0)
        if mask is not None:
            denom = torch.clamp(_mean(torch.where(mask, w_pix, 0.0), batch)
                                / torch.clamp(_mean(mask.to(w_pix.dtype), batch), min=eps), min=eps)
        else:
            denom = torch.clamp(_mean(w_pix, batch), min=eps)
        nll = nll * (w_pix / denom)[None]
    loss = torch.mean(torch.sum(w[:, None, None, None, None] * nll, dim=0))
    return (loss if batch is None else loss / batch.size), error[-1]


def final_cov_loss(preds, gt, cov_preds, mask=None, eps: float = 1e-7, batch: Optional[GlobalBatch] = None):
    """NLL on the final step only."""
    return cov_loss(1.0, preds[-1:], gt, cov_preds[-1:], mask, eps, batch=batch)


def sequence_loss(preds: torch.Tensor, cov_preds: Optional[torch.Tensor], gt: torch.Tensor,
                  flow_mask: Optional[torch.Tensor], gamma: float = 0.85, max_flow: float = 400.0,
                  training_mode: str = "flow", tail_weight: float = 0.0,
                  batch: Optional[GlobalBatch] = None) -> tuple[torch.Tensor, dict]:
    """Loss by training mode: ``flow`` trains the flow branch; ``cov`` and
    ``finalcov`` train the covariance head with the NLL. With ``batch``, the
    loss is this process's share and the metrics are global means."""
    mask = torch.linalg.vector_norm(gt, dim=-1, keepdim=True) < max_flow
    if flow_mask is not None:
        mask = mask & flow_mask.bool()

    metrics: dict = {}
    if training_mode == "flow":
        loss = flow_loss(gamma, preds, gt, mask, batch)
    elif training_mode in ("cov", "finalcov"):
        if cov_preds is None:
            raise ValueError(f"training mode {training_mode!r} needs cov_preds")
        if training_mode == "cov":
            loss, error = cov_loss(gamma, preds, gt, cov_preds, mask, tail_weight=tail_weight, batch=batch)
        else:
            loss, error = final_cov_loss(preds, gt, cov_preds, mask, batch=batch)
        metrics["error"] = _mean(error, batch)
        metrics["cov"] = _mean(cov_preds[-1], batch).detach()
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
