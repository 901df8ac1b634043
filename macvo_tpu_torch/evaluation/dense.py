"""Dense-output evaluation: flow and depth accuracy and covariance calibration
(port of ``macvo_tpu/evaluation/dense.py``).

A sequence streams through the module under test; each frame (or pair) gives
its metrics and the summaries aggregate them as the JAX package does:
``FlowPerformance`` and the covariance summaries by mean, ``DepthPerformance``
by median. The per-frame reductions are NaN-aware means and linearly
interpolated quantiles (``jnp.nanmean`` / ``jnp.nanquantile``): the
per-pixel values in the outputs' type (fp32), as the JAX package computes
them, the reductions in float64, on the module's device.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable

import numpy as np
import torch


def _summary(cls, values, reduce):
    return cls(*[float(reduce([getattr(v, f.name) for v in values])) for f in dataclasses.fields(cls)])


@dataclasses.dataclass
class FlowPerformance:
    masked_epe: float
    epe: float
    px1: float
    px3: float
    px5: float

    @classmethod
    def mean(cls, values: list["FlowPerformance"]) -> "FlowPerformance":
        return _summary(cls, values, np.mean)


@dataclasses.dataclass
class FlowCovPerformance:
    masked_nll: float
    q25_nll: float
    q50_nll: float
    q75_nll: float

    @classmethod
    def mean(cls, values: list["FlowCovPerformance"]) -> "FlowCovPerformance":
        return _summary(cls, values, np.mean)


@dataclasses.dataclass
class DepthPerformance:
    masked_err: float
    err_25: float
    err_50: float
    err_75: float

    @classmethod
    def median(cls, values: list["DepthPerformance"]) -> "DepthPerformance":
        return _summary(cls, values, np.median)


@dataclasses.dataclass
class DepthCovPerformance:
    masked_nll: float
    q25_nll: float
    q50_nll: float
    q75_nll: float

    @classmethod
    def mean(cls, values: list["DepthCovPerformance"]) -> "DepthCovPerformance":
        return _summary(cls, values, np.mean)


def _nan(x: torch.Tensor) -> torch.Tensor:
    return torch.tensor(float("nan"), dtype=x.dtype, device=x.device)


def _flow_metrics(est_flow: torch.Tensor, gt_flow: torch.Tensor, mask: torch.Tensor) -> dict[str, float]:
    """EPE over the finite pixels and, within ``mask`` (B,H,W), the masked EPE
    and the shares under 1, 3 and 5 px."""
    epe = torch.linalg.vector_norm(est_flow - gt_flow, dim=-1)
    finite = torch.isfinite(epe)
    ok = mask & finite
    nan = _nan(epe.double())
    out = {"masked_epe": torch.nanmean(torch.where(ok, epe.double(), nan)),
           "epe": torch.nanmean(torch.where(finite, epe.double(), nan))}
    for px in (1, 3, 5):
        out[f"px{px}"] = torch.nanmean(torch.where(ok, (epe < px).double(), nan))
    return {k: float(v) for k, v in out.items()}


def _gaussian_nll(err_sq: torch.Tensor, var: torch.Tensor, mask: torch.Tensor) -> dict[str, float]:
    """err^2 / var + log var (var floored at 1e-9) where ``mask`` holds and it is
    finite: its mean and its quartiles (linear interpolation)."""
    var = torch.clamp(var, min=1e-9)
    nll = err_sq / var + torch.log(var)
    masked = torch.where(mask & torch.isfinite(nll), nll.double(), _nan(nll.double())).flatten()
    out = {"masked_nll": torch.nanmean(masked)}
    qs = torch.nanquantile(masked, torch.tensor([0.25, 0.5, 0.75], dtype=masked.dtype, device=masked.device))
    out.update(q25_nll=qs[0], q50_nll=qs[1], q75_nll=qs[2])
    return {k: float(v) for k, v in out.items()}


def _pairs(seq) -> Iterable:
    prev = None
    for frame in seq:
        if prev is not None:
            yield prev, frame
        prev = frame


def evaluate_flow(matcher, seq, max_flow: float = 400.0, use_gt_mask: bool = False) -> FlowPerformance:
    """Mean over the consecutive pairs of ``seq`` of the matcher's flow metrics
    against ``gt_flow``, on pixels whose ground truth is under ``max_flow``
    (and inside ``flow_mask`` with ``use_gt_mask``)."""
    results = []
    for f0, f1 in _pairs(seq):
        if f0.stereo.gt_flow is None:
            raise ValueError("evaluate_flow needs frames with gt_flow")
        out = matcher.estimate(f0.stereo, f1.stereo)
        gt = f0.stereo.gt_flow.to(out.flow.device)
        mask = torch.linalg.vector_norm(gt, dim=-1) < max_flow
        if use_gt_mask and f0.stereo.flow_mask is not None:
            mask = mask & f0.stereo.flow_mask.to(mask.device)[..., 0].bool()
        results.append(FlowPerformance(**_flow_metrics(out.flow, gt, mask)))
    return FlowPerformance.mean(results)


def evaluate_flowcov(matcher, seq, max_flow: float = 400.0, use_gt_mask: bool = False) -> FlowCovPerformance:
    """Mean over the pairs of the Gaussian NLL of the flow error under the
    matcher's diagonal covariance."""
    results = []
    for f0, f1 in _pairs(seq):
        out = matcher.estimate(f0.stereo, f1.stereo)
        if out.cov is None:
            raise ValueError("matcher does not provide covariance")
        gt = f0.stereo.gt_flow.to(out.flow.device)
        err_sq = torch.square(out.flow - gt)
        mask = (torch.linalg.vector_norm(gt, dim=-1) < max_flow)[..., None]
        if use_gt_mask and f0.stereo.flow_mask is not None:
            mask = mask & f0.stereo.flow_mask.to(mask.device).bool()
        results.append(FlowCovPerformance(**_gaussian_nll(err_sq, out.cov[..., :2], mask)))
    return FlowCovPerformance.mean(results)


def evaluate_depth(depth_module, seq, max_depth: float = 80.0) -> DepthPerformance:
    """Median over the frames of the depth error's mean and quartiles, on
    finite pixels whose ground truth is under ``max_depth`` (on the host, as
    the JAX package)."""
    results = []
    for frame in seq:
        if frame.stereo.gt_depth is None:
            raise ValueError("evaluate_depth needs frames with gt_depth")
        out = depth_module.estimate(frame.stereo)
        gt = frame.stereo.gt_depth.detach().cpu().numpy()
        err = np.abs(out.depth.detach().cpu().numpy() - gt)
        vals = err[np.isfinite(err) & (gt < max_depth)]
        if vals.size == 0:
            continue
        results.append(DepthPerformance(
            masked_err=float(np.mean(vals)), err_25=float(np.quantile(vals, 0.25)),
            err_50=float(np.quantile(vals, 0.50)), err_75=float(np.quantile(vals, 0.75))))
    return DepthPerformance.median(results)


def evaluate_depthcov(depth_module, seq, max_depth: float = 80.0) -> DepthCovPerformance:
    """Mean over the frames of the Gaussian NLL of the depth error under the
    module's depth variance."""
    results = []
    for frame in seq:
        out = depth_module.estimate(frame.stereo)
        if out.cov is None:
            raise ValueError("depth module does not provide covariance")
        gt = frame.stereo.gt_depth.to(out.depth.device)
        err_sq = torch.square(out.depth - gt)
        results.append(DepthCovPerformance(**_gaussian_nll(err_sq, out.cov, gt < max_depth)))
    return DepthCovPerformance.mean(results)
