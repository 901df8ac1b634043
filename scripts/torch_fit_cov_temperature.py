#!/usr/bin/env python
"""Fit per-band covariance temperatures of a FlowFormerCov checkpoint on a
holdout world, in the PyTorch/CUDA port (counterpart of
``scripts/fit_cov_temperature.py``).

Pixels are split into ``--bands`` bands by quantiles of the predicted
log10 sigma (the per-pixel mean variance, as the frontend bands them when it
applies the file), and each band's variance is scaled by its NLL-optimal
temperature

    tau2_b = mean over band b of (err_u^2/var_u + err_v^2/var_v) / 2

(a band with fewer than 100 pixels keeps 1). The fit is written as JSON
(``log10_sigma_edges``, ``tau2``, ``fit_coverage_raw``,
``fit_coverage_recalibrated``) to ``--out``, or to ``<weight>.calib.json``,
which every later ``cov_calib: auto`` run of that weight loads:

    python scripts/torch_fit_cov_temperature.py --weight model/MACVO_FrontendCov.npz \\
        --root data/randomized/seq_1049 --out results/calib/MACVO_FrontendCov.calib.json

Runs on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np

CHI2_2 = {"p50": 1.386, "p90": 4.605, "p95": 5.991}


def coverage(chi2: np.ndarray, mask: np.ndarray) -> dict:
    return {k: float((chi2[mask] < q).mean()) for k, q in CHI2_2.items()}


def collect(matcher, seq, max_pairs: int, device) -> tuple[np.ndarray, ...]:
    """Per valid pixel of the first ``max_pairs`` pairs: (var_u, var_v, err_u^2, err_v^2)."""
    sig2_u, sig2_v, err_u2, err_v2 = [], [], [], []
    for i in range(min(max_pairs, len(seq) - 1)):
        f0, f1 = seq[i].to(device), seq[i + 1].to(device)
        match = matcher.estimate(f0.stereo, f1.stereo)
        est = match.flow[0].double().cpu().numpy()
        gt = f0.stereo.gt_flow[0].double().cpu().numpy()
        mask = f0.stereo.flow_mask[0, ..., 0].cpu().numpy() > 0.5
        var = np.maximum(match.cov[0, ..., :2].double().cpu().numpy(), 1e-12)
        err = est - gt
        sig2_u.append(var[mask, 0])
        sig2_v.append(var[mask, 1])
        err_u2.append(err[mask, 0] ** 2)
        err_v2.append(err[mask, 1] ** 2)
        print(f"[fit] pair {i}: epe={np.sqrt((err ** 2).sum(-1))[mask].mean():.3f} px", flush=True)
    return tuple(np.concatenate(x) for x in (sig2_u, sig2_v, err_u2, err_v2))


def fit(s2u, s2v, e2u, e2v, bands: int) -> dict:
    """Band edges, temperatures and the fit's coverage before and after."""
    log_sigma = 0.5 * np.log10(0.5 * (s2u + s2v))
    edges = np.quantile(log_sigma, np.linspace(0, 1, bands + 1)[1:-1])
    idx = np.searchsorted(edges, log_sigma)
    z2 = 0.5 * (e2u / s2u + e2v / s2v)
    tau2 = np.ones(bands)
    for b in range(bands):
        sel = idx == b
        if sel.sum() >= 100:
            tau2[b] = float(z2[sel].mean())
    chi2_raw = 2.0 * z2
    everything = np.ones(len(z2), bool)
    return {"log10_sigma_edges": [float(x) for x in edges], "tau2": [float(x) for x in tau2],
            "fit_coverage_raw": coverage(chi2_raw, everything),
            "fit_coverage_recalibrated": coverage(chi2_raw / tau2[idx], everything)}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--weight", type=str, required=True)
    ap.add_argument("--root", type=str, default="data/randomized/seq_1049")
    ap.add_argument("--max_pairs", type=int, default=16)
    ap.add_argument("--bands", type=int, default=8)
    ap.add_argument("--dtype", type=str, default="bf16", help="network dtype of the fit's forwards")
    ap.add_argument("--decoder_depth", type=int, default=12)
    ap.add_argument("--out", type=str, default=None, help="default: <weight>.calib.json")
    ap.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    from macvo_tpu_torch.data.datasets.tartanair import TartanAir
    from macvo_tpu_torch.modules.frontend import IMatcher
    from macvo_tpu_torch.utils.config import build_dynamic_config
    from macvo_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    seq = TartanAir({"root": args.root, "gtFlow": True, "gtDepth": False, "gtPose": True})
    mcfg, _ = build_dynamic_config({"type": "FlowFormerCovMatcher", "args": {
        "weight": args.weight, "enc_dtype": args.dtype, "dec_dtype": args.dtype,
        "decoder_depth": args.decoder_depth, "cov_calib": "none"}})
    matcher = IMatcher.instantiate(mcfg.type, mcfg.args, device=device)
    samples = collect(matcher, seq, args.max_pairs, device)
    rec = {"weight": args.weight, "fit_root": args.root, "pairs": min(args.max_pairs, len(seq) - 1),
           "bands": args.bands, **fit(*samples, args.bands),
           "nominal": {"p50": 0.50, "p90": 0.90, "p95": 0.95},
           "note": "variance temperatures per log10(sigma) band, fitted on a holdout world; the "
                   "frontend applies them (cov_calib) when this file sits next to the weight npz."}
    out = Path(args.out) if args.out else Path(args.weight).with_suffix(".calib.json")
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(rec, indent=1) + "\n")
    print(json.dumps({k: rec[k] for k in ("tau2", "fit_coverage_raw", "fit_coverage_recalibrated")}, indent=1))
    print(f"[fit] wrote {out}")
    return rec


if __name__ == "__main__":
    main()
