#!/usr/bin/env python
"""Covariance calibration of a FlowFormerCov checkpoint in the PyTorch/CUDA
port (counterpart of ``scripts/cov_calibration.py``).

For the first ``--max_pairs`` pairs of the real clip (``--data real``) or of a
SyntheticStereo sequence (``--data synthetic``), through FlowFormerCovFrontend:

* the masked flow EPE and Gaussian NLL;
* the chi-square coverage: the share of pixels whose normalized squared error
  err_u^2/sigma_u^2 + err_v^2/sigma_v^2 is under the chi2(2) quantiles at
  50/90/95 % (a calibrated head meets the nominal levels, an overconfident
  one falls short);
* a ``GridRecorder`` density of log10 predicted sigma against log10 |error|.

Writes ``<out>.json`` and ``<out>_grid.npz`` always, and ``<out>.png`` where
matplotlib is installed:

    python scripts/torch_cov_calibration.py --weight model/MACVO_FrontendCov.npz --data real \\
        [--out results/cov_calibration] [--calib none|auto|<file>] [--max_pairs 6]

Runs on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from types import SimpleNamespace

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np

# chi2(2) quantiles at 50/90/95 %
CHI2_2 = {"p50": 1.386, "p90": 4.605, "p95": 5.991}
ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--weight", type=str, default="model/MACVO_FrontendCov.npz")
    ap.add_argument("--data", choices=["real", "synthetic"], default="real")
    ap.add_argument("--out", type=str, default="results/cov_calibration")
    ap.add_argument("--max_pairs", type=int, default=6)
    ap.add_argument("--calib", type=str, default="none",
                    help="'none' (raw head), 'auto' (<weight>.calib.json if present), or a temperature file")
    ap.add_argument("--decoder_depth", type=int, default=12)
    ap.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    from macvo_tpu_torch.modules.frontend import IFrontend
    from macvo_tpu_torch.utils.device import resolve_device
    from macvo_tpu_torch.utils.extensions import GridRecorder

    device = resolve_device(args.device)
    if args.data == "real":
        from macvo_tpu_torch.data.datasets.tartanair import TartanAirV2
        seq = TartanAirV2({"root": str(ROOT / "assets/test_sequence/TartanAir2_abs_P000"), "compressed": True,
                           "gtFlow": True, "gtDepth": True, "gtPose": True})
    else:
        from macvo_tpu_torch.data.datasets.synthetic import SyntheticStereo
        seq = SyntheticStereo({"n_frames": args.max_pairs + 1, "width": 320, "height": 240, "fx": 160.0,
                               "fy": 160.0, "seed": 123, "traj_seed": 17})

    fe = IFrontend.instantiate("FlowFormerCovFrontend", SimpleNamespace(
        weight=args.weight, enc_dtype="fp32", dec_dtype="fp32", decoder_depth=args.decoder_depth,
        enforce_positive_disparity=False, cov_calib=args.calib), device=device)

    grid = GridRecorder((-2.0, 2.0), (-2.0, 2.0), bins=(80, 80))
    nlls, epes, cov = [], [], {k: [] for k in CHI2_2}
    n = min(args.max_pairs, len(seq) - 1)
    for i in range(n):
        f0, f1 = seq[i].to(device), seq[i + 1].to(device)
        _, match = fe.estimate_pair(f0.stereo, f1.stereo)
        if match.cov is None:
            raise ValueError("the frontend must predict a flow covariance")
        est = match.flow[0].double().cpu().numpy()
        gt = f0.stereo.gt_flow[0].double().cpu().numpy()
        mask = f0.stereo.flow_mask[0, ..., 0].cpu().numpy() > 0.5
        if match.mask is not None:
            mask &= match.mask[0, ..., 0].cpu().numpy()
        var = np.maximum(match.cov[0, ..., :2].double().cpu().numpy(), 1e-12)   # (H,W,2) sigma_uu, sigma_vv
        err = est - gt
        epe = np.sqrt((err ** 2).sum(-1))
        nll = 0.5 * ((err ** 2) / var + np.log(var) + np.log(2 * np.pi)).sum(-1)
        chi2 = ((err ** 2) / var).sum(-1)
        epes.append(float(epe[mask].mean()))
        nlls.append(float(nll[mask].mean()))
        for k, q in CHI2_2.items():
            cov[k].append(float((chi2[mask] < q).mean()))
        grid.record(np.log10(np.sqrt(var[mask]).ravel()), np.log10(np.abs(err[mask]).ravel() + 1e-6))

    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    rec = {"weight": args.weight, "data": args.data, "pairs": n, "calib": args.calib,
           "epe": float(np.mean(epes)), "nll": float(np.mean(nlls)),
           "chi2_coverage": {k: float(np.mean(v)) for k, v in cov.items()},
           "nominal": {"p50": 0.50, "p90": 0.90, "p95": 0.95}}
    Path(str(out) + ".json").write_text(json.dumps(rec, indent=1) + "\n")
    grid.save(str(out) + "_grid.npz")
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        fig, ax = plt.subplots(figsize=(5, 5))
        ax.imshow(grid.density.T, origin="lower", extent=(-2, 2, -2, 2), aspect="auto", cmap="viridis")
        ax.plot([-2, 2], [-2, 2], "w--", lw=1, label="calibrated")
        ax.set_xlabel("log10 predicted sigma (px)")
        ax.set_ylabel("log10 |flow error| (px)")
        ax.set_title(f"cov calibration — {args.data}")
        ax.legend()
        fig.tight_layout()
        fig.savefig(str(out) + ".png", dpi=120)
        plt.close(fig)
    except Exception as e:  # noqa: BLE001
        print("plot skipped:", e)
    print(json.dumps(rec, indent=1))
    return rec


if __name__ == "__main__":
    main()
