#!/usr/bin/env python
"""Where a matcher's flow error lives on a ground-truth sequence, in the
PyTorch/CUDA port (counterpart of ``scripts/flow_error_analysis.py``): the
dense EPE bucketed by ground-truth flow magnitude, ground-truth depth band
(the last band is the sky / far field) and image-row band, each bucket's
EPE, pixel share and share of the total error.

    python scripts/torch_flow_error_analysis.py \\
        --data configs/sequence/TartanAirv2_RealAsset.yaml \\
        [--weight model/MACVO_FrontendCov.npz] [--dtype bf16|fp32] [--out <json>]

Same bins, JSON record and printout as the JAX script; the matcher is
FlowFormerCovMatcher on ``--weight`` with 12 decoder steps
(``--decoder_depth``); ``--size`` crops every frame to its center for a
quick run. Runs on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

MAG_BINS = [0.0, 2.0, 8.0, 24.0, 64.0, 400.0]
DEPTH_BINS = [0.0, 5.0, 20.0, 100.0, 1e9]   # last band ≈ sky / far field
ROW_BANDS = 4


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--data", type=str, required=True)
    ap.add_argument("--weight", type=str, default="model/MACVO_FrontendCov.npz")
    ap.add_argument("--dtype", type=str, default="bf16", choices=["bf16", "fp32"])
    ap.add_argument("--decoder_depth", type=int, default=12)
    ap.add_argument("--size", type=int, default=0, help="center crop of every frame (0: none), for a quick run")
    ap.add_argument("--out", type=str, default=None)
    ap.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    from macvo_tpu_torch.data import DevicePrefetcher, SequenceBase
    from macvo_tpu_torch.evaluation.real_asset import CenterCrop
    from macvo_tpu_torch.modules.frontend import IMatcher
    from macvo_tpu_torch.utils.config import build_dynamic_config, load_config
    from macvo_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    datacfg, _ = load_config(Path(args.data))
    seq = SequenceBase.from_config(datacfg.Sequence if hasattr(datacfg, "Sequence") else datacfg)
    if args.size:
        seq = CenterCrop(seq, args.size)
    mcfg, _ = build_dynamic_config({"type": "FlowFormerCovMatcher", "args": {
        "weight": args.weight, "enc_dtype": args.dtype, "dec_dtype": args.dtype,
        "decoder_depth": args.decoder_depth}})
    matcher = IMatcher.instantiate(mcfg.type, mcfg.args, device=device)

    err_all, mag_all, depth_all, row_all = [], [], [], []
    prev = None
    for frame in DevicePrefetcher(seq, device):
        if prev is not None:
            f0, f1 = prev, frame
            if f0.stereo.gt_flow is None:
                raise ValueError("flow error analysis needs a sequence with gt_flow")
            out = matcher.estimate(f0.stereo, f1.stereo)
            flow = out.flow.float().cpu().numpy()[0]
            gt = f0.stereo.gt_flow.float().cpu().numpy()[0]
            err = np.linalg.norm(flow - gt, axis=-1)
            mag = np.linalg.norm(gt, axis=-1)
            h = err.shape[0]
            rows = np.broadcast_to(np.arange(h)[:, None] * ROW_BANDS // h, err.shape)
            err_all.append(err.ravel()); mag_all.append(mag.ravel())
            row_all.append(rows.ravel())
            if f0.stereo.gt_depth is not None:
                depth_all.append(f0.stereo.gt_depth.cpu().numpy()[0, ..., 0].ravel())
        prev = frame

    err = np.concatenate(err_all); mag = np.concatenate(mag_all)
    rows = np.concatenate(row_all)
    depth = np.concatenate(depth_all) if depth_all else None
    valid = mag < 400.0
    rec: dict = {"weight": args.weight, "epe_overall": float(err[valid].mean()),
                 "n_px": int(valid.sum()), "buckets": {}}

    def bucket(name, key, edges):
        rows_out = []
        for lo, hi in zip(edges[:-1], edges[1:]):
            m = valid & (key >= lo) & (key < hi)
            if m.sum() == 0:
                continue
            rows_out.append({
                "range": [float(lo), float(hi)],
                "share_pct": round(100.0 * m.sum() / valid.sum(), 2),
                "epe": round(float(err[m].mean()), 3),
                "epe_contrib_pct": round(100.0 * float(err[m].sum()) / float(err[valid].sum()), 2),
            })
        rec["buckets"][name] = rows_out
        print(f"\n-- by {name}:")
        for r in rows_out:
            print(f"  [{r['range'][0]:>8.1f},{r['range'][1]:>10.1f})  "
                  f"share {r['share_pct']:5.1f}%  EPE {r['epe']:7.3f}  "
                  f"contributes {r['epe_contrib_pct']:5.1f}% of total error")

    print(f"overall EPE {rec['epe_overall']:.3f} px over {rec['n_px']} px")
    bucket("gt_flow_magnitude_px", mag, MAG_BINS)
    if depth is not None:
        bucket("gt_depth_m", depth, DEPTH_BINS)
    bucket("image_row_band", rows, list(range(ROW_BANDS + 1)))

    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(rec, indent=1) + "\n")
        print(f"\nwrote {args.out}")
    return rec


if __name__ == "__main__":
    main()
