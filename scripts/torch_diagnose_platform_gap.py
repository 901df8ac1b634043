"""How much of the card-vs-CPU accuracy gap of the PyTorch/CUDA port is
precision (counterpart of ``scripts/diagnose_platform_gap.py``, which split
the TPU-vs-CPU gap of the JAX package).

On the card an fp32 matmul or convolution may run on TF32 tensor cores
(10-bit mantissa) when ``allow_tf32`` is on, as many PyTorch users set it.
The port's policy turns TF32 off for its fp32 networks
(``utils/precision.py: tf32_off``), and its geometry runs at full
precision whatever the caller set (``matmul_highest``). This script measures
what TF32 would cost, with the shipped checkpoint in fp32, in one process:

  stage A  dense flow EPE / px1 / px3 of FlowFormerCovMatcher (12 decoder
           steps) on the real clip's pairs, on the card under the port's
           policy (``card_policy``, TF32 off), on the card with TF32 on
           (``card_tf32``), and on the CPU (``cpu``); plus the mean
           |flow difference| of each pair of legs on the first pairs
  stage B  full E2E (ATE / RTE / ROE, the config of
           ``evaluation/real_asset.py: make_config``) on the card, TF32 off
           and on (the network only: the geometry's guard keeps it off there)
  stage C  the same E2E on the CPU (the reference point; slow)

    python scripts/torch_diagnose_platform_gap.py [--stages AB] [--pairs N] [--cpu_pairs N]
        [--out chiprun_out/platform_gap.json]

The record goes to ``--out`` (default ``chiprun_out/platform_gap.json``,
which git ignores). Runs on the card unless ``--device cpu`` is given (the
"card" legs then run on the CPU: a smoke run, with ``--size`` a center crop).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

OUT = REPO / "chiprun_out" / "platform_gap.json"
WEIGHT = str(REPO / "model" / "MACVO_FrontendCov.npz")
LEGS = ("card_policy", "card_tf32", "cpu")
DELTA_PAIRS = 3          # the first pairs whose flow maps are compared, as the JAX script


def _policy(tf32: bool):
    from macvo_tpu_torch.utils.precision import tf32_enabled

    return tf32_enabled() if tf32 else contextlib.nullcontext()


def mean_abs_delta(a: dict, b: dict) -> list[float]:
    """Mean |flow difference| in px of two legs, pair by pair (the pairs both ran)."""
    import numpy as np

    return [float(np.abs(x - y).mean()) for x, y in zip(a["_flows"], b["_flows"])]


class _Recording:
    """A matcher that keeps the flow maps (float64, host) of its first ``n`` estimates."""

    def __init__(self, matcher, n: int) -> None:
        self.matcher, self.n, self.flows = matcher, n, []

    def estimate(self, s0, s1):
        out = self.matcher.estimate(s0, s1)
        if len(self.flows) < self.n:
            self.flows.append(out.flow[0].double().cpu().numpy())
        return out


def flow_leg(seq, device, tf32: bool, weight: str, decoder_depth: int) -> dict:
    """Dense flow metrics of the matcher over ``seq``'s pairs, and the flow
    maps of its first DELTA_PAIRS pairs."""
    import torch

    from macvo_tpu_torch.data import DevicePrefetcher
    from macvo_tpu_torch.evaluation.dense import evaluate_flow
    from macvo_tpu_torch.modules.frontend import IMatcher
    from macvo_tpu_torch.utils.config import build_dynamic_config

    device = torch.device(device)
    mcfg, _ = build_dynamic_config({"type": "FlowFormerCovMatcher", "args": {
        "weight": weight, "enc_dtype": "fp32", "dec_dtype": "fp32", "decoder_depth": decoder_depth,
        "cov_calib": "none"}})
    matcher = _Recording(IMatcher.instantiate(mcfg.type, mcfg.args, device=device), DELTA_PAIRS)
    start = time.perf_counter()
    with _policy(tf32), torch.inference_mode():
        perf = evaluate_flow(matcher, DevicePrefetcher(seq, device))
    return {"epe": float(perf.epe), "px1": float(perf.px1), "px3": float(perf.px3), "pairs": len(seq) - 1,
            "secs": time.perf_counter() - start, "_flows": matcher.flows}


def e2e_leg(device, tf32: bool, weight: str, decoder_depth: int, size: int = 0) -> dict:
    from macvo_tpu_torch.evaluation.real_asset import make_config, real_sequence, run_and_evaluate

    cfg = make_config({"type": "FlowFormerCovFrontend", "args": {
        "weight": weight, "enc_dtype": "fp32", "dec_dtype": "fp32",
        "decoder_depth": decoder_depth, "enforce_positive_disparity": False}})
    start = time.perf_counter()
    m = run_and_evaluate(cfg, real_sequence(gt_frontend=False, size=size), device, policy=_policy(tf32))
    return {k: float(v.rmse) for k, v in m.items()} | {"secs": time.perf_counter() - start}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--stages", type=str, default="AB")
    ap.add_argument("--pairs", type=int, default=0, help="card legs' pairs of stage A (0: all)")
    ap.add_argument("--cpu_pairs", type=int, default=0, help="the CPU leg's pairs of stage A (0: all)")
    ap.add_argument("--weight", type=str, default=WEIGHT)
    ap.add_argument("--decoder_depth", type=int, default=12)
    ap.add_argument("--size", type=int, default=0, help="center crop of the clip (0: the full 640x640)")
    ap.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"],
                    help="the card legs' device (cpu: a smoke run of the script)")
    ap.add_argument("--out", type=str, default=str(OUT))
    args = ap.parse_args(argv)

    import torch

    from macvo_tpu_torch.evaluation.real_asset import real_sequence
    from macvo_tpu_torch.utils.device import resolve_device

    card = resolve_device(args.device)
    rec: dict = {"device": torch.cuda.get_device_name(card) if card.type == "cuda" else "cpu",
                 "weight": args.weight, "decoder_depth": args.decoder_depth, "size": args.size or 640,
                 "measured_utc": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime())}

    if "A" in args.stages:
        def pairs(n):
            return real_sequence(gt_frontend=True, frames=n + 1 if n else 0, size=args.size)

        legs = {name: flow_leg(pairs(n), device, tf32, args.weight, args.decoder_depth)
                for name, n, device, tf32 in (("card_policy", args.pairs, card, False),
                                              ("card_tf32", args.pairs, card, True),
                                              ("cpu", args.cpu_pairs, torch.device("cpu"), False))}
        for name in LEGS:
            print(name, json.dumps({k: legs[name][k] for k in ("epe", "px1", "px3", "pairs", "secs")}), flush=True)
        rec["stageA"] = {
            "flow": {name: {k: legs[name][k] for k in ("epe", "px1", "px3", "pairs", "secs")} for name in LEGS},
            "mean_abs_flow_delta_px": {
                "card_tf32_vs_cpu": mean_abs_delta(legs["card_tf32"], legs["cpu"]),
                "card_policy_vs_cpu": mean_abs_delta(legs["card_policy"], legs["cpu"]),
                "card_tf32_vs_policy": mean_abs_delta(legs["card_tf32"], legs["card_policy"]),
            },
        }
        print(json.dumps(rec["stageA"], indent=1), flush=True)

    if "B" in args.stages:
        rec["stageB_e2e"] = {"card_policy": e2e_leg(card, False, args.weight, args.decoder_depth, args.size),
                             "card_tf32": e2e_leg(card, True, args.weight, args.decoder_depth, args.size)}
        print(json.dumps(rec["stageB_e2e"], indent=1), flush=True)

    if "C" in args.stages:
        rec["stageC_e2e_cpu"] = e2e_leg(torch.device("cpu"), False, args.weight, args.decoder_depth, args.size)
        print(json.dumps(rec["stageC_e2e_cpu"], indent=1), flush=True)

    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(rec, indent=1) + "\n")
    print(f"wrote {args.out}")
    return rec


if __name__ == "__main__":
    main()
