#!/usr/bin/env python
"""Stereo-depth quality of one sequence in the PyTorch/CUDA port
(counterpart of ``scripts/depth_quality.py``).

Streams a sequence through an IStereoDepth module and prints the depth
accuracy and, where the module gives a covariance, its calibration, as JSON
lines from the port's dense evaluation (``evaluation/dense.py``):

    python scripts/torch_depth_quality.py --data configs/sequence/<seq>.yaml \\
        [--module '{"type": "GTDepth", "args": {}}'] [--max_depth 80]

Runs on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--data", type=str, required=True)
    ap.add_argument("--module", type=str, default=json.dumps({
        "type": "FlowFormerCovDepth",
        "args": {"weight": "random:0", "enc_dtype": "bf16", "dec_dtype": "bf16", "decoder_depth": 12},
    }))
    ap.add_argument("--max_depth", type=float, default=80.0)
    ap.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    from macvo_tpu_torch.data import DevicePrefetcher, SequenceBase
    from macvo_tpu_torch.evaluation.dense import evaluate_depth, evaluate_depthcov
    from macvo_tpu_torch.modules.frontend import IStereoDepth
    from macvo_tpu_torch.utils.config import build_dynamic_config, load_config
    from macvo_tpu_torch.utils.device import resolve_device
    from macvo_tpu_torch.utils.logging import Logger

    device = resolve_device(args.device)
    datacfg, _ = load_config(Path(args.data))
    seq = SequenceBase.from_config(datacfg.Sequence if hasattr(datacfg, "Sequence") else datacfg)
    mod_cfg, _ = build_dynamic_config(json.loads(args.module))
    module = IStereoDepth.instantiate(mod_cfg.type, mod_cfg.args, device=device)

    perf = evaluate_depth(module, DevicePrefetcher(seq, device), max_depth=args.max_depth)
    Logger.info(f"Depth quality on {seq}: {perf}")
    out = {"depth": perf.__dict__}
    print(json.dumps(out))
    if getattr(module, "provide_cov", False):
        out["depth_cov"] = evaluate_depthcov(module, DevicePrefetcher(seq, device), max_depth=args.max_depth).__dict__
        print(json.dumps({"depth_cov": out["depth_cov"]}))
    return out


if __name__ == "__main__":
    main()
