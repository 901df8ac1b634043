#!/usr/bin/env python
"""Optical-flow matcher quality of one sequence in the PyTorch/CUDA port
(counterpart of ``scripts/match_quality.py``): one or more matcher configs
on the same sequence, each reported as JSON lines from the port's dense
evaluation (``evaluation/dense.py``):

    python scripts/torch_match_quality.py --data configs/sequence/<seq>.yaml \\
        [--module '{"type": "GTMatcher", "args": {}}'] [--module '{...}']

Runs on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--data", type=str, required=True)
    ap.add_argument("--module", type=str, action="append", default=None,
                    help="matcher config json; repeat to compare several")
    ap.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    modules = args.module or [json.dumps({
        "type": "FlowFormerCovMatcher",
        "args": {"weight": "random:0", "enc_dtype": "bf16", "dec_dtype": "bf16", "decoder_depth": 12},
    })]

    from macvo_tpu_torch.data import DevicePrefetcher, SequenceBase
    from macvo_tpu_torch.evaluation.dense import evaluate_flow, evaluate_flowcov
    from macvo_tpu_torch.modules.frontend import IMatcher
    from macvo_tpu_torch.utils.config import build_dynamic_config, load_config
    from macvo_tpu_torch.utils.device import resolve_device
    from macvo_tpu_torch.utils.logging import Logger

    device = resolve_device(args.device)
    datacfg, _ = load_config(Path(args.data))
    seq = SequenceBase.from_config(datacfg.Sequence if hasattr(datacfg, "Sequence") else datacfg)
    reports = []
    for mod_json in modules:
        mod_cfg, _ = build_dynamic_config(json.loads(mod_json))
        module = IMatcher.instantiate(mod_cfg.type, mod_cfg.args, device=device)
        perf = evaluate_flow(module, DevicePrefetcher(seq, device))
        Logger.info(f"{mod_cfg.type} flow quality on {seq}: {perf}")
        rec = {"module": mod_cfg.type, "flow": perf.__dict__}
        print(json.dumps(rec))
        if getattr(module, "provide_cov", False):
            rec["flow_cov"] = evaluate_flowcov(module, DevicePrefetcher(seq, device)).__dict__
            print(json.dumps({"module": mod_cfg.type, "flow_cov": rec["flow_cov"]}))
        reports.append(rec)
    return reports


if __name__ == "__main__":
    main()
