#!/usr/bin/env python
"""Batch experiment runner of the PyTorch/CUDA port (counterpart of
``scripts/experiment_macvo.py``; reference: Scripts/Experiment/Experiment_MACVO.py).

Runs one odometry config over several sequence configs, each into its own
child of one result sandbox (``<resultRoot>/<name>_batch/<stamp>/<data stem>``,
listed in its ``children.txt``), and writes the per-sequence ATE / RTE / ROE /
RPE RMSE plus their average row to ``evaluation.csv`` in the parent sandbox:

    python scripts/torch_experiment_macvo.py --odom configs/experiment/macvo/MACVO_Performant.yaml \\
        --data configs/sequence/A.yaml configs/sequence/B.yaml [--resultRoot ./results] \\
        [--seq_from N] [--seq_to N] [--device cuda|cpu]

Runs on the card unless ``--device cpu`` is given (``cuda`` without a card raises).
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

HEADERS = ["sequence", "ATE rmse", "RTE rmse", "ROE rmse", "RPE rmse"]


def main(argv=None):
    """Run as the module doc says; returns the parent :class:`Sandbox`."""
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--odom", type=str, required=True)
    parser.add_argument("--data", type=str, nargs="+", required=True)
    parser.add_argument("--resultRoot", type=str, default="./results")
    parser.add_argument("--seq_from", type=int, default=None)
    parser.add_argument("--seq_to", type=int, default=None)
    parser.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"])
    args = parser.parse_args(argv)

    import numpy as np

    from macvo_tpu_torch.__main__ import build_sequence
    from macvo_tpu_torch.data import DevicePrefetcher
    from macvo_tpu_torch.evaluation import evaluate_sandbox
    from macvo_tpu_torch.odometry import build_odometry
    from macvo_tpu_torch.utils.config import load_config
    from macvo_tpu_torch.utils.device import resolve_device
    from macvo_tpu_torch.utils.logging import Logger, print_as_table, save_as_csv
    from macvo_tpu_torch.utils.sandbox import Sandbox

    device = resolve_device(args.device)
    odom_cfg, _ = load_config(Path(args.odom))
    project = getattr(odom_cfg.Odometry, "name", "MACVO")
    parent = Sandbox.create(args.resultRoot, f"{project}_batch")

    rows = []
    for data_path in args.data:
        stem = Path(data_path).stem
        data_cfg, _ = load_config(Path(data_path))
        seq = build_sequence(data_cfg, odom_cfg, args.seq_from, args.seq_to)
        child = parent.new_child(stem)
        Logger.info(f"[{stem}] running {len(seq)} frames")
        system = build_odometry(odom_cfg, device=device)
        system.receive_frames(DevicePrefetcher(seq, device), saveto=child)
        try:
            m = evaluate_sandbox(child)
            rows.append([stem, m["ATE"].rmse, m["RTE"].rmse, m["ROE"].rmse, m["RPE"].rmse])
        except FileNotFoundError:
            rows.append([stem] + [float("nan")] * 4)

    if rows:
        rows.append(["Average"] + [float(np.nanmean([r[i] for r in rows])) for i in range(1, 5)])
    print_as_table(HEADERS, [[r[0]] + [f"{v:.6f}" for v in r[1:]] for r in rows],
                   title=f"{project} batch evaluation")
    save_as_csv(HEADERS, rows, parent.path("evaluation.csv"))
    Logger.info(f"results -> {parent.folder}")
    return parent


if __name__ == "__main__":
    main()
