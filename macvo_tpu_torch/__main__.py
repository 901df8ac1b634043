"""MAC-VO runner of the PyTorch/CUDA port (counterpart of ``macvo.py``).

Usage:
    python -m macvo_tpu_torch --odom configs/experiment/macvo/MACVO_Performant.yaml \\
                              --data configs/sequence/TartanAirv2_RealAsset.yaml
    python -m macvo_tpu_torch --odom configs/experiment/baseline/TartanVO.yaml \\
                              --data configs/sequence/TartanAirv2_RealAsset.yaml

Builds the odometry class the config's ``Odometry.type`` names (``MACVO``,
the default, or the ``TartanVO`` baseline), runs it over the sequence on
``--device`` (``cuda`` by default), writes ``config.yaml`` (the odometry
config, with the sequence config as ``Data``), ``poses.npy`` /
``ref_poses.npy`` / ``tensor_map.npz`` (and, with ``profile: true``, a trace
of frame 2 under ``trace/``) into ``<resultRoot>/<name>_<time>/`` and, unless
``--noeval``, prints ATE, RTE, ROE and RPE against the ground truth
interpolated onto the estimate's timestamps.
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path


def build_sequence(data_cfg, odom_cfg, seq_from=None, seq_to=None):
    from .data import SequenceBase

    seq = SequenceBase.from_config(data_cfg.Sequence if hasattr(data_cfg, "Sequence") else data_cfg)
    if seq_from is not None or seq_to is not None:
        seq.clip(seq_from, seq_to)
    pre = getattr(odom_cfg, "Preprocess", None)
    # As macvo_tpu/data/sequence.py:smart_transform reads it: a list applies to any
    # sequence, a mapping by the sequence's type name.
    if isinstance(pre, dict):
        pre = pre.get(seq.name())
    elif pre is not None and not isinstance(pre, list):
        pre = getattr(pre, seq.name(), None)
    if pre:
        raise NotImplementedError(f"the runner does not apply Preprocess transforms yet; {seq.name()} needs {pre}")
    return seq


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="MAC-VO odometry runner (PyTorch/CUDA port)")
    parser.add_argument("--odom", type=str, required=True, help="odometry config yaml")
    parser.add_argument("--data", type=str, default=None,
                        help="sequence config yaml (default: Data section of --odom)")
    parser.add_argument("--seq_from", type=int, default=None, help="clip start frame")
    parser.add_argument("--seq_to", type=int, default=None, help="clip end frame")
    parser.add_argument("--resultRoot", type=str, default="./results")
    parser.add_argument("--noeval", action="store_true", help="skip metric evaluation")
    parser.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"])
    args = parser.parse_args(argv)

    from .data import DevicePrefetcher
    from .evaluation import evaluate_sandbox
    from .odometry import build_odometry
    from .utils.config import load_config, save_config
    from .utils.device import resolve_device

    device = resolve_device(args.device)
    odom_cfg, odom_dict = load_config(Path(args.odom))
    if args.data is not None:
        data_cfg, odom_dict["Data"] = load_config(Path(args.data))
    else:
        data_cfg = odom_cfg.Data
    seq = build_sequence(data_cfg, odom_cfg, args.seq_from, args.seq_to)
    name = getattr(odom_cfg.Odometry, "name", "MACVO")
    out_dir = Path(args.resultRoot) / f"{name}_{time.strftime('%m_%d_%H%M%S')}"
    out_dir.mkdir(parents=True, exist_ok=True)
    save_config(odom_dict, out_dir / "config.yaml")

    system = build_odometry(odom_cfg, device=device)
    print(f"Running {name} on {seq} ({device}) -> {out_dir}", flush=True)
    system.receive_frames(DevicePrefetcher(seq, device), saveto=out_dir)

    if not args.noeval and (out_dir / "ref_poses.npy").exists():
        metrics = evaluate_sandbox(out_dir)
        print(f"{'metric':<6} {'mean':>10} {'std':>10} {'rmse':>10} {'max':>10}")
        for k, v in metrics.items():
            print(f"{k:<6} {v.mean:10.6f} {v.std:10.6f} {v.rmse:10.6f} {v.max:10.6f}")


if __name__ == "__main__":
    main()
