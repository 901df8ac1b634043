"""Ablation study of the PyTorch/CUDA port (counterpart of scripts/run_ablations.py).

Runs every ablation config of ``configs/experiment/macvo/ablation/`` (or the
configs given with ``--odom``; with ``--fast`` also ``MACVO_Fast.yaml``) over
one sequence config, in one process, on the card unless ``--device cpu``, and
writes the table ordered by ATE to ``chiprun_out/ablation_table.md`` and
``.json`` (ATE / RTE / ROE rmse, lost-track frames, steady time per frame,
latent-attention launches, peak device memory, and the card's name and power
limit). ``--seeds N`` runs each config with the keypoint generator seeded
0..N-1 and tables the median and range of each metric:

    python scripts/torch_run_ablations.py --data configs/sequence/Synthetic_Holdout.yaml [--fast]
    python scripts/torch_run_ablations.py --data configs/sequence/TartanAirv2_RealAsset.yaml \
        --odom configs/experiment/macvo/Paper_Reproduce.yaml --seeds 8 --out chiprun_out/seeds

The frames are generated or read before each run, so the times are the
odometry's. The configs run as shipped (TwoFrame_PGO in float64, which the
card has); their checkpoint paths are read from the repository root.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def _from_root(cfg) -> None:
    """Checkpoint paths of the config (``./model/...``) resolved against the repository root."""
    for node in (cfg.Odometry.frontend, cfg.Odometry.motion):
        weight = getattr(node.args, "weight", None) if node.args is not None else None
        if weight is not None and not Path(weight).is_absolute():
            node.args.weight = str(ROOT / weight)


def run_variant(name: str, cfg, frames: list, device, seed: int) -> dict:
    import numpy as np
    import torch

    from macvo_tpu_torch.data import DevicePrefetcher
    from macvo_tpu_torch.evaluation import evaluate_all
    from macvo_tpu_torch.odometry import build_odometry
    from macvo_tpu_torch.ops import latent_attn

    _from_root(cfg)
    system = build_odometry(cfg, device=device)
    system.generator.manual_seed(seed)
    stamps = []

    def on_frame(_frame, _odom):
        if device.type == "cuda":
            torch.cuda.synchronize()
        stamps.append(time.perf_counter())

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    latent_attn.latent_cross_attention.launches = 0
    start = time.perf_counter()
    system.receive_frames(DevicePrefetcher(frames, device), on_frame_finished=on_frame)
    n = len(system.graph.frames)
    est = system.graph.frames.data["pose"][:n].astype(np.float64)
    gt = np.stack([np.asarray(f.gt_pose[0]) for f in frames]).astype(np.float64)
    m = evaluate_all(gt, est)
    frame_ms = np.diff(np.array([start] + stamps)) * 1e3
    row = {"variant": name, "seed": seed, "frames": n, "ATE_m": m["ATE"].rmse, "RTE_m_per_frame": m["RTE"].rmse,
           "ROE_deg_per_frame": m["ROE"].rmse, "lost_frames": int(system.graph.frames.data["need_interp"][:n].sum()),
           "steady_frame_ms_median": float(np.median(frame_ms[2:])) if n > 3 else None,
           "latent_attn_launches": latent_attn.latent_cross_attention.launches,
           "finite": bool(np.isfinite(est).all())}
    if device.type == "cuda":
        row["max_memory_allocated_bytes"] = int(torch.cuda.max_memory_allocated())
    return row


def table(rows: list[dict]) -> list[str]:
    """Markdown rows, one a variant, ordered by (median) ATE; with several
    seeds each metric is ``median [min, max]``."""
    import numpy as np

    by_variant: dict[str, list[dict]] = {}
    for r in rows:
        by_variant.setdefault(r["variant"], []).append(r)

    def cell(group, key, fmt="{:.5f}"):
        vals = [g[key] for g in group if g[key] is not None]
        if not vals:
            return "n/a"
        if len(vals) == 1:
            return fmt.format(vals[0])
        return f"{fmt.format(np.median(vals))} [{fmt.format(min(vals))}, {fmt.format(max(vals))}]"

    lines = ["| variant | runs | ATE rmse (m) | RTE rmse (m/f) | ROE rmse (deg/f) | lost frames | steady ms/frame |",
             "|---|---|---|---|---|---|---|"]
    for name, group in sorted(by_variant.items(), key=lambda kv: np.median([g["ATE_m"] for g in kv[1]])):
        lines.append(f"| {name} | {len(group)} | {cell(group, 'ATE_m')} | {cell(group, 'RTE_m_per_frame')} | "
                     f"{cell(group, 'ROE_deg_per_frame')} | {cell(group, 'lost_frames', '{:.0f}')} | "
                     f"{cell(group, 'steady_frame_ms_median', '{:.1f}')} |")
    return lines


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--data", required=True, help="sequence config yaml")
    ap.add_argument("--odom", nargs="+", default=None,
                    help="odometry configs to run (default: every config of configs/experiment/macvo/ablation)")
    ap.add_argument("--fast", action="store_true", help="also run configs/experiment/macvo/MACVO_Fast.yaml")
    ap.add_argument("--seeds", type=int, default=1, help="runs of each config, keypoint generator seeded 0..N-1")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--out", default=str(ROOT / "chiprun_out/ablation_table"), help="path without suffix")
    args = ap.parse_args()

    import torch

    from macvo_tpu_torch.data import SequenceBase
    from macvo_tpu_torch.utils.config import load_config
    from macvo_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    configs = ([Path(p) for p in args.odom] if args.odom
               else sorted((ROOT / "configs/experiment/macvo/ablation").glob("*.yaml")))
    if args.fast:
        configs.append(ROOT / "configs/experiment/macvo/MACVO_Fast.yaml")
    seq = SequenceBase.from_config(load_config(Path(args.data))[0].Sequence)
    t0 = time.perf_counter()
    frames = [seq[i] for i in range(len(seq))]
    data_s = time.perf_counter() - t0
    card = ""
    if device.type == "cuda":
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]

    rows = []
    for path in configs:
        name = path.stem.replace("TartanAirv2_", "")
        for seed in range(args.seeds):
            t0 = time.perf_counter()
            row = run_variant(name, load_config(path)[0], frames, device, seed)
            row["wall_s"] = time.perf_counter() - t0
            print(json.dumps(row), flush=True)
            rows.append(row)
    rows.sort(key=lambda r: r["ATE_m"])

    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    meta = {"data": args.data, "frames": len(frames), "data_s": data_s, "seeds": args.seeds, "device": str(device),
            "card": card, "torch": torch.__version__, "weight": "model/MACVO_FrontendCov.npz",
            "script": "scripts/torch_run_ablations.py"}
    out.with_suffix(".json").write_text(json.dumps({"meta": meta, "rows": rows}, indent=1) + "\n")
    lines = [f"<!-- {json.dumps(meta)} -->"] + table(rows)
    out.with_suffix(".md").write_text("\n".join(lines) + "\n")
    print("\n".join(lines))


if __name__ == "__main__":
    main()
