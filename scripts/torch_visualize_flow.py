#!/usr/bin/env python
"""Flow colour-wheel figures of a sequence in the PyTorch/CUDA port
(counterpart of ``scripts/visualize_flow.py``): for each of the first
``--max_frames`` pairs, the left image beside the matcher's flow, one PNG a
pair (needs matplotlib):

    python scripts/torch_visualize_flow.py --data configs/sequence/<seq>.yaml \\
        [--module '{"type": "GTMatcher", "args": {}}'] [--out results/flow]

Runs on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main(argv=None) -> list[Path]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--data", type=str, required=True)
    ap.add_argument("--module", type=str, default=json.dumps({"type": "GTMatcher", "args": {}}))
    ap.add_argument("--out", type=str, default="results/flow")
    ap.add_argument("--max_frames", type=int, default=10)
    ap.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from macvo_tpu_torch.data import SequenceBase
    from macvo_tpu_torch.modules.frontend import IMatcher
    from macvo_tpu_torch.utils.config import build_dynamic_config, load_config
    from macvo_tpu_torch.utils.device import resolve_device
    from macvo_tpu_torch.utils.logging import Logger
    from macvo_tpu_torch.viz.plot_axes import flow_to_color

    device = resolve_device(args.device)
    datacfg, _ = load_config(Path(args.data))
    seq = SequenceBase.from_config(datacfg.Sequence if hasattr(datacfg, "Sequence") else datacfg)
    mod_cfg, _ = build_dynamic_config(json.loads(args.module))
    matcher = IMatcher.instantiate(mod_cfg.type, mod_cfg.args, device=device)

    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    written = []
    prev = None
    for i in range(min(len(seq), args.max_frames + 1)):
        frame = seq[i].to(device)
        if prev is not None:
            flow = matcher.estimate(prev.stereo, frame.stereo).flow[0].float().cpu().numpy()
            fig, axes = plt.subplots(1, 2, figsize=(12, 4), dpi=120)
            axes[0].imshow(prev.stereo.imageL[0].float().cpu().numpy())
            axes[0].set_title(f"frame {i - 1}")
            axes[1].imshow(flow_to_color(flow))
            axes[1].set_title("flow")
            for ax in axes:
                ax.axis("off")
            fig.tight_layout()
            written.append(out / f"flow_{i - 1:04d}.png")
            fig.savefig(written[-1])
            plt.close(fig)
        prev = frame
    Logger.info(f"flow visualizations -> {out}")
    return written


if __name__ == "__main__":
    main()
