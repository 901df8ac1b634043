"""Step parity of the port's training step, card against CPU, with cuDNN on and off.

    python scripts/torch_train_step_parity.py [--out chiprun_out/step_parity.json]

Runs ``chip_smoke.step_parity`` (one fp32 flow step of
``configs/train/FlowFormerCov_synth.yaml`` from ``model/MACVO_FrontendCov.npz``
on the 1x96x128 crop of the first ``FlowFormerCov_synth_cov.yaml`` batch that
``chip_smoke.py`` uses) twice: with cuDNN's convolution algorithms off, as
``chip_smoke.py`` gates it, and on, as training runs. Prints one JSON line a
setting, plus the card's name and power limit, and writes them to ``--out``.
It gates nothing: ``chip_smoke.py`` holds the cuDNN-off run to its bounds.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", default=str(ROOT / "chiprun_out/step_parity.json"))
    args = parser.parse_args()

    import numpy as np
    import torch

    import chip_smoke
    from macvo_tpu_torch.data.datasets.train import TrainPairDataset
    from macvo_tpu_torch.utils.config import load_config

    if not torch.cuda.is_available():
        print("torch_train_step_parity: needs one NVIDIA card", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    cfg = load_config(ROOT / "configs/train/FlowFormerCov_synth_cov.yaml")[0]
    dataset = TrainPairDataset(cfg.Data.Sequences, cfg.Data.transforms, stereo_prob=float(cfg.Data.stereo_prob))
    batch = dataset.draw(int(cfg.Train.batch_size), int(cfg.Train.image_height), int(cfg.Train.image_width),
                         np.random.default_rng(int(cfg.Train.seed)))
    crop = {k: v[:1, :96, :128] for k, v in batch.items()}
    recs = {"nvidia_smi": smi, "bounds_with_cudnn_off": chip_smoke.PARITY_BOUNDS}
    for cudnn in (False, True):
        recs[f"cudnn_{'on' if cudnn else 'off'}"] = rec = chip_smoke.step_parity(torch.device("cuda"), crop, cudnn)
        print(json.dumps(rec), flush=True)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(recs, indent=1))
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
