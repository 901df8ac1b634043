"""Accuracy record of the JAX package on the real clip written as a KITTI
odometry sequence: the reference for the ``datasets`` phase (``kitti``) of
``chip_smoke.py``.

    JAX_PLATFORMS=cpu python scripts/jax_kitti_record.py [--odom configs/experiment/macvo/MACVO_Performant.yaml]
        [--seq_to N] [--out results/jax_kitti_record]

Writes the layout with ``chip_smoke.py``'s own writer (the 10 frames at
640x640, K and baseline of the clip, ``poses/00.txt`` as EDN camera
matrices), runs ``macvo.py --device cpu`` on it (the config's ``Preprocess``
resizes the frames to 376x780), and prints one JSON line with ATE, RTE and
ROE (rmse) of the runner's result directory and the wall time.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import yaml

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--odom", default="configs/experiment/macvo/MACVO_Performant.yaml")
    parser.add_argument("--seq_to", type=int, default=None)
    parser.add_argument("--out", default=str(ROOT / "results/jax_kitti_record"))
    args = parser.parse_args()

    from chip_smoke import CLIP_BASELINE, CLIP_K, read_clip, write_kitti_layout

    out = Path(args.out)
    clip = read_clip(10)
    root = write_kitti_layout(out / "kitti", clip["left"], clip["right"], CLIP_K, CLIP_BASELINE,
                              clip["times_s"], clip["poses"])
    data = out / "kitti.yaml"
    data.write_text(yaml.safe_dump({"Sequence": {"type": "KITTI", "args": {"root": str(root), "gt_pose": True}}}))
    argv = [sys.executable, "macvo.py", "--odom", args.odom, "--data", str(data), "--device", "cpu",
            "--resultRoot", str(out / "results"), "--noeval"]
    if args.seq_to is not None:
        argv += ["--seq_to", str(args.seq_to)]
    start = time.perf_counter()
    subprocess.run(argv, cwd=ROOT, check=True, env={**os.environ, "JAX_PLATFORMS": "cpu"})
    wall = time.perf_counter() - start

    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    from macvo_tpu.evaluation import evaluate_sandbox
    from macvo_tpu.utils.sandbox import Sandbox

    result = max((p.parent for p in (out / "results").rglob("poses.npy")), key=lambda p: p.stat().st_mtime)
    metrics = evaluate_sandbox(Sandbox.load(result))
    print(json.dumps({"odom": args.odom, "frames": args.seq_to or 10, "result": str(result.relative_to(ROOT)),
                      "wall_s": wall, "jax": jax.__version__,
                      **{k: float(metrics[k].rmse) for k in ("ATE", "RTE", "ROE")}}), flush=True)


if __name__ == "__main__":
    main()
