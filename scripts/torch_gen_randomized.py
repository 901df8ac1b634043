"""Write domain-randomized training worlds to disk in TartanAir v1 layout
(counterpart of ``scripts/gen_randomized.py``), rendered by the port's
``RandomizedStereo`` on the host, one world a worker process.

    python scripts/torch_gen_randomized.py --out data/randomized --n_seqs 16 \\
        --n_frames 24 [--width 640 --height 480 --workers 4 --seed0 1000]

Each world goes to ``<out>/seq_<seed:04d>`` (seeds ``seed0``, ``seed0 + 1``,
...) with the same files, bytes and camera as the JAX writer's: fx = fy = 320,
the principal point at the image centre, baseline 0.25, supersampling 2. The
stock ``TartanAir`` loader reads them; the randomized training recipes
(``configs/train/FlowFormerCov_randomized*.yaml``), the TartanVO trainer and
the pose-net trainer read ``data/randomized`` by default.
"""

from __future__ import annotations

import argparse
import multiprocessing as mp
import sys
import time
from pathlib import Path

# spawned workers import this module without the working directory on sys.path
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def gen_one(args: tuple) -> str:
    """Render world ``seed`` of ``n_frames`` at ``width`` x ``height`` into
    ``<out_root>/seq_<seed:04d>``."""
    seed, n_frames, width, height, out_root = args
    from macvo_tpu_torch.data.datasets.randomized import RandomizedStereo
    from macvo_tpu_torch.data.datasets.synthetic import write_sequence_tartanair_layout

    t0 = time.time()
    seq = RandomizedStereo({
        "n_frames": n_frames, "width": width, "height": height,
        "fx": 320.0, "fy": 320.0, "cx": width / 2.0, "cy": height / 2.0,
        "baseline": 0.25, "seed": seed, "supersample": 2,
    })
    out = Path(out_root) / f"seq_{seed:04d}"
    write_sequence_tartanair_layout(seq, out)
    return f"{out} ({n_frames} frames, {time.time() - t0:.0f}s)"


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", required=True)
    ap.add_argument("--n_seqs", type=int, default=16)
    ap.add_argument("--n_frames", type=int, default=24)
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--height", type=int, default=480)
    ap.add_argument("--seed0", type=int, default=1000)
    ap.add_argument("--workers", type=int, default=4)
    return ap.parse_args(argv)


def main(argv=None) -> list[str]:
    args = parse_args(argv)
    jobs = [(args.seed0 + i, args.n_frames, args.width, args.height, args.out) for i in range(args.n_seqs)]
    done = []
    with mp.get_context("spawn").Pool(args.workers) as pool:
        for msg in pool.imap_unordered(gen_one, jobs):
            print("done:", msg, flush=True)
            done.append(msg)
    return done


if __name__ == "__main__":
    main()
