#!/usr/bin/env python
"""Throughput of batched multi-sequence odometry in the PyTorch/CUDA port
(counterpart of ``scripts/throughput.py``).

Runs N ``SyntheticStereo`` sequences (seeds 7, 8, ...) through
``BatchedOdometry`` (one frontend forward a step for all of them) and prints
one JSON line with the frames/s of one sequence alone and of the N in
lockstep, and the scaling efficiency ``fps_N / (fps_1 * ranks)``:

    python scripts/torch_throughput.py [--sequences 4] [--width 320 --height 240 --frames 6]
    torchrun --nproc_per_node <cards> scripts/torch_throughput.py      # N sequences over the cards

The config is the JAX script's: bf16, ``random:0`` weights, 12 decoder steps,
``RandomSelector``, ``Local_TwoFrame_PGO`` icp with capacity 192. Under
``torchrun`` each process runs its share of the sequences on its card;
``--sequences`` (default: the number of processes) also runs several
sequences on one card. Runs on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

CONFIG = {"Odometry": {
    "args": {"num_point": 128, "edgewidth": 20, "match_cov_default": 0.25, "profile": False, "mapping": False},
    "frontend": {"type": "FlowFormerCovFrontend", "args": {
        "weight": "random:0", "enc_dtype": "bf16", "dec_dtype": "bf16",
        "enforce_positive_disparity": False, "decoder_depth": 12}},
    "motion": {"type": "StaticMotionModel", "args": {}},
    "keypoint": {"type": "RandomSelector", "args": {"mask_width": 24}},
    "mappoint": {"type": "RandomSelector", "args": {"mask_width": 24}},
    "outlier": {"type": "CovarianceSanityFilter", "args": {}},
    "cov": {"obs": {"type": "MatchCovariance", "args": {
        "kernel_size": 7, "match_cov_default": 0.25, "min_flow_cov": 0.25, "min_depth_cov": 0.05}}},
    "postprocess": {"type": "PoseInterpolate", "args": {}},
    "keyframe": {"type": "AllKeyframe", "args": {}},
    "optimizer": {"type": "Local_TwoFrame_PGO", "args": {"graph_type": "icp", "parallel": True, "capacity": 192}},
}}


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--width", type=int, default=320)
    parser.add_argument("--height", type=int, default=240)
    parser.add_argument("--frames", type=int, default=6)
    parser.add_argument("--sequences", type=int, default=0, help="sequences in lockstep (0: one a process)")
    parser.add_argument("--decoder_depth", type=int, default=12)
    parser.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"])
    args = parser.parse_args(argv)

    import torch
    import torch.distributed as dist

    from macvo_tpu_torch.data.datasets.synthetic import SyntheticStereo
    from macvo_tpu_torch.parallel import BatchedOdometry, init_distributed, make_mesh
    from macvo_tpu_torch.parallel.mesh import world
    from macvo_tpu_torch.utils.config import build_dynamic_config
    from macvo_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    init_distributed(None, int(os.environ.get("WORLD_SIZE", 1)), int(os.environ.get("RANK", 0)), device=device)
    rank, ranks = world()
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    n_seq = args.sequences or ranks
    cfg, _ = build_dynamic_config(CONFIG)
    cfg.Odometry.frontend.args.decoder_depth = args.decoder_depth

    rendered: dict[int, list] = {}

    def frames(seed: int) -> list:
        """Sequence ``seed``'s frames on the device, rendered once (on host
        threads) before any timed step."""
        if seed not in rendered:
            seq = SyntheticStereo({"n_frames": args.frames, "width": args.width, "height": args.height,
                                   "fx": args.width / 2.0, "fy": args.width / 2.0, "seed": seed})
            with ThreadPoolExecutor(min(8, args.frames)) as pool:
                rendered[seed] = [f.to(device) for f in pool.map(seq.__getitem__, range(args.frames))]
        return rendered[seed]

    def run(n: int, mesh) -> float:
        seqs = [frames(7 + i) for i in range(n)]
        driver = BatchedOdometry(cfg, n_sequences=n, mesh=mesh, device=device)
        driver.step([s[0] for s in seqs])
        driver.step([s[1] for s in seqs])
        if device.type == "cuda":
            torch.cuda.synchronize()
        if ranks > 1:
            dist.barrier()
        t0 = time.perf_counter()
        for i in range(2, args.frames):
            driver.step([s[i] for s in seqs])
        driver.finish()
        if device.type == "cuda":
            torch.cuda.synchronize()
        if ranks > 1:
            dist.barrier()
        return n * (args.frames - 2) / (time.perf_counter() - t0)

    try:
        fps_1 = run(1, None)
        fps_n = run(n_seq, make_mesh((ranks,), ("data",), device=device.type) if ranks > 1 else None)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    rec = {"devices": ranks, "sequences": n_seq, "frames_per_s_1seq": round(fps_1, 3),
           "frames_per_s_nseq": round(fps_n, 3), "scaling_efficiency": round(fps_n / (fps_1 * ranks), 3)}
    if rank == 0:
        print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main()
