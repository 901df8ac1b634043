#!/usr/bin/env python
"""Per-stage time of the FlowFormerCov frontend in the PyTorch/CUDA port
(counterpart of ``scripts/profile_frontend.py``), at 480x640 batch 2, bf16
by default:

    python scripts/torch_profile_frontend.py [--dtype bf16|fp32] [--stages all|twins,corr,...]
        [--height 480 --width 640] [--out chiprun_out/profile_frontend_bf16.json]

The stages and their printed names are the JAX script's: ``twins`` (the
encoder on 2 images, the context pass, and on 4, the feature pass),
``corr`` (all-pairs correlation), ``perceiver`` (correlation + cost
perceiver, whose input stage is the latent-attention kernel), ``decoder``
(12 recurrent steps), ``eft`` (one ``encode_flow_token``),
``perceiver_parts`` (``input_attn``, the kernel alone on the folded
weights; ``intra`` and ``vert``, one latent self-attention and one vertical
layer; ``patch``, the tokenizer: patchify, embedding and positions) and
``full`` (the forward of a pair batch). ``all`` runs every one of them
(the JAX script leaves ``perceiver_parts`` out of its ``all``).

The JAX script times the difference of two scan lengths. Here each stage
reports, from ``macvo_tpu_torch.utils.timer.stage_profile``: ``wall_ms``,
the median of ``--reps`` synced calls between CUDA events; ``device_ms``,
the sum of one call's kernel (and copy) durations from ``torch.profiler``
(CUPTI also sees the kernels launched through ctypes); ``kernels`` a call;
and ``busy`` = device_ms / wall_ms. On the CPU (``--device cpu``) only
``wall_ms`` is measured. Weights are seeded random (the times do not depend
on them). Runs on the card unless ``--device cpu`` is given; prints one line
a stage, then one JSON object, also written to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

STAGES = ("twins", "corr", "perceiver", "decoder", "eft", "perceiver_parts", "full")


def _report(rows: list, name: str, rec: dict) -> None:
    rows.append({"stage": name, **rec})
    fields = " ".join(f"{k} {'-' if rec[k] is None else format(rec[k], '.4f')}"
                      for k in ("wall_ms", "device_ms", "kernels", "busy"))
    print(f"{name:<36s} {fields}", flush=True)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--height", type=int, default=480)
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--dtype", default="bf16", choices=["bf16", "fp32"])
    ap.add_argument("--decoder_depth", type=int, default=12)
    ap.add_argument("--stages", type=str, default="all", help="all, or a comma list of " + ",".join(STAGES))
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--out", type=str, default=None)
    args = ap.parse_args(argv)
    stages = STAGES if args.stages == "all" else tuple(args.stages.split(","))

    from macvo_tpu_torch.models.flowformer import FlowFormerConfig, FlowFormerCov
    from macvo_tpu_torch.models.flowformer.decoder import MemoryCovDecoder, encode_flow_token
    from macvo_tpu_torch.models.flowformer.encoder import (
        CostPerceiverEncoder,
        MemoryEncoder,
        SelfAttentionLayer,
        VerticalAttentionLayer,
        all_pairs_correlation,
    )
    from macvo_tpu_torch.models.flowformer.network import _DTYPES, precision_scope
    from macvo_tpu_torch.models.flowformer.twins import TwinsSVT
    from macvo_tpu_torch.ops.latent_attn import latent_attn_folded
    from macvo_tpu_torch.utils.device import resolve_device
    from macvo_tpu_torch.utils.precision import tf32_off
    from macvo_tpu_torch.utils.timer import stage_profile

    device = resolve_device(args.device)
    if args.dtype == "fp32" and device.type == "cuda":
        tf32_off()                       # the port's fp32 policy: TF32 off
    H, W, B = args.height, args.width, 2
    h1, w1 = H // 8, W // 8
    n1 = h1 * w1
    dt = _DTYPES[args.dtype]
    gen = torch.Generator().manual_seed(0)

    def rand(*shape, dtype=torch.float32, normal=True):
        x = torch.randn(shape, generator=gen) if normal else torch.rand(shape, generator=gen)
        return x.to(device=device, dtype=dtype)

    def build(factory):
        torch.manual_seed(0)
        with torch.inference_mode(False):    # weights are normal tensors (the perceiver tracks their versions)
            return factory().to(device).eval()

    scope = lambda: precision_scope(device, args.dtype)       # noqa: E731
    img = rand(B, H, W, 3, normal=False)
    img4 = torch.cat([img, img])
    feat, ctx = rand(B, h1, w1, 256, dtype=dt), rand(B, h1, w1, 256, dtype=dt)
    rows: list = []

    def run(name, fn):
        def call():
            with scope():
                return fn()
        _report(rows, name, stage_profile(call, device, reps=args.reps))

    with torch.inference_mode():
        if "twins" in stages:
            twins = build(TwinsSVT)
            run(f"twins batch{B} (cnet pass)", lambda: twins(2.0 * img - 1.0))
            run(f"twins batch{2 * B} (fnet pass)", lambda: twins(2.0 * img4 - 1.0))
        if "corr" in stages:
            run("all-pairs correlation", lambda: all_pairs_correlation(feat, feat))
        if "perceiver" in stages:
            menc = build(MemoryEncoder)
            run("memory encoder (corr+perceiver)", lambda: menc(feat, feat, ctx))
        if "decoder" in stages or "eft" in stages:
            cost_memory = rand(B * n1, 8, 128, dtype=dt)
            cost_maps = rand(B, n1, h1, w1)
            ctx32 = ctx.float()
        if "decoder" in stages:
            dec = build(lambda: MemoryCovDecoder(decoder_depth=args.decoder_depth, inference_only=True))
            run(f"decoder scan x{args.decoder_depth}", lambda: dec(cost_memory, ctx32, cost_maps, compute_dtype=dt))
        if "eft" in stages:
            coords = rand(B, 2, h1, w1, normal=False) * 32
            run("encode_flow_token x1", lambda: encode_flow_token(cost_maps, coords))
        if "perceiver_parts" in stages:
            perceiver = build(CostPerceiverEncoder)
            cost_maps2 = rand(B, n1, h1, w1, dtype=dt)
            with scope():
                tokens = perceiver.tokenize(cost_maps2)
            folded = perceiver.fold_m, perceiver.fold_wvp, perceiver.fold_c
            latents = rand(B * n1, 8, 128, dtype=dt)
            grid = rand(B, h1, w1, 8, 128, dtype=dt)
            intra = build(lambda: SelfAttentionLayer(128))
            vert = build(lambda: VerticalAttentionLayer(128, 64))
            run("perceiver: input cross-attn", lambda: latent_attn_folded(tokens, *folded))
            run("perceiver: intra layer x1", lambda: intra(latents))
            run("perceiver: vertical layer x1", lambda: vert(grid, ctx))
            run("perceiver: patchify+embed", lambda: perceiver.tokenize(cost_maps2))
        if "full" in stages:
            model = build(lambda: FlowFormerCov(FlowFormerConfig(
                encoder_dtype=args.dtype, decoder_dtype=args.dtype, decoder_depth=args.decoder_depth,
                inference_only=True)))
            run(f"FULL forward (pair batch{B})", lambda: model(img, img))

    report = {"script": "torch_profile_frontend", "device": torch.cuda.get_device_name(device)
              if device.type == "cuda" else "cpu", "dtype": args.dtype, "height": H, "width": W, "batch": B,
              "decoder_depth": args.decoder_depth, "tokens": ((h1 + 7) // 8) * ((w1 + 7) // 8), "stages": rows}
    print(json.dumps(report), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(report, indent=1) + "\n")
    return report


if __name__ == "__main__":
    main()
