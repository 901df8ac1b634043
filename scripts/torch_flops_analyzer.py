#!/usr/bin/env python
"""FLOPs, bytes and parameters of the FlowFormerCov frontend network in the
PyTorch/CUDA port (counterpart of ``scripts/flops_analyzer.py``):

    python scripts/torch_flops_analyzer.py [--height 480 --width 640 --batch 2 --dtype bf16]

Prints one JSON object with the JAX script's keys:

* ``params_M``: the network's parameters, in millions;
* ``flops_G``: one forward (pair batch, inference) counted by
  ``torch.utils.flop_counter.FlopCounterMode`` (2 a multiply-add of every
  matmul and convolution). The latent-attention kernel is a ctypes call the
  counter cannot see on the card; its calls are counted by the folded form's
  own formula (``ops/latent_attn.py: folded_flops``, the one its bound in
  ``chip_smoke.py`` uses). On the CPU the counter sees the kernel's plain
  version, whose count equals the formula;
* ``hbm_bytes_G``: the bytes each aten op reads and writes (its tensor
  arguments and results, views excluded), summed over the forward, under a
  ``TorchDispatchMode``, the kernel's calls by its own bytes
  (``folded_bytes``). This is the unfused analogue of XLA's "bytes accessed":
  every op's intermediate goes through memory, where XLA's fusions keep many
  in registers, so it bounds the traffic from above.

On the card it adds the forward's peak memory and synced time. The weights
are seeded random (the figures do not depend on them). Runs on the card
unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import statistics
import sys
from pathlib import Path

import torch
from torch.utils._python_dispatch import TorchDispatchMode

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


class ByteCounter(TorchDispatchMode):
    """Sums each aten op's tensor arguments' and results' bytes; views and
    ops inside a ``skipping()`` region are left out."""

    def __init__(self) -> None:
        super().__init__()
        self.bytes = 0
        self.skip = False

    @contextlib.contextmanager
    def skipping(self):
        self.skip = True
        try:
            yield
        finally:
            self.skip = False

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not self.skip and not getattr(func, "is_view", False):
            for x in torch.utils._pytree.tree_leaves((args, kwargs, out)):
                if isinstance(x, torch.Tensor):
                    self.bytes += x.numel() * x.element_size()
        return out


def count(model, img, unfused: bool = False) -> dict:
    """FLOPs and bytes of ``model(img, img)``. ``unfused`` runs the cost
    perceiver's input stage unfused (grad mode on, as for training), the form
    the JAX package runs off the TPU; else the folded form (the kernel)."""
    from torch.utils.flop_counter import FlopCounterMode

    from macvo_tpu_torch.models.flowformer import encoder
    from macvo_tpu_torch.ops.latent_attn import folded_bytes, folded_flops

    calls, byte_counter = [], ByteCounter()
    original = encoder.latent_attn_folded

    def counted(tokens, *folded):
        n, t, _ = tokens.shape
        calls.append((n, t, tokens.element_size()))
        with byte_counter.skipping():
            return original(tokens, *folded)

    grad = torch.enable_grad() if unfused else torch.no_grad()
    encoder.latent_attn_folded = counted
    try:
        with grad, FlopCounterMode(display=False) as flop_counter, byte_counter:
            model(img, img)
    finally:
        encoder.latent_attn_folded = original
    kernel_flops = sum(folded_flops(n, t) for n, t, _ in calls)
    on_card = img.device.type == "cuda"
    return {"flops": flop_counter.get_total_flops() + (kernel_flops if on_card else 0),
            "bytes": byte_counter.bytes + sum(folded_bytes(n, t, b) for n, t, b in calls),
            "latent_attn_calls": [[n, t] for n, t, _ in calls], "latent_attn_flops": kernel_flops}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--height", type=int, default=480)
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--decoder_depth", type=int, default=12)
    ap.add_argument("--dtype", type=str, default="bf16", choices=["bf16", "fp32"])
    ap.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    from macvo_tpu_torch.models.flowformer import FlowFormerConfig, FlowFormerCov
    from macvo_tpu_torch.utils.device import resolve_device
    from macvo_tpu_torch.utils.precision import tf32_off

    device = resolve_device(args.device)
    if args.dtype == "fp32" and device.type == "cuda":
        tf32_off()
    torch.manual_seed(0)
    model = FlowFormerCov(FlowFormerConfig(encoder_dtype=args.dtype, decoder_dtype=args.dtype,
                                           decoder_depth=args.decoder_depth, inference_only=True))
    model = model.to(device).eval()
    img = torch.zeros((args.batch, args.height, args.width, 3), device=device)
    counts = count(model, img)
    report = {
        "resolution": f"{args.height}x{args.width}",
        "batch": args.batch,
        "params_M": round(sum(p.numel() for p in model.parameters()) / 1e6, 2),
        "flops_G": round(counts["flops"] / 1e9, 2),
        "hbm_bytes_G": round(counts["bytes"] / 1e9, 2),
        "latent_attn": {"calls": counts["latent_attn_calls"], "flops_G": counts["latent_attn_flops"] / 1e9,
                        "counted_by": "formula" if device.type == "cuda" else "FlopCounterMode (plain version)"},
    }
    if device.type == "cuda":
        with torch.inference_mode():
            for _ in range(2):
                model(img, img)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            times = []
            for _ in range(5):
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                model(img, img)
                end.record()
                torch.cuda.synchronize()
                times.append(start.elapsed_time(end))
        report["forward_ms"] = statistics.median(times)
        report["peak_memory_GB"] = torch.cuda.max_memory_allocated() / 1e9
        report["device"] = torch.cuda.get_device_name(device)
    print(json.dumps(report), flush=True)
    return report


if __name__ == "__main__":
    main()
