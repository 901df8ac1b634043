#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``macvo_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each announced by a flushed, timestamped JSON line:

1. device   - the card's name and power limit (``nvidia-smi``).
2. build    - ``nvcc`` builds every kernel of the main paths for sm_90a from
              ``macvo_tpu_torch/csrc``, one process a source, all at once
              (registers / shared memory from ptxas).
3. kernel   - each kernel against its plain PyTorch version on the card at the
              main paths' shapes, with its time, bound, bound share (bound /
              time) and the plain version's time. A kernel's ``ms`` times 50
              calls made from Python between two CUDA events, host cost
              included, as the main path pays it (and as PRs 4-5 recorded it);
              ``device_ms`` is device time (the same 50 calls in one CUDA
              graph, replayed between CUDA events) and ``device_bound_share``
              its bound share: the latent attention at N = 12,800 pixels, T = 100 tokens
              (bf16 and fp32), through both entry points (folded weights, as
              the main path calls it, and the JAX signature); the local
              correlation at the five shapes of a 640x640 PWC forward and an
              odd one.
4. network  - FlowFormerCov (fp32, shipped checkpoint, 12 steps) on a 64x96
              crop of a real pair, and the three TartanVO networks (PWC and
              stereo at 128x192, pose net at 112x160): the card against the CPU.
5. gt       - GT depth/flow frontend on the real 10-frame 640x640 TartanAir v2
              clip through the whole backend; ATE/RTE/ROE within the bounds
              of tests/test_real_asset.py.
6. performant - MACVO_Performant (fp32, TF32 off), the full checkpoint at
              640x640 with 12 decoder steps, all 10 frames; ATE <= 0.05 m.
7. fast     - MACVO_Fast (bf16 autocast), same clip; ATE <= 0.08 m.
8. tartanvo - the TartanVO baseline (configs/experiment/baseline/TartanVO.yaml,
              fp32), same clip; ATE/RTE/ROE within 0.1 % of the JAX CPU record
              and 5 correlation launches a frame pair.
9. synthetic - the README's quickstart, configs/experiment/macvo/MACVO_Synthetic.yaml
              on its own Synthetic_Demo sequence (320x240, 10 frames, GT
              frontend, rendered on the host before the run); ATE/RTE/ROE
              within the bounds of tests/test_e2e.py.
              No kernel is on this path: both counters must stay at 0.
10. paper   - configs/experiment/macvo/Paper_Reproduce.yaml (CovAwareSelector,
              TartanMotionNet motion model, float64 disp-graph TwoFrame_PGO,
              LikelyFrontOfCamFilter) on the real clip; ATE <= 0.05 m and one
              latent-attention launch a frame.
11. ablation - the ablation configs that reach every covariance module
              (TartanAirv2_CovKP: NoCovariance + CovAwareSelector; _CovDiag:
              Modifier_Diagonalize; _ScaleNorm: Modifier_Normalize) on the
              real clip: finite poses, ATE/RTE/ROE printed, one latent-attention
              launch a frame each.
12. train   - the training path (macvo_tpu_torch.train), five checks:
              cov: configs/train/FlowFormerCov_synth_cov.yaml as shipped (bf16,
                batch 6, 240x320, 12 decoder steps) from the shipped checkpoint,
                3 steps through the runner's functions, batches drawn before the
                timed steps: finite losses, every parameter outside the
                covariance branch bit-identical, one bf16 latent-attention
                launch a step (counted by token type, counts set to 0 before
                each step); then the runner itself, ``train.run.main``, for 3
                steps and its final eval, whose npz the odometry runs on.
              flow: FlowFormerCov_synth.yaml (flow mode), 2 steps from the same
                checkpoint with no kernel launch; then the moved weights are
                refolded and the kernel's input stage on an eval pair equals the
                unfused stage within the kernel's tolerance.
              eval: make_eval_fn over the 12 Eval pairs with the shipped
                checkpoint in fp32: epe/px1/px3/nll within 1 % of the JAX CPU
                record (scripts/jax_train_eval_record.py); one fp32 launch a pair.
              step parity: one fp32 flow step on a 1x96x128 crop, card (cuDNN
                off, TF32 off) against CPU, same weights and batch: the loss
                within 1e-5; its gradient in the predictions within 1e-6 of its
                largest value wherever the L1 sign is decided (the residual
                exceeds the two devices' difference); the network's gradients
                under the CPU's loss gradient within 1e-4 of each leaf's scale;
                each weight's update by the device's own step within 1e-3 lr
                plus two ulps, where the CPU's clipped gradient is at least 1e-2
                of its leaf's scale and 100 Adam eps (so the first Adam step's
                direction is decided). scripts/torch_train_step_parity.py runs
                the same with cuDNN on as well.
              fp32 size: FlowFormerCov.yaml (fp32, 480x640, cov mode) with the
                batch cut from 6 to 2: ms a step, peak memory, one fp32 launch
                a step.
              In cov, eval and fp32 size the kernel is also held against its
                plain version on the tokens and folded weights the path gave
                its first call, at the kernel phase's tolerance for the type.
13. datasets - the user's data layouts, written from the real clip into a
              temporary directory under results/ and read through the runner's
              build_sequence (the config's Preprocess applied):
              kitti: the 10 frames as a KITTI odometry sequence (image_2/3,
                calib.txt P0-P3, times.txt, poses/00.txt), MACVO_Performant.yaml
                as shipped (fp32): SmartResizeFrame takes the frames to 376x780
                (padded to 376x784: 4,606 pixels at 1/8); the frontend must see
                376x780, one fp32 launch a frame, the kernel within the kernel
                phase's fp32 tolerance of its plain version on the path's first
                tokens, ATE (the runner's, from its result directory) at most
                the larger of 0.05 m and twice the JAX CPU record
                (scripts/jax_kitti_record.py).
              general: a 480x640 crop of 4 frames as a GeneralStereo rig
                (left/, right/, times.txt, pose file), MACVO_Fast.yaml (bf16):
                Preprocess scales up and crops to 640x640; one bf16 launch a
                frame, finite poses.
              euroc: 5 frames as a raw EuRoC recording (gray 752x480, the
                loader's rectification undone, a small L->R rotation, the
                clip's 100 Hz IMU, ground truth at the camera stamps so the
                loader keeps 3), EuRoC_IMU through DevicePrefetcher with
                MACVO_Performant.yaml: every frame a StereoInertialFrame with
                IMU samples and attitude, one fp32 launch a frame, finite poses.
14. kernels - one JSON line listing every ported kernel.

Each learned run resets the kernels' launch counters right before it and
reads them right after: every kernel of the path must have launched. Any
failure ends the run with a non-zero exit and without the final line, which
is ``{"ok": true, "device": {...}}``. Without CUDA the script exits non-zero.
It writes only under ``results/`` and the kernels' build directory.

The layout writers of phase 13 (``read_clip``, ``write_kitti_layout``,
``write_general_layout``, ``euroc_raw_images``, ``write_euroc_layout``) are
also what the port's dataset tests and ``scripts/jax_kitti_record.py`` use.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
CLIP = "configs/sequence/TartanAirv2_RealAsset.yaml"
GT_BOUNDS = {"ATE": 0.002, "RTE": 0.0025, "ROE": 0.045}   # tests/test_real_asset.py:33-35, tests/test_e2e.py:19-21
LEARNED_ATE = {"performant": 0.05, "fast": 0.08, "paper": 0.05}
ABLATIONS = ("TartanAirv2_CovKP", "TartanAirv2_CovDiag", "TartanAirv2_ScaleNorm")
# TartanVO baseline, JAX package on the CPU, 10 frames at 640x640 (README's baseline row); an accuracy record
TARTANVO_JAX_CPU = {"ATE": 1.613477, "RTE": 0.360225, "ROE": 3.962729}
TARTANVO_REL = 0.001
# (B, C, H, W) of the correlation calls of one 640x640 PWC forward, coarse levels last; then an odd shape
CORR_SHAPES = [(1, 32, 160, 160), (1, 64, 80, 80), (1, 96, 40, 40), (1, 128, 20, 20), (1, 196, 10, 10)]
CORR_ODD = (2, 48, 37, 53)
KERNEL_SOURCES = {   # kernel -> (CUDA source, the TPU kernel it replaces)
    "latent_cross_attention": ("macvo_tpu_torch/csrc/latent_attn.cu", "macvo_tpu/ops/latent_attn.py:36"),
    "local_correlation": ("macvo_tpu_torch/csrc/correlation.cu", "macvo_tpu/ops/correlation.py:46"),
}
# make_eval_fn over the Eval pairs of configs/train/FlowFormerCov_synth_cov.yaml (12 pairs, 240x320, 12
# decoder steps) with model/MACVO_FrontendCov.npz in fp32: the JAX package on the CPU,
# `JAX_PLATFORMS=cpu python scripts/jax_train_eval_record.py` (jax 0.9.0)
TRAIN_EVAL_JAX_CPU = {"epe": 0.8169699311256409, "px1": 0.7096279263496399, "px3": 0.9868731498718262,
                      "nll": 2.576082468032837}
TRAIN_EVAL_REL = 0.01
# MACVO_Performant.yaml on the real clip written as a KITTI sequence (10 frames, Preprocess -> 376x780):
# the JAX package on the CPU, `JAX_PLATFORMS=cpu python scripts/jax_kitti_record.py` (jax 0.9.0);
# ATE bound: the larger of 0.05 m and twice its ATE
KITTI_JAX_CPU = {"ATE": 0.058458222584022355, "RTE": 0.0256436887146321, "ROE": 0.21617183282237912}
CKPT = ROOT / "model/MACVO_FrontendCov.npz"
KERNEL_TOL = {"fp32": (1e-4, 1e-4), "bf16": (1e-2, 1.6e-2)}   # latent attention against its plain version: (atol, rtol)
# step parity, card (cuDNN off, TF32 off) against CPU: relative loss; loss gradient in the predictions
# where the L1 sign is decided, over its largest value; each leaf's gradient over its scale; a weight's
# update over (1e-3 lr + two ulps of the weight), where the first Adam step's direction is decided
PARITY_BOUNDS = {"loss_rel_err": 1e-5, "loss_grad_rel_err": 1e-6, "grad_rel_err": 1e-4,
                 "update_err_share_of_bound": 1.0}
H100 = {"bytes_per_s": 3.35e12, "flops": {"float32": 67e12, "bfloat16": 989e12}}   # H100 SXM data sheet, dense
_T0 = time.perf_counter()


def emit(phase: str, event: str, **fields) -> None:
    print(json.dumps({"t_s": round(time.perf_counter() - _T0, 3), "phase": phase, "event": event, **fields}),
          flush=True)


def cuda_time_ms(fn, iters: int, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_time_ms(fn, iters: int) -> float:
    """Device time of one call: ``iters`` calls captured in one CUDA graph and
    replayed between two CUDA events, so the host's launch cost (Python, ctypes)
    drops out. ``cuda_time_ms`` keeps it in."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def latent_attn_bound_ms(n: int, t: int, dtype) -> tuple[float, str]:
    """Least time for one call: tokens read once + output written once (+ the
    folded weights) over the memory rate, against the FLOPs of the folded form
    at the card's peak for the token type (bf16 tensor cores; fp32 outside
    them)."""
    elt = dtype.itemsize
    nbytes = n * t * 64 * elt + n * 8 * 128 * elt + (64 * 8 + 64 * 128 + 8 * 128) * 4
    flops = n * 2 * (t * 64 * 8 + 8 * t * 64 + 8 * 64 * 128)
    t_bytes = nbytes / H100["bytes_per_s"] * 1e3
    t_ops = flops / H100["flops"][str(dtype).removeprefix("torch.")] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_kernel(device, n: int, t: int, timed: bool) -> dict:
    """latent_cross_attention kernel vs its plain version, bf16 and fp32: the
    entry the main path calls (weights folded beforehand) and the JAX-signature
    wrapper (folds on every call). ``ms`` times the former."""
    import torch

    from macvo_tpu_torch.ops import latent_attn

    gen = torch.Generator().manual_seed(0)

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen) * scale).to(device)

    wk, bk, wv, bv = rnd(64, 128, scale=0.1), rnd(128, scale=0.1), rnd(64, 128, scale=0.1), rnd(128, scale=0.1)
    q, wp, bias = rnd(8, 128), rnd(128, 128, scale=0.1), rnd(8, 128)
    folded = latent_attn.fold_weights(wk, bk, wv, bv, q, wp, bias)
    tokens32 = rnd(n, t, 64)
    results = {}
    for dtype in (torch.bfloat16, torch.float32):
        tokens = tokens32.to(dtype)
        args = (tokens, wk, bk, wv, bv, q, wp, bias)
        outs = {"folded": latent_attn.latent_attn_folded(tokens, *folded),
                "jax_signature": latent_attn.latent_cross_attention(*args)}
        ref = latent_attn.latent_cross_attention_torch(*args).float()
        if device.type == "cuda":
            torch.cuda.synchronize()
        atol, rtol = KERNEL_TOL[latent_attn.DTYPE_NAMES[dtype]]
        errs = {k: (o.float() - ref).abs() for k, o in outs.items()}
        ok = all(bool((e <= atol + rtol * ref.abs()).all()) for e in errs.values())
        name = f"latent_cross_attention[{'bf16' if dtype == torch.bfloat16 else 'fp32'}]"
        rec = {"max_abs_err": float(errs["folded"].max()),
               "max_abs_err_jax_signature": float(errs["jax_signature"].max()),
               "atol": atol, "rtol": rtol, "shape": [n, t, 64]}
        rec["bound_ms"], rec["bound_by"] = latent_attn_bound_ms(n, t, dtype)
        if timed:
            rec["ms"] = cuda_time_ms(lambda: latent_attn.latent_attn_folded(tokens, *folded), 50)
            rec["device_ms"] = graph_time_ms(lambda: latent_attn.latent_attn_folded(tokens, *folded), 50)
            rec["jax_signature_ms"] = cuda_time_ms(lambda: latent_attn.latent_cross_attention(*args), 50)
            rec["plain_ms"] = cuda_time_ms(lambda: latent_attn.latent_cross_attention_torch(*args), 10)
            rec["bound_share"] = rec["bound_ms"] / rec["ms"]
            rec["device_bound_share"] = rec["bound_ms"] / rec["device_ms"]
        emit("kernel", "check", kernel=name, agrees=ok, **rec)
        if not ok:
            raise AssertionError(f"{name}: kernel disagrees with its plain version ({rec})")
        results[name] = rec
    return results


def correlation_bound_ms(b: int, c: int, h: int, w: int) -> tuple[float, str]:
    """Least time for one call: f1 and f2 read once, 81 channels written once
    (fp32), against 2*C*81 FLOPs a pixel at the fp32 rate."""
    nbytes = (2 * b * c * h * w + b * 81 * h * w) * 4
    t_bytes = nbytes / H100["bytes_per_s"] * 1e3
    t_ops = 2 * b * h * w * c * 81 / H100["flops"]["float32"] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_correlation(device, shapes, timed: bool) -> dict:
    """local_correlation kernel vs its plain version at each shape (fp32,
    atol = rtol = 1e-5: channel sums in another order). The record sums ms,
    plain ms and bound over the PWC shapes, i.e. one forward's five calls."""
    import torch

    from macvo_tpu_torch.ops import correlation

    gen = torch.Generator().manual_seed(1)
    total = {"ms": 0.0, "device_ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "max_abs_err": 0.0}
    bound_by = set()          # of the PWC shapes
    for i, shape in enumerate(shapes):
        f1, f2 = (torch.randn(shape, generator=gen).to(device) for _ in range(2))
        out = correlation.local_correlation(f1, f2)
        ref = correlation.local_correlation_torch(f1, f2)
        if device.type == "cuda":
            torch.cuda.synchronize()
        err = (out - ref).abs()
        ok = bool((err <= 1e-5 + 1e-5 * ref.abs()).all()) and tuple(out.shape) == (shape[0], 81, *shape[2:])
        rec = {"shape_bchw": list(shape), "max_abs_err": float(err.max()), "atol": 1e-5, "rtol": 1e-5}
        rec["bound_ms"], rec["bound_by"] = correlation_bound_ms(*shape)
        if timed:
            rec["cluster"] = correlation.cluster_size(*shape, torch.cuda.get_device_properties(device).multi_processor_count)
            rec["ms"] = cuda_time_ms(lambda: correlation.local_correlation(f1, f2), 50)
            rec["device_ms"] = graph_time_ms(lambda: correlation.local_correlation(f1, f2), 50)
            rec["plain_ms"] = cuda_time_ms(lambda: correlation.local_correlation_torch(f1, f2), 10)
            rec["bound_share"] = rec["bound_ms"] / rec["ms"]
            rec["device_bound_share"] = rec["bound_ms"] / rec["device_ms"]
        emit("kernel", "check", kernel="local_correlation", agrees=ok, **rec)
        if not ok:
            raise AssertionError(f"local_correlation: kernel disagrees with its plain version ({rec})")
        total["max_abs_err"] = max(total["max_abs_err"], rec["max_abs_err"])
        if i < len(CORR_SHAPES):
            bound_by.add(rec["bound_by"])
            for key in ("ms", "device_ms", "plain_ms", "bound_ms"):
                total[key] += rec.get(key, 0.0)
    total["bound_by"] = " and ".join(sorted(bound_by))
    if timed:
        total["bound_share"] = total["bound_ms"] / total["ms"]
        total["device_bound_share"] = total["bound_ms"] / total["device_ms"]
    else:
        total["ms"] = total["device_ms"] = total["plain_ms"] = None
    return {"local_correlation": total}


def phase_tartanvo_networks(device, frame0, frame1) -> dict:
    """PWCFlowNet and StereoCovNet at 128x192 on a crop of a real pair, and
    VOFlowRes at 112x160 on a seeded stack: the card (kernel, cuDNN with TF32
    off) against the CPU (plain versions). Bound: max |card - CPU| <= 1e-4 of
    the output's magnitude (at least 1): fp32 sums in other orders."""
    import torch

    from macvo_tpu_torch.models.flowformer import load_flax_checkpoint
    from macvo_tpu_torch.models.tartanvo import PWCFlowNet, StereoCovNet, VOFlowRes, normalize_image

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    crop = (slice(None), slice(256, 384), slice(224, 416))
    l0, l1, r0 = (normalize_image(x[crop]).contiguous() for x in
                  (frame0.stereo.imageL, frame1.stereo.imageL, frame0.stereo.imageR))
    stack = torch.randn((1, 112, 160, 5), generator=torch.Generator().manual_seed(2)) * 0.5
    errs = {}
    for name, cls, ckpt, inputs in (("pwc", PWCFlowNet, "TartanVO_flow", (l0, l1)),
                                    ("stereo", StereoCovNet, "TartanVO_stereo", (l0, r0)),
                                    ("posenet", VOFlowRes, "TartanVO_posenet", (stack,))):
        model = cls().eval()
        load_flax_checkpoint(model, ROOT / "model" / f"{ckpt}.npz")
        with torch.inference_mode():
            ref = model(*inputs)
            model.to(device)
            out = model(*(x.to(device) for x in inputs))
        ref, out = (ref if isinstance(ref, tuple) else (ref,)), (out if isinstance(out, tuple) else (out,))
        for i, (o, r) in enumerate(zip(out, ref)):
            key = f"{name}[{i}]" if len(ref) > 1 else name
            err, scale = float((o.cpu() - r).abs().max()), max(1.0, float(r.abs().max()))
            errs[key] = {"max_abs_err": err, "bound": 1e-4 * scale, "shape": list(o.shape),
                         "finite": bool(torch.isfinite(o).all())}
    ok = all(v["max_abs_err"] <= v["bound"] and v["finite"] for v in errs.values())
    emit("network", "check", model="tartanvo", agrees=ok, errors=errs)
    if not ok:
        raise AssertionError(f"network: TartanVO nets, card vs CPU differ: {errs}")
    return errs


def phase_network(device, frame0, frame1) -> dict:
    """FlowFormerCov (fp32, shipped checkpoint) on a 64x96 crop of a real pair:
    the card (kernel, cuDNN/cuBLAS with TF32 off) against the CPU (plain
    versions). 5e-3 px: fp32 sums in other orders through the recurrent steps."""
    import torch

    from macvo_tpu_torch.models.flowformer import FlowFormerConfig, FlowFormerCov, load_flax_checkpoint

    model = FlowFormerCov(FlowFormerConfig(inference_only=True)).eval()
    load_flax_checkpoint(model, ROOT / "model/MACVO_FrontendCov.npz")
    i1, i2 = (f.stereo.imageL[:, 288:352, 272:368].contiguous() for f in (frame0, frame1))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with torch.inference_mode():
        ref = model(i1, i2)
        model.to(device)
        out = model(i1.to(device), i2.to(device))
    errs = {k: float((out[k].cpu() - ref[k]).abs().max()) for k in ("flow_final", "cov_final")}
    ok = all(v <= 5e-3 for v in errs.values()) and all(bool(torch.isfinite(out[k]).all()) for k in errs)
    emit("network", "check", agrees=ok, shape=list(out["flow_final"].shape), max_abs_err=errs, atol=5e-3)
    if not ok:
        raise AssertionError(f"network: card vs CPU differ by {errs}")
    return errs


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize()


def _peak_reset(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()


def _peak(device):
    import torch

    return int(torch.cuda.max_memory_allocated()) if device.type == "cuda" else None


def _timed_steps(step, batches, device) -> dict:
    """Run ``step`` on each batch; per step: synced ms, latent-attention
    launches by token type (counts set to 0 just before the step), loss."""
    from macvo_tpu_torch.ops import latent_attn

    recs = []
    for b in batches:
        latent_attn.reset_launches()
        _sync(device)
        start = time.perf_counter()
        aux = step(b)
        loss = float(aux["loss"])          # syncs
        _sync(device)
        recs.append({"ms": (time.perf_counter() - start) * 1e3,
                     "launches": dict(latent_attn.latent_cross_attention.launches_by_dtype), "loss": loss})
    return {"step_ms": [round(r["ms"], 3) for r in recs], "launches_per_step": [r["launches"] for r in recs],
            "losses": [r["loss"] for r in recs]}


def _train_model(cfg, device, ckpt):
    from macvo_tpu_torch.models.flowformer import load_flax_checkpoint
    from macvo_tpu_torch.train import run
    from macvo_tpu_torch.train.step import set_matmul_precision

    model = run.build_model(cfg, device, int(cfg.Train.seed))
    load_flax_checkpoint(model, ckpt)
    set_matmul_precision(model)
    return model


@contextlib.contextmanager
def _kernel_inputs(perceiver):
    """Record what the path's first fused input-stage call hands the kernel:
    its tokens and the folded weights it ran with (after any refold)."""
    seen = []

    def fused(tokens):
        out = type(perceiver).fused_input_stage(perceiver, tokens)
        if not seen:
            seen.append(tuple(x.detach().clone() for x in
                              (tokens, perceiver.fold_m, perceiver.fold_wvp, perceiver.fold_c)))
        return out

    perceiver.fused_input_stage = fused
    try:
        yield seen
    finally:
        del perceiver.fused_input_stage


def _check_kernel_inputs(part: str, seen: list) -> dict:
    """The kernel against its plain version on the inputs the path gave it,
    at the kernel phase's tolerance for the token type."""
    import torch

    from macvo_tpu_torch.ops import latent_attn

    if not seen:
        raise AssertionError(f"train {part}: the path made no fused input-stage call")
    tokens, *fold = seen[0]
    with torch.no_grad():
        out = latent_attn.latent_attn_folded(tokens, *fold).float()
        ref = latent_attn.latent_attn_folded_torch(tokens, *fold).float()
    _sync(tokens.device)
    atol, rtol = KERNEL_TOL[latent_attn.DTYPE_NAMES[tokens.dtype]]
    err = (out - ref).abs()
    rec = {"tokens": list(tokens.shape), "dtype": latent_attn.DTYPE_NAMES[tokens.dtype],
           "max_abs_err": float(err.max()), "atol": atol, "rtol": rtol}
    if not bool((err <= atol + rtol * ref.abs()).all()):
        raise AssertionError(f"train {part}: kernel disagrees with its plain version on the path's tokens {rec}")
    return rec


def step_parity(device, crop: dict, cudnn: bool) -> dict:
    """One fp32 flow step (FlowFormerCov_synth.yaml in fp32, TF32 off) from
    the shipped checkpoint on ``crop``, on the CPU and on ``device``, with
    cuDNN on or off on the card. Per device: the loss, the loss gradient in
    the predictions, the network's gradients under the CPU's loss gradient
    (an L1 sign is arbitrary where a prediction lies within rounding of the
    ground truth), and each weight's update by the device's own step."""
    import torch

    from macvo_tpu_torch.data.datasets.train import upcast_batch
    from macvo_tpu_torch.train import run
    from macvo_tpu_torch.train.loss import sequence_loss
    from macvo_tpu_torch.train.step import create_optimizer
    from macvo_tpu_torch.utils.config import load_config

    cfg = load_config(ROOT / "configs/train/FlowFormerCov_synth.yaml")[0]
    cfg.Model.encoder_dtype = cfg.Model.decoder_dtype = "fp32"
    tcfg = run.train_config(cfg)
    res = {}
    enabled = torch.backends.cudnn.enabled
    torch.backends.cudnn.enabled = cudnn
    try:
        for dev in (torch.device("cpu"), device):       # the CPU first: its loss gradient goes to the card
            model = _train_model(cfg, dev, CKPT)
            opt = create_optimizer(model, tcfg)
            before = {n: p.detach().cpu().clone() for n, p in model.named_parameters() if p.requires_grad}
            b = upcast_batch(crop, dev)
            pred = model(b["img1"], b["img2"])["flow_predictions"]
            loss, _ = sequence_loss(pred, None, b["gt_flow"], b["flow_mask"], gamma=tcfg.gamma,
                                    max_flow=tcfg.max_flow, training_mode="flow")
            own = torch.autograd.grad(loss, pred, retain_graph=True)[0]
            cotangent = res["cpu"]["cotangent"].to(dev) if res else own
            pred.backward(cotangent, retain_graph=bool(res))
            grads = {n: p.grad.detach().cpu().clone() for n, p in model.named_parameters() if p.requires_grad}
            if res:                                     # the card's own step, under its own loss gradient
                model.zero_grad(set_to_none=True)
                pred.backward(own)
            opt.step()
            res["cpu" if not res else "card"] = {
                "loss": float(loss.detach()), "cotangent": own.cpu(), "residual": (pred.detach() - b["gt_flow"]).cpu(),
                "grads": grads, "lr": opt.adamw.param_groups[0]["lr"],
                "update": {n: p.detach().cpu() - before[n] for n, p in model.named_parameters() if n in before},
                "weights": {n: p.detach().cpu() for n, p in model.named_parameters() if n in before}}
            del model, opt, pred, loss, own
    finally:
        torch.backends.cudnn.enabled = enabled
    cpu, card = res["cpu"], res["card"]
    # loss gradient: compared wherever the CPU's residual exceeds the two devices' prediction difference
    decided = cpu["residual"].abs() > (card["residual"] - cpu["residual"]).abs()
    ct_err = float(((card["cotangent"] - cpu["cotangent"]).abs() * decided).max()) / float(cpu["cotangent"].abs().max())
    gh = cpu["grads"]
    gmax = max(float(g.abs().max()) for g in gh.values())
    leaf = sorted(((float((card["grads"][n] - g).abs().max()) / max(float(g.abs().max()), 1e-4 * gmax), n)
                   for n, g in gh.items()), reverse=True)
    # updates: compared where the CPU's clipped gradient is far from 0 (1e-2 of its leaf's scale, 100 Adam
    # eps), so both first Adam steps move the weight by lr in one direction; within 1e-3 lr + 2 ulps (each
    # device rounds the new weight twice: decay, then the Adam update)
    norm = float(torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in gh.values()])))
    clip = min(1.0, tcfg.clip / norm)
    lr = cpu["lr"]
    n_checked = n_over = 0
    upd_err = 0.0
    for n, g in gh.items():
        sure = (g.abs() >= 1e-2 * g.abs().max()) & (clip * g.abs() >= 100 * 1e-8)
        w = cpu["weights"][n].abs()
        ulp = torch.nextafter(w, torch.full_like(w, float("inf"))) - w
        diff = (card["update"][n] - cpu["update"][n]).abs()
        rel = (diff / (1e-3 * lr + 2 * ulp))[sure]
        n_checked += int(sure.sum())
        n_over += int((rel > 1).sum())
        upd_err = max(upd_err, float(rel.max()) if rel.numel() else 0.0)
    n_weights = sum(g.numel() for g in gh.values())
    return {"crop_hwb": list(crop["img1"].shape[1:3]) + [int(crop["img1"].shape[0])], "cudnn": cudnn, "lr": lr,
            "loss": {"cpu": cpu["loss"], "card": card["loss"]},
            "loss_rel_err": abs(card["loss"] - cpu["loss"]) / abs(cpu["loss"]),
            "loss_grad_rel_err": ct_err, "loss_grad_within_rounding": int((~decided).sum()),
            "loss_grad_elements": int(decided.numel()),
            "grad_rel_err": leaf[0][0], "worst_leaves": [{"rel_err": e, "leaf": n} for e, n in leaf[:3]],
            "update_err_share_of_bound": upd_err, "updates_checked": n_checked, "updates_over": n_over,
            "weights": n_weights,
            "updates_beyond_1e-3_lr": sum(int(((card["update"][n] - cpu["update"][n]).abs() > 1e-3 * lr).sum())
                                          for n in gh)}


def phase_train(device, rehearsal: bool) -> dict:
    """The five checks of the training path (module docstring, phase 12).
    Returns the latent-attention launches of each part by kernel name."""
    import numpy as np
    import torch

    from macvo_tpu_torch.data.datasets.train import TrainPairDataset, upcast_batch
    from macvo_tpu_torch.models.flowformer.encoder import all_pairs_correlation
    from macvo_tpu_torch.models.flowformer.network import precision_scope
    from macvo_tpu_torch.ops import latent_attn
    from macvo_tpu_torch.train import run
    from macvo_tpu_torch.train.step import create_optimizer, is_trainable, make_train_step
    from macvo_tpu_torch.utils.config import load_config, namespace_to_dict

    counts = latent_attn.latent_cross_attention.launches_by_dtype
    on_card = device.type == "cuda"
    launches = {"latent_cross_attention[bf16]": {}, "latent_cross_attention[fp32]": {}}

    def record(part: str, per_step: list) -> None:
        for dt in ("bf16", "fp32"):
            launches[f"latent_cross_attention[{dt}]"][part] = sum(s[dt] for s in per_step)

    def small(cfg, fp32=False):    # CPU rehearsal: 2 decoder steps, 64x96 crops, batch 2
        if rehearsal:
            cfg.Model.decoder_depth = 2
            cfg.Train.image_height, cfg.Train.image_width, cfg.Train.batch_size = 64, 96, 2
        if fp32:
            cfg.Model.encoder_dtype = cfg.Model.decoder_dtype = "fp32"
        return cfg

    # cov: the shipped phase-2 recipe, 3 steps, batches drawn before the timed steps
    emit("train", "start", part="cov")
    cfg = small(load_config(ROOT / "configs/train/FlowFormerCov_synth_cov.yaml")[0])
    tcfg = run.train_config(cfg)
    h, w, bs, seed = (int(cfg.Train.image_height), int(cfg.Train.image_width), int(cfg.Train.batch_size),
                      int(cfg.Train.seed))
    dataset = TrainPairDataset(cfg.Data.Sequences, cfg.Data.transforms, stereo_prob=float(cfg.Data.stereo_prob))
    rng = np.random.default_rng(seed)          # the runner's stream: run.make_batches(cfg, bs, h, w, seed)
    start = time.perf_counter()
    batches = [dataset.draw(bs, h, w, rng) for _ in range(3)]
    data_ms = (time.perf_counter() - start) * 1e3 / 3
    model = _train_model(cfg, device, CKPT)
    opt = create_optimizer(model, tcfg)
    step = make_train_step(model, opt, tcfg, device)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    _peak_reset(device)
    with _kernel_inputs(model.memory_encoder.perceiver) as seen:
        rec = _timed_steps(step, batches, device)
    rec["peak_memory_bytes"] = _peak(device)
    frozen_equal = all(torch.equal(before[n], p) for n, p in model.named_parameters() if not is_trainable(n, "cov"))
    moved = sorted({".".join(n.split(".")[:3]) for n, p in model.named_parameters() if not torch.equal(before[n], p)})
    rec.update(data_ms_per_batch=data_ms, batch=bs, crop_hw=[h, w], decoder_depth=int(cfg.Model.decoder_depth),
               dtype=str(cfg.Model.encoder_dtype), frozen_bit_identical=frozen_equal, moved_modules=moved,
               steady_step_ms=float(np.median(rec["step_ms"][1:])))
    record("train.cov", rec["launches_per_step"])
    rec["kernel_on_path_tokens"] = _check_kernel_inputs("cov", seen)
    emit("train", "end", part="cov", **rec)
    if not all(np.isfinite(rec["losses"])) or not frozen_equal or not moved:
        raise AssertionError(f"train cov: losses {rec['losses']}, frozen weights bit-identical {frozen_equal}, "
                             f"moved {moved}")
    if on_card and rec["launches_per_step"] != [{"fp32": 0, "bf16": 1}] * 3:
        raise AssertionError(f"train cov: latent attention launches a step {rec['launches_per_step']}, "
                             "not one bf16 launch")
    del seen

    # flow: phase-1 recipe (same data section), 2 steps, then the refolded kernel on an eval pair
    emit("train", "start", part="flow")
    flow_cfg = small(load_config(ROOT / "configs/train/FlowFormerCov_synth.yaml")[0])
    if namespace_to_dict(flow_cfg.Data) != namespace_to_dict(cfg.Data):
        raise AssertionError("train flow: the two recipes' data sections differ; the rendered frames cannot be shared")
    ftcfg = run.train_config(flow_cfg)
    frng = np.random.default_rng(int(flow_cfg.Train.seed))
    start = time.perf_counter()
    fbatches = [dataset.draw(bs, h, w, frng) for _ in range(2)]
    fdata_ms = (time.perf_counter() - start) * 1e3 / 2
    del model, opt, step
    model = _train_model(flow_cfg, device, CKPT)
    opt = create_optimizer(model, ftcfg)
    step = make_train_step(model, opt, ftcfg, device)
    perceiver = model.memory_encoder.perceiver
    key = perceiver._folded_key
    _peak_reset(device)
    rec = _timed_steps(step, fbatches, device)
    rec["peak_memory_bytes"] = _peak(device)
    weights_moved = perceiver._fold_key() != key
    pair = upcast_batch(run.eval_pairs(cfg, h, w)[0], device)
    with torch.no_grad(), precision_scope(device, str(flow_cfg.Model.encoder_dtype)):
        f1, f2 = torch.chunk(model.features(torch.cat([pair["img1"], pair["img2"]])), 2)
        tokens = perceiver.tokenize(all_pairs_correlation(f1, f2)).contiguous()
    latent_attn.reset_launches()
    with torch.no_grad():
        fused = perceiver.fused_input_stage(tokens)
    _sync(device)
    eval_launches = dict(counts)
    stale = [b.clone() for b in (perceiver.fold_m, perceiver.fold_wvp, perceiver.fold_c)]
    perceiver.fold_input_stage()
    refolded = all(torch.equal(a, b) for a, b in zip(stale, (perceiver.fold_m, perceiver.fold_wvp, perceiver.fold_c)))
    with torch.no_grad():
        unfused = perceiver.input_stage(tokens.float()).float()
    err = (fused.float() - unfused).abs()
    atol, rtol = KERNEL_TOL["bf16"]
    agrees = bool((err <= atol + rtol * unfused.abs()).all())
    rec.update(data_ms_per_batch=fdata_ms, weights_moved=weights_moved, refolded_before_the_kernel=refolded,
               eval_pair_tokens=list(tokens.shape), max_abs_err=float(err.max()), atol=atol, rtol=rtol,
               eval_pair_launches=eval_launches, steady_step_ms=rec["step_ms"][-1])
    record("train.flow (steps)", rec["launches_per_step"])
    record("train.flow (eval pair)", [eval_launches])
    emit("train", "end", part="flow", **rec)
    if not all(np.isfinite(rec["losses"])) or not weights_moved or not refolded or not agrees:
        raise AssertionError(f"train flow: {rec}")
    if on_card and (any(sum(s.values()) for s in rec["launches_per_step"])
                    or eval_launches != {"fp32": 0, "bf16": 1}):
        raise AssertionError(f"train flow: kernel launches {rec['launches_per_step']} in the steps, "
                             f"{eval_launches} for the eval pair")

    # eval: the shipped checkpoint in fp32 against the JAX CPU record
    emit("train", "start", part="eval")
    del model, opt, step
    model = _train_model(small(load_config(ROOT / "configs/train/FlowFormerCov_synth_cov.yaml")[0], fp32=True),
                         device, CKPT)
    start = time.perf_counter()
    pairs = run.eval_pairs(cfg, h, w)
    render_ms = (time.perf_counter() - start) * 1e3
    evaluate = run.make_eval_fn(model, tcfg.max_flow)
    _peak_reset(device)
    latent_attn.reset_launches()
    start = time.perf_counter()
    with _kernel_inputs(model.memory_encoder.perceiver) as seen:
        ms = [{k: float(v) for k, v in evaluate(b).items()} for b in pairs]
    eval_ms = (time.perf_counter() - start) * 1e3 / len(pairs)
    eval_launches = dict(counts)
    agg = {k: float(np.mean([m[k] for m in ms])) for k in ms[0]}
    rel = {k: abs(agg[k] - TRAIN_EVAL_JAX_CPU[k]) / abs(TRAIN_EVAL_JAX_CPU[k]) for k in agg}
    rec = {"pairs": len(pairs), "metrics": agg, "jax_cpu_record": TRAIN_EVAL_JAX_CPU, "rel_diff": rel,
           "rel_bound": TRAIN_EVAL_REL, "ms_per_pair": eval_ms, "render_ms": render_ms,
           "launches": eval_launches, "peak_memory_bytes": _peak(device),
           "kernel_on_path_tokens": _check_kernel_inputs("eval", seen)}
    record("train.eval", [eval_launches])
    emit("train", "end", part="eval", **rec)
    if not rehearsal and any(v > TRAIN_EVAL_REL for v in rel.values()):
        raise AssertionError(f"train eval: {agg} not within {TRAIN_EVAL_REL:.0%} of the JAX CPU record")
    if on_card and eval_launches != {"fp32": len(pairs), "bf16": 0}:
        raise AssertionError(f"train eval: kernel launches {eval_launches} for {len(pairs)} fp32 pairs")
    del model, seen

    # step parity: one fp32 flow step on a 1x96x128 crop, the card (cuDNN off) against the CPU
    if on_card:
        emit("train", "start", part="step parity")
        rec = step_parity(device, {k: v[:1, :96, :128] for k, v in batches[0].items()}, cudnn=False)
        rec["bounds"] = PARITY_BOUNDS
        emit("train", "end", part="step parity", **rec)
        if any(rec[k] > bound for k, bound in PARITY_BOUNDS.items()):
            raise AssertionError(f"train step parity: {rec}")

    # fp32 size: the fp32 recipe at 480x640, batch cut from 6 to 2
    emit("train", "start", part="fp32 size")
    fcfg = load_config(ROOT / "configs/train/FlowFormerCov.yaml")[0]
    fbs = 2
    fh, fw = (int(fcfg.Train.image_height), int(fcfg.Train.image_width)) if not rehearsal else (96, 128)
    if rehearsal:
        fcfg.Model.decoder_depth = 2
    start = time.perf_counter()
    fb = next(run.make_batches(fcfg, fbs, fh, fw, int(fcfg.Train.seed)))
    fdata_ms = (time.perf_counter() - start) * 1e3
    model = _train_model(fcfg, device, CKPT)
    ftc = run.train_config(fcfg)
    opt = create_optimizer(model, ftc)
    step = make_train_step(model, opt, ftc, device)
    _peak_reset(device)
    with _kernel_inputs(model.memory_encoder.perceiver) as seen:
        rec = _timed_steps(step, [fb, fb], device)
    rec.update(peak_memory_bytes=_peak(device), data_ms_per_batch=fdata_ms, crop_hw=[fh, fw], batch=fbs,
               reduced={"batch_size": [int(fcfg.Train.batch_size), fbs]}, dtype="fp32",
               decoder_depth=int(fcfg.Model.decoder_depth), steady_step_ms=rec["step_ms"][-1])
    record("train.fp32 size", rec["launches_per_step"])
    rec["kernel_on_path_tokens"] = _check_kernel_inputs("fp32 size", seen)
    emit("train", "end", part="fp32 size", **rec)
    if not all(np.isfinite(rec["losses"])):
        raise AssertionError(f"train fp32 size: losses {rec['losses']}")
    if on_card and rec["launches_per_step"] != [{"fp32": 1, "bf16": 0}] * 2:
        raise AssertionError(f"train fp32 size: latent attention launches a step {rec['launches_per_step']}, "
                             "not one fp32 launch")
    del model, opt, step, seen

    # the runner as a user calls it, then the odometry on its checkpoint
    emit("train", "start", part="runner")
    out_dir = ROOT / "results/chip_smoke_train"
    shutil.rmtree(out_dir, ignore_errors=True)
    out = out_dir / "FlowFormerCov_synth_cov.npz"
    argv = ["--config", str(ROOT / "configs/train/FlowFormerCov_synth_cov.yaml"), "--restore", str(CKPT),
            "--steps", "3", "--log_freq", "1", "--out", str(out), "--device", device.type]
    if rehearsal:
        argv += ["--height", "64", "--width", "96", "--batch", "2"]
    latent_attn.reset_launches()
    start = time.perf_counter()
    run.main(argv)
    _sync(device)
    rec = {"argv": argv[2:], "wall_s": time.perf_counter() - start, "launches": dict(counts),
           "done": (out_dir / "FlowFormerCov_synth_cov.done").exists(),
           "metrics_rows": (out_dir / "FlowFormerCov_synth_cov_metrics.csv").read_text().strip().splitlines()}
    with np.load(CKPT) as ref, np.load(out) as new:
        moved = sorted(k for k in ref.files if not np.array_equal(ref[k], new[k]))
        rec["keys"], rec["moved_keys"] = len(new.files), len(moved)
        rec["only_cov_branch_moved"] = bool(moved) and all(
            any(m in k for m in ("cov_gru", "cov_head", "cov_mask")) for k in moved) and set(new.files) == set(ref.files)
    record(f"train.runner (3 steps + {len(pairs)} eval pairs)", [rec["launches"]])
    emit("train", "end", part="runner", **rec)
    if not rec["done"] or not rec["only_cov_branch_moved"] or len(rec["metrics_rows"]) != 5:
        raise AssertionError(f"train runner: {rec}")
    if on_card and rec["launches"] != {"fp32": 0, "bf16": 3 + len(pairs)}:
        raise AssertionError(f"train runner: kernel launches {rec['launches']}, not {3 + len(pairs)} bf16")
    return launches, out


class CroppedSequence:
    """Center crop of every frame (CPU rehearsal at a tiny size only)."""

    def __init__(self, seq, size: int) -> None:
        self.seq, self.size = seq, size

    def __len__(self):
        return len(self.seq)

    def __getitem__(self, i):
        import dataclasses

        f = self.seq[i]
        s = f.stereo
        h, w = s.height, s.width
        y0, x0 = (h - self.size) // 2, (w - self.size) // 2

        def crop(x):
            return None if x is None else x[:, y0:y0 + self.size, x0:x0 + self.size].contiguous()

        K = s.K.copy()
        K[:, 0, 2] -= x0
        K[:, 1, 2] -= y0
        stereo = dataclasses.replace(s, K=K, imageL=crop(s.imageL), imageR=crop(s.imageR),
                                     gt_flow=crop(s.gt_flow), flow_mask=crop(s.flow_mask),
                                     gt_depth=crop(s.gt_depth))
        return dataclasses.replace(f, stereo=stereo)


def run_odometry(cfg, seq, device, phase: str, system=None, saveto: Path | None = None,
                 received: list | None = None) -> dict:
    """Run ``seq`` through the odometry ``cfg`` builds (or ``system``), each
    frame synced. Metrics against ``seq``'s ground truth; with ``saveto``, as
    the runner takes them: from the result directory (poses in the body frame,
    the ground truth interpolated onto the estimate's stamps). With
    ``received``, each frame the odometry was handed is summed up into it:
    its class, (H, W), device, IMU sample count and whether it has attitude."""
    import numpy as np
    import torch

    from macvo_tpu_torch.data import DevicePrefetcher
    from macvo_tpu_torch.evaluation import evaluate_all, evaluate_sandbox
    from macvo_tpu_torch.odometry import build_odometry

    system = system or build_odometry(cfg, device=device)
    stamps = []

    def on_frame(frame, _odom):
        if device.type == "cuda":
            torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        if received is not None:
            imu = getattr(frame, "imu", None)
            received.append({"type": type(frame).__name__, "hw": tuple(frame.stereo.imageL.shape[1:3]),
                             "device": frame.stereo.imageL.device.type,
                             "imu_samples": 0 if imu is None else int(imu.acc.shape[1]),
                             "attitude": getattr(frame, "attitude", None) is not None})

    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    start = time.perf_counter()
    system.receive_frames(DevicePrefetcher(seq, device), saveto=saveto, on_frame_finished=on_frame)
    n = len(system.graph.frames)
    est = system.graph.frames.data["pose"][:n].astype(np.float64)
    if saveto is not None:
        m = evaluate_sandbox(saveto)
    else:
        gt = np.stack([np.asarray(seq[i].gt_pose[0]) for i in range(len(seq))]).astype(np.float64)
        m = evaluate_all(gt, est)
    frame_ms = np.diff(np.array([start] + stamps)) * 1e3
    rec = {"frames": n, "ATE_m": m["ATE"].rmse, "RTE_m_per_frame": m["RTE"].rmse,
           "ROE_deg_per_frame": m["ROE"].rmse, "frame_ms": [round(float(x), 3) for x in frame_ms],
           "steady_frame_ms_median": float(np.median(frame_ms[2:])) if n > 3 else None}
    if device.type == "cuda":
        rec["max_memory_allocated_bytes"] = int(torch.cuda.max_memory_allocated())
    if not np.isfinite(est).all() or not all(np.isfinite([rec["ATE_m"], rec["RTE_m_per_frame"],
                                                           rec["ROE_deg_per_frame"]])):
        raise AssertionError(f"{phase}: non-finite poses or trajectory metrics {rec}")
    return rec


def check_bounds(phase: str, rec: dict, bounds: dict) -> None:
    for key, metric in (("ATE_m", "ATE"), ("RTE_m_per_frame", "RTE"), ("ROE_deg_per_frame", "ROE")):
        if rec[key] > bounds[metric]:
            raise AssertionError(f"{phase}: {metric} {rec[key]} > bound {bounds[metric]}")


# -- the user's data layouts, written from the real clip (the datasets phase, the port's tests and
# -- scripts/jax_kitti_record.py write them with these functions) ------------------------------------

CLIP_ROOT = ROOT / "assets/test_sequence/TartanAir2_abs_P000"
CLIP_K = (320.0, 320.0, 320.0, 320.0)       # fx, fy, cx, cy of the 640x640 clip (TartanAir v2)
CLIP_BASELINE = 0.25
EUROC_T0_NS = 1403636579763555584           # the first camera stamp of EuRoC MH_01


def read_clip(n: int = 10) -> dict:
    """The real clip's first ``n`` frames as a user's files hold them: BGR
    uint8 images, camera times (s), NED left-camera poses (N,7) float64, and
    the 100 Hz IMU (time s, acc, gyro, global velocity)."""
    import cv2
    import numpy as np

    def imgs(cam):
        files = sorted((CLIP_ROOT / f"image_{cam}cam_front").glob("*.png"))[:n]
        return [cv2.imread(str(f), cv2.IMREAD_COLOR) for f in files]

    imu = {k: np.load(CLIP_ROOT / "imu" / f"{k}.npy") for k in ("imu_time", "acc", "gyro", "vel_global")}
    return {"left": imgs("l"), "right": imgs("r"), "times_s": np.load(CLIP_ROOT / "imu/cam_time.npy")[:n],
            "poses": np.loadtxt(CLIP_ROOT / "pose_lcam_front.txt")[:n], "imu": imu}


def ned_to_edn(poses):
    """NED camera poses (N,7) [t, q_xyzw] -> the same cameras' poses with EDN
    axes in an EDN world, as (N,4,4): KITTI's and EuRoC's convention."""
    import numpy as np

    from macvo_tpu_torch.data.datasets.rectify import EDN2NED_MAT, NED2EDN_MAT
    from macvo_tpu_torch.geometry import se3_np

    mats = np.tile(np.eye(4), (len(poses), 1, 1))
    mats[:, :3, :3] = se3_np.quat_to_matrix(np.asarray(poses, np.float64)[:, 3:])
    mats[:, :3, 3] = poses[:, :3]
    return NED2EDN_MAT @ mats @ EDN2NED_MAT


def write_kitti_layout(base: Path, left, right, K, baseline: float, times_s, poses, seq: str = "00") -> Path:
    """KITTI odometry layout under ``base``: ``sequences/<seq>/image_2``,
    ``image_3``, ``calib.txt`` (P0-P3 of a rectified pair), ``times.txt``,
    and ``poses/<seq>.txt`` (3x4 EDN camera matrices). Returns the sequence root."""
    import cv2
    import numpy as np

    root = base / "sequences" / seq
    for cam, images in (("image_2", left), ("image_3", right)):
        (root / cam).mkdir(parents=True, exist_ok=True)
        for i, img in enumerate(images):
            cv2.imwrite(str(root / cam / f"{i:06d}.png"), img)
    fx, fy, cx, cy = K
    rows = [f"P{i}: {fx!r} 0 {cx!r} {tx!r} 0 {fy!r} {cy!r} 0 0 0 1 0"
            for i, tx in enumerate((0.0, -fx * baseline, 0.0, -fx * baseline))]
    (root / "calib.txt").write_text("\n".join(rows) + "\n")
    np.savetxt(root / "times.txt", np.asarray(times_s, np.float64))
    (base / "poses").mkdir(parents=True, exist_ok=True)
    np.savetxt(base / "poses" / f"{seq}.txt", ned_to_edn(poses)[:, :3].reshape(-1, 12))
    return root


def write_general_layout(root: Path, left, right, times_s=None, poses=None) -> Path:
    """GeneralStereo layout: ``left/``, ``right/``, optional ``times.txt`` and
    ``pose_lcam_front.txt`` (TartanAir rows ``t q_xyzw``). Returns ``root``."""
    import cv2
    import numpy as np

    for cam, images in (("left", left), ("right", right)):
        (root / cam).mkdir(parents=True, exist_ok=True)
        for i, img in enumerate(images):
            cv2.imwrite(str(root / cam / f"{i:06d}.png"), img)
    if times_s is not None:
        np.savetxt(root / "times.txt", np.asarray(times_s, np.float64))
    if poses is not None:
        np.savetxt(root / "pose_lcam_front.txt", np.asarray(poses, np.float64))
    return root


def euroc_raw_images(left, right, K, T_right):
    """What a distorted, unrectified EuRoC rig would have recorded of a
    rectified pinhole pair (``left``, ``right``, BGR, intrinsics ``K``): the
    EuRoC loader's own rectification (its standard cam0/cam1 distortion, the
    L->R extrinsic ``T_right``, camera 0 at the body) undone. Gray 752x480;
    returns (left raw, right raw, the raw K as fx, fy, cx, cy)."""
    import cv2
    import numpy as np

    from macvo_tpu_torch.data.datasets.euroc import DIST_CAM0, DIST_CAM1, EUROC_SIZE

    w, h = EUROC_SIZE
    K_raw = np.array([[458.654, 0, 367.215], [0, 457.296, 248.375], [0, 0, 1.0]])   # EuRoC cam0
    T_LR = np.linalg.inv(T_right)
    R1, R2, P1, P2, *_ = cv2.stereoRectify(K_raw, DIST_CAM0, K_raw, DIST_CAM1, (w, h),
                                           np.ascontiguousarray(T_LR[:3, :3]),
                                           np.ascontiguousarray(T_LR[:3, 3]).reshape(3, 1),
                                           flags=cv2.CALIB_ZERO_DISPARITY, alpha=-1)
    grid = np.stack(np.meshgrid(np.arange(w, dtype=np.float64), np.arange(h, dtype=np.float64)), -1)
    src_K = np.array([[K[0], 0, K[2]], [0, K[1], K[3]], [0, 0, 1.0]])
    out = []
    for img, D, R in ((left, DIST_CAM0, R1), (right, DIST_CAM1, R2)):
        pts = cv2.undistortPoints(grid.reshape(-1, 1, 2), K_raw, D, R=R, P=src_K).reshape(h, w, 2)
        gray = cv2.cvtColor(img, cv2.COLOR_BGR2GRAY)
        out.append(cv2.remap(gray, pts[..., 0].astype(np.float32), pts[..., 1].astype(np.float32),
                             cv2.INTER_LINEAR, borderMode=cv2.BORDER_REFLECT))
    return out[0], out[1], (K_raw[0, 0], K_raw[1, 1], K_raw[0, 2], K_raw[1, 2])


def write_euroc_layout(root: Path, left, right, K, T_right, times_ns, imu, gt) -> Path:
    """EuRoC ASL layout: ``cam0`` / ``cam1`` (``sensor.yaml`` + ``data/<ns>.png``),
    ``imu0/data.csv`` (``imu``: time ns, gyro, acc) and
    ``state_groundtruth_estimate0/data.csv`` (``gt``: time ns, position,
    quaternion xyzw, velocity; written wxyz with zero biases). Camera 0 is
    the body; ``T_right`` is camera 1's body extrinsic. Returns ``root``."""
    import cv2
    import numpy as np
    import yaml

    from macvo_tpu_torch.data.datasets.euroc import DIST_CAM0, DIST_CAM1

    for cam, images, T, D in (("cam0", left, np.eye(4), DIST_CAM0), ("cam1", right, T_right, DIST_CAM1)):
        (root / cam / "data").mkdir(parents=True, exist_ok=True)
        sensor = {"sensor_type": "camera", "rate_hz": 20,
                  "T_BS": {"cols": 4, "rows": 4, "data": [float(x) for x in np.asarray(T).reshape(-1)]},
                  "resolution": [int(images[0].shape[1]), int(images[0].shape[0])], "camera_model": "pinhole",
                  "intrinsics": [float(x) for x in K], "distortion_model": "radial-tangential",
                  "distortion_coefficients": [float(x) for x in D[:4]]}
        (root / cam / "sensor.yaml").write_text(yaml.safe_dump(sensor, sort_keys=False))
        for t, img in zip(times_ns, images):
            cv2.imwrite(str(root / cam / "data" / f"{int(t)}.png"), img)
    t_imu, gyro, acc = imu
    (root / "imu0").mkdir(parents=True, exist_ok=True)
    rows = np.concatenate([np.asarray(t_imu, np.float64)[:, None], gyro, acc], axis=1)
    np.savetxt(root / "imu0" / "data.csv", rows, delimiter=",", fmt=["%d"] + ["%.17g"] * 6, comments="",
               header="#timestamp [ns],w_RS_S_x [rad s^-1],w_RS_S_y [rad s^-1],w_RS_S_z [rad s^-1],"
                      "a_RS_S_x [m s^-2],a_RS_S_y [m s^-2],a_RS_S_z [m s^-2]")
    t_gt, pos, q_xyzw, vel = gt
    rows = np.concatenate([np.asarray(t_gt, np.float64)[:, None], pos, np.roll(q_xyzw, 1, axis=1), vel,
                           np.zeros((len(t_gt), 6))], axis=1)
    (root / "state_groundtruth_estimate0").mkdir(parents=True, exist_ok=True)
    np.savetxt(root / "state_groundtruth_estimate0" / "data.csv", rows, delimiter=",",
               fmt=["%d"] + ["%.17g"] * 16, comments="",
               header="#timestamp, p_RS_R_x [m], p_RS_R_y [m], p_RS_R_z [m], q_RS_w [], q_RS_x [], q_RS_y [], "
                      "q_RS_z [], v_RS_R_x [m s^-1], v_RS_R_y [m s^-1], v_RS_R_z [m s^-1], b_w_RS_S_x [rad s^-1], "
                      "b_w_RS_S_y [rad s^-1], b_w_RS_S_z [rad s^-1], b_a_RS_S_x [m s^-2], b_a_RS_S_y [m s^-2], "
                      "b_a_RS_S_z [m s^-2]")
    return root


def phase_datasets(device, size: int) -> dict:
    """The user's data layouts (module docstring, phase 13), written from the
    real clip into a temporary directory under results/ and read through the
    runner's build_sequence. Returns the latent-attention launches of each run
    by kernel name. ``size`` > 0: CPU rehearsal on a center crop of that size."""
    import tempfile

    import numpy as np

    from macvo_tpu_torch.__main__ import build_sequence
    from macvo_tpu_torch.data import StereoInertialFrame
    from macvo_tpu_torch.data.datasets.euroc import EUROC_BASELINE
    from macvo_tpu_torch.data.datasets.rectify import NED2EDN_MAT
    from macvo_tpu_torch.geometry import se3_np
    from macvo_tpu_torch.odometry import build_odometry
    from macvo_tpu_torch.ops import latent_attn
    from macvo_tpu_torch.utils.config import build_dynamic_config, load_config

    on_card = device.type == "cuda"
    clip = read_clip(10)
    K = list(CLIP_K)
    if size:      # rehearsal: a center crop, resized by Preprocess to a few dozen pixels
        y0 = x0 = (640 - size) // 2
        for cam in ("left", "right"):
            clip[cam] = [np.ascontiguousarray(im[y0:y0 + size, x0:x0 + size]) for im in clip[cam]]
        K[2], K[3] = K[2] - x0, K[3] - y0
    launches = {"latent_cross_attention[fp32]": {}, "latent_cross_attention[bf16]": {}}

    def config(name: str, seq_type: str, rehearsal_hw: tuple[int, int] | None = None):
        """The shipped config; in a rehearsal, 2 decoder steps and the
        sequence type's Preprocess target cut to ``rehearsal_hw``."""
        cfg = load_config(ROOT / "configs/experiment/macvo" / name)[0]
        cfg.Odometry.frontend.args.weight = str(CKPT)
        if size:
            cfg.Odometry.frontend.args.decoder_depth = 2
            if rehearsal_hw:
                args = getattr(cfg.Preprocess, seq_type)[0].args
                args.height, args.width = rehearsal_hw
        return cfg

    def run(part, cfg, data, dtype, n_frames, hw):
        seq = build_sequence(build_dynamic_config({"Sequence": data})[0], cfg)
        if len(seq) != n_frames:
            raise AssertionError(f"datasets {part}: {len(seq)} frames, not {n_frames}")
        system = build_odometry(cfg, device=device)
        perceiver = system.Frontend.runner.model.memory_encoder.perceiver
        latent_attn.reset_launches()
        received = []
        with _kernel_inputs(perceiver) as seen:
            rec = run_odometry(cfg, seq, device, f"datasets {part}", system=system, saveto=out / part,
                               received=received)
        rec["latent_attn_launches"] = dict(latent_attn.latent_cross_attention.launches_by_dtype)
        rec["frontend_hw"] = sorted({f["hw"] for f in received})
        rec["kernel_on_path_tokens"] = _check_kernel_inputs(f"datasets {part}", seen)
        launches[f"latent_cross_attention[{dtype}]"][f"datasets.{part}"] = rec["latent_attn_launches"][dtype]
        if rec["frontend_hw"] != [hw] or any(f["device"] != device.type for f in received):
            raise AssertionError(f"datasets {part}: the odometry was handed {received}, not {hw} frames "
                                 f"on {device.type}")
        other = "bf16" if dtype == "fp32" else "fp32"
        if on_card and (rec["latent_attn_launches"][dtype] != rec["frames"] or rec["latent_attn_launches"][other]):
            raise AssertionError(f"datasets {part}: latent attention launches {rec['latent_attn_launches']} "
                                 f"over {rec['frames']} frames, not one {dtype} launch a frame")
        return received, rec

    (ROOT / "results").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "results", prefix="chip_smoke_datasets_") as tmp:
        out = Path(tmp) / "runs"

        # kitti: the whole clip as a KITTI odometry sequence, MACVO_Performant as shipped
        emit("datasets", "start", part="kitti")
        start = time.perf_counter()
        root = write_kitti_layout(Path(tmp) / "kitti", clip["left"], clip["right"], K, CLIP_BASELINE,
                                  clip["times_s"], clip["poses"])
        write_s = time.perf_counter() - start
        hw = (376, 780) if not size else (size // 2 - 1, size)
        _, rec = run("kitti", config("MACVO_Performant.yaml", "KITTI", hw), {"type": "KITTI", "args": {
            "root": str(root), "gt_pose": True}}, "fp32", 10, hw)
        rec.update(write_s=write_s, jax_cpu_record=KITTI_JAX_CPU,
                   ate_bound_m=max(0.05, 2 * KITTI_JAX_CPU["ATE"]))
        emit("datasets", "end", part="kitti", **rec)
        if not size and rec["ATE_m"] > rec["ate_bound_m"]:
            raise AssertionError(f"datasets kitti: ATE {rec['ATE_m']} m > {rec['ate_bound_m']} m")

        # general: a 480x640 crop of the clip as a user's own rig, MACVO_Fast (bf16); Preprocess -> 640x640
        emit("datasets", "start", part="general")
        crop = slice(80, 560) if not size else slice(size // 8, size - size // 8)
        g_root = write_general_layout(Path(tmp) / "general", [im[crop] for im in clip["left"][:4]],
                                      [im[crop] for im in clip["right"][:4]], clip["times_s"][:4],
                                      clip["poses"][:4])
        fx, fy, cx, cy = K
        hw = (640, 640) if not size else (size // 2, size // 2)
        _, rec = run("general", config("MACVO_Fast.yaml", "GeneralStereo", hw), {"type": "GeneralStereo", "args": {
            "root": str(g_root), "fx": fx, "fy": fy, "cx": cx, "cy": cy - crop.start, "baseline": CLIP_BASELINE,
            "pose_file": str(g_root / "pose_lcam_front.txt")}}, "bf16", 4, hw)
        emit("datasets", "end", part="general", **rec)

        # euroc: a raw (distorted, unrectified) gray EuRoC recording of the clip, with its real 100 Hz IMU
        emit("datasets", "start", part="euroc")
        n = 5                              # the first and last stamps are the ground truth's ends: 3 frames
        T_right = np.eye(4)
        T_right[:3, :3] = se3_np.quat_to_matrix(se3_np.exp(np.array([0, 0, 0, 0.002, -0.003, 0.004]))[3:])
        T_right[:3, 3] = (EUROC_BASELINE, 0.0005, -0.0004)
        raw = [euroc_raw_images(l, r, K, T_right) for l, r in zip(clip["left"][:n], clip["right"][:n])]
        t_cam = EUROC_T0_NS + np.round(clip["times_s"][:n].astype(np.float64) * 1e9).astype(np.int64)
        imu = clip["imu"]
        k = imu["imu_time"] <= clip["times_s"][n - 1] + 1e-6
        R = NED2EDN_MAT[:3, :3]
        scale = EUROC_BASELINE / CLIP_BASELINE      # the loader's baseline is EuRoC's: the world scales with it
        gt_mats = ned_to_edn(clip["poses"][:n])
        e_root = write_euroc_layout(
            Path(tmp) / "euroc" / "MH_01", [r[0] for r in raw], [r[1] for r in raw], raw[0][2], T_right, t_cam,
            (EUROC_T0_NS + np.round(imu["imu_time"][k] * 1e9).astype(np.int64), imu["gyro"][k] @ R.T,
             imu["acc"][k] @ R.T),
            (t_cam, gt_mats[:, :3, 3] * scale, se3_np.quat_from_matrix(gt_mats[:, :3, :3]),
             imu["vel_global"][::10][:n] @ R.T * scale))
        received, rec = run("euroc", config("MACVO_Performant.yaml", "EuRoC_IMU"), {"type": "EuRoC_IMU", "args": {"root": str(e_root), "gt_pose": True}},
                       "fp32", n - 2, (480, 752))
        rec["frame_types"] = sorted({f["type"] for f in received})
        rec["imu_samples"] = [f["imu_samples"] for f in received]
        rec["attitude"] = all(f["attitude"] for f in received)
        emit("datasets", "end", part="euroc", **rec)
        if rec["frame_types"] != [StereoInertialFrame.__name__] or not all(rec["imu_samples"]) \
                or not rec["attitude"]:
            raise AssertionError(f"datasets euroc: the odometry was handed {received}, not StereoInertialFrames "
                                 "with IMU samples and attitude")
    return launches


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda", help=argparse.SUPPRESS)
    parser.add_argument("--size", type=int, default=0, help=argparse.SUPPRESS)      # CPU rehearsal crop
    args = parser.parse_args()

    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs one NVIDIA card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from macvo_tpu_torch.data import SequenceBase
    from macvo_tpu_torch.data.datasets.tartanair import TartanAirV2
    from macvo_tpu_torch.ops import correlation, latent_attn
    from macvo_tpu_torch.ops._build import build
    from macvo_tpu_torch.utils.config import build_dynamic_config, load_config

    device = torch.device(args.device)
    on_card = device.type == "cuda"

    # 1. device
    emit("device", "start")
    smi = ""
    if on_card:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0) if on_card else "cpu"
    emit("device", "end", kind=kind, count=torch.cuda.device_count() if on_card else 0, nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda)

    # 2. build
    if on_card:
        from concurrent.futures import ThreadPoolExecutor

        emit("build", "start")
        start = time.perf_counter()
        with ThreadPoolExecutor(2) as pool:     # one nvcc process a source, started together
            built = list(pool.map(build, ("latent_attn", "correlation")))
        emit("build", "end", wall_s=round(time.perf_counter() - start, 3), libraries=[
            {"library": str(b.path.relative_to(ROOT)), "nvcc_s": round(b.seconds, 3), "ptxas": b.ptxas.splitlines()}
            for b in built])

    # 3. kernel
    emit("kernel", "start")
    kernel_recs = phase_kernel(device, 12800 if on_card else 64, 100 if on_card else 4, timed=on_card)
    corr_shapes = CORR_SHAPES + [CORR_ODD] if on_card else [(1, 8, 12, 16), (1, 16, 5, 7)]
    kernel_recs.update(phase_correlation(device, corr_shapes, timed=on_card))
    emit("kernel", "end")

    clip = load_config(ROOT / CLIP)[0].Sequence.args
    gt_seq = TartanAirV2({"root": str(ROOT / clip.root), "compressed": True,
                          "gtFlow": True, "gtDepth": True, "gtPose": True})
    learned_seq = TartanAirV2({"root": str(ROOT / clip.root), "compressed": True,
                               "gtFlow": False, "gtDepth": False, "gtPose": True})

    # 4. network: the card against the CPU on a small crop of a real pair
    emit("network", "start")
    phase_network(device, learned_seq[0], learned_seq[1])
    phase_tartanvo_networks(device, learned_seq[0], learned_seq[1])
    emit("network", "end")

    # 5. GT frontend through the whole backend
    emit("gt", "start")
    if args.size:
        gt_seq, learned_seq = CroppedSequence(gt_seq, args.size), CroppedSequence(learned_seq, args.size)
    gt_cfg = build_dynamic_config({"Odometry": {
        "args": {"num_point": 200, "edgewidth": 32, "match_cov_default": 0.25, "profile": False,
                 "mapping": False},
        "frontend": {"type": "FrontendCompose", "args": {
            "depth": {"type": "GTDepth", "args": {}}, "match": {"type": "GTMatcher", "args": {}}}},
        "motion": {"type": "StaticMotionModel", "args": {}},
        "keypoint": {"type": "RandomSelector", "args": {"mask_width": 32}},
        "mappoint": {"type": "RandomSelector", "args": {"mask_width": 32}},
        "outlier": {"type": "FilterCompose", "args": {"filter_args": [
            {"type": "CovarianceSanityFilter", "args": {}},
            {"type": "SimpleDepthFilter", "args": {"min_depth": 0.05, "max_depth": "auto"}}]}},
        "cov": {"obs": {"type": "MatchCovariance", "args": {
            "kernel_size": 31, "match_cov_default": 0.25, "min_flow_cov": 0.25, "min_depth_cov": 0.05}}},
        "postprocess": {"type": "MotionInterpolate", "args": {}},
        "keyframe": {"type": "AllKeyframe", "args": {}},
        "optimizer": {"type": "Local_TwoFrame_PGO", "args": {
            "graph_type": "icp", "parallel": True, "use_fp64": True, "capacity": 256}},
    }})[0]
    rec = run_odometry(gt_cfg, gt_seq, device, "gt")
    emit("gt", "end", bounds=GT_BOUNDS, **rec)
    if not args.size:
        check_bounds("gt", rec, GT_BOUNDS)

    # 6./7. learned frontend, Performant (fp32) then Fast (bf16)
    launches = {}
    for phase, cfg_file, kname in (("performant", "MACVO_Performant.yaml", "latent_cross_attention[fp32]"),
                                   ("fast", "MACVO_Fast.yaml", "latent_cross_attention[bf16]")):
        emit(phase, "start")
        cfg = load_config(ROOT / "configs/experiment/macvo" / cfg_file)[0]
        cfg.Odometry.frontend.args.weight = str(ROOT / "model/MACVO_FrontendCov.npz")
        latent_attn.reset_launches()
        rec = run_odometry(cfg, learned_seq, device, phase)
        launches[kname] = latent_attn.latent_cross_attention.launches_by_dtype[kname[-5:-1]]
        rec["latent_attn_launches"] = dict(latent_attn.latent_cross_attention.launches_by_dtype)
        emit(phase, "end", ate_bound_m=LEARNED_ATE[phase], **rec)
        if not args.size and rec["ATE_m"] > LEARNED_ATE[phase]:
            raise AssertionError(f"{phase}: ATE {rec['ATE_m']} m > {LEARNED_ATE[phase]} m")
        if on_card and (launches[kname] < rec["frames"] - 1
                        or latent_attn.latent_cross_attention.launches != launches[kname]):
            raise AssertionError(f"{phase}: latent attention kernel launched {launches[kname]} times "
                                 f"over {rec['frames']} frames")

    # 8. TartanVO baseline: PWC (5 correlation launches a pair) + stereo + pose net
    emit("tartanvo", "start")
    cfg = load_config(ROOT / "configs/experiment/baseline/TartanVO.yaml")[0]
    for node, ckpt in ((cfg.Odometry.match, "flow"), (cfg.Odometry.depth, "stereo"),
                       (cfg.Odometry.tartanvo, "posenet")):
        node.args.weight = str(ROOT / "model" / f"TartanVO_{ckpt}.npz")
    correlation.local_correlation.launches = 0
    rec = run_odometry(cfg, learned_seq, device, "tartanvo")
    launches["local_correlation"] = correlation.local_correlation.launches
    rec["correlation_launches"] = launches["local_correlation"]
    emit("tartanvo", "end", jax_cpu_record=TARTANVO_JAX_CPU, rel_bound=TARTANVO_REL, **rec)
    if not args.size:
        for key, metric in (("ATE_m", "ATE"), ("RTE_m_per_frame", "RTE"), ("ROE_deg_per_frame", "ROE")):
            ref = TARTANVO_JAX_CPU[metric]
            if abs(rec[key] - ref) > TARTANVO_REL * ref:
                raise AssertionError(f"tartanvo: {metric} {rec[key]} not within {TARTANVO_REL:.0%} of {ref}")
    if on_card and launches["local_correlation"] != 5 * (rec["frames"] - 1):
        raise AssertionError(f"tartanvo: correlation kernel launched {launches['local_correlation']} times "
                             f"over {rec['frames']} frames, not 5 a pair")

    # 9. the synthetic quickstart: GT frontend, no kernel on the path
    emit("synthetic", "start")
    cfg = load_config(ROOT / "configs/experiment/macvo/MACVO_Synthetic.yaml")[0]
    synth_seq = SequenceBase.from_config(cfg.Data.Sequence)
    start = time.perf_counter()
    synth_frames = [synth_seq[i] for i in range(len(synth_seq))]     # rendered before the run, not inside it
    render_s = time.perf_counter() - start
    latent_attn.reset_launches()
    correlation.local_correlation.launches = 0
    rec = run_odometry(cfg, synth_frames, device, "synthetic")
    rec["render_s"] = render_s
    rec["kernel_launches"] = {"latent_cross_attention": latent_attn.latent_cross_attention.launches,
                              "local_correlation": correlation.local_correlation.launches}
    emit("synthetic", "end", bounds=GT_BOUNDS, note="GT frontend: no kernel on this path", **rec)
    check_bounds("synthetic", rec, GT_BOUNDS)
    if any(rec["kernel_launches"].values()):
        raise AssertionError(f"synthetic: a kernel launched on a path that has none: {rec['kernel_launches']}")

    # 10./11. Paper_Reproduce and three ablation configs on the real clip
    by_phase = {"latent_cross_attention[fp32]": {"performant": launches["latent_cross_attention[fp32]"]},
                "latent_cross_attention[bf16]": {"fast": launches["latent_cross_attention[bf16]"]}}
    runs = [("paper", "Paper_Reproduce.yaml")] + [("ablation", f"ablation/{a}.yaml") for a in ABLATIONS]
    for phase, cfg_file in runs:
        variant = Path(cfg_file).stem
        emit(phase, "start", config=variant)
        cfg = load_config(ROOT / "configs/experiment/macvo" / cfg_file)[0]
        cfg.Odometry.frontend.args.weight = str(ROOT / "model/MACVO_FrontendCov.npz")
        if cfg.Odometry.motion.type == "TartanMotionNet":
            cfg.Odometry.motion.args.weight = str(ROOT / "model/TartanVO_posenet.npz")
        latent_attn.reset_launches()
        rec = run_odometry(cfg, learned_seq, device, phase)
        rec["latent_attn_launches"] = latent_attn.latent_cross_attention.launches_by_dtype["fp32"]
        rec["latent_attn_launches_bf16"] = latent_attn.latent_cross_attention.launches_by_dtype["bf16"]
        by_phase["latent_cross_attention[fp32]"][f"{phase}[{variant}]"] = rec["latent_attn_launches"]
        emit(phase, "end", config=variant, ate_bound_m=LEARNED_ATE.get(phase), **rec)
        if not args.size and phase in LEARNED_ATE and rec["ATE_m"] > LEARNED_ATE[phase]:
            raise AssertionError(f"{phase}: ATE {rec['ATE_m']} m > {LEARNED_ATE[phase]} m")
        if on_card and (rec["latent_attn_launches"] != rec["frames"] or rec["latent_attn_launches_bf16"]):
            raise AssertionError(f"{phase} ({variant}): latent attention kernel launched "
                                 f"{rec['latent_attn_launches']} (fp32) times over {rec['frames']} frames, "
                                 "not one fp32 launch a frame")

    # 12. training: five checks, then the odometry on the checkpoint the runner wrote
    emit("train", "start")
    train_launches, trained = phase_train(device, rehearsal=bool(args.size))
    for name, parts in train_launches.items():
        by_phase.setdefault(name, {}).update(parts)
    cfg = load_config(ROOT / "configs/experiment/macvo/MACVO_Performant.yaml")[0]
    cfg.Odometry.frontend.args.weight = str(trained)
    seq3 = TartanAirV2({"root": str(ROOT / clip.root), "compressed": True, "gtFlow": False, "gtDepth": False,
                        "gtPose": True}).clip(0, 3)
    latent_attn.reset_launches()
    rec = run_odometry(cfg, CroppedSequence(seq3, args.size) if args.size else seq3, device, "train")
    rec["latent_attn_launches"] = latent_attn.latent_cross_attention.launches_by_dtype["fp32"]
    by_phase["latent_cross_attention[fp32]"]["train.odometry (trained checkpoint, 3 frames)"] = rec["latent_attn_launches"]
    emit("train", "end", part="odometry on the trained checkpoint", weight=str(trained.relative_to(ROOT)), **rec)
    if on_card and (rec["latent_attn_launches"] != rec["frames"] or latent_attn.latent_cross_attention.launches
                    != rec["frames"]):
        raise AssertionError(f"train: odometry on the trained checkpoint launched the kernel "
                             f"{rec['latent_attn_launches']} times over {rec['frames']} frames")
    shutil.rmtree(trained.parent)       # the 55 MB checkpoint and its run's files

    # 13. the user's data: KITTI, GeneralStereo and EuRoC layouts of the clip through the runner's sequence
    emit("datasets", "start")
    start = time.perf_counter()
    for name, parts in phase_datasets(device, args.size).items():
        by_phase.setdefault(name, {}).update(parts)
    emit("datasets", "end", wall_s=time.perf_counter() - start)

    # 14. kernels
    kernels = []
    for name, rec in kernel_recs.items():
        source, replaces = KERNEL_SOURCES[name.split("[")[0]]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces, "launches": launches[name],
            "max_abs_err": rec["max_abs_err"], "ms": rec.get("ms"), "plain_ms": rec.get("plain_ms"),
            "bound_ms": rec.get("bound_ms"), "bound_by": rec.get("bound_by"), "library_ms": None,
            "bound_share": rec.get("bound_share"), "device_ms": rec.get("device_ms"),
            "device_bound_share": rec.get("device_bound_share"),
        })
        if name in by_phase:
            kernels[-1]["launches_by_phase"] = by_phase[name]
    print(json.dumps({"kernels": kernels}), flush=True)
    if on_card:
        print(smi, flush=True)
        print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                                 "count": torch.cuda.device_count()}}), flush=True)
    else:
        print("chip_smoke: CPU rehearsal finished (no result: the run is only valid on a card)", flush=True)
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
