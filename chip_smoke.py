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
              the main path calls it, and the JAX signature), and in fp32 at
              N = 51,200 (phase 20's one forward of four sequences); the local
              correlation at the five shapes of a 640x640 PWC forward and an
              odd one; its backward kernel (both gradients in one launch) at
              the five shapes of a trainer batch (4x320x448) and of a 640x640
              forward, a second run bit-identical to the first.
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
14. dense   - FlowFormerCovMatcher and FlowFormerCovDepth (fp32, shipped
              checkpoint, 12 decoder steps) on the clip with its ground truth:
              evaluate_flow / evaluate_flowcov over the 9 pairs and
              evaluate_depth / evaluate_depthcov over the 10 frames, every field
              within 1 % of the JAX CPU record (scripts/jax_dense_record.py),
              one fp32 latent-attention launch an estimate, the EPE beside the
              JAX package's pin of the checkpoint (tests/test_real_asset.py:218);
              FlowFormerMatcher / FlowFormerDepth give the cov variants' flow and
              depth; ApplyGTMatchCov and ApplyGTMatchMask around FlowFormerMatcher
              and ApplyGTDepthCov around GTDepth give finite metrics.
15. tartanvo_cov - TartanVOCovMatcher (PWC + RAFT-style covariance) with
              seeded random weights (``random:0``; the trained checkpoint does not
              fit in the chip copy) on the clip: the card against the CPU on the
              first pair, evaluate_flowcov finite, 6 correlation launches a pair.
16. train_tvo - the TartanVO trainer (python -m macvo_tpu_torch.train.tartanvo,
              through its main): 3 SyntheticStereo seq_* layouts written into a
              temporary directory, 3 steps of each mode at batch 4 on 320x448
              crops with their evaluations; finite losses, backward-kernel
              launches 5 a flow step, 1 a flowcov step, 0 a stereo step, the
              flowcov run's pwc bit-identical to the flow checkpoint it restored;
              steady ms a step and peak memory; then one fp32 flow step on a
              2x64x128 batch, card (cuDNN off) against CPU, within the step-parity
              bounds of phase 12.
17. runner  - ``python -m macvo_tpu_torch`` through its ``main``: MACVO_Performant.yaml
              on the clip (10 frames, 640x640) with ``--timing`` into a result
              sandbox under results/: metadata.yaml, config.yaml, poses.npy and
              elapsed_time.json in it; the JAX package's six timer sections
              (Odom_Runtime, Sync consume, Frontend.estimate, KP pipeline,
              Frontend.forward, TwoframePGO.dispatch) and the frontend's device
              section (CUDA events), one Odom_Runtime a frame, the device section
              finite; one fp32 latent-attention launch a frame; ATE <= 0.05 m;
              each section's median ms on one line. The poses bit-identical to a
              second run without ``--timing``; a third run (3 frames) with the
              stamp held at the first's lands in ``<stamp>_1``; a run with
              ``--autoremove`` in a process of its own leaves no directory.
              ``--saveplt`` and its figures where matplotlib is installed; where
              it is not, the runner must refuse the flag before the run (a line
              says so) and the timed run goes without it.
18. posenet - two 24-frame RandomizedStereo worlds (160x120) written by
              scripts/torch_gen_randomized.py (render seconds reported), then
              ``python -m macvo_tpu_torch.train.posenet --holdout 1 --steps 20
              --batch 16`` through its ``main``: finite losses, steady ms a step,
              peak memory; one step card (cuDNN off) against the CPU's float64
              step within phase 12's step-parity bounds (the fp32 CPU step
              reported beside it); the written npz as TartanMotionNet in
              Paper_Reproduce.yaml on 3 frames of the clip: finite poses, one fp32
              latent-attention launch a frame.
19. experiment - scripts/torch_experiment_macvo.py through its ``main``:
              MACVO_Performant.yaml over the clip and the clip written as a
              GeneralStereo rig, ``--seq_to 4``: evaluation.csv with one row a
              sequence and the average, children.txt naming both, one fp32
              latent-attention launch a frame.
20. batch   - BatchedOdometry (macvo_tpu_torch.parallel) with MACVO_Performant.yaml
              over four 640x640 sequences in lockstep: the clip, the clip
              backwards (re-stamped in ascending time), SyntheticStereo seeds 7
              and 8 (rendered on host threads before any timed run). On the first
              pair each sequence's flow within 1e-3 px (99.99th percentile; 5e-3 px
              at most) and covariance within 1e-3 relative of the unbatched
              frontend; one fp32 latent-attention launch
              a lockstep step (N = 51,200); ATE <= 0.05 m both ways along the clip;
              every sequence's ATE within 5 mm of its run alone through MACVO.
              Lockstep and alone frames/s, the device's busy share of the
              lockstep run (torch.profiler device time over the plain run's wall
              time), peak memory.
21. parallel - in a world of one over NCCL: the observation-sharded solve
              bit-identical to solve_two_frame (37 and 40 observations, icp and
              disp); one make_sharded_train_step cov step (FlowFormerCov_synth_cov.yaml,
              bf16, batch 6 at 240x320, shipped checkpoint) leaving every
              parameter bit-identical to make_train_step's, one bf16 launch a
              step; then dryrun_multichip(1) in its own process, entry() on the
              card against the CPU within phase 4's bound, and
              scripts/torch_throughput.py --sequences 4 at 320x240.
22. calib   - seq_1049 written by scripts/torch_gen_randomized.py at a cut size
              (5 frames at 320x240); scripts/torch_fit_cov_temperature.py on the
              shipped checkpoint into a temporary directory (edges ascending,
              tau2 finite and positive, read back by load_cov_calib, raw and
              recalibrated coverage); torch_cov_calibration.py on the clip;
              torch_depth_quality.py and torch_match_quality.py on
              the clip with GTDepth / GTMatcher; torch_montecarlo_cov.py at its
              own --tol.
23. kernels - one JSON line listing every ported kernel.

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
    # not a Pallas kernel: the JAX package's VJP of its XLA twin
    "local_correlation_backward": ("macvo_tpu_torch/csrc/correlation_bwd.cu", "macvo_tpu/ops/correlation.py:126"),
}
# (B, C, H, W) of the five correlation calls of a PWC forward on a trainer batch (4x320x448), then at 640x640
CORR_BWD_SHAPES = {"trainer 4x320x448": [(4, 32, 80, 112), (4, 64, 40, 56), (4, 96, 20, 28), (4, 128, 10, 14),
                                         (4, 196, 5, 7)],
                   "640x640": CORR_SHAPES}
# The four evaluate_* of FlowFormerCovMatcher / FlowFormerCovDepth (fp32, model/MACVO_FrontendCov.npz, 12
# decoder steps) on the 10-frame clip at 640x640: the JAX package on the CPU,
# `JAX_PLATFORMS=cpu python scripts/jax_dense_record.py` (jax 0.9.0, 150 s)
DENSE_JAX_CPU = {
    "flow": {"masked_epe": 3.319737103250292, "epe": 3.319737103250292, "px1": 0.41795383559332955,
             "px3": 0.7426673703723483, "px5": 0.8662996424569024},
    "flowcov": {"masked_nll": 7.048918644587199, "q25_nll": 0.341317527823978, "q50_nll": 1.5938520828882854,
                "q75_nll": 3.503373901049296},
    "depth": {"masked_err": 2.2602227926254272, "err_25": 0.00885327160358429, "err_50": 0.030036240816116333,
              "err_75": 0.2215334177017212},
    "depthcov": {"masked_nll": 13.011934679746627, "q25_nll": -6.733919095993042, "q50_nll": -4.457796481251717,
                 "q75_nll": 6.072745704650879}}
DENSE_REL = 0.01
# The JAX package's accuracy pin of the shipped checkpoint's flow EPE on the clip (tests/test_real_asset.py:218:
# model/MACVO_FrontendCov.eval.json's 3.3079 px x 1.2 + 0.5); an accuracy figure, reported beside the port's EPE
DENSE_EPE_PIN = 3.3079 * 1.2 + 0.5
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


def phase_kernel(device, n: int, t: int, timed: bool, dtypes=("bf16", "fp32")) -> dict:
    """latent_cross_attention kernel vs its plain version, for each of
    ``dtypes``: the entry the main path calls (weights folded beforehand) and
    the JAX-signature wrapper (folds on every call). ``ms`` times the former."""
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
    for dtype in [{"bf16": torch.bfloat16, "fp32": torch.float32}[d] for d in dtypes]:
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
    return {"crop_hwb": list(crop["img1"].shape[1:3]) + [int(crop["img1"].shape[0])], "cudnn": cudnn,
            "loss_grad_rel_err": ct_err, "loss_grad_within_rounding": int((~decided).sum()),
            "loss_grad_elements": int(decided.numel()), **_step_errors(cpu, card, tcfg.clip)}


def _step_errors(cpu: dict, card: dict, clip_norm: float) -> dict:
    """Card against CPU after one step (each a dict of loss, grads, lr,
    update and weights before the step, by parameter name): the loss, each
    leaf's gradient over its scale (at least 1e-4 of the largest), and each
    weight's update where the CPU's clipped gradient is far from 0 (1e-2 of
    its leaf's scale, 100 Adam eps), so both first Adam steps move the weight
    by lr in one direction: over 1e-3 lr + 2 ulps (each device rounds the new
    weight twice: decay, then the Adam update)."""
    import torch

    gh = cpu["grads"]
    gmax = max(float(g.abs().max()) for g in gh.values())
    leaf = sorted(((float((card["grads"][n] - g).abs().max()) / max(float(g.abs().max()), 1e-4 * gmax), n)
                   for n, g in gh.items()), reverse=True)
    norm = float(torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in gh.values()])))
    clip = min(1.0, clip_norm / norm)
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
    return {"lr": lr, "loss": {"cpu": cpu["loss"], "card": card["loss"]},
            "loss_rel_err": abs(card["loss"] - cpu["loss"]) / abs(cpu["loss"]),
            "grad_rel_err": leaf[0][0], "worst_leaves": [{"rel_err": e, "leaf": n} for e, n in leaf[:3]],
            "update_err_share_of_bound": upd_err, "updates_checked": n_checked, "updates_over": n_over,
            "weights": sum(g.numel() for g in gh.values()),
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


# -- phases 14-16: the dense matchers and depths, TartanVOCovMatcher, the TartanVO trainer; and the
# -- correlation backward's check of phase 3 -----------------------------------------------------

def correlation_bwd_bound_ms(b: int, c: int, h: int, w: int) -> tuple[float, str]:
    """Least time for one backward call: f1, f2 and g read once, both gradients
    written once ((4C + 81) floats a pixel), against 4 * 81 * C FLOPs a pixel
    at the fp32 rate."""
    pixels = b * h * w
    t_bytes = (4 * c + 81) * pixels * 4 / H100["bytes_per_s"] * 1e3
    t_ops = 4 * 81 * c * pixels / H100["flops"]["float32"] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_correlation_bwd(device, shape_sets: dict, timed: bool) -> dict:
    """local_correlation_backward kernel vs its plain version at each shape
    (both gradients, atol = rtol = 1e-5: sums over the 81 displacements in
    another order), and a second run bit-identical to the first. The record
    sums ms, plain ms and bound over the shapes of the first set (a trainer
    step's five calls); the other sets are in the emitted lines."""
    import torch

    from macvo_tpu_torch.ops import correlation

    gen = torch.Generator().manual_seed(2)
    sums = {}
    for set_name, shapes in shape_sets.items():
        total = {"ms": 0.0, "device_ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "max_abs_err": 0.0}
        bound_by = set()
        for shape in shapes:
            b, _, h, w = shape
            f1, f2 = (torch.randn(shape, generator=gen).to(device) for _ in range(2))
            g = torch.randn((b, 81, h, w), generator=gen).to(device)
            g1, g2 = correlation.local_correlation_backward(f1, f2, g)
            h1, h2 = correlation.local_correlation_backward(f1, f2, g)
            r1, r2 = correlation.local_correlation_bwd_torch(f1, f2, g)
            _sync(device)
            err = max(float((g1 - r1).abs().max()), float((g2 - r2).abs().max()))
            ok = all(bool(((o - r).abs() <= 1e-5 + 1e-5 * r.abs()).all()) for o, r in ((g1, r1), (g2, r2)))
            same = bool(torch.equal(g1, h1) and torch.equal(g2, h2))
            rec = {"set": set_name, "shape_bchw": list(shape), "max_abs_err": err, "atol": 1e-5, "rtol": 1e-5,
                   "bit_identical_rerun": same}
            rec["bound_ms"], rec["bound_by"] = correlation_bwd_bound_ms(*shape)
            if timed:
                rec["ms"] = cuda_time_ms(lambda: correlation.local_correlation_backward(f1, f2, g), 50)
                rec["device_ms"] = graph_time_ms(lambda: correlation.local_correlation_backward(f1, f2, g), 50)
                rec["plain_ms"] = cuda_time_ms(lambda: correlation.local_correlation_bwd_torch(f1, f2, g), 10)
                rec["bound_share"] = rec["bound_ms"] / rec["ms"]
                rec["device_bound_share"] = rec["bound_ms"] / rec["device_ms"]
            emit("kernel", "check", kernel="local_correlation_backward", agrees=ok and same, **rec)
            if not (ok and same):
                raise AssertionError(f"local_correlation_backward: disagrees with its plain version or between "
                                     f"two runs ({rec})")
            total["max_abs_err"] = max(total["max_abs_err"], err)
            bound_by.add(rec["bound_by"])
            for key in ("ms", "device_ms", "plain_ms", "bound_ms"):
                total[key] += rec.get(key, 0.0)
        total["bound_by"] = " and ".join(sorted(bound_by))
        if timed:
            total["bound_share"] = total["bound_ms"] / total["ms"]
            total["device_bound_share"] = total["bound_ms"] / total["device_ms"]
        else:
            total["ms"] = total["device_ms"] = total["plain_ms"] = None
        emit("kernel", "sum", kernel="local_correlation_backward", set=set_name, **total)
        sums[set_name] = total
    first = next(iter(shape_sets))
    return {"local_correlation_backward": {**sums[first], "shapes": first,
                                           "other_sets": {k: v for k, v in sums.items() if k != first}}}


class Counted:
    """A module whose ``estimate`` calls are counted."""

    def __init__(self, module) -> None:
        self.module, self.calls = module, 0
        self.provide_cov = module.provide_cov

    def estimate(self, *frames):
        self.calls += 1
        return self.module.estimate(*frames)


def _clip_frames(device, size: int, n: int = 10) -> list:
    """The first ``n`` frames of the real clip with their ground truth, on
    ``device`` (a center crop of ``size`` in a rehearsal)."""
    from macvo_tpu_torch.data.datasets.tartanair import TartanAirV2

    seq = TartanAirV2({"root": str(CLIP_ROOT), "compressed": True, "gtFlow": True, "gtDepth": True,
                       "gtPose": True})
    seq = CroppedSequence(seq, size) if size else seq
    return [seq[i].to(device) for i in range(n)]


def _rel_err(rec: dict, ref: dict) -> dict:
    """Relative difference of each field of ``rec`` to ``ref``."""
    return {k: abs(rec[k] - ref[k]) / abs(ref[k]) for k in ref}


def phase_dense(device, size: int) -> dict:
    """FlowFormerCovMatcher / FlowFormerCovDepth (fp32, shipped checkpoint, 12
    decoder steps) through the four evaluate_* on the clip: within 1 % of the
    JAX CPU record, one fp32 latent-attention launch an estimate; the plain
    variants give the same flow and depth; the ApplyGT modifiers give finite
    metrics with one fp32 latent-attention launch an estimate. Returns the
    latent-attention launches by part."""
    import dataclasses

    import numpy as np
    import torch

    from macvo_tpu_torch.evaluation import dense
    from macvo_tpu_torch.modules import IMatcher, IStereoDepth
    from macvo_tpu_torch.ops import latent_attn
    from macvo_tpu_torch.utils.config import build_dynamic_config

    on_card = device.type == "cuda"
    frames = _clip_frames(device, size)
    args = {"weight": str(CKPT), "enc_dtype": "fp32", "dec_dtype": "fp32", "decoder_depth": 2 if size else 12,
            "enforce_positive_disparity": False}
    cfg = build_dynamic_config(args)[0]
    matcher = Counted(IMatcher.instantiate("FlowFormerCovMatcher", cfg, device=device))
    depth = Counted(IStereoDepth.instantiate("FlowFormerCovDepth", cfg, device=device))
    latent_attn.reset_launches()
    _sync(device)
    start = time.perf_counter()
    rec = {"flow": dense.evaluate_flow(matcher, frames), "flowcov": dense.evaluate_flowcov(matcher, frames),
           "depth": dense.evaluate_depth(depth, frames), "depthcov": dense.evaluate_depthcov(depth, frames)}
    _sync(device)
    rec = {k: dataclasses.asdict(v) for k, v in rec.items()}
    launches = dict(latent_attn.latent_cross_attention.launches_by_dtype)
    estimates = matcher.calls + depth.calls
    out = {"wall_s": time.perf_counter() - start, "estimates": estimates, "latent_attn_launches": launches,
           "frames": len(frames), "decoder_depth": args["decoder_depth"], **rec,
           "epe_pin_px": DENSE_EPE_PIN, "epe_vs_pin": rec["flow"]["epe"] / DENSE_EPE_PIN}
    if not size:
        out["jax_cpu_record"] = DENSE_JAX_CPU
        out["rel_err"] = {k: _rel_err(rec[k], DENSE_JAX_CPU[k]) for k in DENSE_JAX_CPU}
        out["rel_bound"] = DENSE_REL
    emit("dense", "end", part="FlowFormerCovMatcher + FlowFormerCovDepth", **out)
    if not all(np.isfinite(v) for part in rec.values() for v in part.values()):
        raise AssertionError(f"dense: non-finite metrics {rec}")
    if not size and max(e for part in out["rel_err"].values() for e in part.values()) > DENSE_REL:
        raise AssertionError(f"dense: metrics not within {DENSE_REL:.0%} of the JAX CPU record: {out['rel_err']}")
    if on_card and (launches["fp32"] != estimates or launches["bf16"]):
        raise AssertionError(f"dense: {launches} latent-attention launches for {estimates} estimates")

    # the plain variants: the same flow and depth (the same weights and path)
    plain_m = IMatcher.instantiate("FlowFormerMatcher", cfg, device=device)
    plain_d = IStereoDepth.instantiate("FlowFormerDepth", cfg, device=device)
    f0, f1 = frames[0].stereo, frames[1].stereo
    diffs = {"flow": float((plain_m.estimate(f0, f1).flow - matcher.module.estimate(f0, f1).flow).abs().max()),
             "depth": float((plain_d.estimate(f0).depth - depth.module.estimate(f0).depth).abs().max())}
    emit("dense", "check", part="FlowFormerMatcher / FlowFormerDepth vs the cov variants", max_abs_diff=diffs)
    if max(diffs.values()) > 1e-5:
        raise AssertionError(f"dense: the plain variants differ from the cov variants by {diffs}")

    # the ApplyGT modifiers
    def around(inner, inner_args):
        return build_dynamic_config({"module": {"type": inner, "args": inner_args}})[0]

    gt_cov = Counted(IMatcher.instantiate("ApplyGTMatchCov", around("FlowFormerMatcher", args), device=device))
    gt_mask = Counted(IMatcher.instantiate("ApplyGTMatchMask", around("FlowFormerMatcher", args), device=device))
    latent_attn.reset_launches()
    gt = {"ApplyGTMatchCov(FlowFormerMatcher).flowcov": dense.evaluate_flowcov(gt_cov, frames),
          "ApplyGTMatchMask(FlowFormerMatcher).flow": dense.evaluate_flow(gt_mask, frames, use_gt_mask=True),
          "ApplyGTDepthCov(GTDepth).depthcov": dense.evaluate_depthcov(
              IStereoDepth.instantiate("ApplyGTDepthCov", around("GTDepth", {}), device=device), frames)}
    gt = {k: dataclasses.asdict(v) for k, v in gt.items()}
    gt_launches = dict(latent_attn.latent_cross_attention.launches_by_dtype)
    gt_estimates = gt_cov.calls + gt_mask.calls
    emit("dense", "end", part="ApplyGT modifiers", estimates=gt_estimates, latent_attn_launches=gt_launches, **gt)
    if not all(np.isfinite(v) for part in gt.values() for v in part.values()):
        raise AssertionError(f"dense: ApplyGT modifiers gave non-finite metrics {gt}")
    if on_card and (gt_launches["fp32"] != gt_estimates or gt_launches["bf16"]):
        raise AssertionError(f"dense: ApplyGT: {gt_launches} latent-attention launches for {gt_estimates} estimates")
    del matcher, depth, plain_m, plain_d, gt_cov, gt_mask
    if on_card:
        torch.cuda.empty_cache()
    return {"latent_cross_attention[fp32]": {f"dense (4 evaluate_*, {estimates} estimates)": launches["fp32"],
                                             f"dense.ApplyGT (FlowFormerMatcher, 2 evaluate_*, {gt_estimates} "
                                             "estimates)": gt_launches["fp32"]}}


def phase_tartanvo_cov(device, size: int) -> dict:
    """TartanVOCovMatcher with seeded random weights (random:0) on the clip:
    the card against the CPU on the first pair (1e-4 of each output's
    magnitude, at least 1; NaN margins and masks equal), evaluate_flowcov over
    the 9 pairs finite, 6 correlation launches a pair. Returns the launches."""
    import dataclasses

    import numpy as np
    import torch

    from macvo_tpu_torch.evaluation import dense
    from macvo_tpu_torch.modules import TartanVOCovMatcher
    from macvo_tpu_torch.ops import correlation
    from macvo_tpu_torch.utils.config import build_dynamic_config

    frames = _clip_frames(device, size)
    cfg = build_dynamic_config({"weight": "random:0"})[0]
    card = Counted(TartanVOCovMatcher(cfg, device=device))
    cpu = TartanVOCovMatcher(cfg, device="cpu")
    f0, f1 = frames[0].stereo, frames[1].stereo
    ours = card.module.estimate(f0, f1)
    ref = cpu.estimate(f0.to(torch.device("cpu")), f1.to(torch.device("cpu")))
    errs = {}
    for key in ("flow", "cov", "mask"):
        a, b = getattr(ours, key).cpu(), getattr(ref, key)
        if not torch.equal(torch.isnan(a) if a.is_floating_point() else a, torch.isnan(b) if b.is_floating_point() else b):
            raise AssertionError(f"tartanvo_cov: {key} NaN positions or mask differ between the card and the CPU")
        if a.is_floating_point():
            fin = torch.isfinite(b)
            errs[key] = float((a[fin] - b[fin]).abs().max()) / max(1.0, float(b[fin].abs().max()))
    emit("tartanvo_cov", "check", part="card vs CPU, first pair", weight="random:0", rel_err=errs, bound=1e-4,
         shape=list(ours.flow.shape))
    if max(errs.values()) > 1e-4:
        raise AssertionError(f"tartanvo_cov: card vs CPU differ by {errs}")
    correlation.local_correlation.launches = 0
    _sync(device)
    start = time.perf_counter()
    perf = dataclasses.asdict(dense.evaluate_flowcov(card, frames))
    _sync(device)
    launches = correlation.local_correlation.launches
    rec = {"wall_s": time.perf_counter() - start, "pairs": card.calls, "correlation_launches": launches,
           "flowcov": perf}
    emit("tartanvo_cov", "end", **rec)
    if not all(np.isfinite(v) for v in perf.values()):
        raise AssertionError(f"tartanvo_cov: non-finite evaluate_flowcov {perf}")
    if device.type == "cuda" and launches != 6 * card.calls:
        raise AssertionError(f"tartanvo_cov: {launches} correlation launches for {card.calls} pairs, not 6 a pair")
    return {"local_correlation": {f"tartanvo_cov ({card.calls} pairs)": launches}}


def tvo_step_parity(device) -> dict:
    """One fp32 flow step of the TartanVO trainer (PWCFlowNet, random:0, a
    seeded 2x64x128 batch) on the CPU and on ``device`` with cuDNN off: the
    loss, each leaf's gradient (through the backward kernel on the card) and
    each weight's update, against phase 12's step-parity bounds."""
    import numpy as np
    import torch

    from macvo_tpu_torch.data.datasets.train import upcast_batch
    from macvo_tpu_torch.ops import correlation
    from macvo_tpu_torch.train import tartanvo as tt

    rng = np.random.default_rng(0)
    batch = {"img1": (rng.random((2, 64, 128, 3)) * 255).round().astype(np.uint8),
             "img2": (rng.random((2, 64, 128, 3)) * 255).round().astype(np.uint8),
             "gt_flow": rng.normal(0, 4.0, size=(2, 64, 128, 2)).astype(np.float16)}
    res = {}
    enabled = torch.backends.cudnn.enabled
    torch.backends.cudnn.enabled = False
    try:
        for dev in (torch.device("cpu"), device):
            model, params = tt.build_model("flow", dev)
            opt = tt.make_optimizer(params, 1, 2e-4)
            before = {n: p.detach().cpu().clone() for n, p in model.named_parameters()}
            bwd = correlation.local_correlation_backward.launches
            loss, _ = tt.flow_loss(model, upcast_batch(tt.with_mask(batch), dev))
            loss.backward()
            grads = {n: p.grad.detach().cpu().clone() for n, p in model.named_parameters()}
            tt.update(opt)
            res[dev.type] = {"loss": float(loss.detach()), "grads": grads, "lr": opt.adamw.param_groups[0]["lr"],
                             "bwd_launches": correlation.local_correlation_backward.launches - bwd,
                             "update": {n: p.detach().cpu() - before[n] for n, p in model.named_parameters()},
                             "weights": before}
    finally:
        torch.backends.cudnn.enabled = enabled
    return {"crop_hwb": [64, 128, 2], "cudnn": False, "backward_launches": res[device.type]["bwd_launches"],
            **_step_errors(res["cpu"], res[device.type], 1.0)}


def phase_train_tvo(device, size: int) -> dict:
    """The TartanVO trainer, ``python -m macvo_tpu_torch.train.tartanvo``
    through its ``main``, 3 steps of each mode at batch 4 on 320x448 crops of
    3 SyntheticStereo ``seq_*`` layouts written into a temporary directory
    (flowcov restores the flow run's PWC): finite losses; backward kernel
    launches 5 a flow step, 1 a flowcov step, 0 a stereo step; flowcov's pwc
    bit-identical to what it restored; steady ms a step and peak memory; then
    one fp32 flow step card against CPU. Returns the launches of both
    correlation kernels by mode."""
    import tempfile

    import numpy as np

    from macvo_tpu_torch.data.datasets.synthetic import write_tartanair_layout
    from macvo_tpu_torch.ops import correlation
    from macvo_tpu_torch.train import tartanvo as tt

    on_card = device.type == "cuda"
    h, w, batch = (320, 448, 4) if not size else (64, 128, 2)
    per_step = {"flow": 5, "flowcov": 1, "stereo": 0}
    launches = {"local_correlation": {}, "local_correlation_backward": {}}
    (ROOT / "results").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "results", prefix="chip_smoke_train_tvo_") as tmp:
        start = time.perf_counter()
        for i in range(3):
            write_tartanair_layout(Path(tmp) / "data" / f"seq_{i:03d}", {"n_frames": 3, "width": w, "height": h,
                                                                         "seed": 3 + i, "traj_seed": i})
        emit("train_tvo", "check", part="layouts", write_s=time.perf_counter() - start, sequences=3, frames=3,
             hw=[h, w])
        for mode in ("flow", "flowcov", "stereo"):
            out = Path(tmp) / f"TartanVO_{mode}.npz"
            argv = ["--mode", mode, "--data", str(Path(tmp) / "data"), "--steps", "3", "--batch", str(batch),
                    "--holdout", "1", "--eval-freq", "3", "--height", str(h), "--width", str(w), "--out", str(out),
                    "--device", device.type]
            if mode == "flowcov":
                argv += ["--restore", str(Path(tmp) / "TartanVO_flow.npz")]
            _peak_reset(device)
            correlation.local_correlation.launches = 0
            correlation.local_correlation_backward.launches = 0
            rec = tt.main(argv)
            _sync(device)
            fwd, bwd = correlation.local_correlation.launches, correlation.local_correlation_backward.launches
            steps_ms = [s["ms"] for s in rec["steps"]]
            part = {"mode": mode, "losses": [s["loss"] for s in rec["steps"]],
                    "metrics": [s["metric"] for s in rec["steps"]], "step_ms": steps_ms,
                    "steady_ms_per_step": float(np.median(steps_ms[1:])), "evals": rec["evals"],
                    "peak_bytes": _peak(device), "correlation_launches": fwd, "backward_launches": bwd,
                    "batch": batch, "hw": [h, w]}
            if mode == "flowcov":
                with np.load(Path(tmp) / "TartanVO_flow.npz") as a, np.load(out) as b:
                    part["pwc_bit_identical"] = all(np.array_equal(a[k], b["pwc/" + k]) for k in a.files)
            emit("train_tvo", "end", **part)
            launches["local_correlation"][f"train_tvo.{mode} (3 steps + evals)"] = fwd
            launches["local_correlation_backward"][f"train_tvo.{mode} (3 steps)"] = bwd
            if not all(np.isfinite(part["losses"])):
                raise AssertionError(f"train_tvo {mode}: non-finite losses {part['losses']}")
            if on_card and bwd != per_step[mode] * 3:
                raise AssertionError(f"train_tvo {mode}: {bwd} backward launches in 3 steps, "
                                     f"not {per_step[mode]} a step")
            if part.get("pwc_bit_identical") is False:
                raise AssertionError("train_tvo flowcov: the frozen pwc moved")
    if on_card:
        par = tvo_step_parity(device)
        ok = (par["loss_rel_err"] <= PARITY_BOUNDS["loss_rel_err"] and par["grad_rel_err"] <= PARITY_BOUNDS["grad_rel_err"]
              and par["update_err_share_of_bound"] <= PARITY_BOUNDS["update_err_share_of_bound"]
              and par["backward_launches"] == 5)
        emit("train_tvo", "check", part="step parity (fp32 flow step, card vs CPU, cuDNN off)", agrees=ok,
             bounds=PARITY_BOUNDS, **par)
        if not ok:
            raise AssertionError(f"train_tvo: step parity out of its bounds: {par}")
    return launches


# -- the runner's tooling, the pose net's trainer and the batch experiment runner (phases 17-19) ---------

RUNNER_STAGES = ("Odom_Runtime", "Sync consume", "Frontend.estimate", "KP pipeline", "Frontend.forward",
                 "TwoframePGO.dispatch")      # the JAX package's timer sections, under its names
POSENET_HW = (120, 160)                       # (height, width) of the pose net's worlds; build_samples resizes to 112x160


@contextlib.contextmanager
def held_stamp(stamp: str):
    """Hold the clock the result sandbox reads (``time.strftime`` of its
    ``%m_%d_%H%M%S`` stamp) at ``stamp``."""
    real = time.strftime
    time.strftime = lambda fmt, *a: stamp if fmt == "%m_%d_%H%M%S" else real(fmt, *a)
    try:
        yield
    finally:
        time.strftime = real


def _performant_yaml(tmp: Path, size: int) -> str:
    """MACVO_Performant.yaml as shipped; in a rehearsal, a copy with 2 decoder
    steps and no Preprocess (which would resize the crop to the full size)."""
    from macvo_tpu_torch.utils.config import load_config, save_config

    path = ROOT / "configs/experiment/macvo/MACVO_Performant.yaml"
    if not size:
        return str(path)
    cfg = load_config(path)[1]
    cfg["Odometry"]["frontend"]["args"].update(weight=str(CKPT), decoder_depth=2)
    cfg.pop("Preprocess", None)
    save_config(cfg, tmp / "MACVO_Performant_rehearsal.yaml")
    return str(tmp / "MACVO_Performant_rehearsal.yaml")


def _clip_as_general(root: Path, n: int, size: int) -> str:
    """The clip's first ``n`` frames written as a GeneralStereo rig at ``root``
    (a center crop of ``size`` in a rehearsal); returns its data config
    ``<root>.yaml``."""
    import numpy as np
    import yaml

    clip = read_clip(n)
    fx, fy, cx, cy = CLIP_K
    if size:
        y0 = x0 = (640 - size) // 2
        for cam in ("left", "right"):
            clip[cam] = [np.ascontiguousarray(im[y0:y0 + size, x0:x0 + size]) for im in clip[cam]]
        cx, cy = cx - x0, cy - y0
    write_general_layout(root, clip["left"], clip["right"], clip["times_s"], clip["poses"])
    cfg = root.parent / f"{root.name}.yaml"
    cfg.write_text(yaml.safe_dump({"Sequence": {"type": "GeneralStereo", "args": {
        "root": str(root), "fx": fx, "fy": fy, "cx": cx, "cy": cy, "baseline": CLIP_BASELINE,
        "pose_file": str(root / "pose_lcam_front.txt")}}}))
    return str(cfg)


def _latent_launches() -> dict:
    from macvo_tpu_torch.ops import latent_attn

    return dict(latent_attn.latent_cross_attention.launches_by_dtype)


def _one_fp32_launch_a_frame(phase: str, launches: dict, frames: int, on_card: bool) -> None:
    if on_card and (launches["fp32"] != frames or launches["bf16"]):
        raise AssertionError(f"{phase}: latent attention launches {launches} over {frames} frames, "
                             "not one fp32 launch a frame")


def phase_runner(device, size: int) -> dict:
    """``python -m macvo_tpu_torch`` through its ``main``: MACVO_Performant.yaml
    on the clip (10 frames, 640x640) with ``--timing`` into a result sandbox
    under results/: its files, the JAX package's six timer sections, one
    Odom_Runtime a frame, a finite device section of the frontend, one fp32
    latent-attention launch a frame, ATE <= 0.05 m; the poses bit-identical
    to a second run without ``--timing``; a third run with the stamp held at
    the first's lands beside it with ``_<i>``; a run with ``--autoremove`` (a
    process of its own) leaves no directory. ``--saveplt`` with its figures
    where matplotlib is installed; where it is not, the runner must refuse the
    flag before the run. Returns the latent-attention launches by run."""
    import importlib.util
    import json
    import statistics
    import tempfile

    import numpy as np

    from macvo_tpu_torch.__main__ import main as run_main
    from macvo_tpu_torch.evaluation import evaluate_sandbox
    from macvo_tpu_torch.modules.frontend_network import DEVICE_SECTION
    from macvo_tpu_torch.ops import latent_attn

    on_card = device.type == "cuda"
    launches = {}
    (ROOT / "results").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "results", prefix="chip_smoke_runner_") as tmp, \
            contextlib.chdir(ROOT):
        tmp = Path(tmp)
        data = str(ROOT / CLIP) if not size else _clip_as_general(tmp / "clip", 10, size)
        results = tmp / "results"
        argv = ["--odom", _performant_yaml(tmp, size), "--data", data, "--resultRoot", str(results),
                "--device", device.type]
        plots = importlib.util.find_spec("matplotlib") is not None
        if not plots:
            try:
                run_main(argv + ["--saveplt"])
            except ImportError as e:
                if results.exists():
                    raise AssertionError("runner: --saveplt without matplotlib made a sandbox before refusing")
                emit("runner", "check", part="--saveplt", matplotlib=False,
                     note="matplotlib is not installed here: the runner refused --saveplt before the run, as "
                          "it should; the timed run goes without it (the figures are host code, tested on "
                          "the CPU)", error=str(e))
            else:
                raise AssertionError("runner: --saveplt ran without matplotlib")

        latent_attn.reset_launches()
        start = time.perf_counter()
        box = run_main(argv + ["--timing"] + (["--saveplt"] if plots else []))
        _sync(device)
        wall_s = time.perf_counter() - start
        launches["runner (--timing, 10 frames)"] = _latent_launches()["fp32"]
        rec = {"sandbox": str(box.folder.relative_to(tmp)), "wall_s": wall_s, "latent_attn_launches": _latent_launches(),
               "files": sorted(p.name for p in box.folder.iterdir())}
        missing = {"metadata.yaml", "config.yaml", "poses.npy", "elapsed_time.json"} - set(rec["files"])
        if plots and not (box.folder / "plots").is_dir():
            missing.add("plots/")
        if missing:
            raise AssertionError(f"runner: the sandbox lacks {sorted(missing)}")
        elapsed = json.loads(box.path("elapsed_time.json").read_text())
        poses = np.load(box.path("poses.npy"))
        frames = poses.shape[0]
        m = evaluate_sandbox(box)
        rec.update(frames=frames, ATE_m=m["ATE"].rmse, RTE_m_per_frame=m["RTE"].rmse, ROE_deg_per_frame=m["ROE"].rmse,
                   sections={k: len(v) for k, v in elapsed.items()},
                   plots=sorted(p.name for p in box.path("plots").iterdir()) if plots else None)
        emit("runner", "end", part="timed run", **rec)
        emit("runner", "stage_medians", unit="ms", frames=frames,
             **{k: statistics.median(v) for k, v in sorted(elapsed.items())})
        if not set(RUNNER_STAGES) | {DEVICE_SECTION} <= set(elapsed):
            raise AssertionError(f"runner: elapsed_time.json holds {sorted(elapsed)}, not {RUNNER_STAGES} "
                                 f"and {DEVICE_SECTION!r}")
        if len(elapsed["Odom_Runtime"]) != frames or frames != 10:
            raise AssertionError(f"runner: {len(elapsed['Odom_Runtime'])} Odom_Runtime records over {frames} frames")
        dev = elapsed[DEVICE_SECTION]
        if len(dev) != frames - 1 or not np.isfinite(dev).all() or min(dev) <= 0:
            raise AssertionError(f"runner: the frontend's device section {dev} over {frames - 1} pairs")
        _one_fp32_launch_a_frame("runner", rec["latent_attn_launches"], frames, on_card)
        if not size and rec["ATE_m"] > LEARNED_ATE["performant"]:
            raise AssertionError(f"runner: ATE {rec['ATE_m']} m > {LEARNED_ATE['performant']} m")

        latent_attn.reset_launches()
        plain = run_main(argv)
        launches["runner (untimed, 10 frames)"] = _latent_launches()["fp32"]
        same = bool(np.array_equal(np.load(plain.path("poses.npy")), poses))
        emit("runner", "check", part="timing off", sandbox=str(plain.folder.relative_to(tmp)), poses_bit_identical=same,
             elapsed_time_json=plain.path("elapsed_time.json").exists())
        if not same or plain.path("elapsed_time.json").exists():
            raise AssertionError("runner: the run without --timing differs from the timed run")
        _one_fp32_launch_a_frame("runner (untimed)", _latent_launches(), frames, on_card)

        stamp = box.folder.name
        expect = f"{stamp}_1" if plain.folder.name != f"{stamp}_1" else f"{stamp}_2"
        latent_attn.reset_launches()
        with held_stamp(stamp):
            again = run_main(argv + ["--seq_to", "3", "--noeval"])
        launches["runner (stamp held, 3 frames)"] = _latent_launches()["fp32"]
        kept = bool(np.array_equal(np.load(box.path("poses.npy")), poses))
        emit("runner", "check", part="stamp held", first=stamp, landed=again.folder.name, first_run_kept=kept)
        if again.folder.name != expect or not kept or np.load(again.path("poses.npy")).shape[0] != 3:
            raise AssertionError(f"runner: a run with the stamp {stamp} held went to {again.folder.name}, "
                                 f"not {expect} (first run kept: {kept})")
        _one_fp32_launch_a_frame("runner (stamp held)", _latent_launches(), 3, on_card)

        before = sorted(p.name for p in box.folder.parent.iterdir())
        start = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "macvo_tpu_torch", *argv, "--seq_to", "2", "--autoremove"],
                              cwd=ROOT, capture_output=True, text=True, timeout=300)
        after = sorted(p.name for p in box.folder.parent.iterdir())
        emit("runner", "check", part="--autoremove (own process)", rc=proc.returncode, wall_s=time.perf_counter() - start,
             sandboxes_before=before, sandboxes_after=after, evaluated="ATE" in proc.stdout)
        if proc.returncode != 0 or after != before or "ATE" not in proc.stdout:
            raise AssertionError(f"runner: --autoremove run rc {proc.returncode}, sandboxes {before} -> {after}: "
                                 f"{proc.stderr[-2000:]}")
    return {"latent_cross_attention[fp32]": launches}


def posenet_step_parity(device, xb, yb) -> dict:
    """One step of the pose-net trainer (VOFlowRes, random:0, the schedule of
    a 20-step run) on one batch, on ``device`` with cuDNN off and on the CPU
    in float64 and in fp32: the card's loss, gradients and updates against
    the float64 step (the same weights, the ulps of their fp32 values), and,
    reported beside it, against the fp32 CPU step. The first conv's weight
    gradient sums 16 x 56 x 80 products that cancel: the CPU's fp32 sum is
    2.3e-4 of the leaf's scale from the float64 sum on this batch, so the
    fp32 CPU step is no oracle for it."""
    import torch

    from macvo_tpu_torch.train import posenet as pn

    res = {}
    enabled = torch.backends.cudnn.enabled
    torch.backends.cudnn.enabled = False
    try:
        for key, dev, dtype in (("cpu64", torch.device("cpu"), torch.float64), ("cpu", torch.device("cpu"), None),
                                ("card", device, None)):
            model = pn.build_model(dev)
            before = {n: p.detach().cpu().clone() for n, p in model.named_parameters()}
            if dtype is not None:
                model = model.to(dtype)
            opt, schedule = pn.make_optimizer(model, 20, 1e-4)
            start = {n: p.detach().cpu().clone() for n, p in model.named_parameters()}
            x, y = torch.from_numpy(xb).to(dev), torch.from_numpy(yb).to(dev)
            loss = pn.smooth_l1(model(x.to(dtype or x.dtype)), y.to(dtype or y.dtype))
            loss.backward()
            grads = {n: p.grad.detach().cpu().clone() for n, p in model.named_parameters()}
            for group in opt.param_groups:
                group["lr"] = schedule(0)
            opt.step()
            res[key] = {"loss": float(loss.detach()), "grads": grads, "lr": schedule(0),
                        "update": {n: p.detach().cpu() - start[n] for n, p in model.named_parameters()},
                        "weights": before}
    finally:
        torch.backends.cudnn.enabled = enabled
    against_fp32 = _step_errors(res["cpu"], res["card"], float("inf"))
    return {"batch": list(xb.shape), "cudnn": False, "reference": "CPU float64",
            **_step_errors(res["cpu64"], res["card"], float("inf")),
            "against_cpu_fp32": {k: against_fp32[k] for k in ("loss_rel_err", "grad_rel_err", "worst_leaves",
                                                              "update_err_share_of_bound")},
            "cpu_fp32_against_float64": {k: v for k, v in _step_errors(res["cpu64"], res["cpu"], float("inf")).items()
                                         if k in ("loss_rel_err", "grad_rel_err", "worst_leaves")}}


def phase_posenet(device, size: int) -> dict:
    """The pose net's trainer on worlds the repo makes: two 24-frame
    RandomizedStereo worlds written by scripts/torch_gen_randomized.py into a
    temporary directory under results/ (render seconds reported), then
    ``python -m macvo_tpu_torch.train.posenet --holdout 1 --steps 20 --batch 16``
    through its ``main``: finite losses, steady ms a step, peak memory; one
    step card (cuDNN off) against the CPU's float64 step within phase 12's
    step-parity bounds;
    the written npz as TartanMotionNet in Paper_Reproduce.yaml on 3 frames of
    the clip: finite poses, one fp32 latent-attention launch a frame.
    Returns the latent-attention launches."""
    import tempfile

    import numpy as np

    from macvo_tpu_torch.data.datasets.tartanair import TartanAirV2
    from macvo_tpu_torch.modules.frontend_tartanvo import TartanMotionNet
    from macvo_tpu_torch.odometry import build_odometry
    from macvo_tpu_torch.ops import latent_attn
    from macvo_tpu_torch.train import posenet as pn
    from macvo_tpu_torch.utils.config import load_config

    on_card = device.type == "cuda"
    h, w = POSENET_HW if not size else (48, 64)
    (ROOT / "results").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "results", prefix="chip_smoke_posenet_") as tmp:
        data, out = Path(tmp) / "randomized", Path(tmp) / "TartanVO_posenet.npz"
        sys.path.insert(0, str(ROOT / "scripts"))
        import torch_gen_randomized

        start = time.perf_counter()
        done = torch_gen_randomized.main(["--out", str(data), "--n_seqs", "2", "--n_frames", "24", "--width", str(w),
                                          "--height", str(h), "--workers", "2"])
        render_s = time.perf_counter() - start
        emit("posenet", "check", part="worlds", render_s=render_s, worlds=len(done), frames=24, hw=[h, w],
             workers=2, note="RandomizedStereo, supersample 2, rendered on the host")

        _peak_reset(device)
        rec = pn.main(["--data", str(data), "--holdout", "1", "--steps", "20", "--batch", "16", "--out", str(out),
                       "--device", device.type])
        steps_ms = [s["ms"] for s in rec["steps"]]
        part = {"losses": [s["loss"] for s in rec["steps"]], "step_ms": [round(x, 3) for x in steps_ms],
                "first_step_ms": steps_ms[0], "steady_ms_per_step": float(np.median(steps_ms[2:])),
                "peak_bytes": _peak(device), "train": rec["train"], "eval": rec["eval"], "final_eval": rec["final_eval"],
                "zero_motion": rec["zero_motion"], "batch": 16, "steps": 20}
        emit("posenet", "end", part="trainer", **part)
        if not np.isfinite(part["losses"]).all() or not np.isfinite(list(rec["final_eval"].values())).all():
            raise AssertionError(f"posenet: non-finite losses or eval {part['losses']} {rec['final_eval']}")

        if on_card:
            (Xtr, Ytr), _ = pn.build_samples(sorted(data.glob("seq_*")), holdout=1)
            idx = np.random.default_rng(0).integers(0, Xtr.shape[0], 16)
            par = posenet_step_parity(device, Xtr[idx], Ytr[idx])
            ok = (par["loss_rel_err"] <= PARITY_BOUNDS["loss_rel_err"]
                  and par["grad_rel_err"] <= PARITY_BOUNDS["grad_rel_err"]
                  and par["update_err_share_of_bound"] <= PARITY_BOUNDS["update_err_share_of_bound"])
            emit("posenet", "check", part="step parity (card, cuDNN off, vs the CPU's float64 step)", agrees=ok,
                 bounds=PARITY_BOUNDS, **par)
            if not ok:
                raise AssertionError(f"posenet: step parity out of its bounds: {par}")

        cfg = load_config(ROOT / "configs/experiment/macvo/Paper_Reproduce.yaml")[0]
        cfg.Odometry.frontend.args.weight = str(CKPT)
        cfg.Odometry.motion.args.weight = str(out)
        if size:
            cfg.Odometry.frontend.args.decoder_depth = 2
        clip = load_config(ROOT / CLIP)[0].Sequence.args
        seq3 = TartanAirV2({"root": str(ROOT / clip.root), "compressed": True, "gtFlow": False, "gtDepth": False,
                            "gtPose": True}).clip(0, 3)
        system = build_odometry(cfg, device=device)
        if not isinstance(system.MotionEstimator, TartanMotionNet):
            raise AssertionError(f"posenet: the motion model is {type(system.MotionEstimator).__name__}")
        latent_attn.reset_launches()
        odo = run_odometry(cfg, CroppedSequence(seq3, size) if size else seq3, device, "posenet", system=system)
        odo["latent_attn_launches"] = _latent_launches()
        emit("posenet", "end", part="Paper_Reproduce with the trained pose net (3 frames)", **odo)
        _one_fp32_launch_a_frame("posenet (Paper_Reproduce)", odo["latent_attn_launches"], odo["frames"], on_card)
    return {"latent_cross_attention[fp32]": {"posenet.paper (trained pose net, 3 frames)":
                                             odo["latent_attn_launches"]["fp32"]}}


def phase_experiment(device, size: int) -> dict:
    """scripts/torch_experiment_macvo.py through its ``main``:
    MACVO_Performant.yaml over the clip's data config and the clip written as
    a GeneralStereo rig, ``--seq_to 4``: evaluation.csv with one row a
    sequence and the average, children.txt naming both, one fp32
    latent-attention launch a frame. Returns the launches."""
    import csv
    import importlib.util
    import tempfile

    import numpy as np

    from macvo_tpu_torch.ops import latent_attn

    on_card = device.type == "cuda"
    spec = importlib.util.spec_from_file_location("torch_experiment_macvo", ROOT / "scripts/torch_experiment_macvo.py")
    experiment = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(experiment)
    (ROOT / "results").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "results", prefix="chip_smoke_experiment_") as tmp, \
            contextlib.chdir(ROOT):
        tmp = Path(tmp)
        seqs = [str(ROOT / CLIP) if not size else _clip_as_general(tmp / "TartanAirv2_RealAsset", 4, size),
                _clip_as_general(tmp / "GeneralStereo_clip", 4, size)]
        latent_attn.reset_launches()
        start = time.perf_counter()
        parent = experiment.main(["--odom", _performant_yaml(tmp, size), "--data", *seqs, "--seq_to", "4",
                                  "--resultRoot", str(tmp / "results"), "--device", device.type])
        wall_s = time.perf_counter() - start
        rows = list(csv.reader(parent.path("evaluation.csv").open()))
        children = parent.path("children.txt").read_text().split()
        rec = {"wall_s": wall_s, "rows": rows, "children": children, "latent_attn_launches": _latent_launches()}
        emit("experiment", "end", **rec)
        names = [Path(s).stem for s in seqs]
        if children != names or [r[0] for r in rows] != ["sequence", *names, "Average"]:
            raise AssertionError(f"experiment: children {children}, rows {[r[0] for r in rows]}, not {names}")
        if not np.isfinite([[float(v) for v in r[1:]] for r in rows[1:]]).all():
            raise AssertionError(f"experiment: non-finite metrics {rows}")
        _one_fp32_launch_a_frame("experiment", rec["latent_attn_launches"], 8, on_card)
    return {"latent_cross_attention[fp32]": {"experiment (2 sequences x 4 frames)": rec["latent_attn_launches"]["fp32"]}}


BATCH_SEQS = 4                   # sequences in lockstep in phase batch
BATCH_N = BATCH_SEQS * 2 * 6400  # their one forward's pixels at 1/8 (4 x 2 pairs x 80x80), the kernel's N
# batched against unbatched on the first pair: flow 1e-3 px at the 99.99th percentile and 5e-3 px at
# most (phase 4's card-against-CPU bound for fp32 sums in other orders through the 12 recurrent steps:
# the batch-8 forward's cuDNN and cuBLAS algorithms sum in another order than the batch-2 one's);
# covariance 1e-3 relative
BATCH_FLOW_Q9999, BATCH_FLOW_MAX, BATCH_COV_REL = 1e-3, 5e-3, 1e-3
BATCH_ATE_DIFF = 0.005           # |ATE(batched) - ATE(alone)| per sequence, m


def _script(name: str):
    import importlib.util

    spec = importlib.util.spec_from_file_location(name, ROOT / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _reversed_clip(frames: list) -> list:
    """The clip backwards (frame n-1 first, each with its own ground-truth
    pose), re-stamped with the forward clip's ascending times."""
    import dataclasses

    import numpy as np

    n = len(frames)
    return [dataclasses.replace(frames[n - 1 - i], idx=np.array([i]), stereo=dataclasses.replace(
        frames[n - 1 - i].stereo, time_ns=frames[i].stereo.time_ns.copy())) for i in range(n)]


def _render(seq, n: int) -> list:
    """Frames 0..n-1 of a synthetic sequence, rendered on host threads."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(8) as pool:
        return list(pool.map(seq.__getitem__, range(n)))


def _ate(frames: list, system) -> float:
    import numpy as np

    from macvo_tpu_torch.evaluation import evaluate_all

    n = len(system.graph.frames)
    gt = np.stack([np.asarray(f.gt_pose[0]) for f in frames]).astype(np.float64)
    return float(evaluate_all(gt, system.graph.frames.data["pose"][:n].astype(np.float64))["ATE"].rmse)


def phase_batch(device, size: int) -> dict:
    """BatchedOdometry with MACVO_Performant.yaml (shipped checkpoint, fp32,
    TF32 off, 12 decoder steps) over four 640x640 sequences in lockstep: the
    clip, the clip backwards (re-stamped in ascending time), SyntheticStereo
    seeds 7 and 8 (rendered before any timed run). Gates: on the first pair
    each sequence's flow within 1e-3 px at the 99.99th percentile and 5e-3 px
    at most, and its covariance within 1e-3 relative, of the unbatched
    FlowFormerCovFrontend (fp32 with TF32 off: only cuDNN's and cuBLAS's
    choices for batch 8 change the sum order); one fp32 latent-attention
    launch a lockstep step; ATE <= 0.05 m both ways along the clip; each
    sequence's ATE within 5 mm of its run alone through MACVO. Reports the
    lockstep and alone frames/s, the stage timer's medians over steps 1-3 of
    a second run, the device's busy share (kernel time over wall time of its
    step 4 under the profiler) and the peak memory. Returns the
    latent-attention launches."""
    import statistics
    import tempfile

    import numpy as np
    import torch

    from macvo_tpu_torch.data.datasets.synthetic import SyntheticStereo
    from macvo_tpu_torch.data.datasets.tartanair import TartanAirV2
    from macvo_tpu_torch.modules.frontend_network import FlowFormerCovFrontend
    from macvo_tpu_torch.odometry import MACVO
    from macvo_tpu_torch.ops import latent_attn
    from macvo_tpu_torch.parallel import BatchedOdometry
    from macvo_tpu_torch.parallel.batch_odometry import _with_precomputed_frontend
    from macvo_tpu_torch.utils import timer
    from macvo_tpu_torch.utils.config import load_config

    on_card = device.type == "cuda"
    n_frames, hw = (10, 640) if not size else (4, size)
    (ROOT / "results").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "results", prefix="chip_smoke_batch_") as tmp:
        cfg = load_config(_performant_yaml(Path(tmp), size))[0]
    cfg.Odometry.frontend.args.weight = str(CKPT)
    start = time.perf_counter()
    clip = TartanAirV2({"root": str(CLIP_ROOT), "compressed": True, "gtFlow": False, "gtDepth": False,
                        "gtPose": True})
    clip = CroppedSequence(clip, size) if size else clip
    forward = [clip[i] for i in range(n_frames)]
    synth = [_render(SyntheticStereo({"n_frames": n_frames, "width": hw, "height": hw, "fx": hw / 2.0,
                                      "fy": hw / 2.0, "seed": seed}), n_frames) for seed in (7, 8)]
    names = ["clip", "clip_reversed", "synthetic_seed7", "synthetic_seed8"]
    seqs = [[f.to(device) for f in s] for s in (forward, _reversed_clip(forward), *synth)]
    _sync(device)
    prepare_s = time.perf_counter() - start

    driver = BatchedOdometry(cfg, n_sequences=BATCH_SEQS, device=device)
    # first pair: the batched forward against the unbatched frontend (uncounted launches)
    single = FlowFormerCovFrontend(cfg.Odometry.frontend.args, device=device)
    single.runner = driver.frontend.runner
    pairs = driver.frontend.forward_pairs([s[0].stereo for s in seqs], [s[1].stereo for s in seqs])
    first_pair = {}
    for name, s, (depth_b, match_b) in zip(names, seqs, pairs):
        single.estimate_depth(s[0].stereo)
        depth_s, match_s = single.estimate_pair(s[0].stereo, s[1].stereo)
        diff = (match_b.flow - match_s.flow).abs().flatten()
        first_pair[name] = {
            "flow_abs_px_quantiles": {q: float(torch.quantile(diff, q)) for q in (0.5, 0.999, 0.9999)},
            "flow_px_over_1e-3": int((diff > 1e-3).sum()),
            "flow_max_abs_px": float(diff.max()),
            "stereo_flow_max_abs_px": float((depth_b.disparity - depth_s.disparity).abs().max()),
            "cov_max_rel": float(max(((match_b.cov[..., :2] - match_s.cov[..., :2]).abs()
                                      / match_s.cov[..., :2].abs()).max(),
                                     ((depth_b.disparity_uncertainty - depth_s.disparity_uncertainty).abs()
                                      / depth_s.disparity_uncertainty.abs()).max()))}
    del pairs
    emit("batch", "check", part="first pair, batched against unbatched", flow_bound_px_q9999=BATCH_FLOW_Q9999,
         flow_bound_px_max=BATCH_FLOW_MAX, cov_bound_rel=BATCH_COV_REL, **first_pair)
    bad = {k: v for k, v in first_pair.items()
           if v["flow_abs_px_quantiles"][0.9999] > BATCH_FLOW_Q9999 or v["cov_max_rel"] > BATCH_COV_REL
           or max(v["flow_max_abs_px"], v["stereo_flow_max_abs_px"]) > BATCH_FLOW_MAX}
    if bad:
        raise AssertionError(f"batch: batched forward differs from the unbatched frontend {bad}")

    # the lockstep run, counted and timed (its first step's batch-4 stereo forward warmed first)
    driver.frontend.forward_depths([s[0].stereo for s in seqs])
    _peak_reset(device)
    latent_attn.reset_launches()
    start = time.perf_counter()
    for i in range(n_frames):
        driver.step([s[i] for s in seqs])
    driver.finish()
    _sync(device)
    lockstep_s = time.perf_counter() - start
    launches = _latent_launches()
    peak = _peak(device)
    ate = {name: _ate(s, system) for name, s, system in zip(names, seqs, driver.systems)}

    # a second run on the same model: the stage timer's sections over steps 1-3, then the
    # device's busy share over step 4 under the profiler (kernels only: host events of a
    # step number ~10^5 and take the profiler tens of seconds to sum)
    busy = stages = None
    if on_card:
        frontend = driver.frontend
        del driver
        driver = BatchedOdometry(cfg, n_sequences=BATCH_SEQS, device=device, frontend=frontend)
        driver.step([s[0] for s in seqs])
        timer.reset()
        timer.setup(True)
        try:
            for i in range(1, 4):
                driver.step([s[i] for s in seqs])
            _sync(device)
            stages = {k: statistics.median(v) for k, v in timer.records().items()}
        finally:
            timer.setup(False)
            timer.reset()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            start = time.perf_counter()
            driver.step([s[4] for s in seqs])
            _sync(device)
            window_ms = (time.perf_counter() - start) * 1e3
        device_ms = sum(e.self_device_time_total for e in prof.key_averages()
                        if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
        busy = {"steps": 1, "device_ms": device_ms, "wall_ms": window_ms, "busy_share": device_ms / window_ms}
    del driver

    # each sequence alone through MACVO (its frontend the unbatched one on the same model), one after another
    alone_s, ate_alone = 0.0, {}
    for name, s in zip(names, seqs):
        system = MACVO.from_config(_with_precomputed_frontend(cfg), device=device)
        system.Frontend = single
        _sync(device)
        start = time.perf_counter()
        for f in s:
            system.run(f)
        system.terminate()
        _sync(device)
        alone_s += time.perf_counter() - start
        ate_alone[name] = _ate(s, system)
        del system
    frames = BATCH_SEQS * n_frames
    rec = {"sequences": names, "frames_each": n_frames, "hw": [hw, hw], "prepare_s": prepare_s,
           "lockstep_s": lockstep_s, "lockstep_frames_per_s": frames / lockstep_s,
           "alone_s": alone_s, "alone_frames_per_s": frames / alone_s, "speedup": alone_s / lockstep_s,
           "device_busy": busy, "stage_ms_median": stages, "peak_memory_bytes": peak,
           "latent_attn_launches": launches,
           "ATE_m": ate, "ATE_alone_m": ate_alone, "ate_bound_m": LEARNED_ATE["performant"],
           "ate_diff_bound_m": BATCH_ATE_DIFF}
    emit("batch", "end", **rec)
    if on_card and (launches["fp32"] != n_frames or launches["bf16"]):
        raise AssertionError(f"batch: latent attention launches {launches} over {n_frames} lockstep steps, "
                             "not one fp32 launch a step")
    if not size:
        for name in ("clip", "clip_reversed"):
            if ate[name] > LEARNED_ATE["performant"]:
                raise AssertionError(f"batch: {name} ATE {ate[name]} m > {LEARNED_ATE['performant']} m")
        diff = {k: abs(ate[k] - ate_alone[k]) for k in names}
        if max(diff.values()) > BATCH_ATE_DIFF or not np.isfinite(list(ate.values())).all():
            raise AssertionError(f"batch: ATE batched against alone differs by {diff} m")
    return {"latent_cross_attention[fp32]": {f"batch ({BATCH_SEQS} sequences x {n_frames} lockstep steps)":
                                             launches["fp32"]}}


def _sharded_cov_step(device, size: int) -> dict:
    """One make_sharded_train_step cov step (FlowFormerCov_synth_cov.yaml,
    bf16, the shipped checkpoint) in a world of one against make_train_step on
    the same batch: every parameter bit-identical (cuDNN deterministic for
    the comparison), one bf16 launch a step."""
    import numpy as np
    import torch

    from macvo_tpu_torch.data.datasets.train import TrainPairDataset
    from macvo_tpu_torch.ops import latent_attn
    from macvo_tpu_torch.train import create_optimizer, make_sharded_train_step, make_train_step, run
    from macvo_tpu_torch.utils.config import load_config

    cfg = load_config(ROOT / "configs/train/FlowFormerCov_synth_cov.yaml")[0]
    if size:
        cfg.Model.decoder_depth = 2
        cfg.Train.image_height, cfg.Train.image_width, cfg.Train.batch_size = 64, 96, 2
    tcfg = run.train_config(cfg)
    h, w, bs = int(cfg.Train.image_height), int(cfg.Train.image_width), int(cfg.Train.batch_size)
    dataset = TrainPairDataset(cfg.Data.Sequences, cfg.Data.transforms, stereo_prob=float(cfg.Data.stereo_prob))
    batch = dataset.draw(bs, h, w, np.random.default_rng(int(cfg.Train.seed)))
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        out = {}
        for kind, make in (("single", make_train_step), ("sharded", make_sharded_train_step)):
            model = _train_model(cfg, device, CKPT)
            opt = create_optimizer(model, tcfg)
            step = make(model, opt, tcfg, device)
            latent_attn.reset_launches()
            aux = step(batch)
            _sync(device)
            out[kind] = {"loss": float(aux["loss"]), "launches": _latent_launches(),
                         "params": [p.detach().clone() for p in model.parameters()]}
            del model, opt, step
    finally:
        torch.backends.cudnn.deterministic = deterministic
    same = all(torch.equal(a, b) for a, b in zip(out["single"]["params"], out["sharded"]["params"]))
    rec = {"batch": bs, "crop_hw": [h, w], "dtype": str(cfg.Model.encoder_dtype), "params_bit_identical": same,
           "loss": {k: v["loss"] for k, v in out.items()}, "launches": {k: v["launches"] for k, v in out.items()}}
    emit("parallel", "check", part="sharded cov step, world of one, against the single-process step", **rec)
    if not same or out["single"]["loss"] != out["sharded"]["loss"]:
        raise AssertionError(f"parallel: the sharded step differs from the single-process step {rec}")
    if device.type == "cuda" and any(v["launches"] != {"fp32": 0, "bf16": 1} for v in out.values()):
        raise AssertionError(f"parallel: latent attention launches {rec['launches']}, not one bf16 launch a step")
    return rec


def phase_parallel(device, size: int) -> dict:
    """The multi-process paths on one card, in a world of one over NCCL (gloo
    in the rehearsal): the observation-sharded solve bit-identical to
    solve_two_frame on 37 and 40 observations (icp and disp); one sharded cov
    training step bit-identical to the single-process step; then
    ``dryrun_multichip(1)`` (its own process), ``entry()`` on the card
    against the CPU within phase 4's network bound (5e-3), and
    scripts/torch_throughput.py --sequences 4 at 320x240 through its ``main``.
    Returns the latent-attention launches."""
    import torch
    import torch.distributed as dist

    from macvo_tpu_torch.backend.solver import solve_two_frame
    from macvo_tpu_torch.entry import dryrun_multichip, entry, solve_example
    from macvo_tpu_torch.ops import latent_attn
    from macvo_tpu_torch.parallel import make_sharded_solver
    from macvo_tpu_torch.parallel.mesh import free_port, join_group

    on_card = device.type == "cuda"
    join_group(f"127.0.0.1:{free_port()}", 1, 0, device=device)
    try:
        backend = dist.get_backend()
        solves = {}
        for n in (37, 40):
            for graph in ("icp", "disp"):
                data = solve_example(n, dtype=torch.float32, device=device)
                sharded = make_sharded_solver(None, graph)(data)
                single = solve_two_frame(data, graph_type=graph)
                solves[f"{graph} n={n}"] = {"bit_identical": bool(torch.equal(sharded, single)),
                                            "max_abs_diff": float((sharded - single).abs().max())}
        emit("parallel", "check", part="sharded solve, world of one", backend=backend, **solves)
        if not all(v["bit_identical"] for v in solves.values()):
            raise AssertionError(f"parallel: sharded solve differs from solve_two_frame {solves}")
        step = _sharded_cov_step(device, size)
    finally:
        dist.destroy_process_group()

    start = time.perf_counter()
    dry = dryrun_multichip(1, device=device)
    emit("parallel", "check", part="dryrun_multichip(1)", wall_s=time.perf_counter() - start, **dry)

    fn, (state, img1, img2) = entry(device=device)
    cpu_fn, (cpu_state, _, _) = entry(device="cpu")
    gen = torch.Generator().manual_seed(0)
    a = torch.rand((1, 64, 96, 3), generator=gen)
    b = torch.roll(a, 2, dims=2)
    latent_attn.reset_launches()
    out = fn(state, a.to(device), b.to(device))
    entry_launches = _latent_launches()
    ref = cpu_fn(cpu_state, a, b)
    errs = [float((o.cpu() - r).abs().max()) for o, r in zip(out, ref)]
    emit("parallel", "check", part="entry() card against CPU", max_abs_err={"flow": errs[0], "cov": errs[1]},
         atol=5e-3, launches=entry_launches)
    if max(errs) > 5e-3 or not all(bool(torch.isfinite(o).all()) for o in out):
        raise AssertionError(f"parallel: entry() on the card differs from the CPU by {errs}")

    argv = ["--sequences", "4", "--device", device.type]
    argv += ["--width", "320", "--height", "240"] if not size else ["--width", "96", "--height", "64",
                                                                      "--frames", "4", "--decoder_depth", "2"]
    latent_attn.reset_launches()
    start = time.perf_counter()
    tput = _script("torch_throughput").main(argv)
    tput_launches = _latent_launches()
    emit("parallel", "end", part="torch_throughput.py", wall_s=time.perf_counter() - start, result=tput,
         launches=tput_launches)
    return {"latent_cross_attention[bf16]": {"parallel.cov step (single + sharded)": sum(
                v["bf16"] for v in step["launches"].values()),
                "parallel.torch_throughput (1 + 4 sequences)": tput_launches["bf16"]},
            "latent_cross_attention[fp32]": {"parallel.entry": entry_launches["fp32"]}}


def phase_calib(device, size: int) -> dict:
    """The calibration and analysis scripts through their ``main``: the
    holdout world seq_1049 written by scripts/torch_gen_randomized.py at a
    cut size (5 frames at 320x240); torch_fit_cov_temperature.py on the
    shipped checkpoint with --out in a temporary directory (edges ascending,
    tau2 finite and positive), read back by load_cov_calib, raw and
    recalibrated coverage side by side; torch_cov_calibration.py on the clip;
    torch_depth_quality.py / torch_match_quality.py on
    the clip with GTDepth / GTMatcher; torch_montecarlo_cov.py at its own
    --tol. Returns the latent-attention launches."""
    import json
    import math
    import tempfile

    import numpy as np

    from macvo_tpu_torch.modules.frontend_network import load_cov_calib
    from macvo_tpu_torch.ops import latent_attn

    dev = ["--device", device.type]
    small = [] if not size else ["--decoder_depth", "2", "--dtype", "fp32"]
    (ROOT / "results").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "results", prefix="chip_smoke_calib_") as tmp:
        tmp = Path(tmp)
        start = time.perf_counter()
        frames, w, h = (5, 320, 240) if not size else (3, 96, 64)
        _script("torch_gen_randomized").gen_one((1049, frames, w, h, str(tmp)))
        world_s = time.perf_counter() - start
        latent_attn.reset_launches()
        start = time.perf_counter()
        fit = _script("torch_fit_cov_temperature").main(
            ["--weight", str(CKPT), "--root", str(tmp / "seq_1049"), "--max_pairs", str(frames - 1),
             "--out", str(tmp / "fit.calib.json")] + small + dev)
        fit_launches = _latent_launches()
        edges, tau2 = load_cov_calib(str(tmp / "fit.calib.json"), str(CKPT))
        readback = (np.allclose(edges.cpu().numpy(), fit["log10_sigma_edges"], rtol=1e-6)
                    and np.allclose(tau2.cpu().numpy(), fit["tau2"], rtol=1e-6))
        emit("calib", "check", part="fit", world=[frames, h, w], world_s=world_s,
             fit_s=time.perf_counter() - start, edges=fit["log10_sigma_edges"], tau2=fit["tau2"],
             coverage_raw=fit["fit_coverage_raw"], coverage_recalibrated=fit["fit_coverage_recalibrated"],
             read_back=readback, launches=fit_launches)
        if not (np.all(np.diff(fit["log10_sigma_edges"]) > 0) and all(math.isfinite(t) and t > 0 for t in fit["tau2"])
                and readback):
            raise AssertionError(f"calib: fit {fit} (read back {readback})")
        if CKPT.with_suffix(".calib.json").exists():
            raise AssertionError("calib: a calibration file was written beside the shipped checkpoint")

        data = ["--data", "real", "--max_pairs", "3"] if not size else ["--data", "synthetic", "--max_pairs", "1"]
        latent_attn.reset_launches()
        report = _script("torch_cov_calibration").main(
            ["--weight", str(CKPT), "--out", str(tmp / "cov_calibration"), "--calib", "none"] + data + small[:2] + dev)
        cal_launches = _latent_launches()
        emit("calib", "check", part="cov_calibration", launches=cal_launches,
             **{f: report[f] for f in ("pairs", "epe", "nll", "chi2_coverage")})
        if not math.isfinite(report["nll"]):
            raise AssertionError(f"calib: cov_calibration {report}")

        clip = str(ROOT / CLIP)
        with contextlib.chdir(ROOT):        # the clip's data config names its root relative to the checkout
            depth = _script("torch_depth_quality").main(["--data", clip, "--module", json.dumps(
                {"type": "GTDepth", "args": {}})] + dev)
            match = _script("torch_match_quality").main(["--data", clip, "--module", json.dumps(
                {"type": "GTMatcher", "args": {}})] + dev)
        mc = _script("torch_montecarlo_cov").main([] if not size else ["--samples", "200000"])
        emit("calib", "end", depth_quality=depth, match_quality=match, montecarlo_exit=mc)
        if depth["depth"]["masked_err"] != 0.0 or match[0]["flow"]["epe"] != 0.0 or mc != 0:
            raise AssertionError(f"calib: GT depth {depth}, GT match {match}, montecarlo exit {mc}")
    out = {"latent_cross_attention[bf16]": {}, "latent_cross_attention[fp32]": {}}
    key = "bf16" if not size else "fp32"
    out[f"latent_cross_attention[{key}]"][f"calib.fit ({fit['pairs']} pairs)"] = fit_launches[key]
    out["latent_cross_attention[fp32]"][f"calib.cov_calibration ({report['pairs']} pairs)"] = cal_launches["fp32"]
    return out


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
        with ThreadPoolExecutor(3) as pool:     # one nvcc process a source, started together
            built = list(pool.map(build, ("latent_attn", "correlation", "correlation_bwd")))
        emit("build", "end", wall_s=round(time.perf_counter() - start, 3), libraries=[
            {"library": str(b.path.relative_to(ROOT)), "nvcc_s": round(b.seconds, 3), "ptxas": b.ptxas.splitlines()}
            for b in built])

    # 3. kernel
    emit("kernel", "start")
    kernel_recs = phase_kernel(device, 12800 if on_card else 64, 100 if on_card else 4, timed=on_card)
    batch_kernel = phase_kernel(device, BATCH_N if on_card else 256, 100 if on_card else 4, timed=on_card,
                                dtypes=("fp32",))["latent_cross_attention[fp32]"]
    corr_shapes = CORR_SHAPES + [CORR_ODD] if on_card else [(1, 8, 12, 16), (1, 16, 5, 7)]
    kernel_recs.update(phase_correlation(device, corr_shapes, timed=on_card))
    bwd_shapes = CORR_BWD_SHAPES if on_card else {"rehearsal": [(2, 8, 12, 16), (1, 16, 5, 7)]}
    kernel_recs.update(phase_correlation_bwd(device, bwd_shapes, timed=on_card))
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

    # 14. the dense matchers and depths through the dense evaluation, and the ApplyGT modifiers
    emit("dense", "start")
    start = time.perf_counter()
    for name, parts in phase_dense(device, args.size).items():
        by_phase.setdefault(name, {}).update(parts)
    emit("dense", "end", wall_s=time.perf_counter() - start)

    # 15. TartanVOCovMatcher (PWC + RAFT-style covariance) with seeded random weights
    emit("tartanvo_cov", "start")
    start = time.perf_counter()
    for name, parts in phase_tartanvo_cov(device, args.size).items():
        by_phase.setdefault(name, {}).update(parts)
    emit("tartanvo_cov", "end", wall_s=time.perf_counter() - start)

    # 16. the TartanVO trainer: flow, flowcov and stereo, through the correlation's backward kernel
    emit("train_tvo", "start")
    start = time.perf_counter()
    tvo = phase_train_tvo(device, args.size)
    for name, parts in tvo.items():
        by_phase.setdefault(name, {}).update(parts)
    launches["local_correlation_backward"] = sum(tvo["local_correlation_backward"].values())
    emit("train_tvo", "end", wall_s=time.perf_counter() - start)

    # 17.-19. the runner with its tooling, the pose net's trainer, the batch experiment runner
    for phase, fn in (("runner", phase_runner), ("posenet", phase_posenet), ("experiment", phase_experiment)):
        emit(phase, "start")
        start = time.perf_counter()
        for name, parts in fn(device, args.size).items():
            by_phase.setdefault(name, {}).update(parts)
        emit(phase, "end", wall_s=time.perf_counter() - start)

    # 20.-22. batched odometry, the multi-process paths, the calibration and analysis scripts
    for phase, fn in (("batch", phase_batch), ("parallel", phase_parallel), ("calib", phase_calib)):
        emit(phase, "start")
        start = time.perf_counter()
        for name, parts in fn(device, args.size).items():
            by_phase.setdefault(name, {}).update(parts)
        emit(phase, "end", wall_s=time.perf_counter() - start)

    # 23. kernels
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
        if "other_sets" in rec:
            kernels[-1]["shapes"] = rec["shapes"]
            kernels[-1]["other_shape_sets"] = rec["other_sets"]
        if name == "latent_cross_attention[fp32]":
            kernels[-1]["batched_frontend_shape"] = {k: batch_kernel.get(k) for k in (
                "shape", "max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms", "bound_by", "bound_share",
                "device_bound_share")}
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
