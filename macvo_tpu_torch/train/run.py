"""Covariance-head / flow training runner (port of ``macvo_tpu/train/run.py``).

Usage:
    python -m macvo_tpu_torch.train.run --config configs/train/FlowFormerCov_synth_cov.yaml \\
        [--restore model/MACVO_FrontendCov.npz] [--steps N] [--out model/FlowFormerCov.npz] \\
        [--device cuda|cpu]

Trains on one device, ``cuda`` unless ``--device cpu`` is given (asking for
``cuda`` without a card raises). Under ``torchrun`` (``WORLD_SIZE`` > 1) it
trains data-parallel, one process a device (``nccl`` on the cards, ``gloo``
with ``--device cpu``):

    torchrun --nproc_per_node <cards> -m macvo_tpu_torch.train.run --config ...

Every process draws the same global batch stream from the same seed and
trains on its rows (``make_sharded_train_step``); the batch is rounded down
to a multiple of the process count, as the JAX runner rounds it to its
devices. Only rank 0 writes the checkpoint, the autosave, the metrics csv and
runs the evaluation. Data comes from a single sequence
(``Data.Sequence``: consecutive pairs, center crops, no prefetch, as in the
JAX runner) or from a multi-sequence mixture with train-time transforms
(``Data.Sequences``: :class:`TrainPairDataset`). An ``Eval`` section adds
held-out evaluation (flow EPE, 1/3-px accuracy, Gaussian NLL of the
covariance head) every ``Eval.freq`` steps and at the end, logged with the
training loss to ``{out stem}_metrics.csv`` beside the checkpoint.

Checkpoints: ``--out`` is written in the JAX package's npz layout (every
``autosave_freq`` steps and at the end), so ``macvo_tpu``'s ``load_params``
and the port's odometry runner both load it. ``{out stem}.trainstate.pt``
holds the full state (model, optimizer, step); a rerun of the same command
resumes from it before any ``--restore``. ``--max_session_steps N`` stops
after N steps of this invocation with that state saved; the end of training
writes ``{out stem}.done`` and removes the state.
"""

from __future__ import annotations

import argparse
import contextlib
import csv
import math
import os
import time
from pathlib import Path

import numpy as np
import torch


def make_pair_batches(seq, batch_size: int, height: int, width: int, rng: np.random.Generator):
    """Single-sequence data: consecutive-frame pairs, center-cropped, as
    compressed host batches (no prefetch)."""
    from ..data.datasets.train import _host, _quantize_img

    n = len(seq)
    if n < 2:
        raise ValueError("training needs a sequence of at least 2 frames")

    def crop(x, h0, w0):
        return _host(x)[:, h0:h0 + height, w0:w0 + width]

    while True:
        idx = rng.integers(0, n - 1, size=batch_size)
        img1, img2, gt_flow, mask = [], [], [], []
        for i in idx:
            f0, f1 = seq[int(i)], seq[int(i) + 1]
            s = f0.stereo
            if s.gt_flow is None:
                raise ValueError("training needs gt_flow")
            h0 = max(0, (s.height - height) // 2)
            w0 = max(0, (s.width - width) // 2)
            img1.append(crop(s.imageL, h0, w0))
            img2.append(crop(f1.stereo.imageL, h0, w0))
            gt_flow.append(crop(s.gt_flow, h0, w0))
            if s.flow_mask is not None:
                mask.append(crop(s.flow_mask, h0, w0))
        batch = {
            "img1": _quantize_img(np.concatenate(img1, 0)),
            "img2": _quantize_img(np.concatenate(img2, 0)),
            "gt_flow": np.concatenate(gt_flow, 0).astype(np.float16),
        }
        if mask:
            batch["flow_mask"] = np.concatenate(mask, 0)
        yield batch


def make_eval_fn(model: torch.nn.Module, max_flow: float = 400.0):
    """``evaluate(batch) -> {epe, px1, px3, nll}`` (0-d tensors on the
    model's device): masked EPE, 1/3-px accuracy and the Gaussian NLL of the
    covariance head on one batch, without gradients. The model's current
    weights are used (the cost perceiver refolds them when they changed)."""
    from ..data.datasets.train import upcast_batch

    @torch.no_grad()
    def evaluate(batch) -> dict[str, torch.Tensor]:
        device = next(model.parameters()).device
        batch = upcast_batch(batch, device)
        out = model(batch["img1"], batch["img2"])
        flow = out["flow_final"].float()
        gt = batch["gt_flow"]
        valid = torch.linalg.vector_norm(gt, dim=-1, keepdim=True) < max_flow
        if "flow_mask" in batch:
            valid = valid & batch["flow_mask"].bool()
        err = torch.linalg.vector_norm(flow - gt, dim=-1, keepdim=True)
        denom = torch.clamp(valid.sum(), min=1)
        epe = torch.where(valid, err, 0.0).sum() / denom
        px1 = (valid & (err < 1.0)).sum() / denom
        px3 = (valid & (err < 3.0)).sum() / denom
        log_sigma = torch.clamp(out["cov_final"].float(), -8.0, 8.0)
        var = torch.exp(2.0 * log_sigma)
        nll = 0.5 * ((flow - gt) ** 2 / var + torch.log(var) + math.log(2 * math.pi))
        nll = torch.where(valid, nll.sum(-1, keepdim=True), 0.0).sum() / denom
        return {"epe": epe, "px1": px1, "px3": px3, "nll": nll}

    return evaluate


def train_config(cfg, steps=None, mode=None, tail_weight=None):
    """The :class:`TrainConfig` of a training yaml's ``Train`` section, with
    the command line's overrides."""
    from .step import TrainConfig

    t = cfg.Train
    return TrainConfig(
        lr=float(t.lr), weight_decay=float(t.weight_decay), clip=float(t.clip),
        num_steps=int(steps or t.num_steps), gamma=float(t.gamma), max_flow=float(t.max_flow),
        training_mode=str(mode or t.training_mode),
        tail_weight=float(tail_weight if tail_weight is not None else getattr(t, "tail_weight", 0.0)))


def build_model(cfg, device: torch.device, seed: int = 0):
    """The training FlowFormerCov of ``cfg.Model`` (per-step stacks on), its
    initial weights drawn from ``seed``, on ``device``."""
    from ..models.flowformer import FlowFormerConfig, FlowFormerCov

    torch.manual_seed(seed)
    model = FlowFormerCov(FlowFormerConfig(
        decoder_depth=int(cfg.Model.decoder_depth), encoder_dtype=str(cfg.Model.encoder_dtype),
        decoder_dtype=str(cfg.Model.decoder_dtype), inference_only=False))
    return model.to(device)


def make_batches(cfg, batch_size: int, height: int, width: int, seed: int):
    """The training batch stream of ``cfg.Data``: the mixture with its
    transforms and one-deep prefetch (``Sequences``) or one sequence's
    consecutive pairs (``Sequence``)."""
    from ..data import SequenceBase
    from ..data.datasets.train import TrainPairDataset

    if hasattr(cfg.Data, "Sequences"):
        dataset = TrainPairDataset(cfg.Data.Sequences, getattr(cfg.Data, "transforms", None),
                                   stereo_prob=float(getattr(cfg.Data, "stereo_prob", 0.0)))
        return dataset.batches(batch_size, height, width, seed=seed)
    seq = SequenceBase.from_config(cfg.Data.Sequence)
    return make_pair_batches(seq, batch_size, height, width, np.random.default_rng(seed))


def eval_pairs(cfg, height: int, width: int) -> list[dict]:
    """The held-out pairs of ``cfg.Eval`` (empty without that section)."""
    from ..data import SequenceBase
    from ..data.datasets.train import make_eval_pairs

    if not hasattr(cfg, "Eval"):
        return []
    return make_eval_pairs(SequenceBase.from_config(cfg.Eval.Sequence), height, width,
                           max_frames=int(getattr(cfg.Eval, "max_frames", 8)))


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="FlowFormerCov training (PyTorch/CUDA port)")
    parser.add_argument("--config", type=str, required=True)
    parser.add_argument("--steps", type=int, default=None, help="override num_steps")
    parser.add_argument("--tail_weight", type=float, default=None,
                        help="cov mode: up-weight top-decile-EPE pixels by (1+w)")
    parser.add_argument("--out", type=str, default="model/FlowFormerCov.npz")
    parser.add_argument("--restore", type=str, default=None, help="npz checkpoint to start from")
    parser.add_argument("--mode", type=str, default=None, choices=["flow", "cov", "finalcov"],
                        help="override Train.training_mode (two-phase recipe)")
    parser.add_argument("--height", type=int, default=None, help="override crop height")
    parser.add_argument("--width", type=int, default=None, help="override crop width")
    parser.add_argument("--batch", type=int, default=None, help="override batch size")
    parser.add_argument("--log_freq", type=int, default=100)
    parser.add_argument("--no_resume", action="store_true",
                        help="ignore an existing full-state autosave next to --out")
    parser.add_argument("--max_session_steps", type=int, default=0,
                        help="exit cleanly (autosave, no done marker) after N steps in this invocation; "
                             "rerunning the command resumes. 0 = unlimited")
    parser.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"])
    args = parser.parse_args(argv)

    import torch.distributed as dist

    from ..parallel.mesh import init_distributed
    from ..utils.device import resolve_device

    device = resolve_device(args.device)
    init_distributed(None, int(os.environ.get("WORLD_SIZE", 1)), int(os.environ.get("RANK", 0)), device=device)
    try:
        train(args, device)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def train(args, device: torch.device) -> None:
    """The training loop of :func:`main`'s arguments, in this process's
    place of the process group (if any)."""
    from ..models.flowformer import load_flax_checkpoint
    from ..models.flowformer.weights import load_train_state, save_params, save_train_state
    from ..parallel.mesh import world
    from ..utils.config import load_config
    from ..utils.logging import Logger
    from .step import create_optimizer, make_sharded_train_step, make_train_step, set_matmul_precision

    rank, n_proc = world()
    is_main = rank == 0
    cfg, _ = load_config(Path(args.config))
    tcfg = train_config(cfg, args.steps, args.mode, args.tail_weight)
    seed0 = int(getattr(cfg.Train, "seed", 0))
    model = build_model(cfg, device, seed0)
    set_matmul_precision(model)
    opt = create_optimizer(model, tcfg)
    batch_size = int(args.batch or cfg.Train.batch_size)
    if batch_size % n_proc:
        batch_size = max(n_proc, (batch_size // n_proc) * n_proc)
        Logger.warning(f"batch_size rounded to {batch_size} for {n_proc} processes")
    h = int(args.height or cfg.Train.image_height)
    w = int(args.width or cfg.Train.image_width)

    # A full-state autosave beside --out trumps --restore: rerunning the same
    # command after a dead session loses at most autosave_freq steps.
    out_path = Path(args.out)
    state_path = out_path.with_name(out_path.stem + ".trainstate.pt")
    start_step = 0
    if state_path.exists() and not args.no_resume:
        start_step = load_train_state(state_path, model, opt)
        Logger.info(f"RESUMED full train state from {state_path} @ step {start_step}")
    elif args.restore:
        load_flax_checkpoint(model, args.restore)
        Logger.info(f"warm-started params from {args.restore}")
    if n_proc > 1:
        step_fn = make_sharded_train_step(model, opt, tcfg, device)
    else:
        step_fn = make_train_step(model, opt, tcfg, device)
    batches = make_batches(cfg, batch_size, h, w, seed0 + start_step)   # a fresh stream on resume

    pairs = eval_pairs(cfg, h, w) if is_main else []
    eval_fn = make_eval_fn(model, tcfg.max_flow) if pairs else None
    eval_freq = int(getattr(cfg.Eval, "freq", 1000)) if pairs else 0
    if pairs:
        Logger.info(f"eval-during-training: {len(pairs)} pairs every {eval_freq} steps")

    autosave = int(getattr(cfg.Train, "autosave_freq", 5000))
    metrics_path = out_path.with_name(out_path.stem + "_metrics.csv")
    if is_main:
        out_path.parent.mkdir(parents=True, exist_ok=True)

    def save(step_i: int) -> None:
        if is_main:
            save_params(out_path, model)
            save_train_state(state_path, model, opt, step_i)

    with open(metrics_path, "a", newline="") if is_main else contextlib.nullcontext() as metrics_file:
        metrics_csv = csv.writer(metrics_file) if is_main else None
        if is_main and metrics_file.tell() == 0:
            metrics_csv.writerow(["step", "split", "loss", "epe", "px1", "px3", "nll"])

        def run_eval(step_i: int) -> None:
            if eval_fn is None:
                return
            ms = [{k: float(v) for k, v in eval_fn(b).items()} for b in pairs]
            agg = {k: float(np.mean([m[k] for m in ms])) for k in ms[0]}
            Logger.info(f"eval @ {step_i}: epe={agg['epe']:.3f} px1={agg['px1']:.3f} "
                        f"px3={agg['px3']:.3f} nll={agg['nll']:.3f}")
            metrics_csv.writerow([step_i, "eval", "", agg["epe"], agg["px1"], agg["px3"], agg["nll"]])
            metrics_file.flush()

        Logger.info(f"Training steps {start_step}..{tcfg.num_steps}, batch {batch_size} on {device}"
                    + (f" x {n_proc} processes" if n_proc > 1 else ""))
        t0 = time.time()
        try:
            for i, batch in enumerate(batches, start=start_step):
                if i >= tcfg.num_steps:
                    break
                if args.max_session_steps and i - start_step >= args.max_session_steps:
                    save(i)
                    Logger.info(f"session step budget ({args.max_session_steps}) reached @ step "
                                f"{i}/{tcfg.num_steps}; autosaved — re-invoke to continue")
                    return
                aux = step_fn(batch)
                if (i + 1) % args.log_freq == 0:
                    loss = float(aux["loss"])
                    rate = (i + 1 - start_step) / (time.time() - t0)
                    Logger.info(f"step {i + 1}/{tcfg.num_steps} loss={loss:.4f} ({rate:.2f} it/s)")
                    if is_main:
                        metrics_csv.writerow([i + 1, "train", loss, "", "", "", ""])
                        metrics_file.flush()
                if eval_freq and (i + 1) % eval_freq == 0:
                    run_eval(i + 1)
                if (i + 1) % autosave == 0:
                    save(i + 1)
                    Logger.info(f"autosaved -> {out_path} (+ full state @ step {i + 1})")
        finally:
            batches.close()   # stops the prefetch thread
        if not (eval_freq and tcfg.num_steps % eval_freq == 0):
            run_eval(tcfg.num_steps)   # final eval, unless the loop just ran one
    if not is_main:
        return
    save_params(out_path, model)
    # The success marker; the resume state goes once it exists, so a rerun
    # cannot silently skip training.
    state_path.unlink(missing_ok=True)
    out_path.with_name(out_path.stem + ".done").write_text(
        f"steps={tcfg.num_steps} mode={tcfg.training_mode} "
        f"finished={time.strftime('%Y-%m-%dT%H:%M:%SZ', time.gmtime())}\n")
    Logger.info(f"final checkpoint -> {out_path}")


if __name__ == "__main__":
    main()
