"""Train the TartanVO pose net (VOFlowRes) on ground-truth flow and depth
(port of ``scripts/train_posenet.py``).

Usage:
    python -m macvo_tpu_torch.train.posenet [--data data/randomized] [--steps 4000] [--batch 16]
        [--lr 1e-4] [--holdout 3] [--out model/TartanVO_posenet.npz] [--device cuda|cpu]

Supervision is direct: the input stack ``TartanMotionNet`` builds at
inference (flow x ``FLOW_NORM``, capped inverse depth / ``POSE_DEPTH_NORM``,
the intrinsics layer, all at 112x160) mapped to the ground-truth relative
twist ``se3.log(inv(p0) p1) / POSE_NORM``. The flow and depth come from the
``seq_*`` worlds under ``--data`` (``scripts/torch_gen_randomized.py`` writes
them; only worlds whose ``pose_left.txt`` exists are read). Each pair gives
the full frame and two random crops (:func:`build_samples`, the same arrays
as the JAX trainer's); the last ``holdout x 23 x 3`` samples are held out
for evaluation, a count that assumes 24-frame worlds, as in the JAX trainer.

Optimizer: smooth-L1 loss, AdamW (weight decay 1e-5, eps 1e-8) at optax's
``linear_onecycle_schedule(steps, lr)`` for any run length, with no
gradient clipping, as the JAX trainer; the batches are drawn by
``default_rng(0)`` as there. The net starts from seeded random weights
(``random:0``, flax's initializer scales). The checkpoint is written in the
layout of ``model/TartanVO_posenet.npz``, which ``TartanMotionNet`` of both
packages loads. Runs on the card unless ``--device cpu`` is given (``cuda``
without a card raises); fp32 with TF32 off, as the JAX step.
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path

import numpy as np
import torch

from .step import onecycle_schedule

CROPS_PER_PAIR = 3
EVAL_EVERY = 200           # steps between evaluations on the held-out samples (and after the last step)


def build_samples(roots, holdout: int = 1, crops_per_pair: int = CROPS_PER_PAIR):
    """((X_train, Y_train), (X_eval, Y_eval)) as numpy: X (N,112,160,5) the
    pose net's input stacks, Y (N,6) the normalized twists.

    Each pair gives the full frame and ``crops_per_pair - 1`` random crops
    (scale 0.5-0.9, drawn by ``default_rng(11)``): a crop keeps the camera's
    motion but moves the field of view and principal point, so the net learns
    to read the intrinsics layer. The last ``holdout * 23 * crops_per_pair``
    samples are held out (23 pairs of a 24-frame world)."""
    import cv2

    from ..data.datasets.tartanair import TartanAir
    from ..geometry import se3_np
    from ..models.tartanvo.network import FLOW_NORM, POSE_DEPTH_NORM, POSE_NORM, POSENET_SIZE

    th, tw = POSENET_SIZE
    rng = np.random.default_rng(11)
    xs, ys = [], []
    for root in roots:
        seq = TartanAir({"root": str(root), "gtFlow": True, "gtDepth": True, "gtPose": True})
        for i in range(len(seq) - 1):
            f0, f1 = seq[i], seq[i + 1]
            s = f0.stereo
            flow_full = np.asarray(s.gt_flow[0])
            depth_full = np.asarray(f1.stereo.gt_depth[0, ..., 0])
            fx, fy = float(s.K[0, 0, 0]), float(s.K[0, 1, 1])
            cx, cy = float(s.K[0, 0, 2]), float(s.K[0, 1, 2])
            H, W = s.imageL.shape[1:3]
            rel = se3_np.mul(se3_np.inv(np.asarray(f0.gt_pose[0], np.float64)),
                             np.asarray(f1.gt_pose[0], np.float64))
            twist = se3_np.log(rel).astype(np.float32) / np.asarray(POSE_NORM, np.float32)
            for c in range(crops_per_pair):
                if c == 0:
                    h0, w0, ch, cw = 0, 0, H, W
                else:
                    sc = rng.uniform(0.5, 0.9)
                    ch, cw = int(H * sc), int(W * sc)
                    h0 = int(rng.integers(0, H - ch + 1))
                    w0 = int(rng.integers(0, W - cw + 1))
                flow = cv2.resize(flow_full[h0:h0 + ch, w0:w0 + cw], (tw, th),
                                  interpolation=cv2.INTER_LINEAR) * FLOW_NORM
                # the new frame's depth, as the odometry calls the motion model
                depth = cv2.resize(depth_full[h0:h0 + ch, w0:w0 + cw], (tw, th), interpolation=cv2.INTER_LINEAR)
                # inverse depth capped at 2 (0.5 m), as TartanMotionNet at inference
                inv_depth = np.minimum(1.0 / np.maximum(depth, 1e-6), 2.0) / POSE_DEPTH_NORM
                gx = (np.arange(w0, w0 + cw, dtype=np.float32) - cx) / fx
                gy = (np.arange(h0, h0 + ch, dtype=np.float32) - cy) / fy
                intr = np.stack(np.meshgrid(gx, gy, indexing="xy"), -1)
                intr = cv2.resize(intr, (tw, th), interpolation=cv2.INTER_LINEAR)
                xs.append(np.concatenate([flow, inv_depth[..., None], intr], -1).astype(np.float32))
                ys.append(twist)
    X, Y = np.stack(xs), np.stack(ys)
    n_hold = holdout * 23 * crops_per_pair
    return (X[:-n_hold], Y[:-n_hold]), (X[-n_hold:], Y[-n_hold:])


def smooth_l1(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Mean smooth-L1 (beta 1): the twists have heavy tails, which pure L1 or
    L2 lets dominate the fit."""
    d = (pred - target).abs()
    return torch.where(d < 1.0, 0.5 * d * d, d - 0.5).mean()


def build_model(device: torch.device, seed: int = 0):
    """VOFlowRes with seeded random weights on ``device``; TF32 off on the card."""
    from ..models.flowformer.weights import build_with_weights
    from ..models.tartanvo import VOFlowRes
    from ..utils.precision import tf32_off

    model = build_with_weights(VOFlowRes, f"random:{seed}")
    if device.type == "cuda":
        tf32_off()
    return model.to(device)


def make_optimizer(model: torch.nn.Module, steps: int, lr: float):
    """(AdamW, schedule): optax's ``adamw(linear_onecycle_schedule(steps, lr),
    weight_decay=1e-5)``; :func:`make_step` sets each step's lr."""
    schedule = onecycle_schedule(steps, lr)
    opt = torch.optim.AdamW(model.parameters(), lr=schedule(0), betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=1e-5)
    return opt, schedule


def make_step(model: torch.nn.Module, opt, schedule, device: torch.device):
    """``step(i, xb, yb) -> loss``: one forward, backward and AdamW step at
    ``schedule(i)``; the loss a detached device tensor."""

    def step(i: int, xb: np.ndarray, yb: np.ndarray) -> torch.Tensor:
        loss = smooth_l1(model(torch.from_numpy(xb).to(device)), torch.from_numpy(yb).to(device))
        loss.backward()
        for group in opt.param_groups:
            group["lr"] = schedule(i)
        opt.step()
        opt.zero_grad(set_to_none=True)
        return loss.detach()

    return step


@torch.no_grad()
def evaluate(model: torch.nn.Module, X: np.ndarray, Y: np.ndarray, device: torch.device) -> dict:
    err = (model(torch.from_numpy(X).to(device)) - torch.from_numpy(Y).to(device)).abs()
    return {"l1": float(err.mean()), "trans_l1": float(err[:, :3].mean()), "rot_l1": float(err[:, 3:].mean())}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--data", type=str, default="data/randomized")
    ap.add_argument("--steps", type=int, default=4000)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--holdout", type=int, default=3, help="held-out sequences")
    ap.add_argument("--out", type=str, default="model/TartanVO_posenet.npz")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Train as the module doc says; returns ``{"out", "train", "eval", "steps":
    [{loss, ms}...], "evals": [...], "final_eval", "zero_motion"}`` (``ms``:
    each step's wall time, synced)."""
    from ..models.flowformer.weights import save_params
    from ..utils.device import resolve_device

    args = parse_args(argv)
    device = resolve_device(args.device)
    roots = sorted(p for p in Path(args.data).glob("seq_*") if (p / "pose_left.txt").exists())
    if not roots:
        raise FileNotFoundError(f"no sequences under {args.data}: write them with scripts/torch_gen_randomized.py")
    (Xtr, Ytr), (Xev, Yev) = build_samples(roots, holdout=args.holdout)
    print(f"train {Xtr.shape[0]} pairs, eval {Xev.shape[0]} pairs", flush=True)

    model = build_model(device)
    opt, schedule = make_optimizer(model, args.steps, args.lr)
    step = make_step(model, opt, schedule, device)
    record = {"out": args.out, "train": int(Xtr.shape[0]), "eval": int(Xev.shape[0]), "steps": [], "evals": []}

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    rng = np.random.default_rng(0)
    t0 = time.time()
    for i in range(args.steps):
        idx = rng.integers(0, Xtr.shape[0], args.batch)
        sync()
        start = time.perf_counter()
        loss = step(i, Xtr[idx], Ytr[idx])
        sync()
        record["steps"].append({"loss": float(loss), "ms": (time.perf_counter() - start) * 1e3})
        if (i + 1) % EVAL_EVERY == 0:
            ev = evaluate(model, Xev, Yev, device)
            record["evals"].append({"step": i + 1, **ev})
            print(f"step {i + 1}/{args.steps} loss={float(loss):.4f} eval_l1={ev['l1']:.4f} "
                  f"(t {ev['trans_l1']:.4f} r {ev['rot_l1']:.4f}) {(i + 1) / (time.time() - t0):.2f} it/s",
                  flush=True)

    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    save_params(args.out, model)
    print(f"saved {args.out}", flush=True)
    record["final_eval"] = evaluate(model, Xev, Yev, device)
    # the eval table's baseline: predicting zero motion
    record["zero_motion"] = {"l1": float(np.abs(Yev).mean()), "trans_l1": float(np.abs(Yev[:, :3]).mean()),
                             "rot_l1": float(np.abs(Yev[:, 3:]).mean())}
    print("final eval:", record["final_eval"], "zero-motion baseline:", record["zero_motion"], flush=True)
    return record


if __name__ == "__main__":
    main()
