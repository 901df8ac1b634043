"""Train the TartanVO-family nets (port of ``scripts/train_tartanvo.py``).

Usage:
    python -m macvo_tpu_torch.train.tartanvo --mode {flow,stereo,flowcov} [--data data/randomized]
        [--steps 3000] [--batch 4] [--lr 2e-4] [--holdout 2] [--restore PWC.npz] [--out X.npz]
        [--eval-freq 250] [--height 320] [--width 448] [--device cuda|cpu]

* ``--mode flow``: ``PWCFlowNet``, smooth-L1 on the flow at 1/4 resolution
  against the ground truth averaged over 4x4 blocks and scaled by
  ``FLOW_NORM`` (the net regresses flow x 0.05).
* ``--mode stereo``: ``StereoCovNet``, smooth-L1 on the disparity (scaled by
  0.02) plus 0.05 x the Gaussian NLL of the detached disparity error under
  the predicted variance.
* ``--mode flowcov``: ``RAFTFlowCovNet`` with its ``pwc`` frozen (warm-started
  from ``--restore``): the gamma = 0.85-weighted NLL of the detached 1/4-res
  flow error over the GRU iterations. Frozen, the PWC builds no autograd
  graph (its flow only enters the detached error), so the backward reaches
  the context pyramids through the context correlation alone.

Data: the ``seq_*`` TartanAir-layout sequences under ``--data`` (the last
``--holdout`` are held out), random (``--height`` x ``--width``, default
320 x 448) crops with ``PhotometricJitter(1.0)`` and ``AddImageNoise(0.0196)``;
evaluation on the held-out sequences and on the repo's real TartanAir v2 clip.
Optimizer: NaN gradients zeroed, global-norm clip 1.0, AdamW (weight decay
1e-5) at optax's ``linear_onecycle_schedule(steps, lr)`` (constant below 20
steps). The nets start from seeded random weights (``random:0``, flax's
initializer scales).

Outputs: ``--out`` (default ``model/TartanVO_<mode>.npz``) in the JAX
package's npz layout (``load_params`` reads it), rewritten at every
evaluation with a finite held-out metric, and ``<out stem>_metrics.csv``
(``step,loss,holdout_<metric>,real_<metric>``). Runs on the card unless
``--device cpu`` is given (``cuda`` without a card raises). On the card the
PWC and context correlations run the forward kernel, and their gradients the
backward kernel (``ops/correlation.py``): 5 backward launches a flow step, 1 a
flowcov step, none a stereo step.
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

REAL_ASSET = Path(__file__).resolve().parents[2] / "assets/test_sequence/TartanAir2_abs_P000"
CROP_H, CROP_W = 320, 448            # /64 for the PWC pyramid and the hourglass
METRIC = {"flow": "epe_px", "stereo": "disp_mae_px", "flowcov": "nll"}
TRANSFORMS = [{"type": "PhotometricJitter", "args": {"strength": 1.0}},
              {"type": "AddImageNoise", "args": {"stdv": 0.0196}}]


def seq_cfgs(data_root: str | Path, holdout: int) -> tuple[list, list]:
    """(train, held-out) TartanAir configs of the ``seq_*`` directories with a
    ``pose_left.txt`` under ``data_root``; the last ``holdout`` are held out."""
    roots = sorted(p for p in Path(data_root).glob("seq_*") if (p / "pose_left.txt").exists())
    if len(roots) <= holdout:
        raise ValueError(f"not enough sequences under {data_root}: {len(roots)} for {holdout} held out")

    def cfg(root):
        return {"type": "TartanAir", "args": {"root": str(root), "gtFlow": True, "gtDepth": True, "gtPose": True}}

    return [cfg(r) for r in roots[:-holdout]], [cfg(r) for r in roots[-holdout:]]


def real_asset_cfg() -> list:
    return [{"type": "TartanAirV2", "args": {"root": str(REAL_ASSET), "compressed": True,
                                              "gtFlow": True, "gtDepth": True, "gtPose": True}}]


def eval_pairs_for(cfgs, height: int, width: int, max_frames: int = 6, stereo: bool = False) -> list[dict]:
    """Up to ``max_frames`` evaluation batches of one pair each, evenly spaced
    over the pairs of ``cfgs`` (random crops from a generator seeded 3)."""
    from ..data.datasets.train import TrainPairDataset

    ds = TrainPairDataset(cfgs, transforms=[], stereo_prob=1.0 if stereo else 0.0)
    rng = np.random.default_rng(3)
    return [ds.assemble(np.array([i * max(1, len(ds) // max_frames)]), height, width, rng)
            for i in range(min(max_frames, len(ds)))]


def clean_gt(batch: dict) -> tuple[torch.Tensor, torch.Tensor]:
    """NaN-free ground truth and its mask: non-finite flow becomes 0 and leaves
    the mask (NaN x 0 is NaN, which would poison every masked sum)."""
    finite = torch.isfinite(batch["gt_flow"]).all(-1, keepdim=True)
    mask = batch["flow_mask"]
    mask = mask if mask.dtype == torch.bool else mask > 0.5
    return torch.nan_to_num(batch["gt_flow"], nan=0.0, posinf=0.0, neginf=0.0), mask & finite


def _pool4(x: torch.Tensor) -> torch.Tensor:
    """Mean over 4x4 blocks of a (B,H,W,C) map (``reduce_window`` sum / 16, VALID)."""
    return F.avg_pool2d(x.permute(0, 3, 1, 2), 4).permute(0, 2, 3, 1)


def _quarter_gt(batch: dict) -> tuple[torch.Tensor, torch.Tensor]:
    """The 1/4-res ground-truth flow and where it is valid: the whole block
    masked in, and the flow under 400 px."""
    gt_flow, mask = clean_gt(batch)
    gt4 = _pool4(gt_flow)
    valid = (_pool4(mask.float()) > 0.99) & (torch.linalg.vector_norm(gt4, dim=-1, keepdim=True) < 400.0)
    return gt4, valid


def _smooth_l1(d: torch.Tensor) -> torch.Tensor:
    return torch.where(d < 0.5, d * d, d - 0.25)


def flow_loss(model, batch: dict) -> tuple[torch.Tensor, torch.Tensor]:
    """(smooth-L1 loss on the normalized 1/4-res flow, EPE in px)."""
    from ..models.tartanvo import FLOW_NORM, normalize_image

    pred = model(normalize_image(batch["img1"]), normalize_image(batch["img2"]))
    gt4, valid = _quarter_gt(batch)
    n = valid.sum()
    loss = (_smooth_l1((pred - gt4 * FLOW_NORM).abs()) * valid).sum() / torch.clamp(n * 2, min=1.0)
    epe = (torch.linalg.vector_norm(pred / FLOW_NORM - gt4, dim=-1, keepdim=True) * valid).sum()
    return loss, epe / torch.clamp(n, min=1.0)


def stereo_loss(model, batch: dict) -> tuple[torch.Tensor, torch.Tensor]:
    """(smooth-L1 on the scaled disparity + 0.05 x NLL of the detached error,
    disparity MAE in px). A stereo sample's ground truth is (-disparity, 0)."""
    from ..models.tartanvo import normalize_image

    disp, var = model(normalize_image(batch["img1"]), normalize_image(batch["img2"]))
    gt_flow, mask = clean_gt(batch)
    gt_disp = -gt_flow[..., 0:1]
    valid = mask & (gt_disp > 0.05) & (gt_disp < 400.0)
    err2 = ((disp - gt_disp) ** 2).detach()
    var = torch.clamp(var, min=1e-4)
    nll = err2 / var + torch.log(var)
    n = torch.clamp(valid.sum(), min=1.0)
    loss = ((_smooth_l1((disp - gt_disp).abs() * 0.02) + 0.05 * nll) * valid).sum() / n
    return loss, ((disp - gt_disp).abs() * valid).sum() / n


def flowcov_loss(model, batch: dict, gamma: float = 0.85) -> tuple[torch.Tensor, torch.Tensor]:
    """(gamma-weighted NLL of the detached 1/4-res flow error over the GRU
    iterations, the last iteration's NLL)."""
    from ..models.tartanvo import FLOW_NORM, normalize_image

    flow, log_sigmas = model(normalize_image(batch["img1"]), normalize_image(batch["img2"]))
    gt4, valid = _quarter_gt(batch)
    err2 = ((flow / FLOW_NORM - gt4) ** 2).detach()
    denom = torch.clamp(valid.sum() * 2, min=1.0)

    def nll(ls):
        return ((err2 / torch.clamp(torch.exp(2.0 * ls), min=1e-6) + 2.0 * ls) * valid).sum() / denom

    n_it = log_sigmas.shape[0]
    total = sum(gamma ** (n_it - 1 - i) * nll(log_sigmas[i]) for i in range(n_it))
    return total, nll(log_sigmas[-1]).detach()


LOSSES = {"flow": flow_loss, "stereo": stereo_loss, "flowcov": flowcov_loss}


def build_model(mode: str, device: torch.device, restore: str | None = None, seed: int = 0):
    """(model on ``device`` with seeded random weights, its trainable
    parameters). ``flowcov`` loads ``restore`` into ``pwc`` and freezes it."""
    from ..models.flowformer.weights import build_with_weights, load_flax_checkpoint
    from ..models.tartanvo import PWCFlowNet, RAFTFlowCovNet, StereoCovNet
    from ..utils.precision import tf32_off

    if restore and mode != "flowcov":
        raise ValueError("--restore warm-starts the PWC of --mode flowcov only")
    model = build_with_weights({"flow": PWCFlowNet, "stereo": StereoCovNet, "flowcov": RAFTFlowCovNet}[mode],
                               f"random:{seed}")
    if mode == "flowcov":
        if restore:
            load_flax_checkpoint(model.pwc, restore)
        model.pwc.requires_grad_(False)
    if device.type == "cuda":     # fp32 as the JAX step: TF32 off for cuDNN and cuBLAS
        tf32_off()
    model = model.to(device)
    return model, [p for p in model.parameters() if p.requires_grad]


def make_optimizer(params, steps: int, lr: float):
    """clip_by_global_norm(1.0) -> adamw(weight decay 1e-5) at
    ``linear_onecycle_schedule(steps, lr)`` (optax's pct_start 0.3), or the
    constant ``lr`` below 20 steps; :func:`update` puts zero_nans first."""
    from .step import Optimizer, TrainConfig

    cfg = TrainConfig(lr=lr, weight_decay=1e-5, clip=1.0, num_steps=steps, warmup_frac=0.3)
    return Optimizer(params, cfg)


def zero_nans_(grads: list[torch.Tensor]) -> None:
    """optax's ``zero_nans``, in place: every NaN entry of a gradient becomes 0
    (infinities stay), so one poisoned batch is a skipped step instead of a NaN
    norm that the clip multiplies into every update."""
    for g in grads:
        torch.nan_to_num_(g, nan=0.0, posinf=float("inf"), neginf=float("-inf"))


def update(opt) -> None:
    """The JAX trainer's ``chain(zero_nans(), clip_by_global_norm(1.0),
    adamw)``: zero the NaN entries of the gradients, then ``opt``'s step."""
    zero_nans_([p.grad for p in opt.params if p.grad is not None])
    opt.step()


def make_step(model, mode: str, opt, device: torch.device):
    """``step(batch) -> (loss, metric)``: the batch to ``device`` and upcast,
    one forward, backward and optimizer step; detached device tensors."""
    from ..data.datasets.train import upcast_batch

    loss_fn = LOSSES[mode]

    def step(batch):
        loss, metric = loss_fn(model, upcast_batch(with_mask(batch), device))
        loss.backward()
        update(opt)
        return loss.detach(), metric.detach()

    return step


def with_mask(batch: dict) -> dict:
    """The batch with an all-true ``flow_mask`` where it has none."""
    if "flow_mask" in batch:
        return batch
    return {**batch, "flow_mask": np.ones(np.shape(batch["gt_flow"])[:-1] + (1,), bool)}


def make_eval(model, mode: str, device: torch.device):
    """``evaluate(pairs) -> mean metric`` without gradients."""
    from ..data.datasets.train import upcast_batch

    loss_fn = LOSSES[mode]

    @torch.no_grad()
    def evaluate(pairs) -> float:
        return float(np.mean([float(loss_fn(model, upcast_batch(with_mask(b), device))[1]) for b in pairs]))

    return evaluate


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mode", choices=["flow", "stereo", "flowcov"], required=True)
    ap.add_argument("--data", type=str, default="data/randomized")
    ap.add_argument("--steps", type=int, default=3000)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--lr", type=float, default=2e-4)
    ap.add_argument("--holdout", type=int, default=2)
    ap.add_argument("--restore", type=str, default=None, help="flowcov: PWC flow checkpoint to warm-start and freeze")
    ap.add_argument("--out", type=str, default=None)
    ap.add_argument("--eval-freq", type=int, default=250)
    ap.add_argument("--height", type=int, default=CROP_H, help="crop height (a multiple of 64)")
    ap.add_argument("--width", type=int, default=CROP_W, help="crop width (a multiple of 64)")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Train as the module doc says; returns ``{"out", "csv", "steps": [{loss,
    metric, ms}...], "evals": [...]}`` (``ms``: each step's wall time, synced)."""
    from ..data.datasets.train import TrainPairDataset
    from ..models.flowformer.weights import save_params
    from ..utils.device import resolve_device

    args = parse_args(argv)
    device = resolve_device(args.device)
    out_path = Path(args.out or f"model/TartanVO_{args.mode}.npz")
    stereo = args.mode == "stereo"
    train_cfgs, hold_cfgs = seq_cfgs(args.data, args.holdout)
    ds = TrainPairDataset(train_cfgs, transforms=TRANSFORMS, stereo_prob=1.0 if stereo else 0.0)
    ev_hold = eval_pairs_for(hold_cfgs, args.height, args.width, stereo=stereo)
    ev_real = eval_pairs_for(real_asset_cfg(), args.height, args.width, stereo=stereo)
    print(f"mode={args.mode}: {len(ds)} train pairs, {len(ev_hold)} holdout + {len(ev_real)} real eval pairs",
          flush=True)

    model, params = build_model(args.mode, device, args.restore)
    if args.restore:
        print(f"warm-started pwc from {args.restore}", flush=True)
    opt = make_optimizer(params, args.steps, args.lr)
    step, evaluate = make_step(model, args.mode, opt, device), make_eval(model, args.mode, device)
    name = METRIC[args.mode]
    csv = out_path.with_name(out_path.stem + "_metrics.csv")
    out_path.parent.mkdir(parents=True, exist_ok=True)
    csv.write_text(f"step,loss,holdout_{name},real_{name}\n")
    record = {"out": str(out_path), "csv": str(csv), "steps": [], "evals": []}

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    t0 = time.time()
    batches = ds.batches(args.batch, args.height, args.width, seed=5)
    for i in range(args.steps):
        batch = next(batches)
        sync()
        start = time.perf_counter()
        loss, metric = step(batch)
        sync()
        record["steps"].append({"loss": float(loss), "metric": float(metric),
                                "ms": (time.perf_counter() - start) * 1e3})
        if (i + 1) % args.eval_freq == 0 or i + 1 == args.steps:
            mh, mr = evaluate(ev_hold), evaluate(ev_real)
            record["evals"].append({"step": i + 1, f"holdout_{name}": mh, f"real_{name}": mr})
            print(f"step {i + 1}/{args.steps} loss={float(loss):.4f} train_{name}={float(metric):.3f} "
                  f"holdout={mh:.3f} real={mr:.3f} ({(i + 1) / (time.time() - t0):.2f} it/s)", flush=True)
            with csv.open("a") as f:
                f.write(f"{i + 1},{float(loss):.5f},{mh:.5f},{mr:.5f}\n")
            if np.isfinite(mh):
                save_params(out_path, model)
            else:
                print("NONFINITE eval — checkpoint NOT overwritten", flush=True)
    if np.isfinite(evaluate(ev_hold)):
        save_params(out_path, model)
    print(f"saved {out_path}", flush=True)
    return record


if __name__ == "__main__":
    main()
