"""FlowFormerCov training step: config, freeze policy, optimizer, schedule
(port of ``macvo_tpu/train/step.py``).

The same recipe as the JAX package: clip the gradient to global norm
``clip``, then AdamW (eps 1e-8, decoupled weight decay) at optax's
``linear_onecycle_schedule`` (constant lr below 20 steps), gamma-weighted
sequence losses, and the freeze policy: mode ``flow`` freezes the covariance
branch, modes ``cov`` / ``finalcov`` train only it. A frozen parameter gets
``requires_grad=False`` and stays out of the optimizer, which is what optax's
``multi_transform`` with ``set_to_zero`` does: no update, no weight decay,
and the clipping norm over the trainable parameters only. In ``cov`` mode
nothing upstream of the covariance branch then needs a gradient, so the cost
perceiver takes the fused latent-attention kernel.

:func:`make_train_step` runs on one device. :func:`make_sharded_train_step`
is the data-parallel step, one process a device: each process takes its rows
of the global batch, its loss is its share of the global batch's loss (see
``loss.py``), the gradients of the trainable parameters are summed with one
``all_reduce``, and every process clips by the global norm and applies the
same update. That is the step on the global batch, as the JAX package's
step jitted over a mesh computes it, not an average of per-process means.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

import torch.distributed as dist

from ..data.datasets.train import upcast_batch
from .loss import GlobalBatch, sequence_loss

COV_BRANCH_MARKERS = ("cov_gru", "cov_head", "cov_mask")


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    lr: float = 12.5e-5
    weight_decay: float = 1e-5
    clip: float = 1.0
    num_steps: int = 120_000
    warmup_frac: float = 0.05
    gamma: float = 0.85
    max_flow: float = 400.0
    training_mode: str = "cov"     # "flow" | "cov" | "finalcov"
    tail_weight: float = 0.0       # >0: up-weight top-decile-EPE pixels in the cov NLL


def is_cov_param(name: str) -> bool:
    """True for a parameter of the covariance branch: a component of its
    dotted name contains one of :data:`COV_BRANCH_MARKERS`."""
    return any(m in part for part in name.split(".") for m in COV_BRANCH_MARKERS)


def is_trainable(name: str, training_mode: str) -> bool:
    """Freeze policy: ``flow`` trains all but the covariance branch, the
    covariance modes train only it."""
    return not is_cov_param(name) if training_mode == "flow" else is_cov_param(name)


def apply_freeze(model: torch.nn.Module, training_mode: str) -> list[torch.nn.Parameter]:
    """Set ``requires_grad`` by the freeze policy; returns the trainable
    parameters in ``named_parameters`` order."""
    trainable = []
    for name, p in model.named_parameters():
        p.requires_grad_(is_trainable(name, training_mode))
        if p.requires_grad:
            trainable.append(p)
    return trainable


def onecycle_schedule(transition_steps: int, peak_value: float, pct_start: float = 0.3,
                      pct_final: float = 0.85, div_factor: float = 25.0,
                      final_div_factor: float = 1e4) -> Callable[[int], float]:
    """optax's ``linear_onecycle_schedule`` as a function of the step: linear
    from peak/div to peak at ``int(pct_start*T)``, back to peak/div at
    ``int(pct_final*T)``, down to peak/div/final_div at T, then constant.
    Like optax, boundaries that coincide collapse into one."""
    boundaries_and_scales = {int(pct_start * transition_steps): div_factor,
                             int(pct_final * transition_steps): 1.0 / div_factor,
                             transition_steps: 1.0 / final_div_factor}
    bounds = [0] + sorted(boundaries_and_scales)
    values = [peak_value / div_factor]
    for b in bounds[1:]:
        values.append(values[-1] * boundaries_and_scales[b])

    def schedule(step: int) -> float:
        for lo, hi, v0, v1 in zip(bounds[:-1], bounds[1:], values[:-1], values[1:]):
            if lo <= step < hi:
                return v0 + (v1 - v0) * (step - lo) / (hi - lo)
        return values[-1]

    return schedule


def make_schedule(cfg: TrainConfig) -> Callable[[int], float]:
    """The lr of each step: the one-cycle schedule with its warmup fraction
    kept at least 2 steps long, or a constant lr for runs under 20 steps."""
    if cfg.num_steps >= 20:
        return onecycle_schedule(cfg.num_steps, cfg.lr, pct_start=max(cfg.warmup_frac, 2.0 / cfg.num_steps))
    return lambda step: cfg.lr


class Optimizer:
    """Clip to global norm, then AdamW at the scheduled lr, over ``params``.

    Clipping follows optax's ``clip_by_global_norm``: gradients are left as
    they are when their global norm is below ``clip`` and scaled to norm
    ``clip`` otherwise, without a host sync. A trainable parameter that got
    no gradient gets a zero one, so its moments decay and its weight decays,
    as optax treats it."""

    def __init__(self, params: list[torch.nn.Parameter], cfg: TrainConfig) -> None:
        self.params = list(params)
        self.cfg = cfg
        self.schedule = make_schedule(cfg)
        self.count = 0
        self.adamw = torch.optim.AdamW(self.params, lr=self.schedule(0), betas=(0.9, 0.999), eps=1e-8,
                                       weight_decay=cfg.weight_decay)

    def step(self) -> None:
        grads = []
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            grads.append(p.grad)
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        scale = torch.where(norm < self.cfg.clip, torch.ones_like(norm), self.cfg.clip / norm)
        torch._foreach_mul_(grads, scale)
        for group in self.adamw.param_groups:
            group["lr"] = self.schedule(self.count)
        self.adamw.step()
        self.adamw.zero_grad(set_to_none=True)
        self.count += 1

    def state_dict(self) -> dict:
        return {"adamw": self.adamw.state_dict(), "count": self.count}

    def load_state_dict(self, state: dict) -> None:
        self.adamw.load_state_dict(state["adamw"])
        self.count = int(state["count"])


def create_optimizer(model: torch.nn.Module, cfg: TrainConfig) -> Optimizer:
    """Apply the freeze policy of ``cfg.training_mode`` and build the optimizer
    over the trainable parameters."""
    return Optimizer(apply_freeze(model, cfg.training_mode), cfg)


def set_matmul_precision(model: torch.nn.Module) -> None:
    """TF32 off when the model runs fully in fp32 (as the frontend does): the
    fp32 recipe stays fp32 on the card. bf16 models run under autocast with
    fp32 master weights."""
    cfg = model.cfg
    if cfg.encoder_dtype == "fp32" and cfg.decoder_dtype == "fp32":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False


def make_loss_fn(model: torch.nn.Module, cfg: TrainConfig, global_batch: GlobalBatch | None = None):
    """``loss_fn(batch) -> (loss, metrics)`` on a batch already on the model's
    device and upcast: one forward and the mode's sequence loss (this
    process's share of it with ``global_batch``)."""

    def loss_fn(batch):
        out = model(batch["img1"], batch["img2"])
        # The head regresses log-sigma; clamp it so an untrained flow branch
        # (huge errors, tiny variance) cannot overflow the NLL.
        cov_var = torch.exp(2.0 * torch.clamp(out["cov_predictions"], -8.0, 8.0))
        return sequence_loss(out["flow_predictions"], cov_var, batch["gt_flow"], batch.get("flow_mask"),
                             gamma=cfg.gamma, max_flow=cfg.max_flow, training_mode=cfg.training_mode,
                             tail_weight=cfg.tail_weight, batch=global_batch)

    return loss_fn


def make_train_step(model: torch.nn.Module, opt: Optimizer, cfg: TrainConfig, device: torch.device | str):
    """Returns ``step(batch) -> aux``: the batch (host arrays: img1, img2
    (B,H,W,3), gt_flow (B,H,W,2), optional flow_mask (B,H,W,1)) goes to
    ``device`` and is upcast there; one forward, backward and optimizer step;
    ``aux`` holds the loss and the mode's metrics as detached device tensors
    (reading them syncs)."""
    loss_fn = make_loss_fn(model, cfg)

    def step(batch) -> dict:
        loss, metrics = loss_fn(upcast_batch(batch, device))
        loss.backward()
        opt.step()
        return {"loss": loss.detach(), **{k: v.detach() for k, v in metrics.items()}}

    return step


def make_sharded_train_step(model: torch.nn.Module, opt: Optimizer, cfg: TrainConfig,
                            device: torch.device | str, group=None):
    """Data-parallel :func:`make_train_step` over the processes of ``group``
    (the default group when None), each holding the same model and optimizer
    state. ``step(batch) -> aux`` takes the GLOBAL batch (host arrays, its
    size a multiple of the group's), keeps this rank's contiguous rows, and
    returns the global loss and metrics; every rank ends the step with the
    same parameters."""
    global_batch = GlobalBatch(group)
    rank, size = dist.get_rank(group), global_batch.size
    loss_fn = make_loss_fn(model, cfg, global_batch)

    def step(batch) -> dict:
        rows = batch["img1"].shape[0]
        if rows % size:
            raise ValueError(f"global batch of {rows} does not split over {size} processes")
        k = rows // size
        local = {key: v[rank * k:(rank + 1) * k] for key, v in batch.items()}
        loss, metrics = loss_fn(upcast_batch(local, device))
        loss.backward()
        for p in opt.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in opt.params]
        flat = torch._utils._flatten_dense_tensors(grads)
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
        for g, summed in zip(grads, torch._utils._unflatten_dense_tensors(flat, grads)):
            g.copy_(summed)
        opt.step()
        return {"loss": global_batch.sum(loss.detach()), **{k: v.detach() for k, v in metrics.items()}}

    return step
