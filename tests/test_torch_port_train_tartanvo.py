"""The port's trainer of the TartanVO-family nets (``macvo_tpu_torch.train.tartanvo``)
against the JAX package's (``scripts/train_tartanvo.py``), on the CPU.

The JAX trainer defines its per-mode losses inside ``main``; ``_jax_losses``
below restates them (``scripts/train_tartanvo.py:130-207``) with its optimizer
chain (``:209-226``). Both sides start from one set of seeded weights (the
port's ``random_state``, written into the flax layout by the port's npz
writer) and see one seeded batch (2 x 64x64; NaN ground truth and a masked
block in). One step is held to the step-parity bounds of ``chip_smoke.py``
phase 12: the loss 1e-5 relative, each leaf's gradient 1e-4 of the leaf's
scale, each weight's update 1e-3 lr plus two ulps where the first Adam step's
direction is decided (clipped gradient at least 1e-2 of its leaf's scale and
100 Adam eps).
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from macvo_tpu.data.datasets.train import upcast_batch as j_upcast_batch
from macvo_tpu.models.flowformer.weights import load_params
from macvo_tpu.models.tartanvo import PWCFlowNet as JPWC
from macvo_tpu.models.tartanvo import RAFTFlowCovNet as JRAFT
from macvo_tpu.models.tartanvo import StereoCovNet as JStereo
from macvo_tpu.models.tartanvo.network import FLOW_NORM, normalize_image
from macvo_tpu_torch.data.datasets.synthetic import write_tartanair_layout
from macvo_tpu_torch.models.flowformer.weights import (
    flax_to_torch, load_state, random_state, torch_to_flax, transposed_convs)
from macvo_tpu_torch.models.tartanvo import PWCFlowNet, RAFTFlowCovNet, StereoCovNet
from macvo_tpu_torch.train import tartanvo as tt
from macvo_tpu_torch.train.step import Optimizer, TrainConfig

ROOT = Path(__file__).parent.parent
H, W, B, LR = 64, 64, 2, 2e-4
JNETS = {"flow": JPWC, "stereo": JStereo, "flowcov": JRAFT}
NETS = {"flow": PWCFlowNet, "stereo": StereoCovNet, "flowcov": RAFTFlowCovNet}


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _jax_losses(model, mode):
    """``forward_loss(params, batch) -> (loss, metric)`` of scripts/train_tartanvo.py."""

    def clean_gt(b):
        finite = jnp.all(jnp.isfinite(b["gt_flow"]), -1, keepdims=True)
        m = jnp.asarray(b["flow_mask"])
        m = m if m.dtype == jnp.bool_ else m > 0.5
        return jnp.nan_to_num(b["gt_flow"]), m & finite

    def quarter(b):
        gt_flow, mask = clean_gt(b)
        gt4 = jax.lax.reduce_window(gt_flow, 0.0, jax.lax.add, (1, 4, 4, 1), (1, 4, 4, 1), "VALID") / 16.0
        m4 = jax.lax.reduce_window(mask.astype(jnp.float32), 0.0, jax.lax.add, (1, 4, 4, 1), (1, 4, 4, 1),
                                   "VALID") / 16.0
        return gt4, (m4 > 0.99) & (jnp.linalg.norm(gt4, axis=-1, keepdims=True) < 400.0)

    def flow(p, b):
        b = j_upcast_batch(b)
        pred = model.apply({"params": p}, normalize_image(b["img1"]), normalize_image(b["img2"]))
        gt4, valid = quarter(b)
        d = jnp.abs(pred - gt4 * FLOW_NORM)
        sl1 = jnp.where(d < 0.5, d * d, d - 0.25)
        loss = jnp.sum(sl1 * valid) / jnp.maximum(jnp.sum(valid) * 2, 1.0)
        epe = jnp.sum(jnp.linalg.norm(pred / FLOW_NORM - gt4, axis=-1, keepdims=True) * valid)
        return loss, epe / jnp.maximum(jnp.sum(valid), 1.0)

    def stereo(p, b):
        b = j_upcast_batch(b)
        disp_pred, disp_var = model.apply({"params": p}, normalize_image(b["img1"]), normalize_image(b["img2"]))
        gt_flow, mask = clean_gt(b)
        gt_disp = -gt_flow[..., 0:1]
        valid = mask & (gt_disp > 0.05) & (gt_disp < 400.0)
        d = jnp.abs(disp_pred - gt_disp) * 0.02
        sl1 = jnp.where(d < 0.5, d * d, d - 0.25)
        err2 = jax.lax.stop_gradient((disp_pred - gt_disp) ** 2)
        nll = err2 / jnp.maximum(disp_var, 1e-4) + jnp.log(jnp.maximum(disp_var, 1e-4))
        loss = jnp.sum((sl1 + 0.05 * nll) * valid) / jnp.maximum(jnp.sum(valid), 1.0)
        return loss, jnp.sum(jnp.abs(disp_pred - gt_disp) * valid) / jnp.maximum(jnp.sum(valid), 1.0)

    def flowcov(p, b):
        b = j_upcast_batch(b)
        fl, log_sigmas = model.apply({"params": p}, normalize_image(b["img1"]), normalize_image(b["img2"]))
        gt4, valid = quarter(b)
        err2 = jax.lax.stop_gradient((fl / FLOW_NORM - gt4) ** 2)
        total, gamma, n_it = 0.0, 0.85, log_sigmas.shape[0]
        for i in range(n_it):
            var = jnp.exp(2.0 * log_sigmas[i])
            nll = err2 / jnp.maximum(var, 1e-6) + 2.0 * log_sigmas[i]
            total = total + gamma ** (n_it - 1 - i) * jnp.sum(nll * valid) / jnp.maximum(jnp.sum(valid) * 2, 1.0)
        last = jnp.sum((err2 / jnp.maximum(jnp.exp(2 * log_sigmas[-1]), 1e-6) + 2 * log_sigmas[-1]) * valid)
        return total, last / jnp.maximum(jnp.sum(valid) * 2, 1.0)

    return {"flow": flow, "stereo": stereo, "flowcov": flowcov}[mode]


def _jax_optimizer(mode, steps=1, lr=LR):
    """The JAX trainer's chain (constant lr below 20 steps); flowcov freezes pwc."""
    sched = optax.linear_onecycle_schedule(steps, lr) if steps >= 20 else lr
    opt = optax.chain(optax.zero_nans(), optax.clip_by_global_norm(1.0), optax.adamw(sched, weight_decay=1e-5))
    if mode == "flowcov":
        opt = optax.multi_transform({"train": opt, "frozen": optax.set_to_zero()},
                                    param_labels=lambda tree: {k: ("frozen" if k == "pwc" else "train") for k in tree})
    return opt


def _batch(mode, seed=0):
    """Host batch as the dataset ships it: uint8 images, float16 flow with
    NaNs, a bool mask with a masked block; a stereo batch holds (-disparity, 0)."""
    rng = np.random.default_rng(seed)
    img = lambda: (rng.random((B, H, W, 3)) * 255).round().astype(np.uint8)
    if mode == "stereo":
        disp = rng.uniform(0.5, 30.0, size=(B, H, W, 1))
        gt = np.concatenate([-disp, np.zeros_like(disp)], -1)
    else:
        gt = rng.normal(0, 4.0, size=(B, H, W, 2))
    gt[0, 5:9, 10:30] = np.nan
    mask = np.ones((B, H, W, 1), bool)
    mask[1, 20:40, 40:80] = False
    return {"img1": img(), "img2": img(), "gt_flow": gt.astype(np.float16), "flow_mask": mask}


def _flat(tree):
    return {"/".join(k): np.asarray(v) for k, v in flatten_dict(tree).items()}


@pytest.fixture(scope="module")
def inits():
    """mode -> (JAX module, params): the port's seeded random weights (seed 1)
    in the flax layout, through the port's npz writer's ``torch_to_flax``."""
    out = {}
    for mode, jcls in JNETS.items():
        model = NETS[mode]()
        flat = torch_to_flax(random_state(model, 1), transposed_convs(model))
        out[mode] = (jcls(), unflatten_dict({tuple(k.split("/")): jnp.asarray(v) for k, v in flat.items()}))
    return out


def _port_model(mode, params):
    model, trainable = tt.build_model(mode, torch.device("cpu"))
    load_state(model, flax_to_torch(_flat(params), transposed_convs(model)))
    return model, trainable


@pytest.mark.parametrize("mode", ["flow", "stereo", "flowcov"])
def test_one_step_matches_the_jax_trainer(inits, mode):
    """Loss, metric, every trainable leaf's gradient and the update of one
    optimizer step, against the JAX trainer's step on the same batch and
    weights (bounds in the module doc); in flowcov the pwc stays bit-identical
    and gets no gradient."""
    from macvo_tpu_torch.data.datasets.train import upcast_batch

    jm, params = inits[mode]
    batch = upcast_batch(tt.with_mask(_batch(mode)), "cpu")
    # Both sides get the images the port's upcast made: XLA may take x/255 as x*(1/255), one ulp
    # off, and a ReLU of the stereo net near zero turns that ulp into another gradient.
    jbatch = {k: v.numpy() for k, v in batch.items()}
    jloss = _jax_losses(jm, mode)
    (jl, jmetric), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(params, jbatch)
    jopt = _jax_optimizer(mode)
    updates, _ = jax.jit(jopt.update)(jgrads, jopt.init(params), params)
    jupd, jg = _flat(updates), _flat(jgrads)

    model, trainable = _port_model(mode, params)
    names = {id(p): n for n, p in model.named_parameters()}
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    opt = tt.make_optimizer(trainable, 1, LR)
    loss, metric = tt.LOSSES[mode](model, batch)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    np.testing.assert_allclose(float(metric.detach()), float(jmetric), rtol=1e-5)
    # A parameter outside the path (the unused levels of the context pyramids) has no gradient: zero in JAX.
    grads = {names[id(p)]: torch.zeros_like(p) if p.grad is None else p.grad.clone() for p in trainable}
    state = flax_to_torch(jg, transposed_convs(model))
    if mode == "flowcov":
        assert all(not n.startswith("pwc.") for n in grads) and all(
            p.grad is None for p in model.pwc.parameters())
    for n, g in grads.items():
        ref = state[n].numpy()
        scale = max(float(np.abs(ref).max()), 1e-30)
        assert float(np.abs(g.numpy() - ref).max()) <= 1e-4 * scale, n
    norm = float(torch.linalg.vector_norm(torch.stack([g.norm() for g in grads.values()])))
    clipped = {n: g * min(1.0, 1.0 / norm) for n, g in grads.items()}
    tt.update(opt)
    upd_ref = flax_to_torch(jupd, transposed_convs(model))
    n_decided = 0
    for n, p in model.named_parameters():
        moved = (p.detach() - before[n]).numpy()
        if n not in grads:
            assert np.array_equal(moved, np.zeros_like(moved)), n          # frozen: bit-identical
            continue
        g = clipped[n].numpy()
        decided = (np.abs(g) >= 1e-2 * np.abs(g).max()) & (np.abs(g) >= 100 * 1e-8)
        bound = 1e-3 * LR + 2 * np.spacing(np.abs(before[n].numpy()))
        err = np.abs(moved - upd_ref[n].numpy())
        assert (err[decided] <= bound[decided]).all(), n
        n_decided += int(decided.sum())
    assert n_decided > 0.01 * sum(g.numel() for g in grads.values())


def test_flowcov_step_keeps_the_pwc_bit_identical(inits, tmp_path):
    """Two flowcov steps through ``make_step`` from a restored PWC: the PWC's
    weights equal the restored ones bit for bit; the covariance branch moves."""
    from macvo_tpu_torch.models.flowformer.weights import save_params

    _, params = inits["flow"]
    pwc = PWCFlowNet()
    load_state(pwc, flax_to_torch(_flat(params), transposed_convs(pwc)))
    save_params(tmp_path / "pwc.npz", pwc)
    model, trainable = tt.build_model("flowcov", torch.device("cpu"), restore=str(tmp_path / "pwc.npz"))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    step = tt.make_step(model, "flowcov", tt.make_optimizer(trainable, 2, LR), torch.device("cpu"))
    for seed in (0, 1):
        loss, _ = step(_batch("flowcov", seed))
        assert torch.isfinite(loss)
    after = model.state_dict()
    assert all(torch.equal(after[k], v) for k, v in before.items() if k.startswith("pwc."))
    assert all(torch.equal(after[k], pwc.state_dict()[k[4:]]) for k in after if k.startswith("pwc."))
    assert any(not torch.equal(after[k], v) for k, v in before.items() if k.startswith("gaussian."))


def test_nan_gradient_gives_a_skipped_step():
    """A gradient that is NaN everywhere is zeroed before the clip: the first
    step moves the weights by the decoupled weight decay alone, as optax's
    chain does; a partly NaN gradient keeps its finite entries (within 1e-6 of
    optax)."""
    rng = np.random.default_rng(2)
    w0 = rng.normal(size=(3, 4)).astype(np.float32)
    everywhere = np.full((3, 4), np.nan, np.float32)
    partly = np.where(rng.random((3, 4)) < 0.3, np.nan, rng.normal(size=(3, 4))).astype(np.float32)
    for g in (everywhere, partly):
        jopt = _jax_optimizer("flow", steps=1, lr=1e-2)
        upd, _ = jopt.update({"w": g}, jopt.init({"w": w0}), {"w": w0})
        p = torch.nn.Parameter(torch.from_numpy(w0.copy()))
        opt = tt.make_optimizer([p], 1, 1e-2)
        p.grad = torch.from_numpy(g.copy())
        tt.update(opt)
        np.testing.assert_allclose(p.detach().numpy(), w0 + np.asarray(upd["w"]), rtol=1e-6, atol=1e-7)
        assert torch.isfinite(p).all()
        if g is everywhere:
            np.testing.assert_allclose(p.detach().numpy(), w0 * (1 - 1e-2 * 1e-5), rtol=1e-7)
    grads = [torch.tensor([1.0, float("nan"), float("inf")])]
    tt.zero_nans_(grads)
    assert grads[0].tolist() == [1.0, 0.0, float("inf")]


@pytest.mark.parametrize("steps", [100, 20, 19, 3])
def test_schedule_is_optax_linear_onecycle(steps):
    """The trainer's lr at every step (and 5 past the end) equals optax's
    ``linear_onecycle_schedule(steps, lr)`` with its default pct_start 0.3
    (1e-5 relative: optax interpolates in fp32); below 20 steps it is the
    constant lr, as the JAX trainer's guard makes it."""
    p = torch.nn.Parameter(torch.zeros(1))
    opt = tt.make_optimizer([p], steps, LR)
    ref = optax.linear_onecycle_schedule(steps, LR)
    for s in range(steps + 5):
        expect = float(ref(s)) if steps >= 20 else LR
        np.testing.assert_allclose(opt.schedule(s), expect, rtol=1e-5, err_msg=f"step {s}")
    assert isinstance(opt, Optimizer) and opt.cfg == TrainConfig(
        lr=LR, weight_decay=1e-5, clip=1.0, num_steps=steps, warmup_frac=0.3)


@pytest.fixture(scope="module")
def layout(tmp_path_factory):
    """Three ``seq_*`` TartanAir layouts of 4 SyntheticStereo frames at
    128x192, written with the port's writer (the last is held out)."""
    root = tmp_path_factory.mktemp("randomized")
    for i in range(3):
        write_tartanair_layout(root / f"seq_{i:03d}", {"n_frames": 4, "width": 192, "height": 128,
                                                       "seed": 3 + i, "traj_seed": i})
    return root


@pytest.mark.parametrize("mode", ["flow", "stereo", "flowcov"])
def test_runner_end_to_end_writes_what_jax_loads(layout, tmp_path, mode):
    """``main`` on the CPU: 2 steps at batch 2 on 64x128 crops, an evaluation
    at step 2 on the held-out sequence and the real clip; the metrics CSV has
    the JAX header and a row for step 2; the npz loads through the JAX
    package's ``load_params`` and gives the port's outputs (PWCFlowNet's
    tolerance, 2e-6 absolute and 1e-5 relative)."""
    out = tmp_path / f"tvo_{mode}.npz"
    argv = ["--mode", mode, "--data", str(layout), "--steps", "2", "--batch", "2", "--holdout", "1",
            "--eval-freq", "2", "--height", "64", "--width", "128", "--out", str(out), "--device", "cpu"]
    if mode == "flowcov":
        pwc = PWCFlowNet()
        load_state(pwc, tt.build_model("flow", torch.device("cpu"))[0].state_dict())
        from macvo_tpu_torch.models.flowformer.weights import save_params

        save_params(tmp_path / "pwc.npz", pwc)
        argv += ["--restore", str(tmp_path / "pwc.npz")]
    rec = tt.main(argv)
    assert len(rec["steps"]) == 2 and all(np.isfinite(s["loss"]) for s in rec["steps"])
    rows = (tmp_path / f"tvo_{mode}_metrics.csv").read_text().strip().splitlines()
    name = tt.METRIC[mode]
    assert rows[0] == f"step,loss,holdout_{name},real_{name}" and rows[1].startswith("2,")
    assert all(np.isfinite(float(v)) for v in rows[1].split(","))

    jm = JNETS[mode]()
    probe = jnp.zeros((1, 64, 64, 3))
    params = load_params(out, jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), probe, probe)["params"]))
    model = NETS[mode]().eval()
    with np.load(out) as data:
        load_state(model, flax_to_torch({k: data[k] for k in data.files}, transposed_convs(model)))
    x = np.random.default_rng(9).normal(size=(2, 1, 64, 128, 3)).astype(np.float32)
    with torch.inference_mode():
        ours = model(torch.from_numpy(x[0]), torch.from_numpy(x[1]))
    ref = jax.jit(lambda p, a, b: jm.apply({"params": p}, a, b))(params, x[0], x[1])
    for a, b in zip(ours if isinstance(ours, tuple) else (ours,), ref if isinstance(ref, tuple) else (ref,)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=2e-6, rtol=1e-5)


def test_runner_needs_a_card_unless_told_cpu(layout, tmp_path):
    """The default device is cuda: without a card the runner raises before it
    trains or writes anything."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tt.main(["--mode", "flow", "--data", str(layout), "--steps", "1", "--holdout", "1",
                 "--out", str(tmp_path / "x.npz")])
    assert not (tmp_path / "x.npz").exists()
    with pytest.raises(ValueError, match="flowcov"):
        tt.build_model("flow", torch.device("cpu"), restore="x.npz")
