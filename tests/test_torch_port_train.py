"""Parity of the port's training path (``macvo_tpu_torch/train``, the
decoder's training stacks, the npz writer) with the JAX package.

Inputs are seeded numpy arrays at small sizes: 64x96 images, batch 2, 2
decoder steps, full widths. The model's weights are the shipped checkpoint
plus seeded noise, written by the port's ``save_params`` and read by
``macvo_tpu``'s ``load_params``, so every comparison with JAX also checks the
npz the port writes. Tolerances are stated per test: fp32 on both sides, the
same math summed in other orders. Counterparts of the tests of
``tests/test_train.py`` (but the shipped eval record, a file and not code)
close the file; the runner runs end to end on the CPU.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

from macvo_tpu.models.flowformer import FlowFormerConfig as JConfig
from macvo_tpu.models.flowformer import FlowFormerCov as JModel
from macvo_tpu.models.flowformer.decoder import encode_flow_token as j_encode_flow_token
from macvo_tpu.models.flowformer.weights import flatten_params, load_params
from macvo_tpu.train import loss as jloss
from macvo_tpu.train.run import make_eval_fn as j_make_eval_fn
from macvo_tpu.train.step import TrainConfig as JTrainConfig
from macvo_tpu.train.step import make_optimizer as j_make_optimizer
from macvo_tpu.train.step import trainable_mask
from macvo_tpu_torch.data.datasets.train import upcast_batch
from macvo_tpu_torch.models.flowformer import FlowFormerConfig, FlowFormerCov, load_flax_checkpoint
from macvo_tpu_torch.models.flowformer.decoder import encode_flow_token
from macvo_tpu_torch.models.flowformer.weights import (
    load_train_state, save_params, save_train_state, torch_to_flax)
from macvo_tpu_torch.train import loss
from macvo_tpu_torch.train.run import make_eval_fn
from macvo_tpu_torch.train.step import (
    Optimizer, TrainConfig, apply_freeze, create_optimizer, is_trainable, make_loss_fn, make_schedule,
    make_train_step)

ROOT = Path(__file__).parent.parent
CKPT = ROOT / "model" / "MACVO_FrontendCov.npz"
H, W, DEPTH = 64, 96, 2


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _batch(seed=0, b=2, h=H, w=W):
    rng = np.random.default_rng(seed)
    return {"img1": rng.random((b, h, w, 3)).astype(np.float32), "img2": rng.random((b, h, w, 3)).astype(np.float32),
            "gt_flow": rng.normal(0, 2, (b, h, w, 2)).astype(np.float32),
            "flow_mask": rng.random((b, h, w, 1)) > 0.1}


def _noisy_port_model(depth=DEPTH):
    """The shipped checkpoint plus seeded noise of 1 % of each tensor's spread."""
    model = FlowFormerCov(FlowFormerConfig(decoder_depth=depth))
    load_flax_checkpoint(model, CKPT)
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(torch.randn(p.shape, generator=gen) * 0.01 * (p.std() if p.numel() > 1 else p.abs() + 1e-3))
    return model


@pytest.fixture(scope="module")
def shared(tmp_path_factory):
    """The port's model, the npz it writes, the same weights in JAX through
    ``load_params``, and one compiled JAX program giving the training forward
    and the gradients of the flow-mode and cov-mode losses (as
    ``macvo_tpu.train.step.make_train_step``'s loss computes them)."""
    model = _noisy_port_model()
    path = tmp_path_factory.mktemp("npz") / "port.npz"
    save_params(path, model)
    jm = JModel(JConfig(decoder_depth=DEPTH))
    probe = jnp.zeros((1, H, W, 3), jnp.float32)
    template = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), probe, probe)["params"])
    jparams = load_params(path, template)
    batch = _batch()

    def jloss_fn(p, mode):
        out = jm.apply({"params": p}, batch["img1"], batch["img2"])
        cov_var = jnp.exp(2.0 * jnp.clip(out["cov_predictions"], -8.0, 8.0))
        value, _ = jloss.sequence_loss(out["flow_predictions"], cov_var, jnp.asarray(batch["gt_flow"]),
                                       jnp.asarray(batch["flow_mask"]), training_mode=mode)
        return value, out

    @jax.jit
    def forward_and_grads(p):
        (flow_l, out), flow_g = jax.value_and_grad(lambda q: jloss_fn(q, "flow"), has_aux=True)(p)
        (cov_l, _), cov_g = jax.value_and_grad(lambda q: jloss_fn(q, "cov"), has_aux=True)(p)
        return out, {"flow": (flow_l, flow_g), "cov": (cov_l, cov_g)}

    out, grads = jax.device_get(forward_and_grads(jparams))
    return {"model": model, "path": path, "jm": jm, "jparams": jparams, "template": template, "batch": batch,
            "out": out, "grads": grads}


# -- losses ------------------------------------------------------------------------


def _loss_inputs(seed=1, d=3, b=2, h=8, w=12):
    rng = np.random.default_rng(seed)
    preds = rng.normal(0, 2, (d, b, h, w, 2)).astype(np.float32)
    gt = rng.normal(0, 2, (b, h, w, 2)).astype(np.float32)
    gt[0, 0, 0] = 500.0                                # beyond max_flow
    cov = np.exp(rng.normal(0, 1, (d, b, h, w, 2))).astype(np.float32)
    mask = rng.random((b, h, w, 1)) > 0.2
    return preds, gt, cov, mask


def _t(*xs):
    return [torch.from_numpy(x) for x in xs]


@pytest.mark.parametrize("tail_weight", [0.0, 3.0])
@pytest.mark.parametrize("masked", [True, False])
def test_losses_match_jax(tail_weight, masked):
    """flow_loss, cov_loss (tail weighting with the linear nanquantile),
    final_cov_loss: fp32 scalars within 1e-6 relative."""
    preds, gt, cov, mask = _loss_inputs()
    m = mask if masked else None
    ref, ref_err = jloss.cov_loss(0.85, preds, gt, cov, m, tail_weight=tail_weight)
    ours, err = loss.cov_loss(0.85, *_t(preds, gt, cov), None if m is None else torch.from_numpy(m),
                              tail_weight=tail_weight)
    np.testing.assert_allclose(float(ours), float(ref), rtol=1e-6)
    np.testing.assert_allclose(err.numpy(), np.asarray(ref_err), rtol=1e-6)
    ref = jloss.final_cov_loss(preds, gt, cov, m)[0]
    ours = loss.final_cov_loss(*_t(preds, gt, cov), None if m is None else torch.from_numpy(m))[0]
    np.testing.assert_allclose(float(ours), float(ref), rtol=1e-6)
    fmask = mask if masked else np.ones_like(mask)
    np.testing.assert_allclose(float(loss.flow_loss(0.85, *_t(preds, gt, fmask))),
                               float(jloss.flow_loss(0.85, preds, gt, fmask)), rtol=1e-6)


@pytest.mark.parametrize("mode", ["flow", "cov", "finalcov"])
def test_sequence_loss_and_metrics_match_jax(mode):
    preds, gt, cov, mask = _loss_inputs(seed=2)
    ref, ref_m = jloss.sequence_loss(preds, cov, gt, mask, training_mode=mode, tail_weight=1.5)
    ours, ours_m = loss.sequence_loss(*_t(preds, cov, gt, mask), training_mode=mode, tail_weight=1.5)
    np.testing.assert_allclose(float(ours), float(ref), rtol=1e-6)
    assert set(ours_m) == set(ref_m)
    for k in ref_m:
        np.testing.assert_allclose(float(ours_m[k]), float(ref_m[k]), rtol=1e-6)
    ref_s = jloss.sequence_metrics(preds, gt, mask)
    ours_s = loss.sequence_metrics(*_t(preds, gt, mask))
    for k in ref_s:
        np.testing.assert_allclose(float(ours_s[k]), float(ref_s[k]), rtol=1e-6)
    with pytest.raises(ValueError):
        loss.sequence_loss(*_t(preds, cov, gt, mask), training_mode="depth")


def test_all_masked_batch_gives_what_jax_gives():
    """Every pixel masked: jnp.nanmean's NaN flow loss and metrics, the
    zeroed NLL's log-only cov loss, and the NaN threshold of the tail weight."""
    preds, gt, cov, mask = _loss_inputs(seed=3)
    none = np.zeros_like(mask)
    for mode in ("flow", "cov", "finalcov"):
        ref = float(jloss.sequence_loss(preds, cov, gt, none, training_mode=mode, tail_weight=2.0)[0])
        ours = float(loss.sequence_loss(*_t(preds, cov, gt, none), training_mode=mode, tail_weight=2.0)[0])
        assert np.isnan(ref) == np.isnan(ours), (mode, ref, ours)
        if not np.isnan(ref):
            np.testing.assert_allclose(ours, ref, rtol=1e-6)
    assert np.isnan(float(loss.flow_loss(0.85, *_t(preds, gt, none))))
    ref_s, ours_s = jloss.sequence_metrics(preds, gt, none), loss.sequence_metrics(*_t(preds, gt, none))
    assert all(np.isnan(float(ref_s[k])) and np.isnan(float(ours_s[k])) for k in ref_s)


def test_cov_loss_sends_no_gradient_into_the_flow_predictions():
    """Cov mode: d loss / d preds is exactly 0 (the squared error is detached),
    as jax.grad gives; d loss / d cov matches jax.grad within 1e-6."""
    preds, gt, cov, mask = _loss_inputs(seed=4)
    p, c = (torch.from_numpy(x).requires_grad_() for x in (preds, cov))
    value, _ = loss.sequence_loss(p, c, torch.from_numpy(gt), torch.from_numpy(mask), training_mode="cov",
                                  tail_weight=1.0)
    value.backward()
    jg_p, jg_c = jax.grad(lambda a, b: jloss.sequence_loss(a, b, gt, mask, training_mode="cov",
                                                           tail_weight=1.0)[0], argnums=(0, 1))(preds, cov)
    assert p.grad is None or float(p.grad.abs().max()) == 0.0
    assert float(np.abs(np.asarray(jg_p)).max()) == 0.0
    np.testing.assert_allclose(c.grad.numpy(), np.asarray(jg_c), rtol=1e-6, atol=1e-9)


# -- the decoder's training output, gradients, the npz ----------------------------


def test_training_stacks_match_jax(shared):
    """inference_only=False: the per-step full-res stacks (depth, B, 8H, 8W, 2)
    and the final / low-res pairs, on the port-written npz. 1e-4 abs (observed
    1e-5 on flows of ~10 px)."""
    model, out = shared["model"], shared["out"]
    with torch.no_grad():
        ours = model(*(torch.from_numpy(shared["batch"][k]) for k in ("img1", "img2")))
    assert set(ours) == set(out)
    assert ours["flow_predictions"].shape == (DEPTH, 2, H, W, 2)
    for key in out:
        np.testing.assert_allclose(ours[key].numpy(), np.asarray(out[key]), atol=1e-4, rtol=1e-4, err_msg=key)
    infer = FlowFormerCov(FlowFormerConfig(decoder_depth=DEPTH, inference_only=True))
    load_flax_checkpoint(infer, shared["path"])
    with torch.no_grad():
        final = infer(*(torch.from_numpy(shared["batch"][k]) for k in ("img1", "img2")))
    assert set(final) == {"flow_final", "cov_final", "flow_lowres", "cov_lowres"}
    for key in final:
        np.testing.assert_allclose(final[key].numpy(), ours[key].numpy(), atol=1e-5, rtol=1e-5, err_msg=key)


def test_port_written_npz_is_the_jax_layout(shared):
    """Every flax path of the JAX model, with its shape, and the shipped
    checkpoint written back by the port equals the file bit for bit."""
    with np.load(shared["path"]) as data:
        ours = {k: data[k] for k in data.files}
    template = flatten_params(jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shared["template"]))
    assert set(ours) == set(template)
    assert all(ours[k].shape == template[k].shape and ours[k].dtype == np.float32 for k in ours)
    model = FlowFormerCov(FlowFormerConfig())
    load_flax_checkpoint(model, CKPT)
    with np.load(CKPT) as data:
        back = torch_to_flax(model.state_dict())
        assert set(back) == set(data.files)
        for k in data.files:
            np.testing.assert_array_equal(back[k], data[k])


@pytest.mark.parametrize("mode", ["flow", "cov"])
def test_gradients_of_every_trainable_leaf_match_jax(shared, mode):
    """Gradients of the mode's loss, every trainable parameter (and only
    those) against jax.grad of the same loss on the same weights and batch.
    Per leaf: max |diff| <= 1e-3 x max(max |g_leaf|, 1e-4 x the largest |g|
    of any leaf): leaves whose true gradient is 0 (an attention key's bias)
    hold only rounding (observed: 6e-5 flow, 2e-6 cov)."""
    model, batch = shared["model"], shared["batch"]
    jvalue, jgrads = shared["grads"][mode]
    apply_freeze(model, mode)
    model.zero_grad(set_to_none=True)
    try:
        value, _ = make_loss_fn(model, TrainConfig(training_mode=mode))(upcast_batch(batch, "cpu"))
        value.backward()
        ours = torch_to_flax({n: p.grad for n, p in model.named_parameters() if p.requires_grad})
    finally:
        for p in model.parameters():
            p.requires_grad_(True)
            p.grad = None
    np.testing.assert_allclose(float(value.detach()), float(jvalue), rtol=1e-5)
    mask = flatten_params(trainable_mask(shared["jparams"], mode))
    assert set(ours) == {k for k, m in mask.items() if m}
    ref = flatten_params(jgrads)
    gmax = max(float(np.abs(ref[k]).max()) for k in ours)
    for k in ours:
        scale = max(float(np.abs(ref[k]).max()), 1e-4 * gmax)
        assert np.abs(ours[k] - ref[k]).max() <= 1e-3 * scale, k


def test_freeze_sets_match_jax(shared):
    """The trainable parameters of each mode, mapped through the weight
    converter, are JAX's trainable_mask leaves, and the modes partition them."""
    model = FlowFormerCov(FlowFormerConfig(decoder_depth=DEPTH))
    sets = {}
    for mode in ("flow", "cov", "finalcov"):
        names = {n: p for n, p in model.named_parameters() if is_trainable(n, mode)}
        sets[mode] = set(torch_to_flax(names))
        mask = flatten_params(trainable_mask(shared["template"], mode))
        assert sets[mode] == {k for k, m in mask.items() if m}, mode
    assert sets["cov"] == sets["finalcov"] and not sets["cov"] & sets["flow"]
    assert len(sets["cov"]) + len(sets["flow"]) == len(list(model.parameters()))


def test_eval_fn_matches_jax(shared):
    """make_eval_fn on one batch: epe, px1, px3, nll within 1e-4 relative
    (fp32 forwards; px counts could flip at a 1-px boundary, none did)."""
    batch = dict(shared["batch"])
    batch["img1"] = np.clip(batch["img1"] * 255, 0, 255).round().astype(np.uint8)
    ref = jax.device_get(j_make_eval_fn(shared["jm"])(shared["jparams"], batch))
    ours = make_eval_fn(shared["model"])(batch)
    for k in ref:
        np.testing.assert_allclose(float(ours[k]), float(ref[k]), rtol=1e-4, err_msg=k)


def test_encode_flow_token_gradients_match_jax_off_the_integer_grid():
    """Bilinear samples of the cost maps: gradients in the maps and in the
    coordinates against jax.grad of the tent-weight form, coordinates off the
    integer grid (windows leave the map on every side). 1e-5."""
    rng = np.random.default_rng(7)
    maps = rng.normal(size=(2, 6 * 7, 6, 7)).astype(np.float32)
    coords = rng.uniform(-6, 13, size=(2, 6, 7, 2)).astype(np.float32)
    coords = np.floor(coords) + rng.uniform(0.05, 0.95, size=coords.shape).astype(np.float32)
    weight = rng.normal(size=(2, 6, 7, 81)).astype(np.float32)
    jg_m, jg_c = jax.grad(lambda m, c: jnp.sum(j_encode_flow_token(m, c) * weight), argnums=(0, 1))(maps, coords)
    m, c = torch.from_numpy(maps).requires_grad_(), torch.from_numpy(coords).requires_grad_()
    (encode_flow_token(m, c.permute(0, 3, 1, 2)).permute(0, 2, 3, 1) * torch.from_numpy(weight)).sum().backward()
    np.testing.assert_allclose(m.grad.numpy(), np.asarray(jg_m), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(c.grad.numpy(), np.asarray(jg_c), atol=1e-5, rtol=1e-5)


def test_encode_flow_token_gradient_at_integer_positions():
    """Where the two forms differ, written down. At an exactly integer
    coordinate x0 the tent weights relu(1 - |g - x|) sit on the kinks of |.|
    and of max(0, .): JAX takes |.|' (0) = 1 and splits the tie of max in
    half, so its derivative along that axis is v(x0) + (v(x0+1) - v(x0-1)) / 2,
    not a derivative of the sampled surface. The port's floor-based corners
    give the right derivative v(x0+1) - v(x0). Along a non-integer axis, the
    values, and the gradients in the maps, the two agree. The decoder reaches
    integer coordinates only at its first step, where they are the constant
    pixel grid: no parameter's gradient passes through them."""
    maps = np.zeros((1, 1, 5, 5), np.float32)
    maps[0, 0] = np.arange(25, dtype=np.float32).reshape(5, 5) ** 1.5
    v = maps[0, 0]
    weight = np.zeros((1, 1, 1, 81), np.float32)
    weight[..., 40] = 1.0                                         # the window's center sample
    for xy in ((2.0, 2.0), (2.0, 2.5)):
        coords = np.array([[[xy]]], np.float32)
        jg_m, jg_c = jax.grad(lambda m, c: jnp.sum(j_encode_flow_token(m, c) * weight), argnums=(0, 1))(maps, coords)
        m, c = torch.from_numpy(maps).requires_grad_(), torch.from_numpy(coords).requires_grad_()
        (encode_flow_token(m, c.permute(0, 3, 1, 2)).permute(0, 2, 3, 1) * torch.from_numpy(weight)).sum().backward()
        ours, ref = c.grad.numpy()[0, 0, 0], np.asarray(jg_c)[0, 0, 0]
        np.testing.assert_allclose(ours[0], v[2, 3] - v[2, 2] if xy[1] == 2.0 else
                                   0.5 * (v[2, 3] - v[2, 2]) + 0.5 * (v[3, 3] - v[3, 2]), rtol=1e-5)
        np.testing.assert_allclose(ref[0], (v[2, 2] + (v[2, 3] - v[2, 1]) / 2) if xy[1] == 2.0 else
                                   0.5 * (v[2, 2] + (v[2, 3] - v[2, 1]) / 2) + 0.5 * (v[3, 2] + (v[3, 3] - v[3, 1]) / 2),
                                   rtol=1e-5)
        if xy[1] == 2.0:
            np.testing.assert_allclose(ours[1], v[3, 2] - v[2, 2], rtol=1e-5)
            np.testing.assert_allclose(ref[1], v[2, 2] + (v[3, 2] - v[1, 2]) / 2, rtol=1e-5)
        else:
            np.testing.assert_allclose(ours[1], ref[1], rtol=1e-5)            # y = 2.5: they agree
        np.testing.assert_allclose(m.grad.numpy(), np.asarray(jg_m), rtol=1e-6, atol=1e-7)


# -- optimizer and schedule --------------------------------------------------------


class _Toy(torch.nn.Module):
    """Parameters named like a model's: a cov-branch leaf and two others."""

    def __init__(self, arrays):
        super().__init__()
        self.enc = torch.nn.Module()
        self.enc.w = torch.nn.Parameter(torch.from_numpy(arrays["enc"]["w"].copy()))
        self.cov_head = torch.nn.Module()
        self.cov_head.w = torch.nn.Parameter(torch.from_numpy(arrays["cov_head"]["w"].copy()))
        self.cov_head.b = torch.nn.Parameter(torch.from_numpy(arrays["cov_head"]["b"].copy()))
        self.b = torch.nn.Parameter(torch.from_numpy(arrays["b"].copy()))


@pytest.mark.parametrize("mode", ["flow", "cov"])
def test_three_optimizer_steps_match_optax(mode):
    """Clip to global norm 1 (over the trainable leaves only; the first step's
    gradients exceed it, the later ones do not), AdamW with decoupled decay on
    the 100-step schedule, frozen leaves untouched: the parameters after each
    of 3 steps within 1e-6 of optax's (fp32)."""
    rng = np.random.default_rng(5)
    arrays = {"enc": {"w": rng.normal(size=(4, 3)).astype(np.float32)},
              "cov_head": {"w": rng.normal(size=(3, 2)).astype(np.float32), "b": rng.normal(size=2).astype(np.float32)},
              "b": rng.normal(size=5).astype(np.float32)}
    grads = [jax.tree_util.tree_map(lambda a, s=s: (rng.normal(size=a.shape) * s).astype(np.float32), arrays)
             for s in (3.0, 0.1, 0.05)]
    jcfg = JTrainConfig(lr=1e-2, weight_decay=0.1, num_steps=100, training_mode=mode)
    jopt = j_make_optimizer(jcfg, arrays)
    jstate, jparams = jopt.init(arrays), jax.tree_util.tree_map(jnp.asarray, arrays)
    toy = _Toy(arrays)
    opt = create_optimizer(toy, TrainConfig(lr=1e-2, weight_decay=0.1, num_steps=100, training_mode=mode))
    frozen = {n: p.detach().clone() for n, p in toy.named_parameters() if not p.requires_grad}
    names = {"enc.w": ("enc", "w"), "cov_head.w": ("cov_head", "w"), "cov_head.b": ("cov_head", "b"), "b": ("b",)}
    for g in grads:
        updates, jstate = jopt.update(g, jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for n, p in toy.named_parameters():
            if p.requires_grad:
                leaf = g
                for part in names[n]:
                    leaf = leaf[part]
                p.grad = torch.from_numpy(np.asarray(leaf))
        opt.step()
        for n, p in toy.named_parameters():
            ref = jparams
            for part in names[n]:
                ref = ref[part]
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(ref), rtol=1e-6, atol=1e-7, err_msg=n)
    for n, v in frozen.items():
        torch.testing.assert_close(dict(toy.named_parameters())[n].detach(), v, rtol=0, atol=0)
    assert opt.count == 3


@pytest.mark.parametrize("num_steps", [100, 20, 19, 3])
def test_schedule_matches_optax_at_every_step(num_steps):
    """The lr of every step (and 5 past the end): the port's schedule, which
    its optimizer applies, against the update optax's optimizer makes for a
    unit gradient with no weight decay (-lr/(1+eps)). 1e-5 relative: optax
    interpolates in fp32. Below 20 steps the lr is constant."""
    cfg = TrainConfig(lr=2.5e-4, weight_decay=0.0, num_steps=num_steps, training_mode="flow")
    params = {"w": np.zeros(1, np.float32)}
    jopt = j_make_optimizer(JTrainConfig(lr=2.5e-4, weight_decay=0.0, num_steps=num_steps, training_mode="flow"),
                            params)
    state = jopt.init(params)
    update = jax.jit(jopt.update)
    schedule = make_schedule(cfg)
    w = torch.nn.Parameter(torch.zeros(1))
    opt = Optimizer([w], cfg)
    for step in range(num_steps + 5):
        u, state = update({"w": np.full(1, 1e-3, np.float32)}, state, params)
        jax_lr = -float(u["w"][0]) * (1.0 + 1e-8 / 1e-3)
        np.testing.assert_allclose(schedule(step), jax_lr, rtol=1e-5, err_msg=f"step {step}")
        w.grad = torch.full((1,), 1e-3)
        opt.step()
        assert opt.adamw.param_groups[0]["lr"] == schedule(step)
    if num_steps < 20:
        assert {schedule(s) for s in range(num_steps)} == {2.5e-4}
    else:
        peak = max(range(num_steps), key=schedule)
        assert peak == max(int(0.05 * num_steps), int(2.0 / num_steps * num_steps))
        np.testing.assert_allclose(schedule(num_steps + 3), 2.5e-4 / 25e4, rtol=1e-12)


# -- state -------------------------------------------------------------------------


def _tiny_trainer(mode="flow", depth=1, lr=1e-3):
    model = FlowFormerCov(FlowFormerConfig(decoder_depth=depth))
    cfg = TrainConfig(lr=lr, num_steps=10, training_mode=mode)
    opt = create_optimizer(model, cfg)
    return model, opt, make_train_step(model, opt, cfg, "cpu")


def test_resume_is_lossless_bit_for_bit(tmp_path):
    """Counterpart of test_train_state_roundtrip: model, AdamW moments and the
    step survive save/load, and one more step from each copy gives the same
    parameters bit for bit."""
    torch.manual_seed(0)
    model, opt, step = _tiny_trainer()
    batch = _batch(seed=3, b=1, h=32, w=32)
    for _ in range(3):
        step(batch)
    save_train_state(tmp_path / "state.pt", model, opt, 3)
    torch.manual_seed(1)
    model2, opt2, step2 = _tiny_trainer()
    assert load_train_state(tmp_path / "state.pt", model2, opt2) == 3 and opt2.count == 3
    for (n, a), b in zip(model.state_dict().items(), model2.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=n)
    step(batch)
    step2(batch)
    for (n, a), b in zip(model.named_parameters(), model2.parameters()):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=n)


def test_stale_fold_is_refolded_after_optimizer_steps():
    """Two flow steps move the perceiver's input-stage weights; a forward
    without gradients (the folded input stage) then equals one with them (the
    unfused stage), fp32 within 1e-5: the fold follows the weights."""
    torch.manual_seed(0)
    model, _, step = _tiny_trainer(lr=1e-2)
    perceiver = model.memory_encoder.perceiver
    key = perceiver._folded_key
    batch = _batch(seed=4, b=1, h=32, w=48)
    for _ in range(2):
        step(batch)
    assert perceiver._fold_key() != key
    x = [torch.from_numpy(batch[k]) for k in ("img1", "img2")]
    with torch.no_grad():
        folded = model(*x)
    unfused = model(*x)
    assert perceiver._folded_key == perceiver._fold_key()
    for k in ("flow_final", "cov_final"):
        np.testing.assert_allclose(folded[k].numpy(), unfused[k].detach().numpy(), atol=1e-5, rtol=1e-5)


# -- counterparts of tests/test_train.py ----------------------------------------------


def test_loss_weighting():
    gt = torch.zeros((1, 8, 8, 2))
    preds = torch.ones((2, 1, 8, 8, 2))
    mask = torch.ones((1, 8, 8, 1), dtype=torch.bool)
    assert float(loss.flow_loss(0.85, preds, gt, mask)) == pytest.approx(0.85 + 1.0, rel=1e-5)


def test_cov_loss_detaches_error():
    gt = torch.zeros((1, 4, 4, 2))
    preds = torch.full((2, 1, 4, 4, 2), 0.5, requires_grad=True)
    covs = torch.ones((2, 1, 4, 4, 2), requires_grad=True)
    loss.cov_loss(0.85, preds, gt, covs)[0].backward()
    assert preds.grad is None and float(covs.grad.abs().max()) > 0.0


def test_cov_loss_optimum():
    gt = torch.zeros((1, 4, 4, 2))
    preds = torch.full((1, 1, 4, 4, 2), 2.0)
    losses = [float(loss.cov_loss(1.0, preds, gt, torch.full((1, 1, 4, 4, 2), v))[0]) for v in (1.0, 4.0, 16.0)]
    assert losses[1] < losses[0] and losses[1] < losses[2]


def test_freeze_policy():
    model = FlowFormerCov(FlowFormerConfig(decoder_depth=1))
    names = [n for n, _ in model.named_parameters()]
    cov = [is_trainable(n, "cov") for n in names]
    assert 0 < sum(cov) < len(cov)
    assert [a != b for a, b in zip(cov, (is_trainable(n, "flow") for n in names))] == [True] * len(names)


def test_train_step_only_updates_cov_branch():
    torch.manual_seed(0)
    model, opt, step = _tiny_trainer(mode="cov")
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    rng = np.random.default_rng(0)
    batch = {"img1": rng.random((2, 32, 48, 3)).astype(np.float32),
             "img2": rng.random((2, 32, 48, 3)).astype(np.float32),
             "gt_flow": rng.normal(0, 1, (2, 32, 48, 2)).astype(np.float32),
             "flow_mask": np.ones((2, 32, 48, 1), bool)}
    aux = step(batch)
    assert np.isfinite(float(aux["loss"]))
    changed = {n: not torch.equal(before[n], p) for n, p in model.named_parameters()}
    assert not any(c for n, c in changed.items() if not is_trainable(n, "cov"))
    assert any(c for n, c in changed.items() if is_trainable(n, "cov"))
    for _ in range(2):
        aux = step(batch)
    assert np.isfinite(float(aux["loss"]))


def test_eval_fn_metrics():
    model = FlowFormerCov(FlowFormerConfig(decoder_depth=1))
    zero = np.zeros((1, 32, 32, 3), np.float32)
    m = make_eval_fn(model)({"img1": zero, "img2": zero, "gt_flow": np.zeros((1, 32, 32, 2), np.float32)})
    assert np.isfinite(float(m["epe"])) and np.isfinite(float(m["nll"]))
    assert 0.0 <= float(m["px1"]) <= 1.0


def test_training_descends_on_tiny_problem():
    torch.manual_seed(0)
    model, _, step = _tiny_trainer()
    rng = np.random.default_rng(0)
    batch = {"img1": rng.uniform(size=(2, 32, 32, 3)).astype(np.float32),
             "img2": rng.uniform(size=(2, 32, 32, 3)).astype(np.float32),
             "gt_flow": np.full((2, 32, 32, 2), 0.5, np.float32), "flow_mask": np.ones((2, 32, 32, 1), bool)}
    losses = [float(step(batch)["loss"]) for _ in range(10)]
    assert losses[-1] < losses[0] * 0.9, losses


def test_cov_loss_tail_weighting():
    rng = np.random.default_rng(3)
    preds = torch.from_numpy(rng.normal(size=(2, 1, 8, 8, 2)).astype(np.float32))
    gt = preds[-1] + 0.1
    cov = torch.full((2, 1, 8, 8, 2), 0.5)
    mask = torch.ones((1, 8, 8, 1), dtype=torch.bool)
    base = float(loss.cov_loss(0.85, preds, gt, cov, mask)[0])
    uniform = float(loss.cov_loss(0.85, preds, gt, cov, mask, tail_weight=3.0)[0])
    np.testing.assert_allclose(uniform, base, rtol=0.35)
    spike = gt.clone()
    spike[0, 2, 2] += 50.0
    plain = float(loss.cov_loss(0.85, preds, spike, cov, mask)[0])
    assert float(loss.cov_loss(0.85, preds, spike, cov, mask, tail_weight=3.0)[0]) > plain


# -- the runner ------------------------------------------------------------------------


def _write_config(tmp_path, steps=3):
    """A small recipe on RandomizedStereo worlds written in TartanAir layout,
    with photometric jitter, sensor noise, stereo draws and an Eval section."""
    from macvo_tpu_torch.data.datasets.randomized import RandomizedStereo
    from macvo_tpu_torch.data.datasets.synthetic import write_sequence_tartanair_layout

    seqs = []
    for seed in (1000, 1001):
        root = tmp_path / f"seq_{seed}"
        write_sequence_tartanair_layout(RandomizedStereo({"n_frames": 3, "width": 128, "height": 96,
                                                          "fx": 64.0, "fy": 64.0, "seed": seed}), root)
        seqs.append({"type": "TartanAir", "args": {"root": str(root), "gtFlow": True, "gtDepth": True,
                                                   "gtPose": True}})
    cfg = {
        "Train": {"lr": 2.5e-4, "weight_decay": 1e-5, "clip": 1.0, "num_steps": steps, "gamma": 0.85,
                  "max_flow": 400.0, "training_mode": "flow", "batch_size": 2, "image_height": 64,
                  "image_width": 96, "autosave_freq": 1000, "seed": 7},
        "Model": {"decoder_depth": 2, "encoder_dtype": "fp32", "decoder_dtype": "fp32"},
        "Data": {"stereo_prob": 0.35, "Sequences": seqs, "transforms": [
            {"type": "PhotometricJitter", "args": {"strength": 1.0}},
            {"type": "AddImageNoise", "args": {"stdv": 0.0196}}]},
        "Eval": {"freq": 2, "max_frames": 1, "Sequence": {"type": "SyntheticStereo", "args": {
            "n_frames": 2, "width": 96, "height": 64, "fx": 48.0, "fy": 48.0, "seed": 101}}},
    }
    path = tmp_path / "recipe.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return path


def test_runner_end_to_end_on_the_cpu(tmp_path):
    """3 flow steps from the shipped checkpoint on RandomizedStereo worlds:
    the npz (which macvo_tpu's load_params and the port's loader both read),
    metrics.csv (a train row a step, eval rows at step 2 and 3) and the .done
    marker; then a session cut by --max_session_steps 2 leaves the full state
    and no marker, and the same command resumes at step 2 and finishes."""
    from macvo_tpu_torch.train.run import main

    cfg = _write_config(tmp_path)
    out = tmp_path / "out" / "ckpt.npz"
    common = ["--config", str(cfg), "--device", "cpu", "--log_freq", "1", "--restore", str(CKPT)]
    main(common + ["--out", str(out)])
    assert out.exists() and (out.parent / "ckpt.done").read_text().startswith("steps=3 mode=flow")
    assert not (out.parent / "ckpt.trainstate.pt").exists()
    rows = (out.parent / "ckpt_metrics.csv").read_text().strip().splitlines()
    assert rows[0] == "step,split,loss,epe,px1,px3,nll"
    assert [r.split(",")[:2] for r in rows[1:]] == [["1", "train"], ["2", "train"], ["2", "eval"],
                                                  ["3", "train"], ["3", "eval"]]
    assert all(np.isfinite(float(r.split(",")[2])) for r in rows[1:] if ",train," in r)
    jm = JModel(JConfig(decoder_depth=2))
    probe = jnp.zeros((1, 64, 96, 3), jnp.float32)
    params = load_params(out, jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), probe, probe)["params"]))
    with np.load(CKPT) as ref:
        flat = flatten_params(params)
        moved = [k for k in ref.files if not np.array_equal(flat[k], ref[k])]
        assert moved and all("cov_" not in k for k in moved)         # flow mode: the cov branch stays
    load_flax_checkpoint(FlowFormerCov(FlowFormerConfig(inference_only=True)), out)

    out2 = tmp_path / "cut" / "ckpt.npz"
    main(common + ["--out", str(out2), "--max_session_steps", "2"])
    state = out2.parent / "ckpt.trainstate.pt"
    assert state.exists() and out2.exists() and not (out2.parent / "ckpt.done").exists()
    assert torch.load(state, weights_only=True)["step"] == 2
    main(common + ["--out", str(out2)])
    assert (out2.parent / "ckpt.done").exists() and not state.exists()
    rows = (out2.parent / "ckpt_metrics.csv").read_text().strip().splitlines()
    assert [r.split(",")[:2] for r in rows[1:]] == [["1", "train"], ["2", "train"], ["2", "eval"],
                                                  ["3", "train"], ["3", "eval"]]


def test_runner_needs_a_card_unless_told_cpu(tmp_path):
    from macvo_tpu_torch.train.run import main

    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["--config", str(ROOT / "configs/train/FlowFormerCov_synth_cov.yaml"), "--steps", "1",
              "--out", str(tmp_path / "x.npz")])
    assert not (tmp_path / "x.npz").exists()


@pytest.mark.slow
def test_runner_runs_the_shipped_cov_recipe_on_the_cpu(tmp_path):
    """FlowFormerCov_synth_cov.yaml as shipped (bf16 autocast, batch 6,
    240x320, 12 decoder steps) for 2 steps from the shipped checkpoint, with
    its final eval over 12 pairs: only the covariance branch moves."""
    from macvo_tpu_torch.train.run import main

    out = tmp_path / "cov.npz"
    main(["--config", str(ROOT / "configs/train/FlowFormerCov_synth_cov.yaml"), "--restore", str(CKPT),
          "--steps", "2", "--log_freq", "1", "--device", "cpu", "--out", str(out)])
    with np.load(CKPT) as ref, np.load(out) as new:
        moved = {k for k in ref.files if not np.array_equal(ref[k], new[k])}
    assert moved and all(any(m in k for m in ("cov_gru", "cov_head", "cov_mask")) for k in moved)
