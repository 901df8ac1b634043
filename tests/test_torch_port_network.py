"""Parity of the port's FlowFormerCov (macvo_tpu_torch.models.flowformer) with
the JAX package on the shipped checkpoint, module by module, at fp32.

Both sides load ``model/MACVO_FrontendCov.npz``: JAX through its own loader,
the port through ``flax_to_torch``. Inputs are seeded numpy arrays at small
sizes (64x96 images, 2 decoder steps). Tolerances are stated per test; all
are fp32 rounding of the same math summed in different orders.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from macvo_tpu.models.flowformer import FlowFormerConfig as JConfig
from macvo_tpu.models.flowformer import FlowFormerCov as JModel
from macvo_tpu.models.flowformer.decoder import MemoryCovDecoder as JDecoder
from macvo_tpu.models.flowformer.decoder import encode_flow_token as j_encode_flow_token
from macvo_tpu.models.flowformer.decoder import upsample_convex as j_upsample_convex
from macvo_tpu.models.flowformer.encoder import MemoryEncoder as JEncoder
from macvo_tpu.models.flowformer.twins import TwinsSVT as JTwins
from macvo_tpu.models.flowformer.weights import unflatten_params
from macvo_tpu_torch.models.flowformer import FlowFormerConfig, FlowFormerCov, flax_to_torch
from macvo_tpu_torch.models.flowformer.decoder import encode_flow_token, upsample_convex
from macvo_tpu_torch.models.flowformer.weights import load_state

CKPT = Path(__file__).parent.parent / "model" / "MACVO_FrontendCov.npz"
H, W, DEPTH = 64, 96, 2


@pytest.fixture(scope="module")
def npz():
    with np.load(CKPT) as data:
        return {k: data[k] for k in data.files}


@pytest.fixture(scope="module")
def models(npz):
    jm = JModel(JConfig(decoder_depth=DEPTH, inference_only=True))
    probe = jnp.zeros((1, H, W, 3), jnp.float32)
    template = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), probe, probe)["params"])
    jparams = unflatten_params(template, npz)
    tm = FlowFormerCov(FlowFormerConfig(decoder_depth=DEPTH)).eval()
    load_state(tm, flax_to_torch(npz))
    return jm, jparams, tm


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def test_loader_consumes_every_key_with_its_shape(npz):
    state = flax_to_torch(npz)
    assert len(state) == len(npz) == 344
    model = FlowFormerCov(FlowFormerConfig())
    load_state(model, state)                       # raises on a missing/unused key or a shape
    own = model.state_dict()
    assert set(own) == set(state)
    conv = own["memory_decoder.iteration.motion_enc.convf1.weight"].numpy()
    np.testing.assert_array_equal(conv, npz["memory_decoder/iteration/motion_enc/convf1/kernel"].transpose(3, 2, 0, 1))
    dense = own["memory_encoder.perceiver.input_proj.weight"].numpy()
    np.testing.assert_array_equal(dense, npz["memory_encoder/perceiver/input_proj/kernel"].T)
    assert own["feature_encoder.peg0.proj.weight"].shape == (128, 1, 3, 3)
    np.testing.assert_array_equal(own["feature_encoder.embed_norm0.weight"].numpy(),
                                  npz["feature_encoder/embed_norm0/scale"])

    bad = dict(state)
    bad["memory_decoder.mem_k.weight"] = bad["memory_decoder.mem_k.weight"].T[:, :64]
    with pytest.raises(ValueError):
        load_state(model, bad)
    extra = dict(state)
    extra["memory_decoder.unknown.weight"] = torch.zeros(1)
    with pytest.raises(KeyError):
        load_state(model, extra)
    missing = dict(state)
    missing.pop("memory_decoder.iteration.aggregator.gamma")
    with pytest.raises(KeyError):
        load_state(model, missing)


@pytest.mark.parametrize("hw", [(64, 96), (72, 88)])
def test_twins_matches_jax(models, hw):
    """72x88 gives stage sizes that are not multiples of the window or of the
    GSA stride: padded windows and flax's uneven SAME padding. fp32, 2e-4
    abs on features of magnitude ~5 (4 transformer blocks of fp32 rounding)."""
    _, jparams, tm = models
    x = np.random.default_rng(1).uniform(-1, 1, size=(2,) + hw + (3,)).astype(np.float32)
    ref = jax.jit(lambda p, v: JTwins().apply({"params": p}, v))(jparams["feature_encoder"], x)
    with torch.inference_mode():
        ours = tm.feature_encoder(torch.from_numpy(x))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=2e-4, rtol=1e-4)


def test_memory_encoder_matches_jax(models):
    """Cost maps and latent cost memory (the JAX side runs the unfused input
    stage, the port the folded plain function). 2e-4 abs: fp32."""
    _, jparams, tm = models
    rng = np.random.default_rng(2)
    f1, f2 = (rng.normal(size=(2, 8, 12, 256)).astype(np.float32) for _ in range(2))
    ctx = rng.normal(size=(2, 8, 12, 256)).astype(np.float32)
    mem_ref, maps_ref = jax.jit(lambda p, a, b, c: JEncoder().apply({"params": p}, a, b, c))(
        jparams["memory_encoder"], f1, f2, ctx)
    with torch.inference_mode():
        mem, maps = tm.memory_encoder(*(torch.from_numpy(v) for v in (f1, f2, ctx)))
    np.testing.assert_allclose(maps.numpy(), np.asarray(maps_ref), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(mem.numpy(), np.asarray(mem_ref), atol=2e-4, rtol=1e-4)


def test_encode_flow_token_matches_tent_weights():
    """Gather sampling vs the JAX tent-weight matmuls, including windows that
    leave the map on every side (zero outside, same corner convention)."""
    rng = np.random.default_rng(3)
    maps = rng.normal(size=(2, 6 * 7, 6, 7)).astype(np.float32)
    coords = rng.uniform(-6, 13, size=(2, 6, 7, 2)).astype(np.float32)
    coords[0, 0, 0] = (3.0, 2.0)          # integer position
    ref = np.asarray(j_encode_flow_token(jnp.asarray(maps), jnp.asarray(coords)))
    ours = encode_flow_token(torch.from_numpy(maps), torch.from_numpy(coords).permute(0, 3, 1, 2))
    np.testing.assert_allclose(ours.permute(0, 2, 3, 1).numpy(), ref, atol=1e-5, rtol=1e-5)


def test_upsample_convex_matches_jax():
    rng = np.random.default_rng(4)
    flow = rng.normal(size=(2, 5, 6, 2)).astype(np.float32)
    mask = rng.normal(size=(2, 5, 6, 576)).astype(np.float32)
    ref = np.asarray(j_upsample_convex(jnp.asarray(flow), jnp.asarray(mask)))
    ours = upsample_convex(torch.from_numpy(flow).permute(0, 3, 1, 2), torch.from_numpy(mask).permute(0, 3, 1, 2))
    np.testing.assert_allclose(ours.permute(0, 2, 3, 1).numpy(), ref, atol=1e-5, rtol=1e-5)


def test_decoder_matches_jax(models):
    """Recurrent decoder (2 steps) on shared cost memory / context / maps."""
    _, jparams, tm = models
    rng = np.random.default_rng(5)
    mem = rng.normal(size=(2 * 96, 8, 128)).astype(np.float32)
    ctx = rng.normal(size=(2, 8, 12, 256)).astype(np.float32)
    maps = rng.normal(size=(2, 96, 8, 12)).astype(np.float32)
    ref = jax.jit(lambda p, a, b, c: JDecoder(decoder_depth=DEPTH, inference_only=True).apply(
        {"params": p}, a, b, c))(jparams["memory_decoder"], mem, ctx, maps)
    with torch.inference_mode():
        out = tm.memory_decoder(*(torch.from_numpy(v) for v in (mem, ctx, maps)))
    for key in ("flow_lowres", "cov_lowres", "flow_final", "cov_final"):
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]), atol=1e-4, rtol=1e-4, err_msg=key)


def test_flowformer_full_matches_jax(models):
    """Whole FlowFormerCov forward at fp32 on seeded images: flow and
    log-sigma maps within 1e-4 px (observed ~6e-6)."""
    jm, jparams, tm = models
    rng = np.random.default_rng(6)
    i1, i2 = (rng.random((1, H, W, 3), dtype=np.float32) for _ in range(2))
    ref = jax.jit(lambda p, a, b: jm.apply({"params": p}, a, b))(jparams, i1, i2)
    with torch.inference_mode():
        out = tm(torch.from_numpy(i1), torch.from_numpy(i2))
    for key in ("flow_final", "cov_final"):
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]), atol=1e-4, rtol=1e-4, err_msg=key)


def test_bf16_autocast_stays_near_fp32(npz):
    """The Fast (bf16) precision scopes on a 64x96 crop of a real stereo pair:
    fp32 outputs, within bf16's 8-bit mantissa of the fp32 model (observed on
    the CPU: flow max 0.11 px, mean 0.035 px)."""
    from macvo_tpu_torch.data.datasets.tartanair import TartanAirV2

    seq = TartanAirV2({"root": str(CKPT.parent.parent / "assets/test_sequence/TartanAir2_abs_P000"),
                       "compressed": True, "gtFlow": False, "gtDepth": False, "gtPose": False})
    i1, i2 = (x[:, 288:352, 272:368].contiguous() for x in (seq[0].stereo.imageL, seq[0].stereo.imageR))
    outs = {}
    for dt in ("fp32", "bf16"):
        model = FlowFormerCov(FlowFormerConfig(decoder_depth=DEPTH, encoder_dtype=dt, decoder_dtype=dt)).eval()
        load_state(model, flax_to_torch(npz))
        with torch.inference_mode():
            outs[dt] = model(i1, i2)
    for key, (max_tol, mean_tol) in (("flow_final", (0.5, 0.1)), ("cov_final", (0.1, 0.03))):
        diff = (outs["bf16"][key] - outs["fp32"][key]).abs()
        assert outs["bf16"][key].dtype == torch.float32 and torch.isfinite(outs["bf16"][key]).all()
        assert diff.max() < max_tol and diff.mean() < mean_tol, (key, float(diff.max()), float(diff.mean()))


def test_input_padder_matches_jax():
    """Edge-replicating pad to a multiple of 8 and the unpad, at an odd size."""
    from macvo_tpu.models.flowformer.network import InputPadder as JPadder
    from macvo_tpu_torch.models.flowformer import InputPadder

    x = np.random.default_rng(7).random((2, 61, 90, 3), dtype=np.float32)
    ref = np.asarray(JPadder(x.shape).pad(jnp.asarray(x)))
    padder = InputPadder(x.shape)
    ours = padder.pad(torch.from_numpy(x))
    assert ours.shape == (2, 64, 96, 3)
    np.testing.assert_array_equal(ours.numpy(), ref)
    np.testing.assert_array_equal(padder.unpad(ours).numpy(), x)
