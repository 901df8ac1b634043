"""The port's fused latent cross-attention (macvo_tpu_torch/ops/latent_attn.py).

On the CPU the wrapper runs its plain version, which is held to the JAX twin
``latent_cross_attention_xla`` and to the Pallas kernel in interpret mode. The
algebra of the CUDA kernel (the folded weights of ``fold_weights`` and the
plain folded version ``latent_attn_folded_torch``) is checked here, and so is
the cost perceiver's folding of its own weights; the kernel itself runs only
on the card, in tests/test_torch_port_kernels_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from macvo_tpu.ops.latent_attn import latent_cross_attention as jax_pallas
from macvo_tpu.ops.latent_attn import latent_cross_attention_xla
from macvo_tpu_torch.ops import latent_attn

# fp32 compute on both sides in a different contraction order: 1e-5 covers
# the rounding of ~100-term sums of O(1) products.
TOL = 1e-5


def _inputs(n=40, t=16, seed=7, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return [
        rng.normal(size=(n, t, 64)).astype(dtype),
        (rng.normal(size=(64, 128)) * 0.1).astype(np.float32),
        (rng.normal(size=(128,)) * 0.1).astype(np.float32),
        (rng.normal(size=(64, 128)) * 0.1).astype(np.float32),
        (rng.normal(size=(128,)) * 0.1).astype(np.float32),
        rng.normal(size=(8, 128)).astype(np.float32),
        (rng.normal(size=(128, 128)) * 0.1).astype(np.float32),
        rng.normal(size=(8, 128)).astype(np.float32),
    ]


@pytest.mark.parametrize("n,t", [(40, 16), (6, 100), (3, 1)])
def test_plain_matches_xla_twin(n, t):
    args = _inputs(n, t)
    ours = latent_attn.latent_cross_attention_torch(*(torch.from_numpy(a) for a in args))
    ref = np.asarray(latent_cross_attention_xla(*(jnp.asarray(a) for a in args)))
    np.testing.assert_allclose(ours.numpy(), ref, atol=TOL, rtol=TOL)


def test_plain_matches_pallas_interpret():
    """Same check against the Pallas kernel itself, run in interpret mode as
    tests/test_feature_cache.py runs it (tolerance of that test)."""
    args = _inputs(40, 16)
    ref = np.asarray(jax_pallas(*(jnp.asarray(a) for a in args), block_pixels=16, interpret=True))
    ours = latent_attn.latent_cross_attention(*(torch.from_numpy(a) for a in args))
    np.testing.assert_allclose(ours.numpy(), ref, rtol=2e-4, atol=2e-4)


def test_cpu_wrapper_takes_plain_version_and_counts_no_launch():
    args = [torch.from_numpy(a) for a in _inputs(8, 5)]
    before = latent_attn.latent_cross_attention.launches
    by_dtype = dict(latent_attn.latent_cross_attention.launches_by_dtype)
    out = latent_attn.latent_cross_attention(*args)
    assert latent_attn.latent_cross_attention.launches == before
    assert latent_attn.latent_cross_attention.launches_by_dtype == by_dtype
    torch.testing.assert_close(out, latent_attn.latent_cross_attention_torch(*args), rtol=0, atol=0)


def test_reset_launches_zeroes_the_total_and_each_token_type():
    """In place: a reference to the counts taken before a reset reads the new ones."""
    counter = latent_attn.latent_cross_attention
    by_dtype = counter.launches_by_dtype
    counter.launches, by_dtype["bf16"] = 3, 3
    latent_attn.reset_launches()
    assert counter.launches == 0 and by_dtype == {"fp32": 0, "bf16": 0}
    assert counter.launches_by_dtype is by_dtype


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_folded_form_matches_plain(dtype):
    """The kernel computes out = softmax_t(tok M) ^T tok Wvp + c with the
    weights of ``fold_weights``; that algebra (``latent_attn_folded_torch``,
    which the CPU entry ``latent_attn_folded`` runs) equals the plain version
    (bk cancels in the softmax, sum_t a = 1)."""
    args = [torch.from_numpy(a) for a in _inputs(24, 100)]
    args[0] = args[0].to(dtype)
    folded = latent_attn.fold_weights(*args[1:])
    before = latent_attn.latent_cross_attention.launches
    ours = latent_attn.latent_attn_folded(args[0], *folded)
    assert latent_attn.latent_cross_attention.launches == before
    assert ours.dtype == dtype
    torch.testing.assert_close(ours, latent_attn.latent_attn_folded_torch(args[0], *folded), rtol=0, atol=0)
    ref = latent_attn.latent_cross_attention_torch(*args).float()
    if dtype == torch.float32:
        np.testing.assert_allclose(ours.numpy(), ref.numpy(), atol=TOL, rtol=TOL)
    else:   # both round their fp32 result to bf16 (8-bit mantissa): two roundings apart at most
        np.testing.assert_allclose(ours.float().numpy(), ref.numpy(), atol=1e-2, rtol=1e-2)


def test_perceiver_folds_its_weights_once_and_after_each_load():
    """CostPerceiverEncoder keeps (M, Wvp, c) as buffers: folded at
    construction and again by every load_state_dict, equal to folding the
    unfolded input-stage weights (input_proj into k and v, as in
    macvo_tpu/models/flowformer/encoder.py:209-234) per call. float64 folding
    on both sides, stored fp32: 1e-6."""
    from macvo_tpu_torch.models.flowformer.encoder import CostPerceiverEncoder

    def per_call_fold(enc):
        with torch.no_grad():
            w2, b2 = enc.input_proj.weight.T, enc.input_proj.bias
            att = enc.input_attn
            wk, bk, wv, bv = att.k.weight.T, att.k.bias, att.v.weight.T, att.v.bias
            lat = enc.latents[0]
            return latent_attn.fold_weights(w2 @ wk, b2 @ wk + bk, w2 @ wv, b2 @ wv + bv, att.q(lat),
                                            att.proj.weight.T, lat + att.proj.bias)

    torch.manual_seed(3)
    enc = CostPerceiverEncoder(encoder_depth=1)
    with torch.no_grad():
        enc.latents.normal_()
    enc.fold_input_stage()
    for buf, want in zip((enc.fold_m, enc.fold_wvp, enc.fold_c), per_call_fold(enc)):
        torch.testing.assert_close(buf, want, atol=1e-6, rtol=1e-6)
    assert "fold_m" not in enc.state_dict()

    torch.manual_seed(4)
    other = CostPerceiverEncoder(encoder_depth=1)
    with torch.no_grad():
        other.latents.normal_()
    stale = enc.fold_m.clone()
    enc.load_state_dict(other.state_dict())
    assert not torch.equal(enc.fold_m, stale)
    for buf, want in zip((enc.fold_m, enc.fold_wvp, enc.fold_c), per_call_fold(other)):
        torch.testing.assert_close(buf, want, atol=1e-6, rtol=1e-6)
