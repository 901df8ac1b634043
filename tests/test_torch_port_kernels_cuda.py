"""The port's CUDA kernels on the card, against their plain versions.

This file imports no JAX, so it runs on a machine with a card and no JAX:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_port_kernels_cuda.py

(``--noconftest`` skips tests/conftest.py, which configures JAX.) Every test
is marked ``cuda`` and skips, from inside its fixture, where there is no card.
"""

import numpy as np
import pytest
import torch

from macvo_tpu_torch.ops import latent_attn


def _inputs(n, t, seed=7):
    rng = np.random.default_rng(seed)
    shapes = [((n, t, 64), 1.0), ((64, 128), 0.1), ((128,), 0.1), ((64, 128), 0.1), ((128,), 0.1),
              ((8, 128), 1.0), ((128, 128), 0.1), ((8, 128), 1.0)]
    return [(rng.normal(size=s) * k).astype(np.float32) for s, k in shapes]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n,t", [(12800, 100), (37, 1), (5, 333)])
@pytest.mark.parametrize("dtype,atol,rtol", [(torch.float32, 1e-4, 1e-4), (torch.bfloat16, 1e-2, 1.6e-2)])
def test_latent_attn_kernel_matches_plain(cuda_device, n, t, dtype, atol, rtol):
    """Kernel vs plain version; (12800, 100) is the 640x640 shape. fp32: the
    folded form sums in another order (1e-4). bf16 output: at most two bf16
    roundings apart (rtol 2^-6)."""
    args = [torch.from_numpy(a).to(cuda_device) for a in _inputs(n, t)]
    args[0] = args[0].to(dtype)
    before = latent_attn.latent_cross_attention.launches
    out = latent_attn.latent_cross_attention(*args)
    torch.cuda.synchronize()
    assert latent_attn.latent_cross_attention.launches == before + 1
    assert out.dtype == dtype and out.shape == (n, 8, 128)
    ref = latent_attn.latent_cross_attention_torch(*args)
    torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=rtol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol,rtol", [(torch.float32, 1e-4, 1e-4), (torch.bfloat16, 1e-2, 1.6e-2)])
def test_latent_attn_folded_entry_launches_the_kernel(cuda_device, dtype, atol, rtol):
    """The entry the cost perceiver calls, with weights folded beforehand, at
    the 640x640 shape: one launch, the plain version's result (tolerances as
    above)."""
    args = [torch.from_numpy(a).to(cuda_device) for a in _inputs(12800, 100)]
    args[0] = args[0].to(dtype)
    folded = latent_attn.fold_weights(*args[1:])
    before = latent_attn.latent_cross_attention.launches
    out = latent_attn.latent_attn_folded(args[0], *folded)
    torch.cuda.synchronize()
    assert latent_attn.latent_cross_attention.launches == before + 1
    ref = latent_attn.latent_cross_attention_torch(*args)
    torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=rtol)
    with pytest.raises(TypeError):
        latent_attn.latent_attn_folded(args[0], folded[0].double(), *folded[1:])


@pytest.mark.cuda
def test_latent_attn_kernel_rejects_what_it_cannot_take(cuda_device):
    args = [torch.from_numpy(a).to(cuda_device) for a in _inputs(8, 4)]
    with pytest.raises(ValueError):
        latent_attn.latent_cross_attention(args[0][:, :, :32], *args[1:])
    with pytest.raises(ValueError):
        latent_attn.latent_cross_attention(args[0].transpose(0, 1), *args[1:])
    with pytest.raises(ValueError):
        latent_attn.latent_cross_attention(torch.zeros(2, latent_attn.MAX_TOKENS + 1, 64, device=cuda_device),
                                           *args[1:])
    with pytest.raises(TypeError):
        latent_attn.latent_cross_attention(args[0].half(), *args[1:])
