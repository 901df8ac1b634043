"""The port's CUDA kernels on the card, against their plain versions.

This file imports no JAX, so it runs on a machine with a card and no JAX:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_port_kernels_cuda.py

(``--noconftest`` skips tests/conftest.py, which configures JAX.) Every test
is marked ``cuda`` and skips, from inside its fixture, where there is no card.
"""

import numpy as np
import pytest
import torch

from macvo_tpu_torch.ops import correlation, latent_attn


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


# The 640x640 PWC forward calls the correlation at these (B, C, H, W), plus an odd shape.
CORR_SHAPES = [(1, 32, 160, 160), (1, 64, 80, 80), (1, 96, 40, 40), (1, 128, 20, 20), (1, 196, 10, 10),
               (2, 48, 37, 53)]


def _corr_inputs(shape, device, seed=3):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(device) for _ in range(2)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", CORR_SHAPES)
def test_correlation_kernel_matches_plain(cuda_device, shape):
    """Kernel vs plain version, one launch each: fp32 channel sums in another
    order (1e-5)."""
    f1, f2 = _corr_inputs(shape, cuda_device)
    before = correlation.local_correlation.launches
    out = correlation.local_correlation(f1, f2)
    torch.cuda.synchronize()
    assert correlation.local_correlation.launches == before + 1
    assert out.shape == (shape[0], 81, shape[2], shape[3])
    torch.testing.assert_close(out, correlation.local_correlation_torch(f1, f2), atol=1e-5, rtol=1e-5)


@pytest.mark.cuda
def test_correlation_kernel_rejects_what_it_cannot_take(cuda_device):
    f1, f2 = _corr_inputs((1, 16, 12, 20), cuda_device)
    before = correlation.local_correlation.launches
    with pytest.raises(TypeError):
        correlation.local_correlation(f1.double(), f2.double())
    with pytest.raises(TypeError):
        correlation.local_correlation(f1.half(), f2.half())
    with pytest.raises(ValueError):
        correlation.local_correlation(f1.transpose(2, 3), f2.transpose(2, 3))
    with pytest.raises(ValueError):
        correlation.local_correlation(f1, f2, radius=3)
    with pytest.raises(ValueError):
        correlation.local_correlation(f1, f2[:, :8])
    with pytest.raises(RuntimeError):
        correlation.local_correlation(f1.requires_grad_(), f2)
    assert correlation.local_correlation.launches == before


@pytest.mark.cuda
def test_pwc_forward_launches_the_correlation_five_times(cuda_device):
    """One PWC forward at 128x192 runs the kernel once per decoded level and
    agrees with the same network on the CPU (TF32 off; cuDNN sums in another
    order: 1e-4 relative)."""
    from pathlib import Path

    from macvo_tpu_torch.models.flowformer import load_flax_checkpoint
    from macvo_tpu_torch.models.tartanvo import PWCFlowNet

    torch.backends.cudnn.allow_tf32 = False
    model = PWCFlowNet().eval()
    load_flax_checkpoint(model, Path(__file__).parent.parent / "model" / "TartanVO_flow.npz")
    rng = np.random.default_rng(5)
    imgs = [torch.from_numpy(rng.normal(size=(1, 128, 192, 3)).astype(np.float32)) for _ in range(2)]
    with torch.inference_mode():
        ref = model(*imgs)
        model.to(cuda_device)
        before = correlation.local_correlation.launches
        out = model(*(x.to(cuda_device) for x in imgs))
        torch.cuda.synchronize()
    assert correlation.local_correlation.launches == before + 5
    torch.testing.assert_close(out.cpu(), ref, atol=1e-4 * float(ref.abs().max()), rtol=1e-4)
