"""The port's local correlation (macvo_tpu_torch.ops.correlation) against the
JAX package's, on the CPU.

The JAX package's own CPU path is its XLA twin ``local_correlation_xla``: its
public ``local_correlation`` reaches the Pallas body only on a TPU, and
``local_correlation_pallas`` takes no ``interpret`` flag, so the Pallas body
does not run here. Both JAX entries are held against the port's plain
version (which the port's wrapper runs on CPU tensors). The port is NCHW,
the JAX contract channel-last: the test transposes. Tolerance atol = rtol =
1e-5: fp32 channel sums taken in another order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from macvo_tpu.ops.correlation import local_correlation as j_local_correlation
from macvo_tpu.ops.correlation import local_correlation_xla as j_local_correlation_xla
from macvo_tpu_torch.ops import correlation

SHAPES = [(1, 10, 10, 196, 4), (2, 13, 17, 32, 4), (1, 40, 40, 96, 4), (1, 11, 14, 24, 2),
          (1, 20, 20, 128, 4), (2, 37, 53, 48, 4)]


def _inputs(b, h, w, c, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(b, h, w, c)).astype(np.float32) for _ in range(2)]


def _nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()


@pytest.mark.parametrize("b,h,w,c,radius", SHAPES)
@pytest.mark.parametrize("jax_entry", ["local_correlation_xla", "local_correlation"])
def test_plain_matches_jax(b, h, w, c, radius, jax_entry):
    f1, f2 = _inputs(b, h, w, c, seed=h * w + c)
    fn = {"local_correlation_xla": j_local_correlation_xla, "local_correlation": j_local_correlation}[jax_entry]
    ref = np.asarray(fn(jnp.asarray(f1), jnp.asarray(f2), radius))
    ours = correlation.local_correlation_torch(_nchw(f1), _nchw(f2), radius)
    assert ours.shape == (b, (2 * radius + 1) ** 2, h, w)
    np.testing.assert_allclose(ours.permute(0, 2, 3, 1).numpy(), ref, atol=1e-5, rtol=1e-5)


def test_cpu_entry_runs_the_plain_version_without_counting():
    f1, f2 = (_nchw(x) for x in _inputs(1, 9, 12, 16, seed=5))
    before = correlation.local_correlation.launches
    out = correlation.local_correlation(f1, f2)
    assert correlation.local_correlation.launches == before
    torch.testing.assert_close(out, correlation.local_correlation_torch(f1, f2), rtol=0, atol=0)


def test_cpu_entry_keeps_autograd():
    """On the CPU the plain version is differentiable (the kernel is not)."""
    f1, f2 = (_nchw(x).requires_grad_() for x in _inputs(1, 6, 7, 8, seed=6))
    correlation.local_correlation(f1, f2).sum().backward()
    assert f1.grad is not None and torch.isfinite(f2.grad).all()


def test_other_devices_raise():
    f = torch.zeros(1, 4, 8, 8, device="meta")
    with pytest.raises(ValueError):
        correlation.local_correlation(f, f)


# (B, H, W, C): odd H and W, the coarsest trainer level (5x7x196), B = 2, a window wider than the map.
BWD_SHAPES = [(2, 9, 13, 7), (4, 5, 7, 196), (1, 37, 53, 48), (2, 3, 4, 32), (1, 20, 28, 96)]


def _vjp_inputs(b, h, w, c, seed):
    f1, f2 = _inputs(b, h, w, c, seed)
    g = np.random.default_rng(seed + 1).normal(size=(b, h, w, 81)).astype(np.float32)
    return f1, f2, g


def _jax_vjp(f1, f2, g):
    import jax

    _, vjp = jax.vjp(lambda a, b: j_local_correlation(a, b, 4), jnp.asarray(f1), jnp.asarray(f2))
    return [np.asarray(x) for x in vjp(jnp.asarray(g))]


@pytest.mark.parametrize("b,h,w,c", BWD_SHAPES)
def test_plain_backward_matches_jax_vjp(b, h, w, c):
    """The plain backward (the CUDA backward kernel's twin) against ``jax.vjp``
    of the JAX package's public ``local_correlation`` (its custom VJP), on
    unit-normal inputs: 1e-5 absolute (fp32 sums over the 81 displacements in
    another order)."""
    f1, f2, g = _vjp_inputs(b, h, w, c, seed=3 * h + w)
    ref1, ref2 = _jax_vjp(f1, f2, g)
    g1, g2 = correlation.local_correlation_bwd_torch(_nchw(f1), _nchw(f2), _nchw(g))
    np.testing.assert_allclose(g1.permute(0, 2, 3, 1).numpy(), ref1, atol=1e-5, rtol=0)
    np.testing.assert_allclose(g2.permute(0, 2, 3, 1).numpy(), ref2, atol=1e-5, rtol=0)


@pytest.mark.parametrize("b,h,w,c", BWD_SHAPES[:3])
def test_cpu_autograd_entry_matches_jax_vjp(b, h, w, c):
    """autograd through the CPU entry (the plain version) and the backward
    entry on CPU tensors give ``jax.vjp``'s gradients (1e-5 absolute), and
    count no kernel launch."""
    f1, f2, g = _vjp_inputs(b, h, w, c, seed=h + 7 * w)
    ref1, ref2 = _jax_vjp(f1, f2, g)
    a, bb = _nchw(f1).requires_grad_(), _nchw(f2).requires_grad_()
    before = (correlation.local_correlation.launches, correlation.local_correlation_backward.launches)
    correlation.local_correlation(a, bb).backward(_nchw(g))
    e1, e2 = correlation.local_correlation_backward(_nchw(f1), _nchw(f2), _nchw(g))
    assert (correlation.local_correlation.launches, correlation.local_correlation_backward.launches) == before
    for ours in (a.grad, e1):
        np.testing.assert_allclose(ours.permute(0, 2, 3, 1).numpy(), ref1, atol=1e-5, rtol=0)
    for ours in (bb.grad, e2):
        np.testing.assert_allclose(ours.permute(0, 2, 3, 1).numpy(), ref2, atol=1e-5, rtol=0)


def test_backward_entry_rejects_other_devices():
    f = torch.zeros(1, 4, 8, 8, device="meta")
    with pytest.raises(ValueError):
        correlation.local_correlation_backward(f, f, torch.zeros(1, 81, 8, 8, device="meta"))
