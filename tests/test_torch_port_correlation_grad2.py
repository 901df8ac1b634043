"""The correlation differentiated twice: the port (macvo_tpu_torch.ops.correlation)
against the JAX package, on the CPU.

JAX's ``local_correlation`` is a ``custom_vjp`` whose backward is ``jax.vjp``
of its XLA twin, so it can be differentiated again. The port's card route
goes through ``LocalCorrelationFunction`` and ``LocalCorrelationBackwardFunction``
(the forward and backward kernels on CUDA tensors, their plain versions on
CPU tensors); its CPU entry runs the plain version under autograd. Both are
held here to ``jax.vjp`` applied to ``jax.vjp``, on the same seeded inputs in
fp32, within 1e-5 of each output's largest value; and ``gradgradcheck`` holds
the Functions to float64 finite differences (the third order through the
backward Function's own second derivative).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from macvo_tpu.ops.correlation import local_correlation as j_local_correlation
from macvo_tpu_torch.ops import correlation

# (B, H, W, C): odd H and W, the coarsest trainer level, a window wider than the map
SHAPES = [(2, 9, 13, 7), (4, 5, 7, 196), (1, 3, 4, 32)]
ROUTES = {
    "entry": correlation.local_correlation,
    "functions": lambda a, b: correlation.LocalCorrelationFunction.apply(a, b, 4),
}


def _nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()


def _nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


def _inputs(b, h, w, c, seed):
    rng = np.random.default_rng(seed)
    f1, f2, w1, w2 = (rng.normal(size=(b, h, w, c)).astype(np.float32) for _ in range(4))
    g = rng.normal(size=(b, h, w, 81)).astype(np.float32)
    return f1, f2, g, w1, w2


def _jax_second_order(f1, f2, g, w1, w2):
    def gradient(a, b, gg):
        _, vjp = jax.vjp(lambda x, y: j_local_correlation(x, y, 4), a, b)
        return vjp(gg)

    _, vjp2 = jax.vjp(gradient, jnp.asarray(f1), jnp.asarray(f2), jnp.asarray(g))
    return [np.asarray(x) for x in vjp2((jnp.asarray(w1), jnp.asarray(w2)))]


def _port_second_order(f1, f2, g, w1, w2, fn):
    a, b, gg = (_nchw(x).requires_grad_() for x in (f1, f2, g))
    g1, g2 = torch.autograd.grad(fn(a, b), (a, b), gg, create_graph=True)
    s = (g1 * _nchw(w1)).sum() + (g2 * _nchw(w2)).sum()
    return [_nhwc(x) if x is not None else None for x in torch.autograd.grad(s, (a, b, gg), allow_unused=True)]


def _close(ours, ref):
    assert ours.shape == ref.shape
    assert np.abs(ours - ref).max() <= 1e-5 * np.abs(ref).max()


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("b,h,w,c", SHAPES)
def test_second_order_matches_jax_vjp_of_vjp(b, h, w, c, route):
    """The gradients for f1, f2 and the upstream g of <w1, grad_f1> + <w2, grad_f2>,
    with no kernel launch counted on the CPU."""
    f1, f2, g, w1, w2 = _inputs(b, h, w, c, seed=5 * h + w)
    ref = _jax_second_order(f1, f2, g, w1, w2)
    before = (correlation.local_correlation.launches, correlation.local_correlation_backward.launches)
    ours = _port_second_order(f1, f2, g, w1, w2, ROUTES[route])
    assert (correlation.local_correlation.launches, correlation.local_correlation_backward.launches) == before
    for o, r in zip(ours, ref):
        _close(o, r)


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("which", ["grad_f1", "grad_f2"])
def test_second_order_of_one_gradient_matches_jax(which, route):
    """A scalar of one of the two gradients only (the other's incoming
    gradient is None in the backward Function, and its terms are skipped):
    the terms JAX gives with a zero in its place; the skipped term is zero."""
    f1, f2, g, w1, w2 = _inputs(2, 6, 11, 12, seed=21)
    if which == "grad_f1":
        w2 = np.zeros_like(w2)
    else:
        w1 = np.zeros_like(w1)
    ref = _jax_second_order(f1, f2, g, w1, w2)
    a, b, gg = (_nchw(x).requires_grad_() for x in (f1, f2, g))
    g1, g2 = torch.autograd.grad(ROUTES[route](a, b), (a, b), gg, create_graph=True)
    s = (g1 * _nchw(w1)).sum() if which == "grad_f1" else (g2 * _nchw(w2)).sum()
    ours = torch.autograd.grad(s, (a, b, gg), allow_unused=True)
    for o, r in zip(ours, ref):
        if o is None:
            assert not r.any()
        else:
            _close(_nhwc(o), r)


@pytest.mark.parametrize("radius,shape", [(1, (2, 3, 4, 5)), (4, (1, 1, 2, 3))])
def test_correlation_function_passes_gradgradcheck(radius, shape):
    """Second derivatives of ``LocalCorrelationFunction`` in float64 against
    finite differences (radius 4: the window wider than the map)."""
    gen = torch.Generator().manual_seed(radius)
    a, b = (torch.randn(shape, generator=gen, dtype=torch.float64).requires_grad_() for _ in range(2))
    assert torch.autograd.gradgradcheck(lambda x, y: correlation.LocalCorrelationFunction.apply(x, y, radius), (a, b))


def test_correlation_backward_function_passes_gradgradcheck():
    """The backward Function's first and second derivatives (the correlation's
    second and third) in float64 against finite differences."""
    gen = torch.Generator().manual_seed(7)
    a, b = (torch.randn((1, 2, 3, 4), generator=gen, dtype=torch.float64).requires_grad_() for _ in range(2))
    g = torch.randn((1, 9, 3, 4), generator=gen, dtype=torch.float64).requires_grad_()

    def fn(x, y, z):
        return correlation.LocalCorrelationBackwardFunction.apply(x, y, z, 1)

    assert torch.autograd.gradcheck(fn, (a, b, g))
    assert torch.autograd.gradgradcheck(fn, (a, b, g))
