"""Local (windowed) correlation cost volume of the PWC flow net.

Port of ``macvo_tpu/ops/correlation.py``. Layout: **NCHW**, the layout the
port's PWC holds its features in (its convolutions run NCHW); the JAX
contract is the same function channel-last:

    local_correlation(f1 (B,C,H,W), f2 (B,C,H,W), radius=4) -> (B,(2r+1)^2,H,W)
    out[b, (dy+r)(2r+1) + (dx+r), y, x] = mean_c f1[b,c,y,x] * f2[b,c,y+dy,x+dx]

with f2 zero outside the image. :func:`local_correlation` launches the
hand-written kernel ``csrc/correlation.cu`` on CUDA tensors (each launch
counts in ``local_correlation.launches``) and runs the plain version
:func:`local_correlation_torch` on CPU tensors, where autograd differentiates it.

Gradients on the card: where grad is enabled and an input requires it, the
entry goes through :class:`LocalCorrelationFunction`, whose forward launches
the same kernel and whose backward launches ``csrc/correlation_bwd.cu`` (both
input gradients in one launch, counted in ``local_correlation_backward.launches``);
:func:`local_correlation_bwd_torch` is its plain version. The JAX package
differentiates its XLA twin instead (``macvo_tpu/ops/correlation.py:_bwd``).
There is no fallback: a CUDA input the kernels cannot take raises (not
float32, not contiguous, or a radius other than 4).
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from ._build import build

KERNEL_RADIUS = 4   # the radius csrc/correlation.cu is built for (81 channels)


def local_correlation_torch(f1: torch.Tensor, f2: torch.Tensor, radius: int = 4) -> torch.Tensor:
    """Plain version (the JAX twin ``local_correlation_xla``): (2r+1)^2 shifted
    multiply-sums over a zero-padded f2."""
    b, c, h, w = f1.shape
    k = 2 * radius + 1
    f2p = F.pad(f2, (radius, radius, radius, radius))
    outs = [(f1 * f2p[:, :, dy:dy + h, dx:dx + w]).sum(dim=1) for dy in range(k) for dx in range(k)]
    return torch.stack(outs, dim=1) / c


def local_correlation_bwd_torch(f1: torch.Tensor, f2: torch.Tensor, g: torch.Tensor,
                                radius: int = 4) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain backward: (grad_f1, grad_f2) of ``local_correlation_torch`` for the
    output gradient ``g`` (B,(2r+1)^2,H,W):

        grad_f1[b,c,y,x] = (1/C) sum_d g[b,d,y,x] f2[b,c,y+dy,x+dx]
        grad_f2[b,c,y,x] = (1/C) sum_d g[b,d,y-dy,x-dx] f1[b,c,y-dy,x-dx]

    with zero outside the image (grad_f2 is accumulated on a padded map and
    cropped)."""
    b, c, h, w = f1.shape
    k = 2 * radius + 1
    f2p = F.pad(f2, (radius, radius, radius, radius))
    grad_f1 = torch.zeros_like(f1)
    grad_f2p = torch.zeros_like(f2p)
    for dy in range(k):
        for dx in range(k):
            gd = g[:, dy * k + dx:dy * k + dx + 1]
            grad_f1 += gd * f2p[:, :, dy:dy + h, dx:dx + w]
            grad_f2p[:, :, dy:dy + h, dx:dx + w] += gd * f1
    return grad_f1 / c, grad_f2p[:, :, radius:radius + h, radius:radius + w] / c


def cluster_size(b: int, c: int, h: int, w: int, sms: int) -> int:
    """The channel split (thread-block cluster size) the kernel's launcher picks
    for a (B, C, H, W) call on a card of ``sms`` SMs, as the built library
    reports it (builds the kernel)."""
    fn = build("correlation").lib.correlation_cluster_size
    fn.argtypes = [ctypes.c_int] * 5
    fn.restype = ctypes.c_int
    return fn(b, c, h, w, sms)


def bwd_channel_groups(b: int, c: int, h: int, w: int, sms: int) -> int:
    """The number of blocks the backward kernel's launcher splits the channels
    over for a (B, C, H, W) call on a card of ``sms`` SMs (builds the kernel)."""
    fn = build("correlation_bwd").lib.correlation_bwd_channel_groups
    fn.argtypes = [ctypes.c_int] * 5
    fn.restype = ctypes.c_int
    return fn(b, c, h, w, sms)


@functools.cache
def _kernel():
    fn = build("correlation").lib.correlation_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _bwd_kernel():
    fn = build("correlation_bwd").lib.correlation_bwd_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(f1: torch.Tensor, f2: torch.Tensor, radius: int) -> None:
    if f1.dtype != torch.float32 or f2.dtype != torch.float32:
        raise TypeError(f"local_correlation kernel takes float32, got {f1.dtype} and {f2.dtype}")
    if f1.dim() != 4 or f1.shape != f2.shape:
        raise ValueError(f"local_correlation kernel needs two (B,C,H,W) maps of one shape, "
                         f"got {tuple(f1.shape)} and {tuple(f2.shape)}")
    if radius != KERNEL_RADIUS:
        raise ValueError(f"local_correlation kernel is built for radius {KERNEL_RADIUS}, got {radius}")
    if f2.device != f1.device:
        raise ValueError(f"f1 is on {f1.device}, f2 on {f2.device}")
    if not (f1.is_contiguous() and f2.is_contiguous()):
        raise ValueError("local_correlation kernel needs contiguous NCHW inputs")


def _launch(f1: torch.Tensor, f2: torch.Tensor, radius: int) -> torch.Tensor:
    _check(f1, f2, radius)
    b, c, h, w = f1.shape
    k = 2 * radius + 1
    out = torch.empty((b, k * k, h, w), dtype=torch.float32, device=f1.device)
    fn = _kernel()
    with torch.cuda.device(f1.device):
        err = fn(f1.data_ptr(), f2.data_ptr(), out.data_ptr(), b, c, h, w, radius,
                 torch.cuda.current_stream(f1.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"correlation kernel launch failed: cudaError {err}")
    local_correlation.launches += 1
    return out


def local_correlation_backward(f1: torch.Tensor, f2: torch.Tensor, g: torch.Tensor,
                               radius: int = 4) -> tuple[torch.Tensor, torch.Tensor]:
    """(grad_f1, grad_f2): the backward kernel on CUDA tensors (one launch for
    both), :func:`local_correlation_bwd_torch` on CPU tensors."""
    if f1.device.type == "cpu":
        return local_correlation_bwd_torch(f1, f2, g, radius)
    if f1.device.type != "cuda":
        raise ValueError(f"local_correlation_backward: unsupported device {f1.device}")
    _check(f1, f2, radius)
    b, c, h, w = f1.shape
    k = 2 * radius + 1
    if g.dtype != torch.float32 or tuple(g.shape) != (b, k * k, h, w) or g.device != f1.device:
        raise ValueError(f"local_correlation backward needs a float32 {(b, k * k, h, w)} gradient on "
                         f"{f1.device}, got {g.dtype} {tuple(g.shape)} on {g.device}")
    g = g.contiguous()
    grad_f1, grad_f2 = torch.empty_like(f1), torch.empty_like(f2)
    fn = _bwd_kernel()
    with torch.cuda.device(f1.device):
        err = fn(f1.data_ptr(), f2.data_ptr(), g.data_ptr(), grad_f1.data_ptr(), grad_f2.data_ptr(),
                 b, c, h, w, radius, torch.cuda.current_stream(f1.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"correlation backward kernel launch failed: cudaError {err}")
    local_correlation_backward.launches += 1
    return grad_f1, grad_f2


local_correlation_backward.launches = 0   # backward kernel launches


class LocalCorrelationFunction(torch.autograd.Function):
    """The forward kernel, differentiated by the backward kernel (CUDA tensors)."""

    @staticmethod
    def forward(ctx, f1: torch.Tensor, f2: torch.Tensor, radius: int) -> torch.Tensor:
        ctx.save_for_backward(f1, f2)
        ctx.radius = radius
        return _launch(f1, f2, radius)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g: torch.Tensor):
        f1, f2 = ctx.saved_tensors
        grad_f1, grad_f2 = local_correlation_backward(f1, f2, g, ctx.radius)
        return (grad_f1 if ctx.needs_input_grad[0] else None,
                grad_f2 if ctx.needs_input_grad[1] else None, None)


def local_correlation(f1: torch.Tensor, f2: torch.Tensor, radius: int = 4) -> torch.Tensor:
    """The kernel on CUDA tensors (through :class:`LocalCorrelationFunction`
    where a gradient is wanted), :func:`local_correlation_torch` on CPU tensors
    (NCHW; see the module doc)."""
    if f1.device.type == "cpu":
        return local_correlation_torch(f1, f2, radius)
    if f1.device.type != "cuda":
        raise ValueError(f"local_correlation: unsupported device {f1.device}")
    if torch.is_grad_enabled() and (f1.requires_grad or f2.requires_grad):
        return LocalCorrelationFunction.apply(f1, f2, radius)
    return _launch(f1, f2, radius)


local_correlation.launches = 0   # forward kernel launches
