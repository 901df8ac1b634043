"""Local (windowed) correlation cost volume of the PWC flow net.

Port of ``macvo_tpu/ops/correlation.py``. Layout: **NCHW**, the layout the
port's PWC holds its features in (its convolutions run NCHW); the JAX
contract is the same function channel-last:

    local_correlation(f1 (B,C,H,W), f2 (B,C,H,W), radius=4) -> (B,(2r+1)^2,H,W)
    out[b, (dy+r)(2r+1) + (dx+r), y, x] = mean_c f1[b,c,y,x] * f2[b,c,y+dy,x+dx]

with f2 zero outside the image. :func:`local_correlation` launches the
hand-written kernel ``csrc/correlation.cu`` on CUDA tensors (each launch
counts in ``local_correlation.launches``) and runs the plain version
:func:`local_correlation_torch` on CPU tensors. There is no fallback: a CUDA
input the kernel cannot take raises (not float32, not contiguous, a radius
other than 4, or an input that requires grad: the kernel is forward-only).
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


def cluster_size(b: int, c: int, h: int, w: int, sms: int) -> int:
    """The channel split (thread-block cluster size) the kernel's launcher picks
    for a (B, C, H, W) call on a card of ``sms`` SMs, as the built library
    reports it (builds the kernel)."""
    fn = build("correlation").lib.correlation_cluster_size
    fn.argtypes = [ctypes.c_int] * 5
    fn.restype = ctypes.c_int
    return fn(b, c, h, w, sms)


@functools.cache
def _kernel():
    fn = build("correlation").lib.correlation_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(f1: torch.Tensor, f2: torch.Tensor, radius: int) -> torch.Tensor:
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
    if f1.requires_grad or f2.requires_grad:
        raise RuntimeError("local_correlation kernel is forward-only: run it under torch.no_grad() "
                           "or torch.inference_mode()")
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


def local_correlation(f1: torch.Tensor, f2: torch.Tensor, radius: int = 4) -> torch.Tensor:
    """The kernel on CUDA tensors, :func:`local_correlation_torch` on CPU
    tensors (NCHW; see the module doc)."""
    if f1.device.type == "cpu":
        return local_correlation_torch(f1, f2, radius)
    if f1.device.type != "cuda":
        raise ValueError(f"local_correlation: unsupported device {f1.device}")
    return _launch(f1, f2, radius)


local_correlation.launches = 0   # kernel launches
