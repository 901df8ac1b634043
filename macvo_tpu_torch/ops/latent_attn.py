"""Fused latent cross-attention of the cost perceiver's input stage.

Port of ``macvo_tpu/ops/latent_attn.py``. For each source pixel, 8 learned
latent queries attend over the pixel's T cost-patch tokens (64-d) with
``input_proj`` folded into the k/v projections; the output projection and the
residual (``bias`` = proj bias + latents) follow. Signature as in JAX:

    latent_cross_attention(tokens (N,T,64), wk, bk, wv, bv (64,128)/(128,),
                           q (8,128), wp (128,128), bias (8,128)) -> (N,8,128)

The hand-written kernel ``csrc/latent_attn.cu`` computes the folded form of
that function: :func:`fold_weights` turns the seven weights into (M, Wvp, c),
and :func:`latent_attn_folded` takes those directly, so a caller whose
weights do not change (``CostPerceiverEncoder``) folds them once. Both entry
points launch the kernel on CUDA tensors (each launch counts in
``latent_cross_attention.launches``) and run a plain version on CPU tensors
(:func:`latent_cross_attention_torch`, :func:`latent_attn_folded_torch`).
There is no fallback between the two: a CUDA tensor the kernel cannot take
raises, and so does one that requires grad (the kernel is forward-only; the
perceiver trains through its unfused input stage).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ._build import build

D_IN, N_Q, D_OUT = 64, 8, 128
MAX_TOKENS = 512   # the kernel's ring holds at least one pixel's (T, 64) tile


def latent_cross_attention_torch(tokens, wk, bk, wv, bv, q, wp, bias):
    """Plain version (same math as ``latent_cross_attention_xla``), fp32 compute,
    output in the token dtype."""
    t32 = tokens.float()
    k = t32 @ wk.float() + bk.float()
    v = t32 @ wv.float() + bv.float()
    scale = float(q.shape[1]) ** -0.5
    s = torch.einsum("qe,nte->nqt", q.float() * scale, k)
    a = torch.softmax(s, dim=-1)
    o = torch.einsum("nqt,nte->nqe", a, v) @ wp.float()
    return (o + bias.float()).to(tokens.dtype)


def fold_weights(wk, bk, wv, bv, q, wp, bias):
    """Weights of the kernel's folded form (see csrc/latent_attn.cu):
    M = Wk (q d^-1/2)^T (64,8), Wvp = Wv Wp (64,128), c = bv Wp + bias (8,128).
    ``bk`` drops out: it adds a per-query constant to every score of a pixel,
    which the softmax over the tokens removes. Folded in float64, stored fp32."""
    with torch.autocast(device_type=wk.device.type, enabled=False):
        f64 = torch.float64
        scale = float(q.shape[1]) ** -0.5
        m = wk.to(f64) @ (q.to(f64) * scale).T
        wvp = wv.to(f64) @ wp.to(f64)
        c = bv.to(f64)[None] @ wp.to(f64) + bias.to(f64)
    del bk
    return m.float().contiguous(), wvp.float().contiguous(), c.float().contiguous()


def latent_attn_folded_torch(tokens, m, wvp, c):
    """Plain version of the folded form the kernel computes, fp32 compute,
    output in the token dtype: softmax_t(tok M)^T tok Wvp + c."""
    tok = tokens.float()
    a = torch.softmax(torch.einsum("ntd,dq->nqt", tok, m.float()), dim=-1)
    return (torch.einsum("nqt,ntd->nqd", a, tok) @ wvp.float() + c.float()).to(tokens.dtype)


@functools.cache
def _kernel():
    fn = build("latent_attn").lib.latent_attn_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_longlong] + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(tokens: torch.Tensor, m: torch.Tensor, wvp: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    n, t, d_in = tokens.shape
    if tokens.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"latent_cross_attention kernel takes float32 or bfloat16 tokens, got {tokens.dtype}")
    if d_in != D_IN or tuple(m.shape) != (D_IN, N_Q) or tuple(wvp.shape) != (D_IN, D_OUT) \
            or tuple(c.shape) != (N_Q, D_OUT):
        raise ValueError(f"latent_cross_attention kernel needs (N,T,{D_IN}) tokens, {N_Q} queries "
                         f"of {D_OUT} dims; got tokens {tuple(tokens.shape)}")
    if not 1 <= t <= MAX_TOKENS:
        raise ValueError(f"latent_cross_attention kernel takes 1..{MAX_TOKENS} tokens a pixel, got {t}")
    for name, x in (("tokens", tokens), ("M", m), ("Wvp", wvp), ("c", c)):
        if x.device != tokens.device:
            raise ValueError(f"{name} is on {x.device}, tokens on {tokens.device}")
        if x is not tokens and x.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {x.dtype}")
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
        if x.requires_grad:
            raise RuntimeError(f"latent_cross_attention kernel is forward-only, but {name} requires grad: "
                               "run it under torch.no_grad() or torch.inference_mode()")
    out = torch.empty((n, N_Q, D_OUT), dtype=tokens.dtype, device=tokens.device)
    fn = _kernel()
    stream = torch.cuda.current_stream(tokens.device).cuda_stream
    with torch.cuda.device(tokens.device):
        err = fn(tokens.data_ptr(), m.data_ptr(), wvp.data_ptr(), c.data_ptr(), out.data_ptr(),
                 n, t, D_IN, N_Q, D_OUT, 0 if tokens.dtype == torch.float32 else 1, stream)
    if err != 0:
        raise RuntimeError(f"latent_attn kernel launch failed: cudaError {err}")
    latent_cross_attention.launches += 1
    return out


def latent_attn_folded(tokens, m, wvp, c):
    """The kernel on CUDA tensors, :func:`latent_attn_folded_torch` on CPU
    tensors, with weights already folded by :func:`fold_weights`."""
    if tokens.device.type == "cpu":
        return latent_attn_folded_torch(tokens, m, wvp, c)
    if tokens.device.type != "cuda":
        raise ValueError(f"latent_attn_folded: unsupported device {tokens.device}")
    return _launch(tokens, m, wvp, c)


def latent_cross_attention(tokens, wk, bk, wv, bv, q, wp, bias):
    """Kernel on CUDA tensors (weights folded on every call), plain version
    on CPU tensors (see module doc)."""
    if tokens.device.type == "cpu":
        return latent_cross_attention_torch(tokens, wk, bk, wv, bv, q, wp, bias)
    if tokens.device.type != "cuda":
        raise ValueError(f"latent_cross_attention: unsupported device {tokens.device}")
    return _launch(tokens, *fold_weights(wk, bk, wv, bv, q, wp, bias))


latent_cross_attention.launches = 0   # kernel launches, from either entry point
