"""Twins-SVT feature/context encoder (port of ``macvo_tpu/models/flowformer/twins.py``).

First two Twins-SVT stages -> (B, H/8, W/8, 256), channel-last at the public
boundary like the flax model; convolutions run NCHW inside. Hazards carried
over from flax: ``nn.gelu`` is the tanh approximation, LayerNorm eps is 1e-6,
and every strided ``nn.Conv`` pads ``SAME`` (unevenly when the size is not a
multiple of the stride, see :func:`conv_same`).
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

LN_EPS = 1e-6


def layer_norm(dim: int) -> nn.LayerNorm:
    return nn.LayerNorm(dim, eps=LN_EPS)


def gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def same_pads(size: int, kernel: int, stride: int) -> tuple[int, int]:
    """(low, high) padding of flax/XLA ``SAME`` along one axis."""
    out = math.ceil(size / stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def conv_same(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """Apply an unpadded Conv2d to NCHW ``x`` with flax ``SAME`` padding."""
    kh, kw = conv.kernel_size
    sh, sw = conv.stride
    ph = same_pads(x.shape[-2], kh, sh)
    pw = same_pads(x.shape[-1], kw, sw)
    if any(ph + pw):
        x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
    return conv(x)


def conv_nhwc(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """SAME conv of a channel-last tensor, result channel-last."""
    return conv_same(conv, x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class Mlp(nn.Module):
    def __init__(self, dim_in: int, hidden: int, out: int) -> None:
        super().__init__()
        self.Dense_0 = nn.Linear(dim_in, hidden)
        self.Dense_1 = nn.Linear(hidden, out)

    def forward(self, x):
        return self.Dense_1(gelu(self.Dense_0(x)))


class LocallyGroupedAttention(nn.Module):
    """Windowed self-attention (Twins-SVT LSA), window 8, padded windows masked."""

    def __init__(self, dim: int, num_heads: int, window: int = 8) -> None:
        super().__init__()
        self.dim, self.num_heads, self.window = dim, num_heads, window
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x):
        b, h, w, c = x.shape
        ws, nh_ = self.window, self.num_heads
        hd = c // nh_
        pad_h, pad_w = (-h) % ws, (-w) % ws
        x_p = F.pad(x, (0, 0, 0, pad_w, 0, pad_h)) if (pad_h or pad_w) else x
        hp, wp = h + pad_h, w + pad_w
        nh, nw = hp // ws, wp // ws
        qkv = self.qkv(x_p).reshape(b, nh, ws, nw, ws, 3, nh_, hd)
        qkv = qkv.permute(5, 0, 1, 3, 6, 2, 4, 7).reshape(3, b, nh, nw, nh_, ws * ws, hd)
        q, k, v = qkv[0], qkv[1], qkv[2]
        attn = (q * hd**-0.5) @ k.transpose(-1, -2)
        if pad_h or pad_w:
            row = torch.arange(hp, device=x.device).reshape(nh, ws)
            col = torch.arange(wp, device=x.device).reshape(nw, ws)
            valid = (row[:, None, :, None] < h) & (col[None, :, None, :] < w)
            valid = valid.reshape(nh, nw, ws * ws)
            attn = attn.masked_fill(~valid[None, :, :, None, None, :], -1e9)
        attn = torch.softmax(attn, dim=-1)
        out = (attn @ v).reshape(b, nh, nw, nh_, ws, ws, hd)
        out = out.permute(0, 1, 4, 2, 5, 3, 6).reshape(b, hp, wp, c)[:, :h, :w]
        return self.proj(out)


class GlobalSubsampledAttention(nn.Module):
    """Global attention with spatially sub-sampled K/V (Twins-SVT GSA)."""

    def __init__(self, dim: int, num_heads: int, sr_ratio: int) -> None:
        super().__init__()
        self.dim, self.num_heads, self.sr_ratio = dim, num_heads, sr_ratio
        self.q = nn.Linear(dim, dim)
        self.kv = nn.Linear(dim, 2 * dim)
        self.proj = nn.Linear(dim, dim)
        if sr_ratio > 1:
            self.sr = nn.Conv2d(dim, dim, sr_ratio, stride=sr_ratio)
            self.sr_norm = layer_norm(dim)

    def forward(self, x):
        b, h, w, c = x.shape
        nh_ = self.num_heads
        hd = c // nh_
        q = self.q(x).reshape(b, h * w, nh_, hd).transpose(1, 2)           # (b, H, q, hd)
        kv_in = x
        if self.sr_ratio > 1:
            kv_in = self.sr_norm(conv_nhwc(self.sr, x))
        hk, wk = kv_in.shape[1], kv_in.shape[2]
        kv = self.kv(kv_in).reshape(b, hk * wk, 2, nh_, hd)
        k, v = kv[:, :, 0].transpose(1, 2), kv[:, :, 1].transpose(1, 2)    # (b, H, k, hd)
        attn = torch.softmax((q * hd**-0.5) @ k.transpose(-1, -2), dim=-1)
        out = (attn @ v).transpose(1, 2).reshape(b, h, w, c)
        return self.proj(out)


class Block(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: int, use_window: bool,
                 sr_ratio: int = 1, window: int = 8) -> None:
        super().__init__()
        self.norm1 = layer_norm(dim)
        self.norm2 = layer_norm(dim)
        if use_window:
            self.attn = LocallyGroupedAttention(dim, num_heads, window)
        else:
            self.attn = GlobalSubsampledAttention(dim, num_heads, sr_ratio)
        self.mlp = Mlp(dim, dim * mlp_ratio, dim)

    def forward(self, x):
        x = x + self.attn(self.norm1(x)).to(x.dtype)
        return x + self.mlp(self.norm2(x)).to(x.dtype)


class PosConv(nn.Module):
    """PEG: depthwise 3x3 conv positional encoding."""

    def __init__(self, dim: int) -> None:
        super().__init__()
        self.proj = nn.Conv2d(dim, dim, 3, groups=dim)

    def forward(self, x):
        return x + conv_nhwc(self.proj, x).to(x.dtype)


class TwinsSVT(nn.Module):
    """First-two-stage Twins-SVT encoder, (B,H,W,3) -> (B, H/8, W/8, 256)."""

    def __init__(self, embed_dims: Sequence[int] = (128, 256), depths: Sequence[int] = (2, 2),
                 num_heads: Sequence[int] = (4, 8), sr_ratios: Sequence[int] = (8, 4),
                 mlp_ratios: Sequence[int] = (4, 4), patch_sizes: Sequence[int] = (4, 2),
                 window: int = 8, in_chans: int = 3) -> None:
        super().__init__()
        self.depths = tuple(depths)
        prev = in_chans
        for s, dim in enumerate(embed_dims):
            p = patch_sizes[s]
            setattr(self, f"patch_embed{s}", nn.Conv2d(prev, dim, p, stride=p))
            setattr(self, f"embed_norm{s}", layer_norm(dim))
            for i in range(depths[s]):
                setattr(self, f"stage{s}_block{i}", Block(
                    dim, num_heads[s], mlp_ratios[s], use_window=(i % 2 == 0),
                    sr_ratio=sr_ratios[s], window=window))
            setattr(self, f"peg{s}", PosConv(dim))
            setattr(self, f"stage_norm{s}", layer_norm(dim))
            prev = dim
        self.num_stages = len(embed_dims)

    def forward(self, x):
        for s in range(self.num_stages):
            x = conv_nhwc(getattr(self, f"patch_embed{s}"), x)
            x = getattr(self, f"embed_norm{s}")(x)
            for i in range(self.depths[s]):
                x = getattr(self, f"stage{s}_block{i}")(x)
                if i == 0:
                    x = getattr(self, f"peg{s}")(x)
            x = getattr(self, f"stage_norm{s}")(x)
        return x
