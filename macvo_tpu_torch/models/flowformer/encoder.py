"""FlowFormer memory encoder (port of ``macvo_tpu/models/flowformer/encoder.py``).

All-pairs cost volume between 1/8-resolution features, per-pixel cost-map
patch tokens, 8 latent tokens that cross-attend them (the fused kernel of
``ops/latent_attn.py``), then ``encoder_depth`` alternating intra-token
self-attention and vertical attention with context injection.

Outputs: ``cost_memory (B*H1*W1, 8, 128)`` and ``cost_maps (B, H1*W1, H2, W2)``.
"""

from __future__ import annotations

import torch
from torch import nn

from ...ops.latent_attn import fold_weights, latent_attn_folded
from .twins import Mlp, layer_norm


def all_pairs_correlation(feat1: torch.Tensor, feat2: torch.Tensor) -> torch.Tensor:
    """(B,H1,W1,C) x (B,H2,W2,C) -> cost maps (B, H1*W1, H2, W2) / sqrt(C)."""
    b, h1, w1, c = feat1.shape
    h2, w2 = feat2.shape[1], feat2.shape[2]
    cost = torch.bmm(feat1.reshape(b, h1 * w1, c), feat2.reshape(b, h2 * w2, c).transpose(1, 2))
    cost = cost / (c ** 0.5)
    return cost.reshape(b, h1 * w1, h2, w2)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Multi-head attention of (..., Lq, D) x (..., Lk, D): batched matmuls with
    the heads moved ahead of the sequence axis. This also serves the 8x8
    intra-latent attention that ``tiny_attention`` shapes for the TPU's VPU."""
    d = q.shape[-1]
    hd = d // num_heads

    def split(x):
        return x.reshape(x.shape[:-1] + (num_heads, hd)).transpose(-2, -3)   # (..., H, L, hd)

    qh, kh, vh = split(q), split(k), split(v)
    attn = torch.softmax((qh * hd**-0.5) @ kh.transpose(-1, -2), dim=-1)
    out = (attn @ vh).transpose(-2, -3)
    return out.reshape(out.shape[:-2] + (d,))


class CrossAttention(nn.Module):
    def __init__(self, in_dim: int, dim: int, num_heads: int = 1, kv_dim: int | None = None) -> None:
        super().__init__()
        self.num_heads = num_heads
        self.q = nn.Linear(in_dim, dim)
        self.k = nn.Linear(kv_dim or in_dim, dim)
        self.v = nn.Linear(kv_dim or in_dim, dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, q_in, kv_in):
        out = attention(self.q(q_in), self.k(kv_in), self.v(kv_in), self.num_heads)
        return self.proj(out)


class SelfAttentionLayer(nn.Module):
    """Pre-norm transformer layer over the latent-token axis."""

    def __init__(self, dim: int, num_heads: int = 8, mlp_ratio: int = 4) -> None:
        super().__init__()
        self.norm1 = layer_norm(dim)
        self.attn = CrossAttention(dim, dim, num_heads)
        self.norm2 = layer_norm(dim)
        self.mlp = Mlp(dim, dim * mlp_ratio, dim)

    def forward(self, x):
        h = self.norm1(x)
        x = x + self.attn(h, h).to(x.dtype)
        return x + self.mlp(self.norm2(x)).to(x.dtype)


class VerticalAttentionLayer(nn.Module):
    """Attention along the source image's vertical axis, per latent token,
    with projected context injection."""

    def __init__(self, dim: int, vert_c_dim: int, ctx_dim: int = 256, num_heads: int = 8,
                 mlp_ratio: int = 4) -> None:
        super().__init__()
        self.vert_c_dim = vert_c_dim
        self.ctx_proj = nn.Linear(ctx_dim, vert_c_dim)
        self.norm1 = layer_norm(dim)
        self.attn = CrossAttention(dim + vert_c_dim, dim, num_heads)
        self.norm2 = layer_norm(dim)
        self.mlp = Mlp(dim, dim * mlp_ratio, dim)

    def forward(self, x, context):
        # x: (B, H1, W1, K, D); context: (B, H1, W1, C_ctx)
        b, h1, w1, k, d = x.shape
        ctx = self.ctx_proj(context)
        ctx = ctx[:, :, :, None, :].expand(b, h1, w1, k, self.vert_c_dim)
        h_in = torch.cat([self.norm1(x).to(ctx.dtype), ctx], dim=-1)
        h_seq = h_in.permute(0, 2, 3, 1, 4).reshape(b * w1 * k, h1, d + self.vert_c_dim)
        attn_out = self.attn(h_seq, h_seq).reshape(b, w1, k, h1, d).permute(0, 3, 1, 2, 4)
        x = x + attn_out.to(x.dtype)
        return x + self.mlp(self.norm2(x)).to(x.dtype)


def _refold_after_load(module: "CostPerceiverEncoder", _incompatible_keys) -> None:
    module.fold_input_stage()


class CostPerceiverEncoder(nn.Module):
    """Cost maps -> latent cost memory.

    The input stage (input projection + latent cross-attention) has two forms.
    For inference it runs as the folded function of ``ops/latent_attn.py``: the
    kernel on CUDA tensors, its plain version on CPU tensors. Its weights are
    folded once, by :meth:`fold_input_stage`, into the non-persistent buffers
    ``fold_m``, ``fold_wvp`` and ``fold_c``, which follow the module's
    ``.to(device)``. When a gradient is wanted (grad mode on and a parameter
    or the cost maps require grad) it runs unfused, :meth:`input_stage`, the
    form the JAX package trains through (``fused_input=False``). A fused call
    refolds first when a weight of the input stage changed since the last
    fold (its version counter moved, as an optimizer step moves it), so
    evaluation during training never runs on stale folded weights."""

    def __init__(self, cost_latent_input_dim: int = 64, cost_latent_token_num: int = 8,
                 cost_latent_dim: int = 128, encoder_depth: int = 3, patch_size: int = 8,
                 vert_c_dim: int = 64, ctx_dim: int = 256) -> None:
        super().__init__()
        self.patch_size = patch_size
        self.encoder_depth = encoder_depth
        self.token_num = cost_latent_token_num
        self.latent_dim = cost_latent_dim
        d_in = cost_latent_input_dim
        self.patch_embed = nn.Linear(patch_size * patch_size, d_in)
        self.pos_proj = nn.Linear(2, d_in)
        self.latents = nn.Parameter(torch.zeros(1, cost_latent_token_num, cost_latent_dim))
        self.input_proj = nn.Linear(d_in, cost_latent_dim)
        self.input_attn = CrossAttention(cost_latent_dim, cost_latent_dim, num_heads=1)
        for i in range(encoder_depth):
            setattr(self, f"intra{i}", SelfAttentionLayer(cost_latent_dim))
            setattr(self, f"inter{i}", VerticalAttentionLayer(cost_latent_dim, vert_c_dim, ctx_dim))
        self.register_buffer("fold_m", torch.empty(d_in, cost_latent_token_num), persistent=False)
        self.register_buffer("fold_wvp", torch.empty(d_in, cost_latent_dim), persistent=False)
        self.register_buffer("fold_c", torch.empty(cost_latent_token_num, cost_latent_dim), persistent=False)
        self.fold_input_stage()
        self.register_load_state_dict_post_hook(_refold_after_load)

    def tokenize(self, cost_maps: torch.Tensor) -> torch.Tensor:
        """(B, N1, H2, W2) cost maps -> (B*N1, n_tok, 64) patch tokens + linear PE."""
        b, n1, h2, w2 = cost_maps.shape
        p = self.patch_size
        pad_h, pad_w = (-h2) % p, (-w2) % p
        x = cost_maps.reshape(b * n1, h2, w2)
        if pad_h or pad_w:
            x = nn.functional.pad(x, (0, pad_w, 0, pad_h))
        th, tw = (h2 + pad_h) // p, (w2 + pad_w) // p
        patches = x.reshape(b * n1, th, p, tw, p).permute(0, 1, 3, 2, 4).reshape(b * n1, th * tw, p * p)
        tokens = self.patch_embed(patches)
        dev = cost_maps.device
        ys = (torch.arange(th, dtype=torch.float32, device=dev) + 0.5) / th
        xs = (torch.arange(tw, dtype=torch.float32, device=dev) + 0.5) / tw
        gy, gx = torch.meshgrid(ys, xs, indexing="ij")
        coords = torch.stack([gx, gy], dim=-1).reshape(th * tw, 2)
        pos = self.pos_proj(2.0 * coords - 1.0)
        return (tokens + pos[None].to(tokens.dtype)).contiguous()

    @torch.no_grad()
    def fold_input_stage(self) -> None:
        """Fold input_proj, the query of the latents, the output projection and
        the latents into the kernel's (M, Wvp, c), in float64: first the
        folding of ``macvo_tpu/models/flowformer/encoder.py:209-234`` (input_proj
        into k and v), then :func:`fold_weights`. Runs at construction and after
        every ``load_state_dict``; call it again after changing the weights in
        place."""
        f64 = torch.float64
        w2, b2 = self.input_proj.weight.T.to(f64), self.input_proj.bias.to(f64)
        att = self.input_attn
        wk, bk = att.k.weight.T.to(f64), att.k.bias.to(f64)
        wv, bv = att.v.weight.T.to(f64), att.v.bias.to(f64)
        latents = self.latents[0].to(f64)
        q_eff = latents @ att.q.weight.T.to(f64) + att.q.bias.to(f64)
        folded = fold_weights(w2 @ wk, b2 @ wk + bk, w2 @ wv, b2 @ wv + bv, q_eff,
                              att.proj.weight.T.to(f64), latents + att.proj.bias.to(f64))
        for buf, value in zip((self.fold_m, self.fold_wvp, self.fold_c), folded):
            buf.copy_(value)
        self._folded_key = self._fold_key()

    def _fold_key(self) -> tuple:
        """Storage and version counter of each weight the fold reads."""
        att = self.input_attn
        weights = (self.latents, self.input_proj.weight, self.input_proj.bias) + tuple(
            p for lin in (att.q, att.k, att.v, att.proj) for p in (lin.weight, lin.bias))
        return tuple((p.data_ptr(), p._version) for p in weights)

    def input_stage(self, tokens: torch.Tensor) -> torch.Tensor:
        """Unfused input stage (``macvo_tpu/models/flowformer/encoder.py:235-240``):
        input_proj, k/v, softmax over the tokens, proj, plus the latents."""
        latents = self.latents.expand(tokens.shape[0], -1, -1)
        return latents.to(tokens.dtype) + self.input_attn(latents, self.input_proj(tokens))

    def fused_input_stage(self, tokens: torch.Tensor) -> torch.Tensor:
        """The folded input stage (the kernel on CUDA tensors), refolded first
        if a weight it reads changed since the last fold."""
        if self._fold_key() != self._folded_key:
            self.fold_input_stage()
        return latent_attn_folded(tokens, self.fold_m, self.fold_wvp, self.fold_c)

    def forward(self, cost_maps: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        b, n1 = cost_maps.shape[:2]
        h1, w1 = context.shape[1], context.shape[2]
        if n1 != h1 * w1:
            raise ValueError(f"cost maps hold {n1} source pixels, context is {h1}x{w1}")
        tokens = self.tokenize(cost_maps)
        if torch.is_grad_enabled() and (tokens.requires_grad or any(p.requires_grad for p in self.parameters())):
            x = self.input_stage(tokens)
        else:
            x = self.fused_input_stage(tokens)
        for i in range(self.encoder_depth):
            x = getattr(self, f"intra{i}")(x)
            grid = x.reshape(b, h1, w1, self.token_num, self.latent_dim)
            grid = getattr(self, f"inter{i}")(grid, context)
            x = grid.reshape(b * n1, self.token_num, self.latent_dim)
        return x


class MemoryEncoder(nn.Module):
    """feat1, feat2, context -> (cost_memory, cost_maps)."""

    def __init__(self, **kwargs) -> None:
        super().__init__()
        self.perceiver = CostPerceiverEncoder(**kwargs)

    def forward(self, feat1, feat2, context):
        cost_maps = all_pairs_correlation(feat1, feat2)
        return self.perceiver(cost_maps, context), cost_maps
