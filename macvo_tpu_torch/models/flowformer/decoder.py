"""FlowFormerCov recurrent decoder with the covariance branch
(port of ``macvo_tpu/models/flowformer/decoder.py``).

Runs NCHW inside. The 12 steps are a Python loop over one shared
``DecoderIteration`` (the flax ``nn.scan`` with broadcast params). The fp32
islands of the flax model stay fp32 under autocast: cost sampling
(:func:`encode_flow_token`), the latent-memory softmax, GMA's softmax and the
convex upsampling.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .twins import gelu


def coords_grid(batch: int, height: int, width: int, device, dtype=torch.float32) -> torch.Tensor:
    """(B,2,H,W) grid of (x,y) = (u,v) pixel coordinates."""
    ys, xs = torch.meshgrid(torch.arange(height, device=device, dtype=dtype),
                            torch.arange(width, device=device, dtype=dtype), indexing="ij")
    return torch.stack([xs, ys], dim=0)[None].expand(batch, 2, height, width)


def _no_autocast(x: torch.Tensor):
    return torch.autocast(device_type=x.device.type, enabled=False)


def encode_flow_token(cost_maps: torch.Tensor, coords: torch.Tensor, radius: int = 4) -> torch.Tensor:
    """Bilinear samples of a (2r+1)^2 window of each source pixel's cost map
    around its target coords, zero outside the map -> (B, (2r+1)^2, H1, W1) fp32.

    cost_maps (B, H1*W1, H2, W2), any float dtype; coords (B, 2, H1, W1).
    Channel ``i*(2r+1) + j`` is the sample at (x + j - r, y + i - r), as the
    tent-weight matmuls of the JAX version order it. Implemented as four
    gathers (the bilinear corners) from the maps in their own dtype, with fp32
    weights and sums; a corner outside the map contributes zero, which is the
    tent weight's edge convention.
    """
    b, n1, h2, w2 = cost_maps.shape
    h1, w1 = coords.shape[2], coords.shape[3]
    k = 2 * radius + 1
    n = b * n1
    with _no_autocast(coords):
        maps = cost_maps.reshape(n, h2 * w2)
        centers = coords.float().permute(0, 2, 3, 1).reshape(n, 2)
        offs = torch.arange(-radius, radius + 1, device=coords.device, dtype=torch.float32)
        py = centers[:, 1:2] + offs                       # (n, k) rows
        px = centers[:, 0:1] + offs                       # (n, k) cols
        y0, x0 = torch.floor(py), torch.floor(px)
        wy, wx = py - y0, px - x0

        def corner(yi, xi):
            inb = (yi >= 0) & (yi <= h2 - 1)
            inb = inb[:, :, None] & ((xi >= 0) & (xi <= w2 - 1))[:, None, :]
            yc = yi.clamp(0, h2 - 1).long()
            xc = xi.clamp(0, w2 - 1).long()
            idx = (yc[:, :, None] * w2 + xc[:, None, :]).reshape(n, k * k)
            vals = torch.gather(maps, 1, idx).float().reshape(n, k, k)
            return vals * inb

        wy_, wx_ = wy[:, :, None], wx[:, None, :]
        out = (corner(y0, x0) * (1 - wx_) * (1 - wy_) + corner(y0, x0 + 1) * wx_ * (1 - wy_)
               + corner(y0 + 1, x0) * (1 - wx_) * wy_ + corner(y0 + 1, x0 + 1) * wx_ * wy_)
        return out.reshape(b, h1, w1, k * k).permute(0, 3, 1, 2)


def upsample_convex(flow: torch.Tensor, mask: torch.Tensor, factor: int = 8) -> torch.Tensor:
    """Convex x8 upsampling, fp32: (B,C,H,W) flow, (B,9*f*f,H,W) mask -> (B,C,fH,fW)."""
    with _no_autocast(flow):
        flow, mask = flow.float(), mask.float()
        b, c, h, w = flow.shape
        f = factor
        weights = torch.softmax(mask.reshape(b, f * f, 9, h, w), dim=2)
        neigh = F.unfold(flow * f, 3, padding=1).reshape(b, c, 9, h, w)
        up = torch.einsum("bknhw,bcnhw->bckhw", weights, neigh)
        up = up.reshape(b, c, f, f, h, w).permute(0, 1, 4, 2, 5, 3)
        return up.reshape(b, c, h * f, w * f)


def SameConv(cin: int, cout: int, kernel) -> nn.Conv2d:
    """Stride-1 Conv2d with flax ``SAME`` padding (odd kernels: k//2 each side)."""
    kh, kw = (kernel, kernel) if isinstance(kernel, int) else kernel
    return nn.Conv2d(cin, cout, (kh, kw), padding=(kh // 2, kw // 2))


class SepConvGRU(nn.Module):
    """Separable 1x5 / 5x1 convolutional GRU."""

    def __init__(self, hidden_dim: int = 128, input_dim: int = 384) -> None:
        super().__init__()
        cin = hidden_dim + input_dim
        for axis, kernel in (("h", (1, 5)), ("v", (5, 1))):
            for gate in ("z", "r", "q"):
                setattr(self, f"{axis}_{gate}", SameConv(cin, hidden_dim, kernel))

    def forward(self, h, x):
        for axis in ("h", "v"):
            hx = torch.cat([h, x], dim=1)
            z = torch.sigmoid(getattr(self, f"{axis}_z")(hx))
            r = torch.sigmoid(getattr(self, f"{axis}_r")(hx))
            q = torch.tanh(getattr(self, f"{axis}_q")(torch.cat([r * h, x], dim=1)))
            h = (1 - z) * h + z * q
        return h


class MotionEncoder(nn.Module):
    def __init__(self, corr_dim: int = 209) -> None:
        super().__init__()
        self.convc1 = SameConv(corr_dim, 256, 1)
        self.convc2 = SameConv(256, 192, 3)
        self.convf1 = SameConv(2, 128, 7)
        self.convf2 = SameConv(128, 64, 3)
        self.conv = SameConv(256, 126, 3)

    def forward(self, flow, corr):
        c = F.relu(self.convc2(F.relu(self.convc1(corr))))
        f = F.relu(self.convf2(F.relu(self.convf1(flow))))
        out = self.conv(torch.cat([c, f], dim=1))
        return torch.cat([F.relu(out), flow.to(out.dtype)], dim=1)


class GMAAttention(nn.Module):
    def __init__(self, dim: int = 128) -> None:
        super().__init__()
        self.dim = dim
        self.to_q = SameConv(dim, dim, 1)
        self.to_k = SameConv(dim, dim, 1)

    def forward(self, context):
        b, _, h, w = context.shape
        q = self.to_q(context).reshape(b, self.dim, h * w).transpose(1, 2) * self.dim**-0.5
        k = self.to_k(context).reshape(b, self.dim, h * w)
        attn = torch.bmm(q, k)
        with _no_autocast(attn):
            return torch.softmax(attn.float(), dim=-1).to(q.dtype)


class GMAAggregator(nn.Module):
    def __init__(self, dim: int = 128) -> None:
        super().__init__()
        self.dim = dim
        self.to_v = SameConv(dim, dim, 1)
        self.gamma = nn.Parameter(torch.zeros(1))

    def forward(self, attn, motion):
        b, _, h, w = motion.shape
        v = self.to_v(motion).reshape(b, self.dim, h * w).transpose(1, 2)
        agg = torch.bmm(attn.to(v.dtype), v).transpose(1, 2).reshape(b, self.dim, h, w)
        return motion + self.gamma.to(agg.dtype) * agg.to(motion.dtype)


class FlowHead(nn.Module):
    def __init__(self, in_dim: int = 128, hidden: int = 256, out_dim: int = 2) -> None:
        super().__init__()
        self.conv1 = SameConv(in_dim, hidden, 3)
        self.conv2 = SameConv(hidden, out_dim, 3)

    def forward(self, x):
        return self.conv2(F.relu(self.conv1(x)))


class CovHead(nn.Module):
    def __init__(self, in_dim: int = 128, hidden: int = 256) -> None:
        super().__init__()
        self.conv1 = SameConv(in_dim, hidden, 3)
        self.conv2 = SameConv(hidden, hidden // 2, 3)
        self.conv3 = SameConv(hidden // 2, hidden // 4, 3)
        self.conv4 = SameConv(hidden // 4, 2, 3)

    def forward(self, x):
        x = self.conv1(x)
        x = self.conv2(F.relu(x))
        x = self.conv3(x)
        return self.conv4(F.relu(x))


class MaskHead(nn.Module):
    def __init__(self, in_dim: int = 128) -> None:
        super().__init__()
        self.conv1 = SameConv(in_dim, 256, 3)
        self.conv2 = SameConv(256, 64 * 9, 1)

    def forward(self, x):
        return self.conv2(F.relu(self.conv1(x)))


class DecoderIteration(nn.Module):
    """One step: cost lookup -> latent-memory attention -> GMA -> twin GRUs ->
    flow / cov deltas."""

    def __init__(self, query_latent_dim: int = 64, cost_latent_dim: int = 128) -> None:
        super().__init__()
        self.cost_latent_dim = cost_latent_dim
        self.fte1 = SameConv(81, 128, 1)
        self.fte2 = SameConv(128, query_latent_dim, 1)
        self.dec_q = nn.Linear(query_latent_dim, cost_latent_dim)
        self.dec_out = nn.Linear(cost_latent_dim, cost_latent_dim)
        self.motion_enc = MotionEncoder(cost_latent_dim + 81)
        self.aggregator = GMAAggregator(128)
        self.flow_gru = SepConvGRU(128, 384)
        self.flow_head = FlowHead(128, 256, 2)
        self.cov_gru = SepConvGRU(128, 384)
        self.cov_head = CovHead(128, 256)

    def forward(self, state, inv):
        flow_coords1, cov_coords1, flow_net, fcov_net = state
        coords0, flow_inp = inv["coords0"], inv["flow_inp"]
        b, _, h1, w1 = flow_inp.shape
        dt = flow_inp.dtype

        flow = (flow_coords1 - coords0).to(dt)
        cost_forward = encode_flow_token(inv["cost_maps"], flow_coords1).to(dt)
        query = self.fte2(gelu(self.fte1(cost_forward)))
        q = self.dec_q(query.permute(0, 2, 3, 1).reshape(b * h1 * w1, 1, -1))
        scores = torch.bmm(q * self.cost_latent_dim**-0.5, inv["mem_k"].transpose(1, 2))
        with _no_autocast(scores):
            attn = torch.softmax(scores.float(), dim=-1).to(q.dtype)        # (n, 1, 8)
        agg = torch.bmm(attn, inv["mem_v"].to(q.dtype))
        cost_global = self.dec_out(agg).reshape(b, h1, w1, -1).permute(0, 3, 1, 2)
        corr = torch.cat([cost_global.to(dt), cost_forward], dim=1)

        motion_feat = self.motion_enc(flow, corr)
        motion_global = self.aggregator(inv["attention"], motion_feat)
        inp_cat = torch.cat([flow_inp, motion_feat.to(dt), motion_global.to(dt)], dim=1)

        flow_net = self.flow_gru(flow_net, inp_cat)
        delta_flow = self.flow_head(flow_net).float()
        fcov_net = self.cov_gru(fcov_net, inp_cat)
        delta_cov = self.cov_head(fcov_net).float()
        return flow_coords1 + delta_flow, cov_coords1 + delta_cov, flow_net, fcov_net


class MemoryCovDecoder(nn.Module):
    """cost_memory + context + cost_maps -> (flow, cov) after ``decoder_depth``
    steps. ``inference_only`` returns the final full-res pair and the low-res
    pair; otherwise (training) also the per-step full-res stacks
    ``flow_predictions`` / ``cov_predictions`` (depth, B, 8H, 8W, 2) for the
    sequence loss. One code path serves both: the mask heads and the convex
    upsampling run once over the kept states (the final one, or all depth*B). The coordinates are not detached between
    steps, as in the JAX package."""

    def __init__(self, decoder_depth: int = 12, query_latent_dim: int = 64,
                 cost_latent_dim: int = 128, ctx_dim: int = 256, inference_only: bool = False) -> None:
        super().__init__()
        self.decoder_depth = decoder_depth
        self.inference_only = inference_only
        self.proj = SameConv(ctx_dim, 256, 3)
        self.att = GMAAttention(128)
        self.mem_k = nn.Linear(cost_latent_dim, cost_latent_dim)
        self.mem_v = nn.Linear(cost_latent_dim, cost_latent_dim)
        self.iteration = DecoderIteration(query_latent_dim, cost_latent_dim)
        self.flow_mask = MaskHead(128)
        self.cov_mask = MaskHead(128)

    def forward(self, cost_memory, context, cost_maps, compute_dtype=torch.float32):
        """context (B,H1,W1,C) fp32 channel-last; returns channel-last outputs."""
        b, h1, w1, _ = context.shape
        dt = compute_dtype
        coords0 = coords_grid(b, h1, w1, context.device)
        with _no_autocast(context):
            proj = self.proj(context.permute(0, 3, 1, 2).float())
        flow_net0 = torch.tanh(proj[:, :128]).to(dt)
        flow_inp = F.relu(proj[:, 128:]).to(dt)
        attention = self.att(flow_inp)
        mem_k = self.mem_k(cost_memory.to(dt))
        mem_v = self.mem_v(cost_memory.to(dt))
        inv = {"coords0": coords0, "cost_maps": cost_maps, "flow_inp": flow_inp,
               "attention": attention, "mem_k": mem_k, "mem_v": mem_v}
        state = (coords0, coords0, flow_net0, flow_net0)
        steps = []
        for _ in range(self.decoder_depth):
            state = self.iteration(state, inv)
            if not self.inference_only:
                steps.append(state)
        if self.inference_only:
            steps = [state]
        out = {"flow_lowres": (state[0] - coords0).permute(0, 2, 3, 1),
               "cov_lowres": (state[1] - coords0).permute(0, 2, 3, 1)}
        # One mask-head + upsampling pass over the kept steps, (depth*B, ...).
        depth = len(steps)
        flows_lr = torch.cat([s[0] - coords0 for s in steps])
        covs_lr = torch.cat([s[1] - coords0 for s in steps])
        up_masks = 0.25 * self.flow_mask(torch.cat([s[2] for s in steps])).float()
        cmasks = 0.25 * self.cov_mask(torch.cat([s[3] for s in steps])).float()

        def stack(x):   # (depth*B, 2, 8H, 8W) -> (depth, B, 8H, 8W, 2)
            return x.permute(0, 2, 3, 1).reshape((depth, b) + x.shape[2:] + (x.shape[1],))

        flows, covs = stack(upsample_convex(flows_lr, up_masks)), stack(upsample_convex(covs_lr, cmasks))
        out["flow_final"], out["cov_final"] = flows[-1], covs[-1]
        if not self.inference_only:
            out["flow_predictions"], out["cov_predictions"] = flows, covs
        return out
