"""PWC-DC optical-flow network, TartanVO's flow core (port of ``macvo_tpu/models/tartanvo/pwc.py``).

Channel-last at the public boundary like the flax model, NCHW inside: the
convolutions and the 9x9 local correlation (``ops/correlation.py``, the
hand-written kernel on the card) run NCHW. Hazards carried over from flax:
every stride-2 ``SAME`` conv pads unevenly (:func:`conv_same`), a flax
``ConvTranspose`` is a ``ConvTranspose2d(k=4, s=2, padding=1)`` whose kernel
the loader flips, and the feature warp is the JAX package's zero-padded
bilinear gather with an in-bounds mask, not ``grid_sample`` (whose
normalized-coordinate rounding moves the in-bounds test at the border).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.correlation import local_correlation
from ..flowformer.decoder import coords_grid
from ..flowformer.twins import conv_same

LEVEL_DIMS = (16, 32, 64, 96, 128, 196)
DENSE_DIMS = (128, 128, 96, 64, 32)
WARP_SCALES = {4: 0.625, 3: 1.25, 2: 2.5, 1: 5.0}


def _leaky(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, 0.1)


def conv3x3(cin: int, cout: int, dilation: int = 1) -> nn.Conv2d:
    """Stride-1 3x3 conv; flax ``SAME`` is symmetric here."""
    return nn.Conv2d(cin, cout, 3, padding=dilation, dilation=dilation)


def up_conv(cin: int, cout: int) -> nn.ConvTranspose2d:
    """flax ``ConvTranspose(cout, (4, 4), strides=(2, 2), padding="SAME")``."""
    return nn.ConvTranspose2d(cin, cout, 4, stride=2, padding=1)


def bilinear_sample(img: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Sample (B,C,H,W) maps at float (B,2,h,w) (x,y) coords, zero outside
    (the JAX package's ``bilinear_sample``, NCHW) -> (B,C,h,w)."""
    b, c, h, w = img.shape
    flat = img.reshape(b, c, h * w)
    x, y = coords[:, 0], coords[:, 1]
    x0, y0 = torch.floor(x), torch.floor(y)
    wx, wy = (x - x0)[:, None], (y - y0)[:, None]

    def gather(xi, yi):
        inb = (xi >= 0) & (xi <= w - 1) & (yi >= 0) & (yi <= h - 1)
        idx = yi.clamp(0, h - 1).long() * w + xi.clamp(0, w - 1).long()
        vals = torch.gather(flat, 2, idx.reshape(b, 1, -1).expand(b, c, -1)).reshape(b, c, *x.shape[1:])
        return vals * inb[:, None]

    v00, v01 = gather(x0, y0), gather(x0 + 1, y0)
    v10, v11 = gather(x0, y0 + 1), gather(x0 + 1, y0 + 1)
    return v00 * (1 - wx) * (1 - wy) + v01 * wx * (1 - wy) + v10 * (1 - wx) * wy + v11 * wx * wy


def warp_features(feat: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Backward-warp (B,C,H,W) features by a (B,2,H,W) flow; a pixel whose
    target lies outside the map is zero."""
    b, _, h, w = feat.shape
    coords = coords_grid(b, h, w, feat.device) + flow
    inb = ((coords[:, 0] >= 0) & (coords[:, 0] <= w - 1)
           & (coords[:, 1] >= 0) & (coords[:, 1] <= h - 1))
    return bilinear_sample(feat, coords) * inb[:, None]


class PyramidEncoder(nn.Module):
    """6-level stride-2 pyramid; each level = 3 leaky convs."""

    def __init__(self, dims: Sequence[int] = LEVEL_DIMS) -> None:
        super().__init__()
        self.dims = tuple(dims)
        cin = 3
        for lvl, dim in enumerate(self.dims):
            setattr(self, f"conv{lvl}a", nn.Conv2d(cin, dim, 3, stride=2))
            setattr(self, f"conv{lvl}b", conv3x3(dim, dim))
            setattr(self, f"conv{lvl}c", conv3x3(dim, dim))
            cin = dim

    def forward(self, x: torch.Tensor, levels: int | None = None) -> list[torch.Tensor]:
        """The first ``levels`` levels (all by default), finest first."""
        feats = []
        for lvl in range(len(self.dims) if levels is None else levels):
            x = _leaky(conv_same(getattr(self, f"conv{lvl}a"), x))
            x = _leaky(getattr(self, f"conv{lvl}b")(x))
            x = _leaky(getattr(self, f"conv{lvl}c")(x))
            feats.append(x)
        return feats


class DenseFlowEstimator(nn.Module):
    """DenseNet-connected flow decoder block; returns (features, flow)."""

    def __init__(self, cin: int) -> None:
        super().__init__()
        for i, dim in enumerate(DENSE_DIMS):
            setattr(self, f"conv{i}", conv3x3(cin, dim))
            cin += dim
        self.predict = conv3x3(cin, 2)
        self.out_channels = cin

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        for i in range(len(DENSE_DIMS)):
            x = torch.cat([_leaky(getattr(self, f"conv{i}")(x)), x], dim=1)
        return x, self.predict(x)


class ContextNet(nn.Module):
    """Dilated refinement network at the finest decode level."""

    DILATED = ((128, 1), (128, 2), (128, 4), (96, 8), (64, 16), (32, 1))

    def __init__(self, cin: int) -> None:
        super().__init__()
        for i, (dim, d) in enumerate(self.DILATED):
            setattr(self, f"dc{i}", conv3x3(cin, dim, d))
            cin = dim
        self.dc_out = conv3x3(cin, 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(len(self.DILATED)):
            x = _leaky(getattr(self, f"dc{i}")(x))
        return self.dc_out(x)


class PWCFlowNet(nn.Module):
    """(img1, img2) (B,H,W,3), H and W multiples of 64 -> flow at 1/4
    resolution (B,H/4,W/4,2), scaled by ``1/flow_norm`` as trained."""

    def __init__(self, md: int = 4) -> None:
        super().__init__()
        self.md = md
        k2 = (2 * md + 1) ** 2
        self.pyramid = PyramidEncoder()
        for lvl in range(5, 0, -1):
            cin = k2 if lvl == 5 else k2 + LEVEL_DIMS[lvl] + 4
            est = DenseFlowEstimator(cin)
            setattr(self, f"estimator{lvl}", est)
            if lvl > 1:
                setattr(self, f"upflow{lvl}", up_conv(2, 2))
                setattr(self, f"upfeat{lvl}", up_conv(est.out_channels, 2))
        self.context = ContextNet(self.estimator1.out_channels)

    def forward(self, img1: torch.Tensor, img2: torch.Tensor, return_features: bool = False):
        """Flow (B,H/4,W/4,2); with ``return_features`` also the last
        estimator's features (B,H/4,W/4,C), channel-last like the flow."""
        b = img1.shape[0]
        imgs = torch.cat([img1, img2], dim=0).permute(0, 3, 1, 2).contiguous()
        feats = [f.split(b, dim=0) for f in self.pyramid(imgs)]
        up_flow = up_feat = x = flow = None
        for lvl in range(5, 0, -1):   # pyramid levels 1/64 .. 1/4
            f1, f2 = feats[lvl][0].contiguous(), feats[lvl][1].contiguous()
            if up_flow is None:
                x = _leaky(local_correlation(f1, f2, self.md))
            else:
                warped = warp_features(f2, up_flow * WARP_SCALES[lvl])
                corr = _leaky(local_correlation(f1, warped, self.md))
                x = torch.cat([corr, f1, up_flow, up_feat], dim=1)
            x, flow = getattr(self, f"estimator{lvl}")(x)
            if lvl > 1:
                up_flow = getattr(self, f"upflow{lvl}")(flow)
                up_feat = getattr(self, f"upfeat{lvl}")(x)
        flow = (flow + self.context(x)).permute(0, 2, 3, 1)
        if return_features:
            return flow, x.permute(0, 2, 3, 1)
        return flow
