"""RAFT-style recurrent flow-covariance net on PWC features
(port of ``macvo_tpu/models/tartanvo/raftcov.py``).

The PWC flow net gives the flow; two context pyramids (one for each image) give
1/4-resolution features and their 9x9 local correlation, from which a
``GaussianGRU`` refines a log-sigma map over ``iters`` recurrent steps. The
flax ``nn.scan`` of shared weights is one ``GaussianIteration`` called in a
loop. Channel-last at the public boundary like the flax model, NCHW inside.
A pair runs the correlation six times: five in the PWC and one here. Only
the first two levels of each context pyramid are computed (the 1/4 one is
used; the flax model's unused levels have parameters, which load as usual).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.correlation import local_correlation
from ..flowformer.decoder import SameConv, SepConvGRU
from .pwc import LEVEL_DIMS, PWCFlowNet, PyramidEncoder

HIDDEN = 128
CTX_DIM = LEVEL_DIMS[1]   # the 1/4-resolution pyramid level


class GaussianHead(nn.Module):
    """Two-conv log-sigma head."""

    def __init__(self, cin: int = HIDDEN) -> None:
        super().__init__()
        self.conv1 = SameConv(cin, 256, 3)
        self.conv2 = SameConv(256, 2, 3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv2(F.relu(self.conv1(x)))


class GaussianIteration(nn.Module):
    """One GRU refinement step of the covariance state (net, cov)."""

    def __init__(self, corr_dim: int = 81) -> None:
        super().__init__()
        self.enc_corr = SameConv(corr_dim, 128, 3)
        self.enc_cov = SameConv(2, 64, 7)
        self.gru = SepConvGRU(HIDDEN, 128 + 64 + HIDDEN)
        self.head = GaussianHead()

    def forward(self, net, cov, inp, corr):
        feat = torch.cat([F.relu(self.enc_corr(corr)), F.relu(self.enc_cov(cov)), inp], dim=1)
        net = self.gru(net, feat)
        return net, cov + self.head(net)


class GaussianGRU(nn.Module):
    """(context, correlation) NCHW -> per-iteration log-sigma maps (iters, B, 2, h, w)."""

    def __init__(self, iters: int = 4, ctx_dim: int = CTX_DIM) -> None:
        super().__init__()
        self.iters = iters
        self.ctx_proj = SameConv(ctx_dim, 256, 3)
        self.iter = GaussianIteration()

    def forward(self, context: torch.Tensor, corr: torch.Tensor) -> torch.Tensor:
        proj = self.ctx_proj(context)
        net, inp = torch.tanh(proj[:, :HIDDEN]), F.relu(proj[:, HIDDEN:])
        cov = torch.zeros_like(context[:, :2])
        covs = []
        for _ in range(self.iters):
            net, cov = self.iter(net, cov, inp, corr)
            covs.append(cov)
        return torch.stack(covs, 0)


class RAFTFlowCovNet(nn.Module):
    """(img1, img2) (B,H,W,3), H and W multiples of 64 -> (flow (B,H/4,W/4,2)
    scaled by ``1/flow_norm`` as trained, log-sigma stack (iters,B,H/4,W/4,2)).

    The covariance trainer freezes ``pwc`` (``requires_grad_(False)``): its
    flow only enters a stop-gradient, so the PWC then builds no autograd
    graph and only the covariance branch (with the context correlation) has a
    backward."""

    def __init__(self, iters: int = 4) -> None:
        super().__init__()
        self.pwc = PWCFlowNet()
        self.ctx_pyramid = PyramidEncoder()
        self.ctx_pyramid2 = PyramidEncoder()
        self.gaussian = GaussianGRU(iters)

    def forward(self, img1: torch.Tensor, img2: torch.Tensor):
        flow, _ = self.pwc(img1, img2, return_features=True)
        ctx = self.ctx_pyramid(img1.permute(0, 3, 1, 2).contiguous(), levels=2)[1]
        ctx2 = self.ctx_pyramid2(img2.permute(0, 3, 1, 2).contiguous(), levels=2)[1]
        corr = local_correlation(ctx.contiguous(), ctx2.contiguous())
        covs = self.gaussian(ctx, F.relu(corr))
        return flow, covs.permute(0, 1, 3, 4, 2)
