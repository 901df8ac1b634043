"""Stereo disparity network with covariance decoder
(port of ``macvo_tpu/models/tartanvo/stereonet.py``).

A shared-weight siamese feature extractor at 1/2 resolution, an hourglass
encoder with skips down to 1/64, and two decoders on the shared context: one
for disparity (scaled by ``1/normalize_factor``), one for its variance.
Channel-last at the public boundary, NCHW inside; flax pooling is ``VALID``
(floors odd sizes), every stride-2 conv pads flax ``SAME`` (:func:`conv_same`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..flowformer.twins import conv_same
from .pwc import conv3x3, up_conv


class ResBlock(nn.Module):
    def __init__(self, cin: int, dim: int, stride: int = 1) -> None:
        super().__init__()
        self.conv1 = nn.Conv2d(cin, dim, 3, stride=stride)
        self.conv2 = conv3x3(dim, dim)
        self.short = nn.Conv2d(cin, dim, 1, stride=stride) if cin != dim or stride != 1 else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv2(F.relu(conv_same(self.conv1, x)))
        if self.short is not None:
            x = conv_same(self.short, x)
        return F.relu(x + y)


class SiameseFeature(nn.Module):
    """Per-image feature extractor at 1/2 resolution, 64 channels."""

    def __init__(self) -> None:
        super().__init__()
        self.stem = nn.Conv2d(3, 32, 3, stride=2)
        self.res1 = ResBlock(32, 32)
        self.res2 = ResBlock(32, 48)
        self.res3 = ResBlock(48, 64)

    def forward(self, img: torch.Tensor) -> torch.Tensor:
        x = F.relu(conv_same(self.stem, img))
        return self.res3(self.res2(self.res1(x)))


class HourglassEncoder(nn.Module):
    """1/2 -> 1/64 encoder, returns bottleneck + skip features."""

    DIMS = (64, 128, 192, 256, 384)

    def __init__(self, cin: int = 64) -> None:
        super().__init__()
        for i, dim in enumerate(self.DIMS):
            setattr(self, f"enc{i}a", ResBlock(cin, dim))
            cin = dim
        self.bottleneck = conv3x3(cin, 512)

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, list[torch.Tensor]]:
        skips = []
        for i in range(len(self.DIMS)):
            x = getattr(self, f"enc{i}a")(x)
            skips.append(x)
            x = F.max_pool2d(x, 2)
        return F.relu(self.bottleneck(x)), skips


class HourglassDecoder(nn.Module):
    """Bottleneck + skips -> full-res map."""

    DIMS = (320, 192, 128, 64, 64)

    def __init__(self, out_channels: int = 1, final_softplus: bool = False) -> None:
        super().__init__()
        cin = 512
        for i, (dim, skip) in enumerate(zip(self.DIMS, reversed(HourglassEncoder.DIMS))):
            setattr(self, f"dec{i}", up_conv(cin, dim))
            cin = dim + skip
        self.dec_full = up_conv(cin, 64)
        self.head1 = nn.Conv2d(64, 16, 1)
        self.head2 = nn.Conv2d(16, out_channels, 1)
        self.final_softplus = final_softplus

    def forward(self, x: torch.Tensor, skips: list[torch.Tensor]) -> torch.Tensor:
        for i in range(len(self.DIMS)):
            x = torch.cat([F.relu(getattr(self, f"dec{i}")(x)), skips[-(i + 1)]], dim=1)
        x = F.relu(self.head1(F.relu(self.dec_full(x))))
        out = self.head2(x)
        return F.softplus(out) if self.final_softplus else out


class StereoCovNet(nn.Module):
    """(imgL, imgR) (B,H,W,3) -> (disparity (B,H,W,1), disparity variance (B,H,W,1))."""

    def __init__(self, normalize_factor: float = 0.02) -> None:
        super().__init__()
        self.normalize_factor = normalize_factor
        self.feature = SiameseFeature()
        self.fuse = conv3x3(64 + 64 + 6, 64)
        self.encoder = HourglassEncoder()
        self.disp_decoder = HourglassDecoder(1, final_softplus=True)
        self.cov_decoder = HourglassDecoder(1, final_softplus=True)

    def forward(self, img_l: torch.Tensor, img_r: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        b = img_l.shape[0]
        imgs = torch.cat([img_l, img_r], dim=0).permute(0, 3, 1, 2).contiguous()
        f_l, f_r = self.feature(imgs).split(b, dim=0)
        # 1/2-res image context: the two images' channels side by side.
        img_ds = F.avg_pool2d(torch.cat([imgs[:b], imgs[b:]], dim=1), 2)
        x = F.relu(self.fuse(torch.cat([f_l, f_r, img_ds], dim=1)))
        bottleneck, skips = self.encoder(x)
        disparity = self.disp_decoder(bottleneck, skips) / self.normalize_factor
        disparity_cov = self.cov_decoder(bottleneck, skips)
        return disparity.permute(0, 2, 3, 1), disparity_cov.permute(0, 2, 3, 1)
