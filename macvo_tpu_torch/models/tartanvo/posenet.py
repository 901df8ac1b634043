"""VOFlowRes pose-regression head (port of ``macvo_tpu/models/tartanvo/posenet.py``).

A ResNet over the (flow, normalized inverse depth, intrinsics layer) stack at
112x160, with separate translation and rotation heads giving a 6-d se3
(scaled by ``POSE_NORM`` downstream). Channel-last input, NCHW inside; every
stride-2 conv pads flax ``SAME`` (:func:`conv_same`).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..flowformer.twins import conv_same
from .pwc import conv3x3


class BasicBlock(nn.Module):
    def __init__(self, cin: int, dim: int, stride: int = 1) -> None:
        super().__init__()
        self.conv1 = nn.Conv2d(cin, dim, 3, stride=stride)
        self.conv2 = conv3x3(dim, dim)
        self.down = nn.Conv2d(cin, dim, 1, stride=stride) if cin != dim or stride != 1 else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv2(F.relu(conv_same(self.conv1, x)))
        if self.down is not None:
            x = conv_same(self.down, x)
        return F.relu(x + y)


class VOFlowRes(nn.Module):
    """(B,H,W,C) motion stack -> (B,6) [trans(3), rot(3)] se3."""

    def __init__(self, cin: int = 5, blocknums: Sequence[int] = (2, 2, 3, 4, 6, 7, 3),
                 outputnums: Sequence[int] = (32, 64, 64, 128, 128, 256, 256)) -> None:
        super().__init__()
        self.stem1 = nn.Conv2d(cin, 32, 3, stride=2)
        self.stem2 = conv3x3(32, 32)
        self.stem3 = conv3x3(32, 32)
        self.blocks = []
        cin = 32
        for stage, (blocks, dim) in enumerate(zip(blocknums, outputnums)):
            for blk in range(blocks):
                name = f"stage{stage}_blk{blk}"
                setattr(self, name, BasicBlock(cin, dim, stride=2 if blk == 0 else 1))
                self.blocks.append(name)
                cin = dim
        for head in ("trans", "rot"):
            setattr(self, f"{head}_fc1", nn.Linear(cin, 128))
            setattr(self, f"{head}_fc2", nn.Linear(128, 32))
            setattr(self, f"{head}_fc3", nn.Linear(32, 3))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(conv_same(self.stem1, x.permute(0, 3, 1, 2).contiguous()))
        x = F.relu(self.stem3(F.relu(self.stem2(x))))
        for name in self.blocks:
            x = getattr(self, name)(x)
        x = x.mean(dim=(2, 3))   # global average pool -> (B, C)

        def head(name):
            h = F.relu(getattr(self, f"{name}_fc1")(x))
            h = F.relu(getattr(self, f"{name}_fc2")(h))
            return getattr(self, f"{name}_fc3")(h)

        return torch.cat([head("trans"), head("rot")], dim=-1)
