"""Device selection shared by every entry point of the port."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """``cuda`` (the default everywhere) or ``cpu``; CUDA without a card raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' was asked for but torch.cuda.is_available() is False; "
                           "pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}: use 'cuda' or 'cpu'")
    return dev
