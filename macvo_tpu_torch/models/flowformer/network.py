"""FlowFormerCov: joint optical-flow + covariance network
(port of ``macvo_tpu/models/flowformer/network.py``).

Images (B,H,W,3) in [0,1] are normalized to [-1,1]; the Twins context and
feature encoders, the memory encoder and the recurrent cov decoder follow.
The stages are separate methods (``features`` / ``context`` / ``decode``) so
the VO frontend can cache the previous frame's encoder outputs.

Precision: ``encoder_dtype`` / ``decoder_dtype`` of ``"bf16"`` run that part
under ``torch.autocast(dtype=bfloat16)``; ``"fp32"`` runs it in full fp32
(the frontend turns TF32 off for fp32 configs).
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from .decoder import MemoryCovDecoder
from .encoder import MemoryEncoder
from .twins import TwinsSVT

_DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16, "fp16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class FlowFormerConfig:
    """latentcostformer hyperparameters (same defaults as the JAX package)."""

    cost_latent_input_dim: int = 64
    cost_latent_token_num: int = 8
    cost_latent_dim: int = 128
    encoder_depth: int = 3
    patch_size: int = 8
    vert_c_dim: int = 64
    query_latent_dim: int = 64
    decoder_depth: int = 12
    encoder_dtype: str = "fp32"
    decoder_dtype: str = "fp32"
    # Inference: only the final (and low-res) prediction. Training
    # (``False``, the JAX default) adds the per-step upsampled stacks for the
    # sequence loss.
    inference_only: bool = False


def precision_scope(device: torch.device, dtype_name: str):
    """Autocast to bf16 for a ``bf16``/``fp16`` stage; nothing for ``fp32``."""
    if _DTYPES[dtype_name] == torch.float32:
        return contextlib.nullcontext()
    return torch.autocast(device_type=device.type, dtype=torch.bfloat16)


class FlowFormerCov(nn.Module):
    def __init__(self, cfg: FlowFormerConfig = FlowFormerConfig()) -> None:
        super().__init__()
        self.cfg = cfg
        self.context_encoder = TwinsSVT()
        self.feature_encoder = TwinsSVT()
        self.memory_encoder = MemoryEncoder(
            cost_latent_input_dim=cfg.cost_latent_input_dim,
            cost_latent_token_num=cfg.cost_latent_token_num,
            cost_latent_dim=cfg.cost_latent_dim,
            encoder_depth=cfg.encoder_depth,
            patch_size=cfg.patch_size,
            vert_c_dim=cfg.vert_c_dim,
        )
        self.memory_decoder = MemoryCovDecoder(
            decoder_depth=cfg.decoder_depth,
            query_latent_dim=cfg.query_latent_dim,
            cost_latent_dim=cfg.cost_latent_dim,
            inference_only=cfg.inference_only,
        )

    def _enc_scope(self, x):
        return precision_scope(x.device, self.cfg.encoder_dtype)

    def features(self, images: torch.Tensor) -> torch.Tensor:
        """fnet features of [0,1] images (B,H,W,3) -> (B,H/8,W/8,256)."""
        with self._enc_scope(images):
            return self.feature_encoder(2.0 * images - 1.0)

    def context(self, images: torch.Tensor) -> torch.Tensor:
        """cnet context of [0,1] images (B,H,W,3) -> (B,H/8,W/8,256)."""
        with self._enc_scope(images):
            return self.context_encoder(2.0 * images - 1.0)

    def decode(self, feat1, feat2, context):
        """Latent cost volume + recurrent decoder on precomputed features."""
        with self._enc_scope(feat1):
            cost_memory, cost_maps = self.memory_encoder(feat1, feat2, context)
        dec_dtype = _DTYPES[self.cfg.decoder_dtype]
        with precision_scope(feat1.device, self.cfg.decoder_dtype):
            return self.memory_decoder(cost_memory, context.float(), cost_maps, compute_dtype=dec_dtype)

    def forward(self, image1, image2):
        context = self.context(image1)
        feat1, feat2 = torch.chunk(self.features(torch.cat([image1, image2], 0)), 2, 0)
        return self.decode(feat1, feat2, context)


class InputPadder:
    """Pad H,W of channel-last (B,H,W,C) images to multiples of ``factor`` by
    edge replication (flax ``jnp.pad(mode="edge")``)."""

    def __init__(self, shape, factor: int = 8) -> None:
        self.h, self.w = shape[1], shape[2]
        pad_h, pad_w = (-self.h) % factor, (-self.w) % factor
        self._pad = (pad_h // 2, pad_h - pad_h // 2, pad_w // 2, pad_w - pad_w // 2)

    def pad(self, *images):
        t, btm, l, r = self._pad
        if not any(self._pad):
            out = list(images)
        else:
            out = [F.pad(im.permute(0, 3, 1, 2), (l, r, t, btm), mode="replicate").permute(0, 2, 3, 1)
                   for im in images]
        return out if len(out) > 1 else out[0]

    def unpad(self, x):
        t, _, l, _ = self._pad
        return x[:, t:t + self.h, l:l + self.w]


def normalize_cov(log_sigma: torch.Tensor) -> torch.Tensor:
    """Head regresses log-sigma; variance = exp(2 * log_sigma)."""
    return torch.exp(2.0 * log_sigma)
