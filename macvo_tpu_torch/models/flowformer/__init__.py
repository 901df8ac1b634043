"""FlowFormerCov network family (port of ``macvo_tpu/models/flowformer``)."""

from .network import FlowFormerConfig, FlowFormerCov, InputPadder, normalize_cov
from .weights import flax_to_torch, load_flax_checkpoint

__all__ = ["FlowFormerConfig", "FlowFormerCov", "InputPadder", "flax_to_torch",
           "load_flax_checkpoint", "normalize_cov"]
