"""MAC-VO in PyTorch for NVIDIA Hopper: the CUDA port of ``macvo_tpu``.

The package mirrors ``macvo_tpu``'s layout and class names, module for
module, so each counterpart is easy to find. It imports ``torch`` and
nothing of JAX or of ``macvo_tpu``: the jax-free modules it needs
(config, registry, ``se3_np``, ``worldmap``, metrics, the sync layout) are
kept here as copies.

Entry points run on ``device="cuda"`` unless the caller passes
``device="cpu"``; asking for CUDA on a machine without it raises. The one
hand-written kernel of the main path, the fused latent cross-attention
(``ops/latent_attn.py``, source in ``csrc/``), builds with ``nvcc`` on first
use into ``macvo_tpu_torch/_build/``.
"""
