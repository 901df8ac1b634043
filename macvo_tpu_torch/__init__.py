"""MAC-VO in PyTorch for NVIDIA Hopper: the CUDA port of ``macvo_tpu``.

The package mirrors ``macvo_tpu``'s layout and class names, module for
module, so each counterpart is easy to find. It imports ``torch`` and
nothing of JAX or of ``macvo_tpu``: the jax-free modules it needs
(config, registry, ``se3_np``, ``worldmap``, metrics, the sync layout) are
kept here as copies.

Entry points run on ``device="cuda"`` unless the caller passes
``device="cpu"``; asking for CUDA on a machine without it raises. The
package has three hand-written CUDA kernels, sources in ``csrc/``: the fused
latent cross-attention of MAC-VO's frontend (``ops/latent_attn.py``), and
the local correlation of the TartanVO nets and its backward
(``ops/correlation.py``). Each builds with ``nvcc`` on first use into
``macvo_tpu_torch/_build/``.
"""
