"""The reference's ``.pth`` state_dict -> the flax npz layout, for the
FlowFormerCov covariance branch (port of ``macvo_tpu/models/flowformer/torch_convert.py``).

The reference ships torch ``state_dict`` checkpoints, saved from
DataParallel (``module.`` prefix). The blocks whose architecture this repo's
network matches one to one, the covariance branch (SepConvGRU, the 4-conv
CovHead and the 2-conv mask head), convert to the flat ``/``-joined npz of
the JAX package's ``weights.py``: the same file both packages' loaders read
(this package's through :func:`..weights.load_flax_checkpoint`).

Layouts, as the JAX converter writes them:
* torch Conv2d ``(out, in, kh, kw)`` -> flax ``(kh, kw, in, out)``
* torch Linear ``(out, in)``          -> flax ``(in, out)``
* biases carry over unchanged.

:func:`merge_into_params` works on the flat npz dict (path -> array), the
form this package keeps a checkpoint in.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Mapping

import numpy as np


def strip_ddp_prefix(state: Mapping[str, Any]) -> dict[str, Any]:
    """Strip the ``module.`` DataParallel prefix."""
    return {(k[7:] if k.startswith("module.") else k): v for k, v in state.items()}


def _to_numpy(t) -> np.ndarray:
    try:
        return t.detach().cpu().numpy()
    except AttributeError:
        return np.asarray(t)


def _join(prefix: str, name: str) -> str:
    return f"{prefix}.{name}" if prefix else name


def convert_conv(state: Mapping[str, Any], torch_name: str) -> dict[str, np.ndarray]:
    """One torch Conv2d -> flax {'kernel','bias'} dict."""
    w = _to_numpy(state[f"{torch_name}.weight"])
    out = {"kernel": np.transpose(w, (2, 3, 1, 0))}
    if f"{torch_name}.bias" in state:
        out["bias"] = _to_numpy(state[f"{torch_name}.bias"])
    return out


def convert_linear(state: Mapping[str, Any], torch_name: str) -> dict[str, np.ndarray]:
    w = _to_numpy(state[f"{torch_name}.weight"])
    out = {"kernel": np.transpose(w, (1, 0))}
    if f"{torch_name}.bias" in state:
        out["bias"] = _to_numpy(state[f"{torch_name}.bias"])
    return out


# SepConvGRU layer naming: torch convz1/convr1/convq1 (1x5 horizontal) and
# convz2/convr2/convq2 (5x1 vertical) -> flax h_z/h_r/h_q/v_z/v_r/v_q.
_GRU_MAP = {
    "convz1": "h_z", "convr1": "h_r", "convq1": "h_q",
    "convz2": "v_z", "convr2": "v_r", "convq2": "v_q",
}


def convert_sepconv_gru(state: Mapping[str, Any], prefix: str) -> dict[str, Any]:
    return {ours: convert_conv(state, _join(prefix, theirs)) for theirs, ours in _GRU_MAP.items()}


def convert_cov_head(state: Mapping[str, Any], prefix: str) -> dict[str, Any]:
    """4-conv CovHead."""
    return {f"conv{i}": convert_conv(state, _join(prefix, f"conv{i}")) for i in range(1, 5)}


def convert_mask_head(state: Mapping[str, Any], prefix: str) -> dict[str, Any]:
    """nn.Sequential(Conv 3x3, ReLU, Conv 1x1) mask head: sequential indices
    0 and 2 -> conv1/conv2."""
    return {
        "conv1": convert_conv(state, _join(prefix, "0")),
        "conv2": convert_conv(state, _join(prefix, "2")),
    }


def convert_cov_update_block(state: Mapping[str, Any], prefix: str = "memory_decoder.cov_update") -> dict[str, Any]:
    """The reference's CovUpdateBlock -> the decoder iteration's covariance
    branch: {cov_gru, cov_head, cov_mask} subtrees."""
    return {
        "cov_gru": convert_sepconv_gru(state, _join(prefix, "gru")),
        "cov_head": convert_cov_head(state, _join(prefix, "cov_head")),
        "cov_mask": convert_mask_head(state, _join(prefix, "mask")),
    }


def convert_cov_branch_tree(state: Mapping[str, Any],
                            prefix: str = "memory_decoder.cov_update") -> dict[str, Any]:
    """The covariance branch at the model's parameter paths: the mask head
    once at memory_decoder/cov_mask (applied after the decoder's steps), the
    GRU and head under memory_decoder/iteration (shared by every step)."""
    block = convert_cov_update_block(state, prefix)
    cov_mask = block.pop("cov_mask")
    return {"memory_decoder": {"cov_mask": cov_mask, "iteration": block}}


def load_torch_checkpoint(path: str | Path) -> dict[str, Any]:
    """Load a .pth state dict (weights_only, DDP prefix stripped)."""
    import torch

    state = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(state, dict) and "state_dict" in state:
        state = state["state_dict"]
    return strip_ddp_prefix(state)


def flatten_tree(tree: Mapping[str, Any], prefix: str = "") -> dict[str, np.ndarray]:
    """Nested dict -> ``/``-joined path -> array, the npz's keys."""
    out: dict[str, np.ndarray] = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            out.update(flatten_tree(v, path))
        else:
            out[path] = np.asarray(v)
    return out


def convert_cov_branch_pth(pth_path: str | Path, npz_path: str | Path,
                           prefix: str = "memory_decoder.cov_update") -> dict[str, np.ndarray]:
    """.pth -> npz holding the covariance branch at the model's paths
    (mergeable into a full checkpoint with :func:`merge_into_params`)."""
    flat = flatten_tree(convert_cov_branch_tree(load_torch_checkpoint(pth_path), prefix))
    np.savez_compressed(npz_path, **flat)
    return flat


def merge_into_params(params: Mapping[str, np.ndarray], subtree: Mapping[str, Any]) -> dict[str, np.ndarray]:
    """Overwrite the entries of the flat checkpoint ``params`` (path -> array)
    at the paths of ``subtree`` (nested or flat), each shape-checked and cast
    to the checkpoint's dtype; a path the checkpoint lacks raises KeyError."""
    out = dict(params)
    for path, arr in flatten_tree(subtree).items():
        if path not in params:
            raise KeyError(f"converted path '{path}' not in model params")
        if tuple(arr.shape) != tuple(np.shape(params[path])):
            raise ValueError(f"'{path}': converted {arr.shape} != model {np.shape(params[path])}")
        out[path] = arr.astype(np.asarray(params[path]).dtype)
    return out
