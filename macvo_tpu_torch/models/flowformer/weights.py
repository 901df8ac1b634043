"""Carry the flax checkpoint (``model/*.npz``) into a torch ``state_dict``.

The npz holds ``/``-joined flax parameter paths (``macvo_tpu/models/flowformer/
weights.py``). The torch modules of this package are named after the flax
modules, so a path maps to a state-dict key by ``/`` -> ``.`` and the leaf
rename below; the array layouts invert ``macvo_tpu/models/flowformer/
torch_convert.py``:

* Dense ``kernel (in, out)``        -> Linear ``weight (out, in)``
* Conv ``kernel (kh, kw, in, out)`` -> Conv2d ``weight (out, in, kh, kw)``
  (the depthwise PEG conv ``(3, 3, 1, C)`` becomes ``(C, 1, 3, 3)`` by the same rule)
* ConvTranspose ``kernel (kh, kw, in, out)`` -> ConvTranspose2d ``weight (in, out, kh, kw)``,
  flipped in both spatial axes: flax does not flip a transposed conv's kernel,
  torch does. Which paths are transposed convs the model says
  (:func:`transposed_convs`): the array alone cannot tell them apart.
* LayerNorm ``scale``               -> ``weight``
* ``bias``, ``latents`` and ``gamma`` keep their layout.

The decoder's scanned step stores ONE shared parameter set under
``memory_decoder/iteration/...``, which is exactly one torch submodule here.
Conversion happens in memory each time a model loads: no converted file is
written.

The way back, :func:`torch_to_flax` and :func:`save_params`, writes a trained
model in the JAX package's npz layout, so ``macvo_tpu``'s ``load_params`` and
this package's loader both read it. A training run's full state (model,
optimizer and step) is the port's own file, :func:`save_train_state`.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Collection, Mapping

import numpy as np
import torch


def flax_to_torch(npz_arrays: Mapping[str, np.ndarray],
                  transposed: Collection[str] = ()) -> dict[str, torch.Tensor]:
    """flax path -> array mapping  =>  torch state_dict (one entry per array).
    ``transposed`` names the modules (torch dotted paths) that are transposed
    convolutions."""
    out: dict[str, torch.Tensor] = {}
    for path, arr in npz_arrays.items():
        parts = path.split("/")
        leaf = parts[-1]
        a = np.asarray(arr)
        if leaf == "kernel":
            if a.ndim == 2:
                a = a.T
            elif a.ndim == 4 and ".".join(parts[:-1]) in transposed:
                a = a[::-1, ::-1].transpose(2, 3, 0, 1)
            elif a.ndim == 4:
                a = a.transpose(3, 2, 0, 1)
            else:
                raise ValueError(f"{path}: unexpected kernel rank {a.ndim}")
            leaf = "weight"
        elif leaf == "scale":
            leaf = "weight"
        elif leaf not in ("bias", "latents", "gamma"):
            raise ValueError(f"{path}: unknown flax leaf {leaf!r}")
        key = ".".join(parts[:-1] + [leaf])
        if key in out:
            raise ValueError(f"{path}: two flax paths map to torch key {key!r}")
        out[key] = torch.tensor(np.ascontiguousarray(a, dtype=np.float32))
    return out


def transposed_convs(module: torch.nn.Module) -> set[str]:
    """Dotted paths of the transposed convolutions of ``module``."""
    return {name for name, m in module.named_modules() if isinstance(m, torch.nn.ConvTranspose2d)}


def load_flax_checkpoint(module: torch.nn.Module, npz_path: str | Path) -> None:
    """Load an npz checkpoint into ``module``: every npz key is consumed exactly
    once and every parameter is set, each with its shape checked."""
    with np.load(npz_path) as data:
        arrays = {k: data[k] for k in data.files}
    load_state(module, flax_to_torch(arrays, transposed_convs(module)))


def random_seed(weight: str) -> int | None:
    """The seed of a ``"random"`` / ``"random:<seed>"`` weight option (``"random"``
    is seed 0), or None for a checkpoint path."""
    if not str(weight).startswith("random"):
        return None
    return int(str(weight).split(":")[1]) if ":" in str(weight) else 0


def random_state(module: torch.nn.Module, seed: int) -> dict[str, torch.Tensor]:
    """Seeded random weights for every entry of ``module``'s state_dict, drawn
    in state_dict order from a ``torch.Generator`` of its own (the global RNG
    is untouched), with flax's default initializers' scales: a Dense / Conv /
    ConvTranspose kernel N(0, 1/fan_in) with fan_in = inputs x kernel area (flax's
    lecun_normal, untruncated), biases and ``gamma`` 0, LayerNorm scales 1,
    ``latents`` N(0, 0.02^2). The bits differ from a flax init of the same seed."""
    gen = torch.Generator().manual_seed(int(seed))
    transposed = transposed_convs(module)
    out = {}
    for key, value in module.state_dict().items():
        leaf, owner = key.rsplit(".", 1)[-1], key.rsplit(".", 1)[0]
        shape = tuple(value.shape)
        if leaf == "weight" and len(shape) >= 2:
            fan_in = shape[0] if owner in transposed else shape[1]
            for k in shape[2:]:
                fan_in *= k
            t = torch.randn(shape, generator=gen) / fan_in ** 0.5
        elif leaf == "weight":
            t = torch.ones(shape)
        elif leaf == "latents":
            t = torch.randn(shape, generator=gen) * 0.02
        else:
            t = torch.zeros(shape)
        out[key] = t.to(value.dtype)
    return out


def load_weights(module: torch.nn.Module, weight: str | Path) -> None:
    """``weight`` is an npz checkpoint (:func:`load_flax_checkpoint`) or
    ``"random[:<seed>]"`` (:func:`random_state`)."""
    seed = random_seed(str(weight))
    if seed is None:
        load_flax_checkpoint(module, weight)
    else:
        load_state(module, random_state(module, seed))


def build_with_weights(factory, weight: str | Path) -> torch.nn.Module:
    """``factory()`` with the weights of ``weight`` (:func:`load_weights`). The
    modules' default initialization runs on a forked CPU generator, so the
    global torch RNG is left as it was."""
    with torch.random.fork_rng(devices=[]):
        module = factory()
    load_weights(module, weight)
    return module


def load_state(module: torch.nn.Module, state: Mapping[str, torch.Tensor]) -> None:
    own = module.state_dict()
    missing = sorted(set(own) - set(state))
    unused = sorted(set(state) - set(own))
    if missing or unused:
        raise KeyError(f"checkpoint/model mismatch: missing {missing[:8]} (of {len(missing)}), "
                       f"unused {unused[:8]} (of {len(unused)})")
    for key, value in state.items():
        if tuple(own[key].shape) != tuple(value.shape):
            raise ValueError(f"parameter {key!r}: checkpoint {tuple(value.shape)} "
                             f"!= model {tuple(own[key].shape)}")
    module.load_state_dict(state, strict=True)


def torch_to_flax(state: Mapping[str, torch.Tensor], transposed: Collection[str] = ()) -> dict[str, np.ndarray]:
    """Inverse of :func:`flax_to_torch`: torch state_dict => flax path -> float32
    array. A 1-d ``weight`` is a LayerNorm ``scale``; a 2-d one a Dense kernel; a
    4-d one a Conv kernel, or a ConvTranspose kernel (flipped back) for the
    modules in ``transposed``."""
    out: dict[str, np.ndarray] = {}
    for key, value in state.items():
        parts = key.split(".")
        leaf = parts[-1]
        a = value.detach().to("cpu", torch.float32).numpy()
        if leaf == "weight":
            if a.ndim == 1:
                leaf = "scale"
            elif a.ndim == 2:
                a, leaf = a.T, "kernel"
            elif a.ndim == 4 and ".".join(parts[:-1]) in transposed:
                a, leaf = a.transpose(2, 3, 0, 1)[::-1, ::-1], "kernel"
            elif a.ndim == 4:
                a, leaf = a.transpose(2, 3, 1, 0), "kernel"
            else:
                raise ValueError(f"{key}: unexpected weight rank {a.ndim}")
        elif leaf not in ("bias", "latents", "gamma"):
            raise ValueError(f"{key}: unknown torch leaf {leaf!r}")
        out["/".join(parts[:-1] + [leaf])] = np.ascontiguousarray(a)
    return out


def save_params(path: str | Path, module: torch.nn.Module) -> None:
    """Write ``module``'s parameters as an npz in the JAX package's layout
    (``np.savez_compressed`` of flax path -> float32 array)."""
    np.savez_compressed(path, **torch_to_flax(module.state_dict(), transposed_convs(module)))


def save_train_state(path: str | Path, model: torch.nn.Module, optimizer, step: int) -> None:
    """Full training state for a lossless resume: the model's state_dict, the
    optimizer's (moments, counts) and the step, written atomically (a temporary
    file, then a rename)."""
    path = Path(path)
    tmp = path.with_name(path.name + ".tmp")
    torch.save({"model": model.state_dict(), "optimizer": optimizer.state_dict(), "step": int(step)}, tmp)
    os.replace(tmp, path)


def load_train_state(path: str | Path, model: torch.nn.Module, optimizer) -> int:
    """Restore what :func:`save_train_state` wrote into ``model`` and
    ``optimizer``; returns the step."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    load_state(model, state["model"])
    optimizer.load_state_dict(state["optimizer"])
    return int(state["step"])
