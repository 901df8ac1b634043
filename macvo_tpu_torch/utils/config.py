"""YAML config loading with ``!include`` / ``!flatten_seq`` composition.

Behavioral parity with the reference config system (Utility/Config.py:19-107):
YAML files compose via ``!include path`` (splices another file) and
``!flatten_seq [[..], [..]]`` (flattens nested sequences); the loaded tree is
exposed both as a nested ``SimpleNamespace`` (attribute access used throughout
the pipeline) and as a plain dict (serialization).
"""

from __future__ import annotations

import copy
import os
from pathlib import Path
from types import SimpleNamespace
from typing import Any

import yaml


class ConfigLoader(yaml.SafeLoader):
    """SafeLoader with include-directory context for relative ``!include``."""

    def __init__(self, stream: Any) -> None:
        try:
            self._root = os.path.dirname(stream.name)
        except AttributeError:
            self._root = os.curdir
        super().__init__(stream)


def _include(loader: ConfigLoader, node: yaml.Node) -> Any:
    rel = loader.construct_scalar(node)  # type: ignore[arg-type]
    path = os.path.join(loader._root, str(rel))
    with open(path, "r") as f:
        return yaml.load(f, ConfigLoader)


def _flatten_seq(loader: ConfigLoader, node: yaml.Node) -> list[Any]:
    seqs = loader.construct_sequence(node, deep=True)  # type: ignore[arg-type]
    flat: list[Any] = []
    for item in seqs:
        if isinstance(item, list):
            flat.extend(item)
        else:
            flat.append(item)
    return flat


ConfigLoader.add_constructor("!include", _include)
ConfigLoader.add_constructor("!flatten_seq", _flatten_seq)


def dict_to_namespace(d: Any) -> Any:
    if isinstance(d, dict):
        return SimpleNamespace(**{k: dict_to_namespace(v) for k, v in d.items()})
    if isinstance(d, list):
        return [dict_to_namespace(v) for v in d]
    return d


def namespace_to_dict(ns: Any) -> Any:
    if isinstance(ns, SimpleNamespace):
        return {k: namespace_to_dict(v) for k, v in vars(ns).items()}
    if isinstance(ns, (list, tuple)):
        return [namespace_to_dict(v) for v in ns]
    return ns


def load_config(path: str | Path) -> tuple[SimpleNamespace, dict]:
    """Load a YAML config file -> (namespace view, dict view)."""
    with open(path, "r") as f:
        raw = yaml.load(f, ConfigLoader)
    if raw is None:
        raw = {}
    if not isinstance(raw, dict):
        raise ValueError(f"Top-level config must be a mapping, got {type(raw)} in {path}")
    return dict_to_namespace(raw), raw


def build_dynamic_config(d: dict) -> tuple[SimpleNamespace, dict]:
    """Build a config from an in-code dict (reference: Utility/Config.py:53-76)."""
    d = copy.deepcopy(d)
    return dict_to_namespace(d), d


def save_config(ns_or_dict: Any, path: str | Path) -> None:
    d = namespace_to_dict(ns_or_dict)
    with open(path, "w") as f:
        yaml.safe_dump(d, f, sort_keys=False)
