"""Sequence framework: registry datasets + clip / preload / transform
(port of ``macvo_tpu/data/sequence.py``).

Datasets register by name and are instantiated from ``{type, args}`` config
nodes; a sequence can be clipped by index, preloaded into RAM by a thread
pool and wrapped in frame transforms (:func:`smart_transform` picks them
from an experiment's ``Preprocess`` node). :class:`DevicePrefetcher` decodes
the next frame on a host thread and stages it onto the device while the
current frame computes.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace
from typing import Any, Callable, Generator, Generic, TypeVar

import numpy as np
import torch

from ..utils.config import build_dynamic_config
from ..utils.logging import Logger
from ..utils.registry import RegisteredConfigTestable
from .transform import IDataTransform

T_Data = TypeVar("T_Data")


class SequenceBase(RegisteredConfigTestable, Generic[T_Data], register=False):
    """Dataset base: implement ``__getitem__`` (local index -> frame) and call
    ``super().__init__(length)``."""

    def __init__(self, length: int) -> None:
        self.origin_length = length
        self.indices = np.arange(0, length, 1)

    def __getitem__(self, local_index: int) -> T_Data:
        raise NotImplementedError

    def get_index(self, local_index: int) -> int:
        return int(self.indices[local_index])

    def clip(self, start_idx: int | None = None, end_idx: int | None = None, step: int | None = None):
        self.indices = self.indices[start_idx:end_idx:step]
        return self

    def preload(self) -> "PreloadedSequence[T_Data]":
        return PreloadedSequence(self)

    def transform(self, actions):
        if isinstance(actions, list) and len(actions) == 0:
            return self
        return TransformSequence(self, actions)

    def __len__(self) -> int:
        return int(self.indices.size)

    def __iter__(self) -> Generator[T_Data, None, None]:
        for idx in range(len(self)):
            yield self[idx]

    def __repr__(self) -> str:
        return f"{self.name()}(orig_len={self.origin_length}, clip_len={len(self)})"

    @staticmethod
    def config_dict2ns(cfg: SimpleNamespace | dict[str, Any]) -> SimpleNamespace:
        if isinstance(cfg, SimpleNamespace):
            return cfg
        return build_dynamic_config(cfg)[0]

    @classmethod
    def from_config(cls, cfg: SimpleNamespace) -> "SequenceBase":
        return cls.instantiate(cfg.type, cfg.args)


class PreloadedSequence(SequenceBase[T_Data], register=False):
    """RAM-cache the whole (clipped) sequence with a thread pool."""

    def __init__(self, seq: SequenceBase[T_Data]) -> None:
        Logger.info(f"Preloading {seq}")
        with ThreadPoolExecutor(max_workers=8) as pool:
            frames = list(pool.map(seq.__getitem__, range(len(seq))))
        self._frames = frames
        super().__init__(len(frames))

    def __getitem__(self, local_index: int) -> T_Data:
        return self._frames[self.get_index(local_index)]


class TransformSequence(SequenceBase[T_Data], register=False):
    """Apply ``actions`` (one callable or a list, in order) to each frame as it is read."""

    def __init__(self, seq: SequenceBase[T_Data], actions) -> None:
        super().__init__(len(seq))
        self._seq = seq
        self._actions: list[Callable] = actions if isinstance(actions, list) else [actions]

    def __getitem__(self, local_index: int) -> T_Data:
        frame = self._seq[self.get_index(local_index)]
        for action in self._actions:
            frame = action(frame)
        return frame


class DevicePrefetcher(Generic[T_Data]):
    """Iterate a sequence with each frame decoded on a background thread and
    moved to ``device`` (pinned memory + non-blocking copy on CUDA) ahead of use."""

    def __init__(self, seq: SequenceBase[T_Data], device: torch.device, depth: int = 2) -> None:
        self.seq, self.device, self.depth = seq, torch.device(device), depth

    def __len__(self) -> int:
        return len(self.seq)

    def __iter__(self) -> Generator[T_Data, None, None]:
        q: queue.Queue = queue.Queue(maxsize=self.depth)
        done = object()
        closing = threading.Event()
        errors: list[BaseException] = []

        def producer() -> None:
            try:
                for i in range(len(self.seq)):
                    if closing.is_set():
                        return
                    q.put(self.seq[i])
            except BaseException as exc:   # re-raised by the consumer below
                errors.append(exc)
            finally:
                q.put(done)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                item = q.get()
                if item is done:
                    break
                yield item.to(self.device)
        finally:
            # Drain so a producer blocked on a full queue can finish, then join.
            closing.set()
            while thread.is_alive():
                try:
                    q.get(timeout=0.1)
                except queue.Empty:
                    pass
            thread.join()
        if errors:
            raise errors[0]


def smart_transform(seq: SequenceBase, trans_cfg) -> SequenceBase:
    """Wrap ``seq`` in the transforms an experiment's ``Preprocess`` node
    names: a list of ``{type, args}`` nodes applies to every sequence, a
    mapping is keyed by the sequence's registry name (a name it lacks leaves
    the sequence as it is)."""
    if isinstance(trans_cfg, dict):
        trans_cfg = build_dynamic_config(trans_cfg)[0]
    elif isinstance(trans_cfg, list):
        trans_cfg = [t if isinstance(t, SimpleNamespace) else build_dynamic_config(t)[0] for t in trans_cfg]

    if isinstance(trans_cfg, list):
        transform_cfg = trans_cfg
    else:
        seq_type = seq.name()
        if not hasattr(trans_cfg, seq_type):
            return seq
        transform_cfg = getattr(trans_cfg, seq_type)

    actions = [IDataTransform.instantiate(t.type, t.args) for t in transform_cfg]
    if actions:
        Logger.info("Data transforms: " + ", ".join(type(a).__name__ for a in actions))
    return seq.transform(actions)
