"""Sequence framework: registry datasets + clip (port of ``macvo_tpu/data/sequence.py``).

Datasets register by name and are instantiated from ``{type, args}`` config
nodes. :class:`DevicePrefetcher` decodes the next frame on a host thread and
stages it onto the device while the current frame computes.
"""

from __future__ import annotations

import queue
import threading
from types import SimpleNamespace
from typing import Any, Generator, Generic, TypeVar

import numpy as np
import torch

from ..utils.config import build_dynamic_config
from ..utils.registry import RegisteredConfigTestable

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
