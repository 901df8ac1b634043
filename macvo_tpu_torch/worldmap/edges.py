"""Graph edges: typed associations between stores.

Re-design of the reference edge machinery (Module/Map/Graph.py:121-298) on
numpy. Three edge kinds cover the visual map's topology:

* :class:`RangeEdge`   — per-node list of ``[start, length]`` ranges into a
  target store (reference ``DenseEdge_Multi``); used frame→match, frame→map
  where each keyframe owns contiguous blocks of freshly pushed rows.
* :class:`SingleEdge`  — 1:1 index map (reference ``SingleEdge``); used
  match→frame1/2, match→point.
* :class:`MultiEdge`   — fixed-max-degree adjacency (reference
  ``SparseEdge_Multi``); used point→match with ``max_degree`` observations.

All edges grow with their source store via ``grow_to`` (the reference's
auto-registration, Module/Map/Graph.py:99-106).
"""

from __future__ import annotations

from typing import Mapping

import numpy as np


class SingleEdge:
    """src index -> single dst index (-1 = unset)."""

    def __init__(self, init_capacity: int = 1024) -> None:
        self._map = np.full((init_capacity,), -1, dtype=np.int64)
        self._size = 0

    def grow_to(self, n: int) -> None:
        if n > self._map.shape[0]:
            new = np.full((max(n, self._map.shape[0] * 2),), -1, dtype=np.int64)
            new[: self._map.shape[0]] = self._map
            self._map = new
        self._size = max(self._size, n)

    def set(self, src_idx: np.ndarray, dst_idx: np.ndarray) -> None:
        self.grow_to(int(np.max(src_idx, initial=-1)) + 1)
        self._map[np.asarray(src_idx)] = np.asarray(dst_idx)

    def project(self, src_idx: np.ndarray) -> np.ndarray:
        return self._map[np.asarray(src_idx)]

    def serialize(self, prefix: str) -> dict[str, np.ndarray]:
        return {prefix + "/map": self._map[: self._size].copy()}

    def deserialize(self, prefix: str, values: Mapping[str, np.ndarray]) -> "SingleEdge":
        arr = np.asarray(values[prefix + "/map"])
        self._map = arr.copy()
        self._size = arr.shape[0]
        return self


class RangeEdge:
    """src index -> up to ``max_ranges`` contiguous [start, length] dst ranges."""

    def __init__(self, init_capacity: int = 1024, max_ranges: int = 2) -> None:
        self.max_ranges = max_ranges
        self._ranges = np.zeros((init_capacity, max_ranges, 2), dtype=np.int64)
        self._counts = np.zeros((init_capacity,), dtype=np.int64)
        self._size = 0

    def grow_to(self, n: int) -> None:
        if n > self._ranges.shape[0]:
            cap = max(n, self._ranges.shape[0] * 2)
            new_r = np.zeros((cap, self.max_ranges, 2), dtype=np.int64)
            new_c = np.zeros((cap,), dtype=np.int64)
            new_r[: self._ranges.shape[0]] = self._ranges
            new_c[: self._counts.shape[0]] = self._counts
            self._ranges, self._counts = new_r, new_c
        self._size = max(self._size, n)

    def add(self, src_idx: np.ndarray, start: np.ndarray, length: np.ndarray) -> None:
        src_idx = np.atleast_1d(np.asarray(src_idx, dtype=np.int64))
        start = np.atleast_1d(np.asarray(start, dtype=np.int64))
        length = np.atleast_1d(np.asarray(length, dtype=np.int64))
        self.grow_to(int(src_idx.max(initial=-1)) + 1)
        for s, st, ln in zip(src_idx, start, length):
            c = self._counts[s]
            if c >= self.max_ranges:
                raise IndexError(f"RangeEdge: node {s} exceeds max_ranges={self.max_ranges}")
            self._ranges[s, c] = (st, ln)
            self._counts[s] = c + 1

    def project(self, src_idx: np.ndarray) -> np.ndarray:
        """Expand all ranges of the given nodes into one flat dst-index array."""
        src_idx = np.atleast_1d(np.asarray(src_idx, dtype=np.int64))
        chunks = []
        for s in src_idx:
            for c in range(self._counts[s]):
                st, ln = self._ranges[s, c]
                chunks.append(np.arange(st, st + ln, dtype=np.int64))
        if not chunks:
            return np.zeros((0,), dtype=np.int64)
        return np.concatenate(chunks)

    def serialize(self, prefix: str) -> dict[str, np.ndarray]:
        return {
            prefix + "/ranges": self._ranges[: self._size].copy(),
            prefix + "/counts": self._counts[: self._size].copy(),
        }

    def deserialize(self, prefix: str, values: Mapping[str, np.ndarray]) -> "RangeEdge":
        self._ranges = np.asarray(values[prefix + "/ranges"]).copy()
        self._counts = np.asarray(values[prefix + "/counts"]).copy()
        self.max_ranges = self._ranges.shape[1]
        self._size = self._ranges.shape[0]
        return self


class MultiEdge:
    """src index -> up to ``max_degree`` dst indices (-1 padded)."""

    def __init__(self, init_capacity: int = 1024, max_degree: int = 5) -> None:
        self.max_degree = max_degree
        self._adj = np.full((init_capacity, max_degree), -1, dtype=np.int64)
        self._counts = np.zeros((init_capacity,), dtype=np.int64)
        self._size = 0

    def grow_to(self, n: int) -> None:
        if n > self._adj.shape[0]:
            cap = max(n, self._adj.shape[0] * 2)
            new_a = np.full((cap, self.max_degree), -1, dtype=np.int64)
            new_c = np.zeros((cap,), dtype=np.int64)
            new_a[: self._adj.shape[0]] = self._adj
            new_c[: self._counts.shape[0]] = self._counts
            self._adj, self._counts = new_a, new_c
        self._size = max(self._size, n)

    def add(self, src_idx: np.ndarray, dst_idx: np.ndarray) -> None:
        src_idx = np.atleast_1d(np.asarray(src_idx, dtype=np.int64))
        dst_idx = np.atleast_1d(np.asarray(dst_idx, dtype=np.int64))
        self.grow_to(int(src_idx.max(initial=-1)) + 1)
        for s, d in zip(src_idx, dst_idx):
            c = self._counts[s]
            if c >= self.max_degree:
                raise IndexError(f"MultiEdge: node {s} exceeds max_degree={self.max_degree}")
            self._adj[s, c] = d
            self._counts[s] = c + 1

    def project(self, src_idx: np.ndarray) -> np.ndarray:
        """All dst indices of the given nodes, flattened (padding dropped)."""
        src_idx = np.atleast_1d(np.asarray(src_idx, dtype=np.int64))
        flat = self._adj[src_idx].reshape(-1)
        return flat[flat >= 0]

    def serialize(self, prefix: str) -> dict[str, np.ndarray]:
        return {
            prefix + "/adj": self._adj[: self._size].copy(),
            prefix + "/counts": self._counts[: self._size].copy(),
        }

    def deserialize(self, prefix: str, values: Mapping[str, np.ndarray]) -> "MultiEdge":
        self._adj = np.asarray(values[prefix + "/adj"]).copy()
        self._counts = np.asarray(values[prefix + "/counts"]).copy()
        self.max_degree = self._adj.shape[1]
        self._size = self._adj.shape[0]
        return self
