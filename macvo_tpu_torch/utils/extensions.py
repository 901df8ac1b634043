"""Small container and functional extensions (port of ``macvo_tpu/utils/extensions.py``).

* :class:`CircularBuffer`: a fixed-capacity ring buffer with batched writes.
  numpy-backed: it holds host-side history, not device state.
* :class:`GridRecorder`: a 2D histogram accumulator for covariance
  calibration statistics (``scripts/torch_cov_calibration.py``).
* :class:`Chain`: ``>>`` function composition.

Host-side numpy, as in the JAX package: nothing here touches the card.
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np


class CircularBuffer:
    """Fixed-capacity FIFO over (capacity, *row_shape) storage."""

    def __init__(self, capacity: int, row_shape: Sequence[int] = (), dtype=np.float32) -> None:
        assert capacity > 0
        self.capacity = capacity
        self._buf = np.zeros((capacity,) + tuple(row_shape), dtype=dtype)
        self._start = 0
        self._size = 0

    def __len__(self) -> int:
        return self._size

    def push(self, rows: np.ndarray) -> None:
        """Append rows; the oldest entries fall off when full."""
        rows = np.asarray(rows, dtype=self._buf.dtype)
        if rows.ndim == self._buf.ndim - 1:
            rows = rows[None]
        n = rows.shape[0]
        if n >= self.capacity:
            self._buf[:] = rows[-self.capacity:]
            self._start, self._size = 0, self.capacity
            return
        end = (self._start + self._size) % self.capacity
        first = min(n, self.capacity - end)
        self._buf[end : end + first] = rows[:first]
        if first < n:
            self._buf[: n - first] = rows[first:]
        overflow = max(0, self._size + n - self.capacity)
        self._start = (self._start + overflow) % self.capacity
        self._size = min(self._size + n, self.capacity)

    @property
    def array(self) -> np.ndarray:
        """Contents in FIFO order (oldest first), shape (len, *row_shape)."""
        idx = (self._start + np.arange(self._size)) % self.capacity
        return self._buf[idx]

    def __getitem__(self, i):
        return self.array[i]


class GridRecorder:
    """Accumulate (x, y) observations into a 2D histogram grid."""

    def __init__(self, x_range: tuple[float, float], y_range: tuple[float, float],
                 bins: tuple[int, int] = (64, 64)) -> None:
        self.x_range = x_range
        self.y_range = y_range
        self.bins = bins
        self.grid = np.zeros(bins, dtype=np.int64)

    def record(self, xs: np.ndarray, ys: np.ndarray) -> None:
        hist, _, _ = np.histogram2d(
            np.asarray(xs).reshape(-1), np.asarray(ys).reshape(-1),
            bins=self.bins, range=[self.x_range, self.y_range],
        )
        self.grid += hist.astype(np.int64)

    @property
    def density(self) -> np.ndarray:
        total = self.grid.sum()
        return self.grid / max(total, 1)

    def save(self, path) -> None:
        np.savez(path, grid=self.grid, x_range=self.x_range, y_range=self.y_range)

    @classmethod
    def load(cls, path) -> "GridRecorder":
        with np.load(path) as d:
            rec = cls(tuple(d["x_range"]), tuple(d["y_range"]), d["grid"].shape)
            rec.grid = d["grid"].copy()
        return rec


class Chain:
    """Composable function wrapper: ``(Chain(f) >> g >> h)(x) == h(g(f(x)))``."""

    def __init__(self, fn: Callable) -> None:
        self.fn = fn

    def __rshift__(self, other: Callable) -> "Chain":
        nxt = other.fn if isinstance(other, Chain) else other
        return Chain(lambda *a, **k: nxt(self.fn(*a, **k)))

    def __call__(self, *args, **kwargs):
        return self.fn(*args, **kwargs)
