"""SoA factor-graph storage: growable column stores + typed views.

Copy of ``macvo_tpu/worldmap/storage.py`` (reference map store:
Module/Map/Graph.py:19-114, Utility/Extensions/TensorExtension.py:60-159). The
map is host-side bookkeeping — irregular, append-only, consumed in
fixed-shape slices by the backend — so columns are numpy arrays with
amortized-doubling growth.
Device code never touches this store directly; the odometry driver carves
static-shape windows out of it (see backend/two_frame_pgo.py).

``Bundle`` is the reference's ``TensorBundle``: a dict of per-row arrays plus
the row indices it refers to. ``Store`` is ``AutoScalingBundle``: the growable
owner that ``push``es new rows and returns their global indices.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np

# Field schema: name -> (row_shape, dtype)
FieldSpec = Mapping[str, tuple[tuple[int, ...], np.dtype]]


class GrowableArray:
    """Amortized-doubling append buffer (reference: AutoScalingTensor,
    Utility/Extensions/TensorExtension.py:60-159)."""

    def __init__(self, row_shape: tuple[int, ...], dtype, init_capacity: int = 1024) -> None:
        self.row_shape = tuple(row_shape)
        self.dtype = np.dtype(dtype)
        self._buf = np.zeros((init_capacity,) + self.row_shape, dtype=self.dtype)
        self._size = 0

    def __len__(self) -> int:
        return self._size

    @property
    def array(self) -> np.ndarray:
        """View of the valid rows (no copy)."""
        return self._buf[: self._size]

    def _ensure(self, extra: int) -> None:
        need = self._size + extra
        if need <= self._buf.shape[0]:
            return
        cap = max(self._buf.shape[0] * 2, need)
        new = np.zeros((cap,) + self.row_shape, dtype=self.dtype)
        new[: self._size] = self._buf[: self._size]
        self._buf = new

    def push(self, rows: np.ndarray) -> np.ndarray:
        rows = np.asarray(rows, dtype=self.dtype)
        if rows.shape[1:] != self.row_shape:
            raise ValueError(f"push: expected rows of shape (N,{self.row_shape}), got {rows.shape}")
        n = rows.shape[0]
        self._ensure(n)
        self._buf[self._size : self._size + n] = rows
        idx = np.arange(self._size, self._size + n, dtype=np.int64)
        self._size += n
        return idx

    def __getitem__(self, idx):
        return self.array[idx]

    def __setitem__(self, idx, value) -> None:
        self.array[idx] = value


class Bundle:
    """A typed view: row ``index`` (N,) into a store + the column data (N,...).

    Mirrors the reference's TensorBundle (Module/Map/Graph.py:19-76): getitem
    produces a sub-Bundle, columns are accessed through ``.data``.
    """

    def __init__(self, data: dict[str, np.ndarray], index: np.ndarray) -> None:
        self.data = data
        self.index = np.asarray(index, dtype=np.int64)

    @classmethod
    def init(cls, data: dict[str, np.ndarray]) -> "Bundle":
        n = next(iter(data.values())).shape[0] if data else 0
        for k, v in data.items():
            if v.shape[0] != n:
                raise ValueError(f"Bundle.init: field '{k}' has {v.shape[0]} rows, expected {n}")
        return cls(data, np.full((n,), -1, dtype=np.int64))

    def __len__(self) -> int:
        return int(self.index.shape[0])

    def __getitem__(self, idx) -> "Bundle":
        return Bundle({k: v[idx] for k, v in self.data.items()}, self.index[idx])

    def serialize(self, prefix: str) -> dict[str, np.ndarray]:
        out = {prefix + "index": np.asarray(self.index)}
        for k, v in self.data.items():
            out[prefix + k] = np.asarray(v)
        return out


class Store:
    """Growable SoA store; ``push`` appends a Bundle's rows and assigns global
    indices (reference: AutoScalingBundle, Module/Map/Graph.py:80-114)."""

    def __init__(self, fields: FieldSpec, init_capacity: int = 1024) -> None:
        self.fields = {k: (tuple(shape), np.dtype(dt)) for k, (shape, dt) in fields.items()}
        self.columns = {
            k: GrowableArray(shape, dt, init_capacity) for k, (shape, dt) in self.fields.items()
        }
        self._edges: list = []

    def __len__(self) -> int:
        col = next(iter(self.columns.values()))
        return len(col)

    @property
    def data(self) -> dict[str, np.ndarray]:
        return {k: col.array for k, col in self.columns.items()}

    def register_edge(self, edge) -> None:
        """Edges registered here auto-extend when rows are pushed
        (reference: Module/Map/Graph.py:99-106)."""
        self._edges.append(edge)

    def push(self, bundle: Bundle | dict[str, np.ndarray]) -> np.ndarray:
        data = bundle.data if isinstance(bundle, Bundle) else bundle
        missing = set(self.fields) - set(data)
        if missing:
            raise KeyError(f"push: missing fields {sorted(missing)}")
        idx: np.ndarray | None = None
        for k in self.fields:
            got = self.columns[k].push(np.asarray(data[k]))
            if idx is None:
                idx = got
            elif got.shape != idx.shape:
                raise ValueError(f"push: ragged field '{k}'")
        assert idx is not None
        for edge in self._edges:
            edge.grow_to(len(self))
        return idx

    def __getitem__(self, idx) -> Bundle:
        index = np.atleast_1d(np.arange(len(self), dtype=np.int64)[idx])
        rows = {k: col[index] for k, col in self.columns.items()}
        return Bundle(rows, index)

    def bundle(self) -> Bundle:
        """The whole store as one Bundle view."""
        return Bundle(self.data, np.arange(len(self), dtype=np.int64))

    def serialize(self, prefix: str) -> dict[str, np.ndarray]:
        return self.bundle().serialize(prefix)

    def deserialize(self, prefix: str, values: Mapping[str, np.ndarray]) -> "Store":
        for k in self.fields:
            arr = values[prefix + k]
            self.columns[k] = GrowableArray(self.fields[k][0], self.fields[k][1], max(len(arr), 1))
            self.columns[k].push(arr)
        return self
