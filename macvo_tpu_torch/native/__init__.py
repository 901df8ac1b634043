"""Native (C++) host components, consumed with ctypes (port of
``macvo_tpu/native``).

The threaded PNG decode engine (``loader.cpp``, on libpng) is built with
``g++`` into ``macvo_tpu_torch/_build/`` (listed in ``.gitignore``) the first
time an image is decoded, and loaded from there; the file name carries a hash
of the source and flags, so an edit rebuilds. Where it cannot build or load
(no ``g++``, no libpng headers or library) it logs one warning and :func:`decode_png`
returns None, on which the loaders read with cv2, as the JAX package does.
This is host decoding, not a device kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from ..utils.logging import Logger

_SRC = Path(__file__).resolve().parent / "loader.cpp"
_BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]
_LIBS = ["-lpng", "-lpthread"]
_LIB: Optional[ctypes.CDLL] = None
_BUILD_FAILED = False


def _so_path() -> Path:
    digest = hashlib.sha256(_SRC.read_bytes() + " ".join(_FLAGS + _LIBS).encode()).hexdigest()[:16]
    return _BUILD_DIR / f"libmvo_loader_{digest}.so"


def _build(so: Path) -> bool:
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
    cmd = ["g++", *_FLAGS, str(_SRC), "-o", str(tmp), *_LIBS]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
    except (subprocess.CalledProcessError, subprocess.TimeoutExpired, FileNotFoundError) as exc:
        detail = getattr(exc, "stderr", b"") or b""
        Logger.warning(f"native PNG decoder did not build ({exc}): {detail.decode(errors='replace')[-400:]}; "
                       "images are read with cv2")
        return False
    os.replace(tmp, so)
    return True


def get_lib() -> Optional[ctypes.CDLL]:
    """The native library (built on first use), or None where it cannot build."""
    global _LIB, _BUILD_FAILED
    if _LIB is not None or _BUILD_FAILED:
        return _LIB
    so = _so_path()
    if not so.exists() and not _build(so):
        _BUILD_FAILED = True
        return None
    try:
        lib = ctypes.CDLL(str(so))
    except OSError as exc:           # built elsewhere against a libpng this machine lacks
        Logger.warning(f"native PNG decoder did not load ({exc}); images are read with cv2")
        _BUILD_FAILED = True
        return None
    lib.mvo_decode_png.restype = ctypes.c_int
    lib.mvo_decode_png.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int,
        ctypes.c_int, ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
    ]
    lib.mvo_pool_create.restype = ctypes.c_void_p
    lib.mvo_pool_create.argtypes = [ctypes.c_int]
    lib.mvo_pool_destroy.argtypes = [ctypes.c_void_p]
    lib.mvo_pool_decode_batch.restype = ctypes.c_int
    lib.mvo_pool_decode_batch.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
        ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
    ]
    _LIB = lib
    return lib


def available() -> bool:
    return get_lib() is not None


def decoder() -> str:
    """The PNG decoder the loaders use: ``"native"`` or ``"cv2"``."""
    return "native" if available() else "cv2"


def decode_png(path: str | Path, max_h: int = 4096, max_w: int = 4096) -> Optional[np.ndarray]:
    """Decode one PNG -> (H,W,3) float32 RGB in [0,1]; None where the engine
    is unavailable or the decode failed."""
    lib = get_lib()
    if lib is None:
        return None
    buf = np.empty((max_h, max_w, 3), dtype=np.float32)
    h, w = ctypes.c_int(), ctypes.c_int()
    rc = lib.mvo_decode_png(str(path).encode(), buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                            max_h, max_w, ctypes.byref(h), ctypes.byref(w))
    if rc != 0:
        return None
    # The decoder writes rows tightly packed at the true width.
    return buf.reshape(-1)[: h.value * w.value * 3].reshape(h.value, w.value, 3).copy()


class NativeDecodePool:
    """Threaded batch decoder: paths -> (N,H,W,3) float32, without the GIL."""

    def __init__(self, n_threads: int = 0) -> None:
        lib = get_lib()
        if lib is None:
            raise RuntimeError("native PNG decoder unavailable")
        self._lib = lib
        self._pool = lib.mvo_pool_create(n_threads)

    def decode_batch(self, paths: Sequence[str | Path], height: int, width: int) -> np.ndarray:
        n = len(paths)
        out = np.empty((n, height, width, 3), dtype=np.float32)
        c_paths = (ctypes.c_char_p * n)(*[str(p).encode() for p in paths])
        failures = self._lib.mvo_pool_decode_batch(
            self._pool, c_paths, n, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), height, width)
        if failures:
            raise IOError(f"native decode: {failures}/{n} images failed")
        return out

    def close(self) -> None:
        if self._pool is not None:
            self._lib.mvo_pool_destroy(self._pool)
            self._pool = None

    def __del__(self) -> None:  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass
