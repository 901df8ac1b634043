"""Build the package's CUDA sources with ``nvcc`` and load them with ``ctypes``.

Each source under ``macvo_tpu_torch/csrc/`` has a plain ``extern "C"`` launcher
that takes raw pointers, sizes and the stream and returns ``cudaGetLastError()``.
It is compiled for ``sm_90a`` into a shared library under
``macvo_tpu_torch/_build/`` (listed in ``.gitignore``) the first time a kernel
is launched; the file name carries a hash of the source and flags, so an edit
rebuilds. No PyTorch header is included, which keeps one build to seconds.
Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


@dataclass
class BuiltLibrary:
    name: str
    path: Path
    lib: ctypes.CDLL
    seconds: float          # build time; 0.0 when an earlier build was reused
    ptxas: str              # the ``-Xptxas -v`` register / shared-memory report


_LOADED: dict[str, BuiltLibrary] = {}


def find_nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels are built on first use")
    return found


def _ptxas_lines(log: str) -> str:
    return "\n".join(line.strip() for line in log.splitlines()
                     if "registers" in line or "Compiling entry" in line or "bytes stack" in line)


def build(name: str) -> BuiltLibrary:
    """Compile ``csrc/<name>.cu`` (once per process and source hash) and load it."""
    if name in _LOADED:
        return _LOADED[name]
    src = CSRC_DIR / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib_path = BUILD_DIR / f"lib{name}_{digest}.so"
    log_path = BUILD_DIR / f"lib{name}_{digest}.log"
    seconds = 0.0
    if not lib_path.exists():
        tmp = lib_path.with_name(f"{lib_path.stem}.{os.getpid()}.tmp.so")
        cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        start = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        seconds = time.perf_counter() - start
        log = proc.stdout + proc.stderr
        log_path.write_text(log)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {src} (rc {proc.returncode}):\n{log}")
        os.replace(tmp, lib_path)
    log = log_path.read_text() if log_path.exists() else ""
    built = BuiltLibrary(name, lib_path, ctypes.CDLL(str(lib_path)), seconds, _ptxas_lines(log))
    _LOADED[name] = built
    return built
