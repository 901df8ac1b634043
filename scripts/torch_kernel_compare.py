#!/usr/bin/env python3
"""Time two versions of the port's CUDA kernels in one process, in turns.

    git show a8c139e:macvo_tpu_torch/csrc/correlation.cu > results/old_csrc/correlation.cu
    git show a8c139e:macvo_tpu_torch/csrc/latent_attn.cu > results/old_csrc/latent_attn.cu
    python scripts/torch_kernel_compare.py --old results/old_csrc

``--old`` holds earlier sources of ``csrc/correlation.cu`` and
``csrc/latent_attn.cu`` (the directory must be one ``.gitignore`` lists: they
are not part of the package). The package builds today's sources; the old ones
are compiled here, with the package's own ``nvcc`` flags, into the old
directory. Both are checked against the plain PyTorch version on the same inputs,
and timed at the main path's shapes in the order old, new, new, old (device
time: ``--iters`` launches in one CUDA graph, replayed between two CUDA
events), so that both see the same card, clocks and neighbours; each also
gets one host-inclusive time (``*_eager_ms``: calls from Python between two
events). The correlation runs at the five shapes of a 640x640 PWC forward,
the latent attention at N = 12,800 pixels and T = 100 tokens, bf16
and fp32, through the folded entry the perceiver calls. Prints one JSON line
and writes it to ``chiprun_out/kernel_compare.json``. Needs an NVIDIA card.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from chip_smoke import cuda_time_ms as eager_ms  # noqa: E402
from chip_smoke import graph_time_ms  # noqa: E402
from macvo_tpu_torch.ops import _build, correlation, latent_attn  # noqa: E402

CORR_SHAPES = [(1, 32, 160, 160), (1, 64, 80, 80), (1, 96, 40, 40), (1, 128, 20, 20), (1, 196, 10, 10)]
LATENT_SHAPE = (12800, 100)


def build_old(src: Path) -> tuple[ctypes.CDLL, str]:
    """Compile an earlier source next to itself (name carries its hash) and load
    it; returns the library and ptxas's register / shared-memory report."""
    digest = hashlib.sha256(src.read_bytes() + " ".join(_build.NVCC_FLAGS).encode()).hexdigest()[:16]
    lib_path = src.with_name(f"lib{src.stem}_{digest}.so")
    proc = subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", str(lib_path), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}:\n{proc.stdout}{proc.stderr}")
    return ctypes.CDLL(str(lib_path)), _build._ptxas_lines(proc.stdout + proc.stderr)


def old_correlation(lib):
    """The first correlation launcher: (f1, f2, out, B, C, H, W, radius, stream)."""
    fn = lib.correlation_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def run(f1, f2):
        b, c, h, w = f1.shape
        out = torch.empty((b, 81, h, w), device=f1.device)
        err = fn(f1.data_ptr(), f2.data_ptr(), out.data_ptr(), b, c, h, w, 4,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"old correlation kernel: cudaError {err}")
        return out
    return run


def old_latent(lib):
    """The first latent-attention launcher, with today's arguments:
    (tokens, M, Wvp, c, out, N, T, 64, 8, 128, dtype code, stream)."""
    fn = lib.latent_attn_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_longlong] + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def run(tokens, m, wvp, c):
        n, t, _ = tokens.shape
        out = torch.empty((n, 8, 128), dtype=tokens.dtype, device=tokens.device)
        err = fn(tokens.data_ptr(), m.data_ptr(), wvp.data_ptr(), c.data_ptr(), out.data_ptr(), n, t, 64, 8, 128,
                 0 if tokens.dtype == torch.float32 else 1, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"old latent_attn kernel: cudaError {err}")
        return out
    return run


def in_turns(old, new, iters: int) -> dict:
    times = [graph_time_ms(fn, iters) for fn in (old, new, new, old)]
    return {"old_ms": [times[0], times[3]], "new_ms": [times[1], times[2]],
            "speedup": (times[0] + times[3]) / (times[1] + times[2]),
            "old_eager_ms": eager_ms(old, iters), "new_eager_ms": eager_ms(new, iters)}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--old", required=True, help="directory with the earlier correlation.cu and latent_attn.cu")
    parser.add_argument("--iters", type=int, default=200)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_kernel_compare needs an NVIDIA card")
    old_dir = Path(args.old)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    with ThreadPoolExecutor(4) as pool:     # one nvcc process a source, started together
        new = pool.map(_build.build, ("correlation", "latent_attn"))
        old = pool.map(build_old, (old_dir / "correlation.cu", old_dir / "latent_attn.cu"))
        (corr_new, latent_new), ((corr_old, corr_old_ptxas), (latent_old, latent_old_ptxas)) = list(new), list(old)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    rec = {"card": smi, "iters": args.iters,
           "ptxas": {"correlation": corr_new.ptxas.splitlines(), "latent_attn": latent_new.ptxas.splitlines(),
                     "correlation_old": corr_old_ptxas.splitlines(), "latent_attn_old": latent_old_ptxas.splitlines()},
           "correlation": [], "latent_attn": []}

    run_old = old_correlation(corr_old)
    for shape in CORR_SHAPES:
        f1, f2 = (torch.randn(shape, generator=gen).to(dev) for _ in range(2))
        ref = correlation.local_correlation_torch(f1, f2)
        err_old = float((run_old(f1, f2) - ref).abs().max())
        err_new = float((correlation.local_correlation(f1, f2) - ref).abs().max())
        row = {"shape_bchw": list(shape), "max_abs_err_old": err_old, "max_abs_err_new": err_new,
               "cluster": correlation.cluster_size(*shape, torch.cuda.get_device_properties(dev).multi_processor_count)}
        row.update(in_turns(lambda: run_old(f1, f2), lambda: correlation.local_correlation(f1, f2), args.iters))
        rec["correlation"].append(row)
        print(json.dumps(row), flush=True)
    total_old = sum(sum(r["old_ms"]) / 2 for r in rec["correlation"])
    total_new = sum(sum(r["new_ms"]) / 2 for r in rec["correlation"])
    rec["correlation_total"] = {"old_ms": total_old, "new_ms": total_new, "speedup": total_old / total_new}

    run_old_l = old_latent(latent_old)
    n, t = LATENT_SHAPE

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen) * scale).to(dev)

    wk, bk, wv, bv = rnd(64, 128, scale=0.1), rnd(128, scale=0.1), rnd(64, 128, scale=0.1), rnd(128, scale=0.1)
    q, wp, bias = rnd(8, 128), rnd(128, 128, scale=0.1), rnd(8, 128)
    folded = latent_attn.fold_weights(wk, bk, wv, bv, q, wp, bias)
    tokens32 = rnd(n, t, 64)
    for dtype in (torch.bfloat16, torch.float32):
        tokens = tokens32.to(dtype)
        ref = latent_attn.latent_cross_attention_torch(tokens, wk, bk, wv, bv, q, wp, bias).float()
        err_old = float((run_old_l(tokens, *folded).float() - ref).abs().max())
        err_new = float((latent_attn.latent_attn_folded(tokens, *folded).float() - ref).abs().max())
        row = {"dtype": str(dtype).removeprefix("torch."), "shape": [n, t, 64],
               "max_abs_err_old": err_old, "max_abs_err_new": err_new}
        row.update(in_turns(lambda: run_old_l(tokens, *folded),
                            lambda: latent_attn.latent_attn_folded(tokens, *folded), args.iters))
        rec["latent_attn"].append(row)
        print(json.dumps(row), flush=True)

    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "kernel_compare.json").write_text(json.dumps(rec, indent=1))
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
