#!/usr/bin/env python3
"""Time two versions of the port's CUDA kernels in one process, in turns.

    mkdir -p results/old_csrc
    git show 55f71bd:macvo_tpu_torch/csrc/correlation_bwd.cu > results/old_csrc/correlation_bwd.cu
    git show 55f71bd:macvo_tpu_torch/csrc/correlation.cu > results/old_csrc/correlation.cu
    python scripts/torch_kernel_compare.py --old results/old_csrc

``--old`` is a directory (one ``.gitignore`` lists: the sources are not part of
the package) holding earlier sources of any of ``csrc/correlation.cu``,
``csrc/latent_attn.cu`` and ``csrc/correlation_bwd.cu``; each one present is
compared, the others are skipped. Their launchers are called with the
arguments they took before the launchers were given the device index. The
package builds today's sources; the old ones are compiled here, with the
package's own ``nvcc`` flags, into the old directory. Both versions are checked
against the plain PyTorch version on the same inputs and timed in the order
old, new, new, old (device time: ``--iters`` launches in one CUDA graph,
replayed between two CUDA events), so that both see the same card, clocks and
neighbours; each also gets one host-inclusive time (``*_eager_ms``: calls from
Python between two events).

* ``correlation.cu``: the five shapes of a 640x640 PWC forward.
* ``latent_attn.cu``: N = 12,800 pixels, T = 100 tokens, bf16 and fp32, through
  the folded entry the perceiver calls.
* ``correlation_bwd.cu``: both shape sets of ``chip_smoke.CORR_BWD_SHAPES`` (a
  trainer step's five calls at 4x320x448, and 640x640), the new kernel's rerun
  held bit-identical; and the 80x112x32 level with the L2 cold (a 256 MB
  write before each call), since its inputs (30 MB) stay in the 50 MB L2 when a
  graph is replayed.
* Host cost of the wrappers, where the old correlation sources are there: the
  wrappers as they were before (a copy of their steps, here, calling the old
  launchers) against the package's, ``ms - device_ms`` a call at 10x10x196 and
  160x160x32 for the forward and the backward, and each step alone on the host
  clock (``pieces_us``).

Prints one JSON line a row and the record, and writes the record to
``chiprun_out/kernel_compare.json``. Needs an NVIDIA card.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from chip_smoke import CORR_BWD_SHAPES, correlation_bwd_bound_ms, graph_time_ms  # noqa: E402
from chip_smoke import cuda_time_ms as eager_ms  # noqa: E402
from macvo_tpu_torch.ops import _build, correlation, latent_attn  # noqa: E402

OLD_SOURCES = ("correlation.cu", "latent_attn.cu", "correlation_bwd.cu")
CORR_SHAPES = [(1, 32, 160, 160), (1, 64, 80, 80), (1, 96, 40, 40), (1, 128, 20, 20), (1, 196, 10, 10)]
LATENT_SHAPE = (12800, 100)
COLD_SHAPE = (4, 32, 80, 112)
HOST_SHAPES = [(1, 196, 10, 10), (1, 32, 160, 160)]


def old_sources(old_dir: Path) -> dict[str, Path]:
    """The earlier sources found in ``old_dir``, by file name (any subset of
    ``OLD_SOURCES``); raises SystemExit when the directory holds none."""
    if not old_dir.is_dir():
        raise SystemExit(f"--old {old_dir}: no such directory")
    found = {name: old_dir / name for name in OLD_SOURCES if (old_dir / name).is_file()}
    if not found:
        raise SystemExit(f"--old {old_dir} holds none of {', '.join(OLD_SOURCES)}")
    return found


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


def _old_fn(lib, name: str, pointers: int):
    fn = getattr(lib, name)
    fn.argtypes = [ctypes.c_void_p] * pointers + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def old_correlation(lib):
    """An earlier correlation launcher: (f1, f2, out, B, C, H, W, radius, stream)."""
    fn = _old_fn(lib, "correlation_launch", 3)

    def run(f1, f2):
        b, c, h, w = f1.shape
        out = torch.empty((b, 81, h, w), device=f1.device)
        err = fn(f1.data_ptr(), f2.data_ptr(), out.data_ptr(), b, c, h, w, 4,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"old correlation kernel: cudaError {err}")
        return out
    return run


def old_correlation_bwd(lib):
    """An earlier backward launcher: (f1, f2, g, grad_f1, grad_f2, B, C, H, W, radius, stream)."""
    fn = _old_fn(lib, "correlation_bwd_launch", 5)

    def run(f1, f2, g):
        b, c, h, w = f1.shape
        g1, g2 = torch.empty_like(f1), torch.empty_like(f2)
        err = fn(f1.data_ptr(), f2.data_ptr(), g.data_ptr(), g1.data_ptr(), g2.data_ptr(), b, c, h, w, 4,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"old correlation backward kernel: cudaError {err}")
        return g1, g2
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


def cold_ms(fn, iters: int = 20) -> float:
    """Mean device time of one call with the L2 emptied first: a 256 MB buffer
    (five times the 50 MB L2) is written before each call, and only the call
    lies between the two events."""
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device="cuda")
    for _ in range(3):
        fn()
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    torch.cuda.synchronize()
    for start, end in events:
        flush.fill_(1.0)
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in events) / iters


def compare_correlation(lib, gen, dev, iters: int) -> dict:
    run_old = old_correlation(lib)
    rows = []
    for shape in CORR_SHAPES:
        f1, f2 = (torch.randn(shape, generator=gen).to(dev) for _ in range(2))
        ref = correlation.local_correlation_torch(f1, f2)
        err_old = float((run_old(f1, f2) - ref).abs().max())
        err_new = float((correlation.local_correlation(f1, f2) - ref).abs().max())
        row = {"shape_bchw": list(shape), "max_abs_err_old": err_old, "max_abs_err_new": err_new,
               "cluster": correlation.cluster_size(*shape, torch.cuda.get_device_properties(dev).multi_processor_count)}
        row.update(in_turns(lambda: run_old(f1, f2), lambda: correlation.local_correlation(f1, f2), iters))
        rows.append(row)
        print(json.dumps({"correlation": row}), flush=True)
    total_old = sum(sum(r["old_ms"]) / 2 for r in rows)
    total_new = sum(sum(r["new_ms"]) / 2 for r in rows)
    return {"rows": rows, "total": {"old_ms": total_old, "new_ms": total_new, "speedup": total_old / total_new}}


def compare_correlation_bwd(lib, gen, dev, iters: int) -> dict:
    run_old = old_correlation_bwd(lib)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rec = {}
    for set_name, shapes in CORR_BWD_SHAPES.items():
        rows = []
        for shape in shapes:
            b, _, h, w = shape
            f1, f2 = (torch.randn(shape, generator=gen).to(dev) for _ in range(2))
            g = torch.randn((b, 81, h, w), generator=gen).to(dev)
            r1, r2 = correlation.local_correlation_bwd_torch(f1, f2, g)
            o1, o2 = run_old(f1, f2, g)
            n1, n2 = correlation.local_correlation_backward(f1, f2, g)
            m1, m2 = correlation.local_correlation_backward(f1, f2, g)
            torch.cuda.synchronize()
            row = {"shape_bchw": list(shape), "groups": correlation.bwd_channel_groups(*shape, sms),
                   "max_abs_err_old": max(float((o1 - r1).abs().max()), float((o2 - r2).abs().max())),
                   "max_abs_err_new": max(float((n1 - r1).abs().max()), float((n2 - r2).abs().max())),
                   "agrees_new": all(bool(((o - r).abs() <= 1e-5 + 1e-5 * r.abs()).all())
                                     for o, r in ((n1, r1), (n2, r2))),
                   "bit_identical_rerun_new": bool(torch.equal(n1, m1) and torch.equal(n2, m2))}
            row["bound_ms"], row["bound_by"] = correlation_bwd_bound_ms(*shape)
            row.update(in_turns(lambda: run_old(f1, f2, g),
                                lambda: correlation.local_correlation_backward(f1, f2, g), iters))
            row["bound_share_old"] = row["bound_ms"] / (sum(row["old_ms"]) / 2)
            row["bound_share_new"] = row["bound_ms"] / (sum(row["new_ms"]) / 2)
            if shape == COLD_SHAPE:
                cold = [cold_ms(fn) for fn in (lambda: run_old(f1, f2, g),
                                               lambda: correlation.local_correlation_backward(f1, f2, g),
                                               lambda: correlation.local_correlation_backward(f1, f2, g),
                                               lambda: run_old(f1, f2, g))]
                row["cold_old_ms"], row["cold_new_ms"] = [cold[0], cold[3]], [cold[1], cold[2]]
                row["cold_bound_share_new"] = row["bound_ms"] / (sum(row["cold_new_ms"]) / 2)
            rows.append(row)
            print(json.dumps({"correlation_bwd": set_name, **row}), flush=True)
        total = {key: sum(sum(r[f"{key}_ms"]) / 2 for r in rows) for key in ("old", "new")}
        total["bound_ms"] = sum(r["bound_ms"] for r in rows)
        total.update(speedup=total["old"] / total["new"], bound_share_old=total["bound_ms"] / total["old"],
                     bound_share_new=total["bound_ms"] / total["new"])
        rec[set_name] = {"rows": rows, "total_ms": total}
    return rec


def compare_latent(lib, gen, dev, iters: int) -> list:
    run_old_l = old_latent(lib)
    n, t = LATENT_SHAPE

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen) * scale).to(dev)

    wk, bk, wv, bv = rnd(64, 128, scale=0.1), rnd(128, scale=0.1), rnd(64, 128, scale=0.1), rnd(128, scale=0.1)
    q, wp, bias = rnd(8, 128), rnd(128, 128, scale=0.1), rnd(8, 128)
    folded = latent_attn.fold_weights(wk, bk, wv, bv, q, wp, bias)
    tokens32 = rnd(n, t, 64)
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        tokens = tokens32.to(dtype)
        ref = latent_attn.latent_cross_attention_torch(tokens, wk, bk, wv, bv, q, wp, bias).float()
        err_old = float((run_old_l(tokens, *folded).float() - ref).abs().max())
        err_new = float((latent_attn.latent_attn_folded(tokens, *folded).float() - ref).abs().max())
        row = {"dtype": str(dtype).removeprefix("torch."), "shape": [n, t, 64],
               "max_abs_err_old": err_old, "max_abs_err_new": err_new}
        row.update(in_turns(lambda: run_old_l(tokens, *folded),
                            lambda: latent_attn.latent_attn_folded(tokens, *folded), iters))
        rows.append(row)
        print(json.dumps({"latent_attn": row}), flush=True)
    return rows


# -- host cost: the wrappers' steps as they were before the launchers took the device index --

def legacy_forward(lib):
    """The forward entry and wrapper as they were: device-type strings, the
    check (unchanged), ``torch.empty``, a ``torch.cuda.device`` guard and a
    ``torch.cuda.current_stream`` around the old launcher."""
    fn = _old_fn(lib, "correlation_launch", 3)

    def run(f1, f2, radius=4):
        if f1.device.type == "cpu" or f1.device.type != "cuda":
            raise ValueError("cuda only")
        if torch.is_grad_enabled() and (f1.requires_grad or f2.requires_grad):
            raise ValueError("no grad")
        correlation._check(f1, f2, radius)
        b, c, h, w = f1.shape
        out = torch.empty((b, 81, h, w), dtype=torch.float32, device=f1.device)
        with torch.cuda.device(f1.device):
            err = fn(f1.data_ptr(), f2.data_ptr(), out.data_ptr(), b, c, h, w, radius,
                     torch.cuda.current_stream(f1.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"cudaError {err}")
        return out
    return run


def legacy_backward(lib):
    """The backward entry as it was (see :func:`legacy_forward`)."""
    fn = _old_fn(lib, "correlation_bwd_launch", 5)

    def run(f1, f2, g, radius=4):
        if f1.device.type == "cpu" or f1.device.type != "cuda":
            raise ValueError("cuda only")
        correlation._check(f1, f2, radius)
        b, c, h, w = f1.shape
        if g.dtype != torch.float32 or tuple(g.shape) != (b, 81, h, w) or g.device != f1.device:
            raise ValueError("gradient")
        g = g.contiguous()
        g1, g2 = torch.empty_like(f1), torch.empty_like(f2)
        with torch.cuda.device(f1.device):
            err = fn(f1.data_ptr(), f2.data_ptr(), g.data_ptr(), g1.data_ptr(), g2.data_ptr(), b, c, h, w, radius,
                     torch.cuda.current_stream(f1.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"cudaError {err}")
        return g1, g2
    return run


def host_us(fn, n: int) -> float:
    """Host microseconds a call, on the host clock (no synchronisation inside)."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    start = time.perf_counter()
    for _ in range(n):
        fn()
    return (time.perf_counter() - start) / n * 1e6


def host_cost(old_fwd, old_bwd, gen, dev, iters: int) -> dict:
    rec = {"rows": [], "pieces_us": {}}
    for shape in HOST_SHAPES:
        b, _, h, w = shape
        f1, f2 = (torch.randn(shape, generator=gen).to(dev) for _ in range(2))
        g = torch.randn((b, 81, h, w), generator=gen).to(dev)
        pairs = []
        if old_fwd is not None:
            leg = legacy_forward(old_fwd)
            pairs.append(("forward", lambda: leg(f1, f2), lambda: correlation.local_correlation(f1, f2)))
        if old_bwd is not None:
            legb = legacy_backward(old_bwd)
            pairs.append(("backward", lambda: legb(f1, f2, g), lambda: correlation.local_correlation_backward(f1, f2, g)))
        for kernel, old, new in pairs:
            row = {"kernel": kernel, "shape_bchw": list(shape)}
            for name, fn in (("before", old), ("after", new), ("after", new), ("before", old)):
                ms, device_ms = eager_ms(fn, 50), graph_time_ms(fn, 50)
                row.setdefault(name, []).append({"ms": ms, "device_ms": device_ms, "host_us": (ms - device_ms) * 1e3})
            rec["rows"].append(row)
            print(json.dumps({"host_cost": row}), flush=True)
        if shape == HOST_SHAPES[0]:
            index = f1.get_device()
            raw = torch._C._cuda_getCurrentRawStream
            steps = {
                "check": lambda: correlation._check(f1, f2, 4),
                "device_type_strings": lambda: f1.device.type == "cpu" or f1.device.type != "cuda",
                "is_cpu_is_cuda": lambda: f1.is_cpu or not f1.is_cuda,
                "torch_empty": lambda: torch.empty((b, 81, h, w), dtype=torch.float32, device=f1.device),
                "new_empty": lambda: f1.new_empty((b, 81, h, w)),
                "two_empty_like": lambda: (torch.empty_like(f1), torch.empty_like(f2)),
                "current_stream": lambda: torch.cuda.current_stream(f1.device).cuda_stream,
                "raw_stream": lambda: raw(index),
            }

            def device_guard():
                with torch.cuda.device(f1.device):
                    pass
            steps["device_guard"] = device_guard
            out = torch.empty((b, 81, h, w), device=dev)
            stream = torch.cuda.current_stream().cuda_stream
            if old_fwd is not None:
                fn_old = _old_fn(old_fwd, "correlation_launch", 3)
                args = (f1.data_ptr(), f2.data_ptr(), out.data_ptr(), b, shape[1], h, w, 4)
                steps["launcher_before"] = lambda: fn_old(*args, stream)
                steps["launcher_after"] = lambda: correlation._kernel()(*args, index, stream)
                query = _build.build("correlation").lib.correlation_cluster_size
                query.argtypes, query.restype = [ctypes.c_int] * 5, ctypes.c_int
                steps["ctypes_five_ints"] = lambda: query(b, shape[1], h, w, 132)
            for name, fn in steps.items():
                n = 200 if name.startswith("launcher_") else 5000
                rec["pieces_us"][name] = host_us(fn, n)
            torch.cuda.synchronize()
            print(json.dumps({"pieces_us": rec["pieces_us"]}), flush=True)
    return rec


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--old", required=True,
                        help=f"directory with earlier sources: any of {', '.join(OLD_SOURCES)}")
    parser.add_argument("--iters", type=int, default=200)
    args = parser.parse_args(argv)
    found = old_sources(Path(args.old))
    if not torch.cuda.is_available():
        raise SystemExit("torch_kernel_compare needs an NVIDIA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    stems = [name.removesuffix(".cu") for name in found]
    with ThreadPoolExecutor(2 * len(stems)) as pool:     # one nvcc process a source, started together
        new = dict(zip(stems, pool.map(_build.build, stems)))
        old = dict(zip(stems, pool.map(build_old, found.values())))
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    rec = {"card": smi, "iters": args.iters, "old_sources": sorted(found),
           "ptxas": {**{k: v.ptxas.splitlines() for k, v in new.items()},
                     **{f"{k}_old": v[1].splitlines() for k, v in old.items()}}}
    if "correlation" in old:
        rec["correlation"] = compare_correlation(old["correlation"][0], gen, dev, args.iters)
    if "correlation_bwd" in old:
        rec["correlation_bwd"] = compare_correlation_bwd(old["correlation_bwd"][0], gen, dev, args.iters)
    if "latent_attn" in old:
        rec["latent_attn"] = compare_latent(old["latent_attn"][0], gen, dev, args.iters)
    if "correlation" in old or "correlation_bwd" in old:
        rec["host_cost"] = host_cost(old.get("correlation", (None,))[0], old.get("correlation_bwd", (None,))[0],
                                     gen, dev, args.iters)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "kernel_compare.json").write_text(json.dumps(rec, indent=1))
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
