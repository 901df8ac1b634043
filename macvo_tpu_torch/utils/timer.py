"""Opt-in stage timer (port of ``macvo_tpu/utils/timer.py``).

``cpu_time`` sections take host wall-clock time: on the card that is the
time the host spends in a stage (launching its work and whatever it waits
for), as in the JAX package. ``device_time`` sections on a CUDA tensor or
device record two ``torch.cuda.Event`` on the current stream and nothing
else: the events are resolved into milliseconds only at :func:`report` /
:func:`save_elapsed`, so timing a frame adds no synchronisation to it. On
the CPU, where work runs as it is called, a device section is host time.
When the timer is off (the default) no section records or synchronises
anything. :func:`trace` wraps ``torch.profiler`` (Chrome trace format);
:func:`stage_profile` gives one stage's wall and device time, as the stage
profilers (``scripts/torch_profile_{frontend,pipeline}.py``) report them.
"""

from __future__ import annotations

import contextlib
import functools
import json
import math
import statistics
import time
from pathlib import Path
from typing import Any, Callable, Iterator

import torch


class _TimerState:
    def __init__(self) -> None:
        self.active = False
        self.records: dict[str, list[float]] = {}
        self.pending: list[tuple[str, Any, Any]] = []     # (name, start event, end event), in record order

    def add(self, name: str, elapsed_ms: float) -> None:
        self.records.setdefault(name, []).append(elapsed_ms)

    def resolve(self) -> None:
        """Turn the recorded CUDA event pairs into milliseconds (waits for them)."""
        for name, start, end in self.pending:
            end.synchronize()
            self.add(name, start.elapsed_time(end))
        self.pending.clear()


_STATE = _TimerState()


def setup(active: bool) -> None:
    _STATE.active = active


def is_active() -> bool:
    return _STATE.active


def _on_card(on: tuple) -> bool:
    for x in on:
        dev = x.device if isinstance(x, torch.Tensor) else torch.device(x)
        if dev.type == "cuda":
            return True
    return False


@contextlib.contextmanager
def cpu_time(name: str) -> Iterator[None]:
    if not _STATE.active:
        yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        _STATE.add(name, (time.perf_counter() - t0) * 1e3)


@contextlib.contextmanager
def device_time(name: str, *on: torch.Tensor | torch.device | str) -> Iterator[None]:
    """Times the device work launched inside the section: with CUDA events
    when any of ``on`` (tensors or devices) is on the card, else host time."""
    if not _STATE.active:
        yield
        return
    if _on_card(on):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        try:
            yield
        finally:
            end.record()
            _STATE.pending.append((name, start, end))
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        _STATE.add(name, (time.perf_counter() - t0) * 1e3)


def cpu_timeit(name: str) -> Callable:
    def deco(fn: Callable) -> Callable:
        @functools.wraps(fn)
        def wrapped(*args: Any, **kwargs: Any) -> Any:
            with cpu_time(name):
                return fn(*args, **kwargs)

        return wrapped

    return deco


def device_timeit(name: str, device: torch.device | str) -> Callable:
    """Decorator: the function's device work on ``device``, as :func:`device_time`."""

    def deco(fn: Callable) -> Callable:
        @functools.wraps(fn)
        def wrapped(*args: Any, **kwargs: Any) -> Any:
            with device_time(name, device):
                return fn(*args, **kwargs)

        return wrapped

    return deco


@contextlib.contextmanager
def trace(logdir: str | Path, filename: str = "trace.json") -> Iterator[None]:
    """``torch.profiler`` over the section (the card's activity too, where
    there is one); the Chrome trace goes to ``logdir/filename``."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    Path(logdir).mkdir(parents=True, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(str(Path(logdir) / filename))


def stage_profile(fn: Callable[[], Any], device: torch.device | str, reps: int = 10, profiled: int = 3,
                  warmup: int = 2, step_ms: float = 20.0) -> dict:
    """One stage's cost, ``fn`` called with nothing else queued: ``wall_ms``,
    the median of ``reps`` synced calls (between CUDA events on the card, on
    the host clock on the CPU); on the card also ``device_ms``, one call's
    device time (the durations of its kernels, copies and memsets summed, from
    ``torch.profiler``), ``kernels``, that activity's count a call, and
    ``busy`` = device_ms / wall_ms. On the CPU those three are None (no
    device to trace).

    The profiler runs in a session of its own: a step skipped, a step that
    warms the tracer up, then ``profiled`` recorded steps, each of as many
    calls as fill ``step_ms`` (at least one). A session of a few short calls
    lost some or all of their kernels in a long-lived process, so a short
    stage is averaged over many calls."""
    on_card = torch.device(device).type == "cuda"
    for _ in range(warmup):
        fn()
    walls = []
    for _ in range(reps):
        if on_card:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            walls.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            fn()
            walls.append((time.perf_counter() - t0) * 1e3)
    rec = {"wall_ms": statistics.median(walls), "device_ms": None, "kernels": None, "busy": None, "reps": reps}
    if on_card:
        calls = max(1, math.ceil(step_ms / max(rec["wall_ms"], 1e-3)))
        torch.cuda.synchronize()
        activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        schedule = torch.profiler.schedule(wait=1, warmup=1, active=profiled)
        with torch.profiler.profile(activities=activities, schedule=schedule) as prof:
            for _ in range(2 + profiled):
                for _ in range(calls):
                    fn()
                torch.cuda.synchronize()
                prof.step()
        # Kernels, copies and memsets: not the steps' own annotations, which
        # span them on the device timeline.
        device = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
                  and not getattr(e, "is_user_annotation", False) and not e.name.startswith("ProfilerStep")]
        rec["profiled_calls"] = calls * profiled
        if device:
            rec["device_ms"] = sum(e.time_range.elapsed_us() for e in device) / 1e3 / rec["profiled_calls"]
            rec["kernels"] = len(device) / rec["profiled_calls"]
            rec["busy"] = rec["device_ms"] / rec["wall_ms"]
    return rec


def records() -> dict[str, list[float]]:
    """Every section's times in ms, CUDA events resolved."""
    _STATE.resolve()
    return _STATE.records


def report() -> str:
    lines = [f"{'section':<28}{'calls':>8}{'avg ms':>12}{'median ms':>12}{'total ms':>12}"]
    for name, vals in sorted(records().items()):
        lines.append(f"{name:<28}{len(vals):>8}{sum(vals) / len(vals):>12.3f}"
                     f"{statistics.median(vals):>12.3f}{sum(vals):>12.1f}")
    text = "\n".join(lines)
    print(text)
    return text


def save_elapsed(path: str | Path) -> None:
    with open(path, "w") as f:
        json.dump(records(), f)


def reset() -> None:
    _STATE.records.clear()
    _STATE.pending.clear()
