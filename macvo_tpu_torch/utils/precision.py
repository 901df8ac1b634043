"""Matmul-precision control for the geometry path and the fp32 networks
(port of ``macvo_tpu/utils/precision.py``).

The geometry (keypoint pipeline, covariance projection, LM solve) is a few
thousand tiny 3x3/6x6 contractions a frame, so it always runs at full fp32
or float64 precision, whatever the caller set: :func:`matmul_highest` (a
decorator) and :func:`highest` (a context) run their body with autocast off
for every device type where it is on, and with TF32 (and oneDNN's bf16
matmuls) off through both of PyTorch's switches: the legacy ones
(``torch.set_float32_matmul_precision``, the ``allow_tf32`` flags) and,
where this torch has them, the ``fp32_precision`` settings. Every setting is
restored on exit, also after an exception, so a guarded call nests and
leaves the caller's own policy as it was.

The networks choose their precision by config: a fully fp32 net runs with
TF32 off (:func:`tf32_off`, called where such a net is built and left set,
as the JAX package's fp32 accuracy mode), a bf16 one under autocast.
"""

from __future__ import annotations

import contextlib
import functools

import torch

_AUTOCAST_TYPES = ("cuda", "cpu")


@functools.cache
def _holders() -> tuple[tuple, tuple]:
    """The objects with an ``fp32_precision`` setting in this torch, as
    (parents, leaves): a leaf that holds ``"none"`` inherits its parent's."""
    b = torch.backends
    mkldnn = getattr(b, "mkldnn", None)
    parents = [b, b.cudnn, mkldnn]
    leaves = [b.cuda.matmul] + [getattr(owner, op, None) for owner in (b.cudnn, mkldnn)
                                for op in ("matmul", "conv", "rnn")]

    def have(xs):
        return tuple(x for x in xs if x is not None and hasattr(x, "fp32_precision"))

    return have(parents), have(leaves)


def _read(getter):
    """A legacy flag's value, or None where torch refuses to read it (it
    raises when the two APIs were mixed into disagreeing settings)."""
    try:
        return getter()
    except RuntimeError:
        return None


def tf32_off() -> None:
    """Full fp32 for cuBLAS, cuDNN and oneDNN, left set: the fp32 networks'
    policy, and what :func:`highest` sets for its body. The legacy switches
    first (they also rewrite the new-API settings they map to), then every
    ``fp32_precision`` leaf to ``"ieee"``, so that both APIs read back off."""
    torch.set_float32_matmul_precision("highest")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for leaf in _holders()[1]:
        leaf.fp32_precision = "ieee"


def settings() -> tuple:
    """Every TF32-related setting, for :func:`restore`: the legacy matmul
    level and cuDNN flag (None where torch refuses to read one) and each
    ``fp32_precision`` value."""
    parents, leaves = _holders()
    return (_read(torch.get_float32_matmul_precision), _read(lambda: torch.backends.cudnn.allow_tf32),
            tuple(x.fp32_precision for x in parents + leaves))


def restore(saved: tuple) -> None:
    """Set every setting back to ``saved`` (from :func:`settings`)."""
    matmul_level, cudnn_tf32, values = saved
    if matmul_level is not None:
        torch.set_float32_matmul_precision(matmul_level)
    if cudnn_tf32 is not None:
        torch.backends.cudnn.allow_tf32 = cudnn_tf32
    parents, leaves = _holders()
    for holder, value in zip(parents + leaves, values):   # parents first: a parent's write reaches its leaves
        holder.fp32_precision = value


def _is_off(saved: tuple) -> bool:
    matmul_level, cudnn_tf32, values = saved
    n_parents = len(_holders()[0])
    return (matmul_level == "highest" and cudnn_tf32 is False
            and all(v == "ieee" for v in values[n_parents:]))


class highest:
    """Run the body at full precision: autocast off where it is on, TF32 off;
    every setting restored on exit. Where the settings are already off (an
    fp32 network built them so), only the autocast state is touched."""

    def __enter__(self):
        snapshot = settings()
        self._saved = None if _is_off(snapshot) else snapshot
        self._autocast = [torch.autocast(t, enabled=False) for t in _AUTOCAST_TYPES
                          if torch.is_autocast_enabled(t)]
        for ctx in self._autocast:
            ctx.__enter__()
        if self._saved is not None:
            tf32_off()
        return self

    def __exit__(self, *exc):
        try:
            if self._saved is not None:
                restore(self._saved)
        finally:
            for ctx in reversed(self._autocast):
                ctx.__exit__(*exc)
        return False


@contextlib.contextmanager
def tf32_enabled():
    """TF32 on for cuBLAS and cuDNN over the body, as a caller's
    ``allow_tf32 = True`` sets it (the geometry's guard still turns it off
    inside); every setting restored on exit."""
    saved = settings()
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        yield
    finally:
        restore(saved)


def matmul_highest(fn):
    """Decorator: ``fn`` runs inside :func:`highest`."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with highest():
            return fn(*args, **kwargs)

    return wrapped
