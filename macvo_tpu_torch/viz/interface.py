"""Function-level-gated visualizer dispatch (port of ``macvo_tpu/viz/interface.py``;
reference: Utility/Visualize/).

The reference gates every plot function with a per-function mode switchable
globally or individually (``none | rerun | image``,
Utility/Visualize/Matplotlib_Visualize.py:38-87). Same contract here: plot
functions register under a name; ``set_mode`` flips one or all; the ``image``
mode saves numbered PNGs into the active sandbox, ``rerun`` streams into the
rerun viewer when the sdk is importable (it is optional in this image).
"""

from __future__ import annotations

import functools
from pathlib import Path
from typing import Callable, Literal, Optional

Mode = Literal["none", "image", "rerun"]


class VisualizerRegistry:
    def __init__(self) -> None:
        self.modes: dict[str, Mode] = {}
        self.default_mode: Mode = "none"
        self.save_dir: Optional[Path] = None
        self._counters: dict[str, int] = {}

    def set_mode(self, name: Optional[str] = None, mode: Mode = "none") -> None:
        if name is None:
            self.default_mode = mode
            for key in self.modes:
                self.modes[key] = mode
        else:
            self.modes[name] = mode

    def set_save_dir(self, path) -> None:
        self.save_dir = Path(path)
        self.save_dir.mkdir(parents=True, exist_ok=True)

    def mode_of(self, name: str) -> Mode:
        return self.modes.get(name, self.default_mode)

    def next_path(self, name: str, suffix: str = ".png") -> Path:
        count = self._counters.get(name, 0)
        self._counters[name] = count + 1
        root = self.save_dir or Path(".")
        return root / f"{name}_{count:05d}{suffix}"

    def register(self, fn: Callable) -> Callable:
        """Decorator: the wrapped plot fn is called only when its mode != none;
        it receives ``mode`` and ``save_path`` keyword arguments."""
        name = fn.__name__
        self.modes.setdefault(name, self.default_mode)

        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            mode = self.mode_of(name)
            if mode == "none":
                return None
            if "save_path" not in kwargs or kwargs["save_path"] is None:
                kwargs["save_path"] = self.next_path(name) if mode == "image" else None
            return fn(*args, mode=mode, **kwargs)

        wrapped.plot_name = name  # type: ignore[attr-defined]
        return wrapped


fig_plt = VisualizerRegistry()


def has_rerun() -> bool:
    try:
        import rerun  # noqa: F401

        return True
    except ImportError:
        return False
