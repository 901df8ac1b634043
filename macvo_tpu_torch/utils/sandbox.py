"""Result sandboxes (port of ``macvo_tpu/utils/sandbox.py``).

Every run gets its own directory ``<root>/<name>/<stamp>``, with ``_1``,
``_2``, ... appended when a run of the same name already holds that stamp, so
no run writes into another's results. ``metadata.yaml`` records the time, the
git commit and the command line; ``config.yaml`` is written when the config is
assigned; children (one per sequence of a batch experiment) are listed in
``children.txt``; ``set_autoremove`` deletes the directory when the process
exits. A run writes ``poses.npy``, ``ref_poses.npy``, ``need_interp.npy``,
``tensor_map.npz`` and, with ``--timing``, ``elapsed_time.json`` here.
"""

from __future__ import annotations

import atexit
import datetime
import shutil
import subprocess
import sys
import time
from pathlib import Path
from typing import Any

import yaml

from .config import load_config, namespace_to_dict

_REPO = Path(__file__).resolve().parents[2]


def _git_sha() -> str:
    try:
        return subprocess.run(["git", "rev-parse", "HEAD"], cwd=_REPO, capture_output=True, text=True,
                              timeout=5).stdout.strip() or "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


class Sandbox:
    def __init__(self, folder: str | Path) -> None:
        self.folder = Path(folder)
        self._config: Any = None
        self._autoremove = False

    # -- construction -----------------------------------------------------------
    @classmethod
    def create(cls, root: str | Path, name: str) -> "Sandbox":
        """A new, empty sandbox ``<root>/<name>/<stamp>[_<i>]`` with its
        ``metadata.yaml``; the stamp is the local time ``%m_%d_%H%M%S``."""
        stamp = time.strftime("%m_%d_%H%M%S")
        folder, idx = Path(root) / name / stamp, 0
        while True:
            try:
                folder.mkdir(parents=True)      # not exist_ok: a directory that exists belongs to another run
                break
            except FileExistsError:
                idx += 1
                folder = Path(root) / name / f"{stamp}_{idx}"
        box = cls(folder)
        with open(folder / "metadata.yaml", "w") as f:
            yaml.safe_dump({"time": datetime.datetime.now().isoformat(), "git_sha": _git_sha(),
                            "argv": list(sys.argv)}, f)
        return box

    @classmethod
    def load(cls, folder: str | Path) -> "Sandbox":
        folder = Path(folder)
        if not folder.exists():
            raise FileNotFoundError(f"Sandbox folder does not exist: {folder}")
        return cls(folder)

    # -- config -----------------------------------------------------------------
    @property
    def config(self) -> Any:
        """The run's config as a namespace, read from ``config.yaml`` on first use."""
        if self._config is None and (self.folder / "config.yaml").exists():
            self._config, _ = load_config(self.folder / "config.yaml")
        return self._config

    @config.setter
    def config(self, value: Any) -> None:
        self._config = value
        with open(self.folder / "config.yaml", "w") as f:
            yaml.safe_dump(namespace_to_dict(value), f, sort_keys=False)

    # -- paths ------------------------------------------------------------------
    def path(self, name: str) -> Path:
        return self.folder / name

    # -- hierarchy --------------------------------------------------------------
    def new_child(self, name: str) -> "Sandbox":
        child = self.folder / name
        child.mkdir(parents=True, exist_ok=True)
        with open(self.folder / "children.txt", "a") as f:
            f.write(name + "\n")
        return Sandbox(child)

    def get_children(self) -> list["Sandbox"]:
        listing = self.folder / "children.txt"
        if not listing.exists():
            return []
        names = [ln.strip() for ln in listing.read_text().splitlines() if ln.strip()]
        return [Sandbox(self.folder / n) for n in names]

    def get_leaves(self) -> list["Sandbox"]:
        """Every descendant without children (itself when it has none)."""
        children = self.get_children()
        if not children:
            return [self]
        return [leaf for c in children for leaf in c.get_leaves()]

    # -- cleanup ----------------------------------------------------------------
    def set_autoremove(self) -> None:
        """Delete the sandbox when the process exits."""
        if not self._autoremove:
            self._autoremove = True
            atexit.register(self._remove)

    def _remove(self) -> None:
        if self._autoremove and self.folder.exists():
            shutil.rmtree(self.folder, ignore_errors=True)


def as_path(saveto: "Sandbox | str | Path") -> Path:
    """The directory of a sandbox, or a plain path as it is."""
    return saveto.folder if isinstance(saveto, Sandbox) else Path(saveto)
