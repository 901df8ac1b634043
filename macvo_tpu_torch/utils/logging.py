"""Package logger and table helpers (plain ``logging`` and text; the port needs
no extra dependency). ``print_as_table`` prints what the JAX package's
``print_as_table`` prints without ``rich``; ``save_as_csv`` writes the same
bytes as the JAX package's."""

from __future__ import annotations

import csv
import logging
import sys
from pathlib import Path
from typing import Any, Iterable

Logger = logging.getLogger("macvo_tpu_torch")
if not Logger.handlers:
    _handler = logging.StreamHandler(sys.stderr)
    _handler.setFormatter(logging.Formatter("[%(levelname)s] %(message)s"))
    Logger.addHandler(_handler)
    Logger.setLevel(logging.INFO)
    Logger.propagate = False


def print_as_table(headers: list[str], rows: Iterable[list[Any]], title: str | None = None) -> None:
    """The title line, then the headers and each row, tab-separated."""
    print(title or "")
    print("\t".join(headers))
    for row in rows:
        print("\t".join(str(c) for c in row))


def save_as_csv(headers: list[str], rows: Iterable[list[Any]], path: str | Path) -> None:
    with open(path, "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(headers)
        writer.writerows(rows)
