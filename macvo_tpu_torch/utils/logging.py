"""Package logger (plain ``logging``; the port needs no extra dependency)."""

from __future__ import annotations

import logging
import sys

Logger = logging.getLogger("macvo_tpu_torch")
if not Logger.handlers:
    _handler = logging.StreamHandler(sys.stderr)
    _handler.setFormatter(logging.Formatter("[%(levelname)s] %(message)s"))
    Logger.addHandler(_handler)
    Logger.setLevel(logging.INFO)
    Logger.propagate = False
