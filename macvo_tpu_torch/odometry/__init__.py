from .. import backend as _backend  # noqa: F401  (registers the optimizers)
from .. import modules as _modules  # noqa: F401  (registers the pipeline modules)
from .baseline_tartanvo import TartanVO
from .macvo import MACVO

ODOMETRY_TYPES = {"MACVO": MACVO, "TartanVO": TartanVO}


def build_odometry(cfg, device="cuda"):
    """The odometry class ``cfg.Odometry.type`` names (``MACVO`` when it names
    none), its config validated, built on ``device``."""
    cls = ODOMETRY_TYPES[getattr(cfg.Odometry, "type", "MACVO")]
    cls.is_valid_config(cfg.Odometry)
    return cls.from_config(cfg, device=device)


__all__ = ["MACVO", "ODOMETRY_TYPES", "TartanVO", "build_odometry"]
