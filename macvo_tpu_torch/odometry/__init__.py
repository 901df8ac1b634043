from .. import backend as _backend  # noqa: F401  (registers the optimizers)
from .. import modules as _modules  # noqa: F401  (registers the pipeline modules)
from .macvo import MACVO

__all__ = ["MACVO"]
