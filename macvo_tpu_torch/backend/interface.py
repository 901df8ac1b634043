"""Backend optimizer interface (port of ``macvo_tpu/backend/interface.py``).

``start_optimize`` launches the solve on the device and returns at once (the
pose stays a device tensor); ``write_map`` fetches it into the host map and
``take_pending`` hands it to the next frame without a fetch — the
one-frame-latency pipelining of the reference, from CUDA's asynchronous
launches. The ``parallel`` config key is accepted and ignored.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Any, Generic, Optional, TypeVar

from ..utils.registry import RegisteredConfigTestable
from ..worldmap import VisualMap

T_GraphInput = TypeVar("T_GraphInput")
T_GraphOutput = TypeVar("T_GraphOutput")


class IOptimizer(RegisteredConfigTestable, Generic[T_GraphInput, T_GraphOutput], register=False):
    #: True when the subclass can consume the odometry's packed sync array on
    #: the device via ``start_optimize_device``.
    supports_device_chaining = False

    def __init__(self, config: SimpleNamespace) -> None:
        self.config = config
        self.context: Any = self.init_context(config)
        self._pending: Optional[T_GraphOutput] = None

    @staticmethod
    def init_context(config: SimpleNamespace) -> Any:
        return {}

    def get_graph_data(self, global_map: VisualMap, frame_idx: int) -> T_GraphInput:
        raise NotImplementedError

    def _optimize(self, context: Any, graph_data: T_GraphInput) -> tuple[Any, T_GraphOutput]:
        """Launch the solve; must not wait for the device."""
        raise NotImplementedError

    def write_graph_data(self, result: Optional[T_GraphOutput], global_map: VisualMap) -> None:
        raise NotImplementedError

    def start_optimize(self, graph_data: T_GraphInput) -> None:
        if self._pending is not None:
            raise RuntimeError("start_optimize called while a job is still pending")
        self.context, self._pending = self._optimize(self.context, graph_data)

    def write_map(self, global_map: VisualMap) -> None:
        if self._pending is None:
            return
        result, self._pending = self._pending, None
        self.write_graph_data(result, global_map)

    def take_pending(self) -> Optional[T_GraphOutput]:
        result, self._pending = self._pending, None
        return result

    def terminate(self) -> None:
        self._pending = None
