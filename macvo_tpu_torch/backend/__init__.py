from .interface import IOptimizer
from .solver import TwoFrameData, solve_two_frame
from .two_frame_pgo import Empty_TwoFrame_PGO, Local_TwoFrame_PGO, TwoFrame_PGO, solve_sync_packed

__all__ = ["Empty_TwoFrame_PGO", "IOptimizer", "Local_TwoFrame_PGO", "TwoFrameData", "TwoFrame_PGO", "solve_sync_packed",
           "solve_two_frame"]
