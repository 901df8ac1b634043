"""Factor-graph world map (reference: Module/Map/)."""

from .storage import Bundle, GrowableArray, Store
from .edges import MultiEdge, RangeEdge, SingleEdge
from .visual_map import (
    FRAME_FIELDS,
    MATCH_FIELDS,
    POINT_FIELDS,
    FrameNode,
    MatchObs,
    PointNode,
    VisualMap,
)

__all__ = [
    "Bundle", "GrowableArray", "Store",
    "MultiEdge", "RangeEdge", "SingleEdge",
    "FRAME_FIELDS", "MATCH_FIELDS", "POINT_FIELDS",
    "FrameNode", "MatchObs", "PointNode", "VisualMap",
]
