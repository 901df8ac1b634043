"""The visual map: frames, tracked points, dense map points, observations.

Behavioral parity with the reference VisualMap (Module/Map/VisualMap.py:15-133,
schemas in Module/Map/Template.py:5-43): three node stores + one observation
store joined by six edges, whole-map (de)serialization into a flat npz
namespace. Host-side numpy (see storage.py for the design rationale).
"""

from __future__ import annotations

from typing import Mapping

import numpy as np

from .edges import MultiEdge, RangeEdge, SingleEdge
from .storage import Bundle, Store

# Schemas (reference: Module/Map/Template.py:5-43)
FRAME_FIELDS = {
    "K": ((3, 3), np.float32),
    "baseline": ((), np.float32),
    "pose": ((7,), np.float32),        # sensor pose in world frame [t, q_xyzw]
    "T_BS": ((7,), np.float32),        # body-to-sensor SE3
    "need_interp": ((), np.bool_),
    "time_ns": ((), np.int64),
}
POINT_FIELDS = {
    "pos_Tw": ((3,), np.float32),
    "cov_Tw": ((3, 3), np.float64),
    "color": ((3,), np.uint8),
}
MATCH_FIELDS = {
    "pixel1_uv": ((2,), np.float32),
    "pixel2_uv": ((2,), np.float32),
    "pixel1_d": ((1,), np.float32),
    "pixel2_d": ((1,), np.float32),
    "pixel1_disp": ((1,), np.float32),
    "pixel2_disp": ((1,), np.float32),
    "pixel1_disp_cov": ((1,), np.float32),
    "pixel2_disp_cov": ((1,), np.float32),
    "pixel1_uv_cov": ((3,), np.float32),   # (sigma_uu, sigma_vv, sigma_uv)
    "pixel2_uv_cov": ((3,), np.float32),
    "pixel1_d_cov": ((1,), np.float32),
    "pixel2_d_cov": ((1,), np.float32),
    "obs1_covTc": ((3, 3), np.float64),
    "obs2_covTc": ((3, 3), np.float64),
}

FrameNode = Bundle
PointNode = Bundle
MatchObs = Bundle


class VisualMap:
    """Factor-graph map store (reference: Module/Map/VisualMap.py:15-133)."""

    INIT_SIZE = 1024
    MAX_PT_OBS = 5
    MAX_FRAME_RANGE = 2

    def __init__(self) -> None:
        self.frames = Store(FRAME_FIELDS, self.INIT_SIZE)
        self.points = Store(POINT_FIELDS, self.INIT_SIZE)
        self.map_points = Store(POINT_FIELDS, self.INIT_SIZE)
        self.match = Store(MATCH_FIELDS, self.INIT_SIZE)

        self.frame2match = RangeEdge(self.INIT_SIZE, self.MAX_FRAME_RANGE)
        self.frame2map = RangeEdge(self.INIT_SIZE, self.MAX_FRAME_RANGE)
        self.match2frame1 = SingleEdge(self.INIT_SIZE)
        self.match2frame2 = SingleEdge(self.INIT_SIZE)
        self.match2point = SingleEdge(self.INIT_SIZE)
        self.point2match = MultiEdge(self.INIT_SIZE, self.MAX_PT_OBS)

        self.frames.register_edge(self.frame2match)
        self.frames.register_edge(self.frame2map)
        self.points.register_edge(self.point2match)
        self.match.register_edge(self.match2point)
        self.match.register_edge(self.match2frame1)
        self.match.register_edge(self.match2frame2)

    # -- typed traversal (reference: VisualMap.py:86-102) ---------------------
    def get_frame2match(self, frame: Bundle) -> Bundle:
        return self.match[self.frame2match.project(frame.index)]

    def get_match2point(self, match: Bundle) -> Bundle:
        return self.points[self.match2point.project(match.index)]

    def get_point2match(self, point: Bundle) -> Bundle:
        return self.match[self.point2match.project(point.index)]

    def get_match2frame1(self, match: Bundle) -> Bundle:
        return self.frames[self.match2frame1.project(match.index)]

    def get_match2frame2(self, match: Bundle) -> Bundle:
        return self.frames[self.match2frame2.project(match.index)]

    def get_frame2map(self, frame: Bundle) -> Bundle:
        return self.map_points[self.frame2map.project(frame.index)]

    # -- persistence ----------------------------------------------------------
    def serialize(self) -> dict[str, np.ndarray]:
        out: dict[str, np.ndarray] = {}
        out.update(self.frames.serialize("frames/"))
        out.update(self.points.serialize("points/"))
        out.update(self.map_points.serialize("map_points/"))
        out.update(self.match.serialize("match/"))
        out.update(self.frame2match.serialize("edge/frame2match"))
        out.update(self.frame2map.serialize("edge/frame2map"))
        out.update(self.match2frame1.serialize("edge/match2frame1"))
        out.update(self.match2frame2.serialize("edge/match2frame2"))
        out.update(self.match2point.serialize("edge/match2point"))
        out.update(self.point2match.serialize("edge/point2match"))
        return out

    @classmethod
    def deserialize(cls, values: Mapping[str, np.ndarray]) -> "VisualMap":
        m = cls()
        m.frames.deserialize("frames/", values)
        m.points.deserialize("points/", values)
        if "map_points/index" in values:
            m.map_points.deserialize("map_points/", values)
        m.match.deserialize("match/", values)
        m.frame2match.deserialize("edge/frame2match", values)
        m.frame2map.deserialize("edge/frame2map", values)
        m.match2frame1.deserialize("edge/match2frame1", values)
        m.match2frame2.deserialize("edge/match2frame2", values)
        m.match2point.deserialize("edge/match2point", values)
        m.point2match.deserialize("edge/point2match", values)
        return m

    def save(self, path) -> None:
        np.savez_compressed(path, **self.serialize())

    @classmethod
    def load(cls, path) -> "VisualMap":
        with np.load(path) as data:
            return cls.deserialize(dict(data))

    def __repr__(self) -> str:
        return (
            f"VisualMap(#frame={len(self.frames)}, #point={len(self.points)}, "
            f"#map={len(self.map_points)}, #match={len(self.match)})"
        )
