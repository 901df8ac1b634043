"""Packed per-frame sync layout (copy of ``macvo_tpu/odometry/layout.py``),
shared by the odometry orchestrator, which produces the array in its keypoint
pipeline, and the backend, which can consume it on the device
(``backend/two_frame_pgo.py: solve_sync_packed``).

ONE (K+1, 52) float32 array carries everything the host needs from a frame,
so a frame costs one device->host transfer. The same array is a complete
two-frame LM problem: observation columns 0:36, keep mask 36, world
landmarks 37:40, their world covariance 40:49, color 49:52; the extra LAST
row holds est_pose 0:7 and the registration pose 7:14.
"""

from __future__ import annotations

MIN_NUM_POINT = 10  # lost-track threshold (reference: Odometry/MACVO.py:64)

OBS_LAYOUT: list[tuple[str, int]] = [
    ("pixel1_uv", 2), ("pixel2_uv", 2), ("pixel1_d", 1), ("pixel2_d", 1),
    ("pixel1_disp", 1), ("pixel2_disp", 1), ("pixel1_disp_cov", 1),
    ("pixel2_disp_cov", 1), ("pixel1_uv_cov", 3), ("pixel2_uv_cov", 3),
    ("pixel1_d_cov", 1), ("pixel2_d_cov", 1), ("obs1_covTc", 9), ("obs2_covTc", 9),
]
_OBS_WIDTH = sum(w for _, w in OBS_LAYOUT)           # 36

# Column offsets of each observation field.
OBS_COLS: dict[str, tuple[int, int]] = {}
_off = 0
for _name, _w in OBS_LAYOUT:
    OBS_COLS[_name] = (_off, _off + _w)
    _off += _w

COL_KEEP = _OBS_WIDTH                                 # 36
COL_POS = (COL_KEEP + 1, COL_KEEP + 4)                # 37:40 pos0_Tw
COL_COV = (COL_POS[1], COL_POS[1] + 9)                # 40:49 cov0_Tw
COL_COLOR = (COL_COV[1], COL_COV[1] + 3)              # 49:52 color
PACKED_SYNC_WIDTH = COL_COLOR[1]                      # 52
