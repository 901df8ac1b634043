"""Observation-sharded two-frame solve (port of ``macvo_tpu/parallel/sharded_ba.py``).

Each process of a group takes a slice of the observation blocks of the LM
problem, builds its part of the 6x6 normal equations and its part of the
robust loss, and ``all_reduce`` sums them (``solve_two_frame``'s ``reduce``).
Every process then runs the identical 6x6 update, so the solution needs no
gather or broadcast. :func:`pad_to_multiple` rounds the observation count up
to a multiple of the group's size with masked rows.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..backend.solver import TwoFrameData, solve_two_frame

# Fields sharded along the observation axis; the rest replicate.
_OBS_FIELDS = {
    "points_w", "points_c", "kp2", "disp2", "cov_obs_c", "cov_pts_w",
    "cov_kp2", "disp2_cov", "mask",
}


def pad_to_multiple(data: TwoFrameData, multiple: int) -> TwoFrameData:
    """Pad the observation axis to a multiple of ``multiple`` with zero rows,
    masked out (zero weight in the solve)."""
    n = data.mask.shape[0]
    pad = (-n) % multiple
    if pad == 0:
        return data

    def pad_field(name: str, arr: torch.Tensor) -> torch.Tensor:
        if name not in _OBS_FIELDS:
            return arr
        return torch.cat([arr, torch.zeros((pad,) + tuple(arr.shape[1:]), dtype=arr.dtype, device=arr.device)])

    return TwoFrameData(**{f: pad_field(f, getattr(data, f)) for f in TwoFrameData._fields})


def shard(data: TwoFrameData, index: int, count: int) -> TwoFrameData:
    """Shard ``index`` of ``count`` of a padded block: a contiguous slice of
    the observation fields, the others whole."""
    n = data.mask.shape[0] // count
    return TwoFrameData(**{f: getattr(data, f)[index * n:(index + 1) * n] if f in _OBS_FIELDS else getattr(data, f)
                           for f in TwoFrameData._fields})


def make_sharded_solver(group=None, graph_type: str = "icp"):
    """Returns ``solve(data) -> (7,) pose`` over the ranks of ``group`` (the
    default group when None): every rank calls it with the same whole block,
    pads it, solves on its own shard and sums the normal equations with
    ``all_reduce`` over ``group``. Every rank returns the same pose."""
    rank, size = dist.get_rank(group), dist.get_world_size(group)

    def reduce(x: torch.Tensor) -> torch.Tensor:
        x = x.contiguous()
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
        return x

    def solve(data: TwoFrameData) -> torch.Tensor:
        return solve_two_frame(shard(pad_to_multiple(data, size), rank, size), graph_type=graph_type,
                               reduce=reduce)

    return solve
