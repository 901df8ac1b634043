"""The committed real TartanAir v2 clip as an evaluation set: the sequence,
the odometry config the JAX package's accuracy records are measured with,
and one run to trajectory metrics (port of the helpers of
``tests/test_real_asset.py``, which the checkpoint gate
``scripts/torch_promote_checkpoint.py`` and the accuracy-gap diagnosis
``scripts/torch_diagnose_platform_gap.py`` share).

The clip (``assets/test_sequence/TartanAir2_abs_P000``): 10 frames at
640x640 with ground-truth depth, flow and pose.
"""

from __future__ import annotations

import contextlib
import dataclasses
from pathlib import Path

import numpy as np
import torch

from ..data import DevicePrefetcher
from ..data.datasets.tartanair import TartanAirV2
from ..utils.config import build_dynamic_config
from .metrics import evaluate_all

ASSET = Path(__file__).resolve().parents[2] / "assets" / "test_sequence" / "TartanAir2_abs_P000"


class CenterCrop:
    """A sequence whose frames are center crops of ``size`` x ``size``: the
    images and the ground-truth depth, flow and flow mask, with the principal
    point moved to match (small runs of the clip on the CPU)."""

    def __init__(self, seq, size: int) -> None:
        self.seq, self.size = seq, size

    def __len__(self) -> int:
        return len(self.seq)

    def __getitem__(self, i: int):
        f = self.seq[i]
        s = f.stereo
        y0, x0 = (s.height - self.size) // 2, (s.width - self.size) // 2

        def crop(x):
            return None if x is None else x[:, y0:y0 + self.size, x0:x0 + self.size].contiguous()

        K = s.K.copy()
        K[:, 0, 2] -= x0
        K[:, 1, 2] -= y0
        return dataclasses.replace(f, stereo=dataclasses.replace(
            s, K=K, imageL=crop(s.imageL), imageR=crop(s.imageR), gt_flow=crop(s.gt_flow),
            flow_mask=crop(s.flow_mask), gt_depth=crop(s.gt_depth)))


def real_sequence(gt_frontend: bool, root: str | Path = ASSET, frames: int = 0, size: int = 0):
    """The clip, with its ground-truth depth and flow where ``gt_frontend``;
    its first ``frames`` frames (0: all) and a ``size`` center crop (0: none)."""
    seq = TartanAirV2({"root": str(root), "compressed": True, "gtFlow": gt_frontend,
                       "gtDepth": gt_frontend, "gtPose": True})
    if frames:
        seq = seq.clip(0, frames)
    return CenterCrop(seq, size) if size else seq


def make_config(frontend: dict, num_point: int = 200, gt_frontend: bool = False):
    """The reference's E2E config around ``frontend``: CovAwareSelector,
    sanity + depth + front-of-camera filters, icp graph in float64, mapping
    off, full resolution, StaticMotionModel seeding the solve. With
    ``gt_frontend`` (no covariances) a RandomSelector and sanity + depth
    filters take their places."""
    cfg = {"Odometry": {
        "args": {"num_point": num_point, "edgewidth": 32, "match_cov_default": 0.25,
                 "profile": False, "mapping": False},
        "frontend": frontend,
        "motion": {"type": "StaticMotionModel", "args": {}},
        "keypoint": {"type": "CovAwareSelector", "args": {
            "kernel_size": 7, "mask_width": 32, "max_depth": "auto",
            "max_depth_cov": 250.0, "max_match_cov": 100.0}},
        "mappoint": {"type": "RandomSelector", "args": {"mask_width": 32}},
        "outlier": {"type": "FilterCompose", "args": {"filter_args": [
            {"type": "CovarianceSanityFilter", "args": {}},
            {"type": "SimpleDepthFilter", "args": {"min_depth": 0.05, "max_depth": "auto"}},
            {"type": "LikelyFrontOfCamFilter", "args": {}}]}},
        "cov": {"obs": {"type": "MatchCovariance", "args": {
            "kernel_size": 31, "match_cov_default": 0.25,
            "min_flow_cov": 0.25, "min_depth_cov": 0.05}}},
        "postprocess": {"type": "MotionInterpolate", "args": {}},
        "keyframe": {"type": "AllKeyframe", "args": {}},
        "optimizer": {"type": "Local_TwoFrame_PGO", "args": {
            "graph_type": "icp", "parallel": True, "use_fp64": True, "capacity": 256}},
    }}
    if gt_frontend:
        cfg["Odometry"]["keypoint"] = {"type": "RandomSelector", "args": {"mask_width": 32}}
        cfg["Odometry"]["outlier"] = {"type": "FilterCompose", "args": {"filter_args": [
            {"type": "CovarianceSanityFilter", "args": {}},
            {"type": "SimpleDepthFilter", "args": {"min_depth": 0.05, "max_depth": "auto"}}]}}
    return build_dynamic_config(cfg)[0]


def run_and_evaluate(cfg, seq, device: str | torch.device = "cuda", policy=None) -> dict:
    """MAC-VO with ``cfg`` over ``seq`` on ``device``: ATE / RTE / ROE
    (``MetricStats``) against the sequence's ground-truth poses. ``policy``,
    a context manager, is entered around the run once the odometry is built
    (building an fp32 frontend sets its own precision policy)."""
    from ..odometry import MACVO

    device = torch.device(device)
    odom = MACVO.from_config(cfg, device=device)
    with policy if policy is not None else contextlib.nullcontext():
        odom.receive_frames(DevicePrefetcher(seq, device))
    n = len(odom.graph.frames)
    est = odom.graph.frames.data["pose"][:n].astype(np.float64)
    gt = np.stack([np.asarray(seq[i].gt_pose[0]) for i in range(len(seq))]).astype(np.float64)
    return evaluate_all(gt, est)
