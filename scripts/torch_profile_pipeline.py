#!/usr/bin/env python
"""Per-stage time of the non-frontend work of a frame in the PyTorch/CUDA
port (counterpart of ``scripts/profile_pipeline.py``), at 480x640:

    python scripts/torch_profile_pipeline.py [--height 480 --width 640]
        [--out chiprun_out/profile_pipeline.json]

Three stages, on the JAX script's inputs and under its names: the keypoint
pipeline (selection, gathers, covariances, filters, packing), the
dense-mapping pipeline, both of the odometry ``bench.py`` builds (the
reference's Fast config: CovAwareSelector_NoDepth keypoints,
MappingPointSelector, mapping on, disp graph, the shipped checkpoint or
``random:0``), on two SyntheticStereo frames with random depth, flow and
covariance maps, and the two-frame LM solve (disp graph, 256 observations
of a random pose, float32). Each stage reports ``wall_ms``, ``device_ms``,
``kernels`` a call and ``busy`` as ``scripts/torch_profile_frontend.py``
does (``macvo_tpu_torch.utils.timer.stage_profile``). Runs on the card
unless ``--device cpu`` is given; prints one line a stage, then one JSON
object, also written to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
CHECKPOINT = ROOT / "model" / "MACVO_FrontendCov.npz"


def fast_odometry(device, weight: str):
    """MAC-VO as ``bench.py: build_odometry`` builds it (the reference's Fast
    config with mapping on, bf16 frontend, the float32 re-anchored solve)."""
    from macvo_tpu_torch.odometry import MACVO
    from macvo_tpu_torch.utils.config import build_dynamic_config

    cfg, _ = build_dynamic_config({"Odometry": {
        "args": {"num_point": 200, "edgewidth": 32, "match_cov_default": 0.25, "profile": False,
                 "mapping": True},
        "frontend": {"type": "FlowFormerCovFrontend", "args": {
            "weight": weight, "enc_dtype": "bf16", "dec_dtype": "bf16",
            "enforce_positive_disparity": False, "decoder_depth": 12}},
        "motion": {"type": "StaticMotionModel", "args": {}},
        "keypoint": {"type": "CovAwareSelector_NoDepth", "args": {
            "mask_width": 32, "kernel_size": 7, "max_match_cov": 100.0}},
        "mappoint": {"type": "MappingPointSelector", "args": {
            "max_depth": 5.0, "max_depth_cov": 0.005, "mask_width": 32}},
        "outlier": {"type": "CovarianceSanityFilter", "args": {}},
        "cov": {"obs": {"type": "MatchCovariance", "args": {
            "kernel_size": 31, "match_cov_default": 0.25, "min_flow_cov": 0.25, "min_depth_cov": 0.05}}},
        "postprocess": {"type": "MotionInterpolate", "args": {}},
        "keyframe": {"type": "AllKeyframe", "args": {}},
        "optimizer": {"type": "Local_TwoFrame_PGO", "args": {
            "graph_type": "disp", "parallel": True, "use_fp64": False, "capacity": 256}},
    }})
    return MACVO.from_config(cfg, device=device)


def solve_problem(device, n: int = 256):
    """The JAX script's LM problem: ``n`` points 4-20 m ahead seen from a
    random pose, with their pixels and disparities, float32."""
    from macvo_tpu_torch.backend.solver import TwoFrameData
    from macvo_tpu_torch.geometry import camera, se3

    gen = torch.Generator().manual_seed(7)
    f32 = dict(dtype=torch.float32, device=device)
    pose = se3.exp((0.05 * torch.randn(6, generator=gen)).to(**f32))

    def uniform(lo, hi):
        return (lo + (hi - lo) * torch.rand(n, generator=gen)).to(**f32)

    pts_c = torch.stack([uniform(4.0, 20.0), uniform(-3.0, 3.0), uniform(-2.0, 2.0)], dim=1)
    K = torch.tensor([[320.0, 0, 320], [0, 320.0, 240], [0, 0, 1]], **f32)
    eye3 = (torch.eye(3, **f32) * 0.01).expand(n, 3, 3)
    return TwoFrameData(
        pose0=pose, points_w=se3.act(pose, pts_c), points_c=pts_c,
        kp2=camera.point_to_pixel_ned(pts_c, K), disp2=K[0, 0] * 0.25 / pts_c[:, 0],
        cov_obs_c=eye3, cov_pts_w=eye3, cov_kp2=(torch.eye(2, **f32) * 0.25).expand(n, 2, 2),
        disp2_cov=torch.full((n,), 0.25, **f32), K=K, baseline=torch.tensor(0.25, **f32),
        mask=torch.ones(n, dtype=torch.bool, device=device))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--height", type=int, default=480)
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--out", type=str, default=None)
    args = ap.parse_args(argv)

    from macvo_tpu_torch.backend.solver import solve_two_frame
    from macvo_tpu_torch.data.datasets.synthetic import SyntheticStereo
    from macvo_tpu_torch.modules.frontend import DepthOutput, MatchOutput
    from macvo_tpu_torch.utils.device import resolve_device
    from macvo_tpu_torch.utils.timer import stage_profile

    device = resolve_device(args.device)
    H, W = args.height, args.width
    weight = str(CHECKPOINT) if CHECKPOINT.exists() else "random:0"
    odom = fast_odometry(device, weight)
    seq = SyntheticStereo({"n_frames": 2, "width": W, "height": H, "fx": 320.0, "fy": 320.0,
                           "cx": W / 2.0, "cy": H / 2.0})
    s0, s1 = seq[0].stereo.to(device), seq[1].stereo.to(device)

    gen = torch.Generator().manual_seed(0)

    def uniform(shape, lo, hi):
        return (lo + (hi - lo) * torch.rand(shape, generator=gen)).to(device)

    depth_map = uniform((1, H, W, 1), 2.0, 30.0)
    cov_map = uniform((1, H, W, 1), 0.01, 1.0)
    depth = DepthOutput(depth=depth_map, cov=cov_map, disparity=320.0 * 0.25 / depth_map,
                        disparity_uncertainty=cov_map, mask=None)
    match = MatchOutput(flow=(torch.randn((1, H, W, 2), generator=gen) * 3.0).to(device),
                        cov=uniform((1, H, W, 3), 0.1, 1.0), mask=None)
    pose = torch.tensor([0, 0, 0, 0, 0, 0, 1], dtype=torch.float32, device=device)
    data = solve_problem(device)

    rows = []
    stages = (
        ("keypoint pipeline (fused)", lambda: odom.keypoint_pipeline(s0, s1, depth, depth, match, pose, pose)),
        ("mapping pipeline (fused)", lambda: odom.mapping_pipeline(s0, depth, depth, match, pose)),
        ("two-frame LM solve (disp, 256 obs)", lambda: solve_two_frame(data, graph_type="disp")),
    )
    with torch.inference_mode():
        for name, fn in stages:
            rec = stage_profile(fn, device, reps=args.reps)
            rows.append({"stage": name, **rec})
            fields = " ".join(f"{k} {'-' if rec[k] is None else format(rec[k], '.4f')}"
                              for k in ("wall_ms", "device_ms", "kernels", "busy"))
            print(f"{name:<36s} {fields}", flush=True)
    report = {"script": "torch_profile_pipeline", "device": torch.cuda.get_device_name(device)
              if device.type == "cuda" else "cpu", "height": H, "width": W, "weight": weight, "stages": rows}
    print(json.dumps(report), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(report, indent=1) + "\n")
    return report


if __name__ == "__main__":
    main()
