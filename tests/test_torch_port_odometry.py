"""The port's odometry end to end on the real TartanAir v2 clip, on the CPU.

* GT frontend (oracle depth/flow) through the whole backend must meet the
  bounds of tests/test_real_asset.py (ATE <= 0.002 m, RTE <= 0.0025 m/frame,
  ROE <= 0.045 deg/frame), like the JAX package's run.
* The learned path (MACVO_Performant, shipped checkpoint) runs frames to poses
  on a small center crop: finite poses, the device-chained backend, the dense
  map. The full-width fp32 learned run is ``slow``.
"""

import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

from macvo_tpu_torch.__main__ import main as run_main
from macvo_tpu_torch.data.datasets.tartanair import TartanAirV2
from macvo_tpu_torch.evaluation import evaluate_all
from macvo_tpu_torch.odometry import MACVO
from macvo_tpu_torch.utils.config import build_dynamic_config, load_config

ROOT = Path(__file__).parent.parent
ASSET = ROOT / "assets" / "test_sequence" / "TartanAir2_abs_P000"
ATE_BOUND, RTE_BOUND, ROE_BOUND = 0.002, 0.0025, 0.045

GT_CONFIG = {"Odometry": {
    "args": {"num_point": 200, "edgewidth": 32, "match_cov_default": 0.25, "profile": False, "mapping": False},
    "frontend": {"type": "FrontendCompose", "args": {
        "depth": {"type": "GTDepth", "args": {}}, "match": {"type": "GTMatcher", "args": {}}}},
    "motion": {"type": "StaticMotionModel", "args": {}},
    "keypoint": {"type": "RandomSelector", "args": {"mask_width": 32}},
    "mappoint": {"type": "RandomSelector", "args": {"mask_width": 32}},
    "outlier": {"type": "FilterCompose", "args": {"filter_args": [
        {"type": "CovarianceSanityFilter", "args": {}},
        {"type": "SimpleDepthFilter", "args": {"min_depth": 0.05, "max_depth": "auto"}}]}},
    "cov": {"obs": {"type": "MatchCovariance", "args": {
        "kernel_size": 31, "match_cov_default": 0.25, "min_flow_cov": 0.25, "min_depth_cov": 0.05}}},
    "postprocess": {"type": "MotionInterpolate", "args": {}},
    "keyframe": {"type": "AllKeyframe", "args": {}},
    "optimizer": {"type": "Local_TwoFrame_PGO", "args": {
        "graph_type": "icp", "parallel": True, "use_fp64": True, "capacity": 256}},
}}


def real_sequence(gt_frontend: bool):
    return TartanAirV2({"root": str(ASSET), "compressed": True, "gtFlow": gt_frontend,
                        "gtDepth": gt_frontend, "gtPose": True})


class Crop:
    """Center crop of every frame with the principal point moved to match."""

    def __init__(self, seq, size, n):
        self.seq, self.size, self.n = seq, size, n

    def __len__(self):
        return self.n

    def __iter__(self):
        return (self[i] for i in range(self.n))

    def __getitem__(self, i):
        f = self.seq[i]
        s = f.stereo
        y0, x0 = (s.height - self.size) // 2, (s.width - self.size) // 2
        K = s.K.copy()
        K[:, 0, 2] -= x0
        K[:, 1, 2] -= y0
        crop = (lambda x: None if x is None else x[:, y0:y0 + self.size, x0:x0 + self.size].contiguous())
        return dataclasses.replace(f, stereo=dataclasses.replace(
            s, K=K, imageL=crop(s.imageL), imageR=crop(s.imageR)))


def _run(cfg, seq):
    odom = MACVO.from_config(build_dynamic_config(cfg)[0] if isinstance(cfg, dict) else cfg, device="cpu")
    odom.receive_frames(seq)
    n = len(odom.graph.frames)
    est = odom.graph.frames.data["pose"][:n].astype(np.float64)
    gt = np.stack([np.asarray(seq[i].gt_pose[0]) for i in range(len(seq))]).astype(np.float64)
    return odom, evaluate_all(gt, est)


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def test_gt_frontend_meets_reference_bounds():
    odom, m = _run(GT_CONFIG, real_sequence(gt_frontend=True))
    assert len(odom.graph.frames) == 10 and len(odom.graph.match) > 9 * 100
    assert m["ATE"].rmse <= ATE_BOUND, f"ATE {m['ATE'].rmse:.5f} > {ATE_BOUND}"
    assert m["RTE"].rmse <= RTE_BOUND, f"RTE {m['RTE'].rmse:.5f} > {RTE_BOUND}"
    assert m["ROE"].rmse <= ROE_BOUND, f"ROE {m['ROE'].rmse:.5f} > {ROE_BOUND}"


def _performant(decoder_depth=12):
    cfg = load_config(ROOT / "configs/experiment/macvo/MACVO_Performant.yaml")[0]
    cfg.Odometry.frontend.args.weight = str(ROOT / "model/MACVO_FrontendCov.npz")
    cfg.Odometry.frontend.args.decoder_depth = decoder_depth
    return cfg


def test_learned_path_runs_frames_to_poses_on_a_crop():
    """Performant config, shipped checkpoint, 2 decoder steps, 3 frames of a
    192x192 crop (edgewidth 32 leaves a 128-pixel core): finite poses, one
    device-chained solve a pair, the dense map filled."""
    cfg = _performant(decoder_depth=2)
    cfg.Odometry.args.num_point = 64
    cfg.Odometry.args.num_map_point = 128
    odom, m = _run(cfg, Crop(real_sequence(gt_frontend=False), 192, 3))
    assert odom._device_chain
    poses = odom.graph.frames.data["pose"][:3]
    assert np.isfinite(poses).all()
    np.testing.assert_allclose(np.linalg.norm(poses[:, 3:], axis=1), 1.0, atol=1e-5)
    assert len(odom.graph.map_points) > 0 and len(odom.graph.match) > 0
    assert np.isfinite(m["ATE"].rmse)


def test_runner_writes_poses(tmp_path):
    """``python -m macvo_tpu_torch`` on the GT configuration, first 4 frames."""
    import yaml

    odom = tmp_path / "gt.yaml"
    data = tmp_path / "seq.yaml"
    odom.write_text(yaml.safe_dump({**GT_CONFIG, "Odometry": {**GT_CONFIG["Odometry"], "name": "GT"}}))
    data.write_text(yaml.safe_dump({"Sequence": {"type": "TartanAirV2", "args": {
        "root": str(ASSET), "compressed": True, "gtFlow": True, "gtDepth": True, "gtPose": True}}}))
    run_main(["--odom", str(odom), "--data", str(data), "--seq_to", "4", "--device", "cpu",
              "--resultRoot", str(tmp_path / "results")])
    (out,) = (tmp_path / "results").iterdir()
    poses = np.load(out / "poses.npy")
    assert poses.shape == (4, 8) and np.isfinite(poses).all()
    assert np.load(out / "ref_poses.npy").shape == (4, 8)


def test_keypoint_pipeline_packs_what_jax_packs():
    """One frame pair of the real clip through both keypoint pipelines with the
    GT frontend, where CovAwareSelector_NoDepth falls back to its deterministic
    grid: the same keypoints, so the packed (K+1, 52) sync arrays (gathers,
    MatchCovariance, outlier mask, world registration) agree. fp32 on the port,
    f64 covariances on the JAX side cast to f32: 1e-4 relative."""
    import jax
    import jax.numpy as jnp

    from macvo_tpu.data.datasets.tartanair import TartanAirV2 as JTartanAirV2
    from macvo_tpu.odometry import MACVO as JMACVO
    from macvo_tpu.utils.config import build_dynamic_config as j_build

    cfg = {"Odometry": {**GT_CONFIG["Odometry"],
                        "keypoint": {"type": "CovAwareSelector_NoDepth", "args": {
                            "kernel_size": 7, "mask_width": 32, "max_match_cov": 100.0}},
                        "outlier": {"type": "CovarianceSanityFilter", "args": {}}}}
    prev_pose = np.array([0.1, -0.2, 0.05, 0.02, -0.03, 0.01, 1.0], np.float32)
    prev_pose[3:] /= np.linalg.norm(prev_pose[3:])
    est_pose = prev_pose + np.array([0.05, 0.0, 0.01, 0, 0, 0, 0], np.float32)

    jodom = JMACVO.from_config(j_build(cfg)[0])
    jseq = JTartanAirV2({"root": str(ASSET), "compressed": True, "gtFlow": True, "gtDepth": True, "gtPose": True})
    jf0, jf1 = jseq[0], jseq[1]
    jd0 = jodom.Frontend.estimate_depth(jf0.stereo)
    jd1, jm = jodom.Frontend.estimate_pair(jf0.stereo, jf1.stereo)
    ref = np.asarray(jodom._pipeline_core(jf0.stereo, jf1.stereo)(
        jf0.stereo.imageL, jd0, jd1, jm, jnp.asarray(prev_pose), jnp.asarray(est_pose), jax.random.PRNGKey(0)))

    odom = MACVO.from_config(build_dynamic_config(cfg)[0], device="cpu")
    seq = real_sequence(gt_frontend=True)
    f0, f1 = seq[0], seq[1]
    d0 = odom.Frontend.estimate_depth(f0.stereo)
    d1, m = odom.Frontend.estimate_pair(f0.stereo, f1.stereo)
    ours = odom.keypoint_pipeline(f0.stereo, f1.stereo, d0, d1, m, torch.from_numpy(prev_pose),
                                  torch.from_numpy(est_pose)).numpy()
    assert ours.shape == ref.shape == (201, 52)
    assert ours[:200, 36].sum() > 100                       # most grid points kept
    np.testing.assert_allclose(ours, ref, rtol=1e-4, atol=1e-5)


@pytest.mark.slow
def test_learned_performant_full_width_cpu():
    """Full 640x640 fp32 run, 12 decoder steps, on the CPU; near the JAX CPU
    record (evidence/eval_real_asset_cpu.json: ATE 0.0381 m). The keypoint
    draws differ from jax.random's, so the bound is the smoke run's 0.05 m."""
    _, m = _run(_performant(), real_sequence(gt_frontend=False))
    assert np.isfinite(m["ATE"].rmse) and m["ATE"].rmse <= 0.05, m["ATE"].rmse


def test_frontend_cold_pair_matches_cached_pair():
    """FlowFormerCovFrontend's two pair paths: the cached one (left features of
    t1 reused from estimate_depth) and the cold one (all three images
    encoded) give the same depth and match outputs (fp32, different batch
    composition only: 1e-4)."""
    from macvo_tpu_torch.modules.frontend_network import FlowFormerCovFrontend

    cfg = build_dynamic_config({"weight": str(ROOT / "model/MACVO_FrontendCov.npz"), "enc_dtype": "fp32",
                                "dec_dtype": "fp32", "decoder_depth": 2,
                                "enforce_positive_disparity": False})[0]
    seq = Crop(real_sequence(gt_frontend=False), 96, 2)
    f0, f1 = seq[0].stereo, seq[1].stereo
    fe = FlowFormerCovFrontend(cfg, device="cpu")
    fe.estimate_depth(f0)
    cached = fe.estimate_pair(f0, f1)
    fe._feat_cache = None
    cold = fe.estimate_pair(f0, f1)
    for a, b in ((cached[0].depth, cold[0].depth), (cached[0].cov, cold[0].cov),
                 (cached[1].flow, cold[1].flow), (cached[1].cov, cold[1].cov)):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)
