"""The port's SyntheticStereo against the JAX package's, and the port's
counterparts of tests/test_e2e.py on it, on the CPU.

* The sequence is generated by the same numpy arithmetic, so a config gives
  the same images, depths, flows, masks and poses bit for bit.
* The end-to-end runs use the same configurations and bounds as
  tests/test_e2e.py (ATE <= 0.002 m, RTE <= 0.0025 m/frame, ROE <= 0.045
  deg/frame; 1e-5 for the empty optimizer; < 0.02 m for the interpolated
  frames). The keypoint draws are the port's own (torch.Generator), so the
  runs are held to the bounds, not to the JAX package's trajectories.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from macvo_tpu.data.datasets import synthetic as jsynth
from macvo_tpu_torch.__main__ import main as run_main
from macvo_tpu_torch.data.datasets import synthetic
from macvo_tpu_torch.data.datasets.tartanair import TartanAir
from macvo_tpu_torch.evaluation import evaluate_all, evaluate_sandbox
from macvo_tpu_torch.odometry import MACVO
from macvo_tpu_torch.utils.config import build_dynamic_config
from macvo_tpu_torch.worldmap import VisualMap

ROOT = Path(__file__).parent.parent
ATE_BOUND, RTE_BOUND, ROE_BOUND = 0.002, 0.0025, 0.045      # tests/test_e2e.py

SPECS = [
    {"n_frames": 4, "width": 160, "height": 120, "fx": 80.0, "fy": 80.0},
    {"n_frames": 3, "width": 160, "height": 120, "fx": 90.0, "fy": 85.0, "cx": 70.5, "cy": 61.0,
     "baseline": 0.3, "seed": 123, "traj_seed": 17, "gtDepth": False, "gtPose": False},
]


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _host(x):
    return None if x is None else np.asarray(x)


@pytest.mark.parametrize("spec", SPECS)
def test_synthetic_stereo_equals_jax_bit_for_bit(spec):
    """Every field of every frame, and the frame stamps after a clip: exactly equal."""
    ours, ref = synthetic.SyntheticStereo(spec), jsynth.SyntheticStereo(spec)
    assert len(ours) == len(ref) == spec["n_frames"]
    np.testing.assert_array_equal(ours.poses, ref.poses)
    ours.clip(1, None)
    ref.clip(1, None)
    for i in range(len(ref)):
        a, b = ours[i], ref[i]
        np.testing.assert_array_equal(a.idx, b.idx)
        assert (a.gt_pose is None) == (b.gt_pose is None) == (not spec.get("gtPose", True))
        if b.gt_pose is not None:
            np.testing.assert_array_equal(a.gt_pose, b.gt_pose)
        for field in ("T_BS", "K", "baseline", "time_ns", "imageL", "imageR", "gt_flow", "flow_mask", "gt_depth"):
            x, y = _host(getattr(a.stereo, field)), _host(getattr(b.stereo, field))
            assert (x is None) == (y is None), field
            if y is not None:
                assert x.dtype == y.dtype and x.shape == y.shape, field
                np.testing.assert_array_equal(x, y, err_msg=field)
        assert isinstance(a.stereo.imageL, torch.Tensor)


def test_layout_writer_writes_what_jax_writes(tmp_path):
    """write_tartanair_layout: the same files, byte for byte."""
    spec = {"n_frames": 3, "width": 64, "height": 48, "fx": 32.0, "fy": 32.0}
    ours = synthetic.write_tartanair_layout(tmp_path / "ours", spec)
    ref = jsynth.write_tartanair_layout(tmp_path / "ref", spec)
    files = sorted(p.relative_to(ref) for p in ref.rglob("*") if p.is_file())
    assert len(files) == 3 * 3 + 2 + 1
    assert files == sorted(p.relative_to(ours) for p in ours.rglob("*") if p.is_file())
    for rel in files:
        assert (ours / rel).read_bytes() == (ref / rel).read_bytes(), rel


def make_config(motion="GTMotionwithNoise", graph_type="icp", optimizer="Local_TwoFrame_PGO",
                keyframe=None, mapping=False):
    """tests/test_e2e.py's configuration."""
    return build_dynamic_config({"Odometry": {
        "args": {"num_point": 200, "edgewidth": 20, "match_cov_default": 0.25, "profile": False,
                 "mapping": mapping},
        "frontend": {"type": "FrontendCompose", "args": {
            "depth": {"type": "GTDepth", "args": {}}, "match": {"type": "GTMatcher", "args": {}}}},
        "motion": {"type": motion, "args": {"noise_std": 0.0} if motion == "GTMotionwithNoise" else {}},
        "keypoint": {"type": "RandomSelector", "args": {"mask_width": 32}},
        "mappoint": {"type": "RandomSelector", "args": {"mask_width": 32}},
        "outlier": {"type": "FilterCompose", "args": {"filter_args": [
            {"type": "CovarianceSanityFilter", "args": {}},
            {"type": "SimpleDepthFilter", "args": {"min_depth": 0.1, "max_depth": "auto"}}]}},
        "cov": {"obs": {"type": "MatchCovariance", "args": {
            "kernel_size": 7, "match_cov_default": 0.25, "min_flow_cov": 0.25, "min_depth_cov": 0.05}}},
        "postprocess": {"type": "PoseInterpolate", "args": {}},
        "keyframe": keyframe or {"type": "AllKeyframe", "args": {}},
        "optimizer": {"type": optimizer, "args": {
            "graph_type": graph_type, "parallel": True, "use_fp64": True, "capacity": 256}},
    }})[0]


@pytest.fixture(scope="module")
def sequence():
    return synthetic.SyntheticStereo({"n_frames": 10, "width": 320, "height": 240, "fx": 160.0, "fy": 160.0})


def run_odometry(cfg, seq, saveto=None):
    odom = MACVO.from_config(cfg, device="cpu")
    odom.receive_frames(seq, saveto=saveto)
    return odom


def _assert_bounds(m):
    assert m["ATE"].rmse <= ATE_BOUND, f"ATE {m['ATE'].rmse}"
    assert m["RTE"].rmse <= RTE_BOUND, f"RTE {m['RTE'].rmse}"
    assert m["ROE"].rmse <= ROE_BOUND, f"ROE {m['ROE'].rmse}"


def test_config_validates():
    MACVO.is_valid_config(make_config().Odometry)


def test_e2e_static_motion_icp(sequence, tmp_path):
    """No motion prior: the LM backend recovers the whole motion from the ICP graph."""
    run_odometry(make_config(motion="StaticMotionModel"), sequence, tmp_path / "run")
    _assert_bounds(evaluate_sandbox(tmp_path / "run"))


def test_e2e_gtmotion(sequence):
    odom = run_odometry(make_config(motion="GTMotionwithNoise"), sequence)
    _assert_bounds(evaluate_all(sequence.poses.astype(np.float64),
                                odom.graph.frames.data["pose"].astype(np.float64)))


def test_e2e_artifacts_written(sequence, tmp_path):
    odom = run_odometry(make_config(mapping=True), sequence, tmp_path / "run")
    poses = np.load(tmp_path / "run" / "poses.npy")
    assert poses.shape == (10, 8) and (tmp_path / "run" / "ref_poses.npy").exists()
    assert len(odom.graph.map_points) > 0, "mapping mode must add dense points"
    saved = VisualMap.load(tmp_path / "run" / "tensor_map.npz")
    assert len(saved.frames) == 10 and len(saved.points) > 0


def test_e2e_keyframe_skip_interpolation():
    """UniformKeyframe(2): odd frames are marked need_interp and the interior
    ones (5-frame endpoint guard) are repaired by PoseInterpolate. Empty
    optimizer + GT motion, as in tests/test_e2e.py: the GT flow spans one
    frame, so only the keyframe / interpolation machinery is under test."""
    seq = synthetic.SyntheticStereo({"n_frames": 20, "width": 160, "height": 120, "fx": 80.0, "fy": 80.0})
    cfg = make_config(optimizer="Empty_TwoFrame_PGO",
                      keyframe={"type": "UniformKeyframe", "args": {"keyframe_freq": 2}})
    odom = run_odometry(cfg, seq)
    est = odom.graph.frames.data["pose"].astype(np.float64)
    gt = seq.poses.astype(np.float64)
    keyframes = np.arange(0, 20, 2)
    np.testing.assert_allclose(est[keyframes, :3], gt[keyframes, :3], atol=1e-5)
    repaired = [i for i in range(5, 15) if i % 2 == 1]
    err = np.linalg.norm(est[repaired, :3] - gt[repaired, :3], axis=-1)
    assert err.max() < 0.02, f"interpolated-frame error {err}"
    assert odom.graph.frames.data["need_interp"][repaired].all()


def test_e2e_empty_optimizer_uses_motion_model(sequence):
    """No-op optimizer and exact GT motion: the trajectory is the ground truth."""
    odom = run_odometry(make_config(optimizer="Empty_TwoFrame_PGO"), sequence)
    m = evaluate_all(sequence.poses.astype(np.float64), odom.graph.frames.data["pose"].astype(np.float64))
    assert m["ATE"].rmse <= 1e-5


def test_e2e_real_files_tartanair_layout(tmp_path):
    """The scene written in TartanAir v1 layout and read back by the port's
    TartanAir loader, then the whole pipeline, held to tests/test_e2e.py's
    file-round-trip bounds. The port has no data transforms yet, so the run is
    at the layout's 640x480 (the JAX test halves it with ScaleFrame first)."""
    spec = {"n_frames": 10, "width": 640, "height": 480, "fx": 320.0, "fy": 320.0, "cx": 320.0, "cy": 240.0}
    root = synthetic.write_tartanair_layout(tmp_path / "seq", spec)
    seq = TartanAir({"root": str(root), "gtFlow": True, "gtDepth": True, "gtPose": True, "compressed": False})
    assert seq[0].stereo.imageL.shape == (1, 480, 640, 3)
    run_odometry(make_config(motion="StaticMotionModel"), seq, tmp_path / "run")
    m = evaluate_sandbox(tmp_path / "run")
    assert m["ATE"].rmse <= 0.02, f"ATE {m['ATE'].rmse}"
    assert m["RTE"].rmse <= 0.02, f"RTE {m['RTE'].rmse}"
    assert m["ROE"].rmse <= 0.5, f"ROE {m['ROE'].rmse}"


def test_quickstart_runner_meets_the_bounds(tmp_path):
    """The README's quickstart, ``python -m macvo_tpu_torch --odom
    configs/experiment/macvo/MACVO_Synthetic.yaml --device cpu``, at its full
    320x240: its own Data section, PoseInterpolate, the bounds above."""
    run_main(["--odom", str(ROOT / "configs/experiment/macvo/MACVO_Synthetic.yaml"), "--device", "cpu",
              "--resultRoot", str(tmp_path)])
    (run,) = tmp_path.iterdir()                     # <resultRoot>/<name>/<stamp>
    (out,) = run.iterdir()
    assert np.load(out / "poses.npy").shape == (10, 8)
    _assert_bounds(evaluate_sandbox(out))
