"""Faults of the port against the JAX reference, each pinned by a test.

* The cost perceiver's input stage keeps its gradients: unfused when a
  gradient is wanted, as the JAX package trains it (``fused_input=False``).
* ``TartanMotionNet`` serves as MAC-VO's motion model (device passed on,
  poses chained on one device).
* The runner applies a ``Preprocess`` as the JAX runner does, list form
  included (it refused any that would apply until the data layer was ported).
* The runner evaluates against ground truth interpolated onto the estimate's
  timestamps (``geometry/interp.py``, ``evaluation/trajectory.py``).
* The runner writes ``config.yaml``, and ``profile: true`` writes a trace of
  frame 2 into the result directory.
* The LM solve whitens ill-conditioned 3x3 covariances (the icp graph's) with
  a pivoted LU inverse, as the JAX solver's ``jnp.linalg.inv``, not with a
  float32 adjugate that cancels.
* The promotion gate compares the candidate's and the shipped calibration
  files by their resolved paths, as it compares the weights and the curves: a
  self-promotion spelled two ways left the records rewritten and then raised
  ``SameFileError``.
"""

from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from macvo_tpu.models.flowformer.encoder import CostPerceiverEncoder as JPerceiver
from macvo_tpu_torch.models.flowformer.encoder import CostPerceiverEncoder
from macvo_tpu_torch.models.flowformer.weights import flax_to_torch, load_state

ROOT = Path(__file__).parent.parent

# A narrow perceiver: 16-d tokens, 32-d latents, one encoder layer.
NARROW = dict(cost_latent_input_dim=16, cost_latent_token_num=8, cost_latent_dim=32, encoder_depth=1,
              patch_size=8, vert_c_dim=8)


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _narrow_perceiver():
    """The JAX perceiver with seeded parameters, the port's carrying the same
    numbers through the checkpoint loader, and seeded inputs."""
    rng = np.random.default_rng(11)
    b, h1, w1, h2, w2, ctx_dim = 1, 3, 4, 12, 20, 16
    cost = rng.normal(size=(b, h1 * w1, h2, w2)).astype(np.float32)
    ctx = rng.normal(size=(b, h1, w1, ctx_dim)).astype(np.float32)
    jm = JPerceiver(**NARROW, fused_input=False)
    params = jm.init(jax.random.PRNGKey(3), jnp.asarray(cost), jnp.asarray(ctx))["params"]
    # latents start at N(0, 0.02): scale them up so the softmax is not flat
    params["latents"] = jnp.asarray(rng.normal(size=params["latents"].shape).astype(np.float32))
    flat = {"/".join(k): np.asarray(v) for k, v in flatten_dict(params).items()}
    model = CostPerceiverEncoder(**NARROW, ctx_dim=ctx_dim)
    load_state(model, flax_to_torch(flat))
    return jm, params, model, cost, ctx, rng.normal(size=(b * h1 * w1, 8, 32)).astype(np.float32)


def test_perceiver_input_stage_gradients_match_jax():
    """Gradients of a weighted sum of the perceiver's output with respect to
    input_proj, the input attention's k, the latents and the cost maps: the
    port's unfused input stage against jax.grad of the JAX encoder with
    fused_input=False, on the same numbers. fp32 on both sides, the same math
    summed in other orders: 1e-4 abs and rel."""
    jm, params, model, cost, ctx, weight = _narrow_perceiver()

    def loss(p, c):
        return jnp.sum(jm.apply({"params": p}, c, jnp.asarray(ctx)) * weight)

    jgrad_p, jgrad_c = jax.grad(loss, argnums=(0, 1))(params, jnp.asarray(cost))

    cost_t = torch.from_numpy(cost).requires_grad_()
    out = model(cost_t, torch.from_numpy(ctx))
    (out * torch.from_numpy(weight)).sum().backward()

    pairs = [(model.input_proj.weight.grad, np.asarray(jgrad_p["input_proj"]["kernel"]).T),
             (model.input_attn.k.weight.grad, np.asarray(jgrad_p["input_attn"]["k"]["kernel"]).T),
             (model.latents.grad, np.asarray(jgrad_p["latents"])),
             (cost_t.grad, np.asarray(jgrad_c))]
    for ours, ref in pairs:
        assert ours is not None
        assert np.abs(ref).max() > 1e-3                  # a real gradient, not zeros
        np.testing.assert_allclose(ours.numpy(), ref, atol=1e-4, rtol=1e-4)


def test_perceiver_folded_and_unfused_stages_agree():
    """Without a gradient the perceiver takes the folded entry, with one the
    unfused stage; both compute the same function (fp32, 1e-5)."""
    _, _, model, cost, ctx, _ = _narrow_perceiver()
    with torch.no_grad():
        folded = model(torch.from_numpy(cost), torch.from_numpy(ctx))
    unfused = model(torch.from_numpy(cost), torch.from_numpy(ctx))
    assert unfused.grad_fn is not None and folded.grad_fn is None
    np.testing.assert_allclose(unfused.detach().numpy(), folded.numpy(), atol=1e-5, rtol=1e-5)


POSENET = ROOT / "model" / "TartanVO_posenet.npz"


def test_tartan_motion_net_predict_after_update_matches_jax():
    """TartanMotionNet as MAC-VO drives it: ``update`` with the optimized pose,
    then ``predict`` from flow and depth (NaNs included). The port against the
    JAX module on the same checkpoint and inputs: the chained pose within 1e-5
    (fp32 pose net and SE3 chain, other summation orders)."""
    from macvo_tpu.modules.frontend_tartanvo import TartanMotionNet as JMotion
    from macvo_tpu_torch.modules.frontend_tartanvo import TartanMotionNet

    rng = np.random.default_rng(5)
    meta = SimpleNamespace(height=64, width=96, fx=80.0, fy=80.0, cx=48.0, cy=32.0, frame_baseline=0.25)
    frame = SimpleNamespace(stereo=meta)
    flow = rng.normal(scale=3.0, size=(1, 64, 96, 2)).astype(np.float32)
    depth = rng.uniform(1.0, 20.0, size=(1, 64, 96, 1)).astype(np.float32)
    flow[0, :5] = np.nan
    depth[0, :, :3] = np.nan
    prior = np.array([0.3, -0.1, 0.5, 0.0, 0.0, np.sin(0.2), np.cos(0.2)], np.float32)

    jm = JMotion(SimpleNamespace(weight=str(POSENET)))
    ours = TartanMotionNet(SimpleNamespace(weight=str(POSENET)), device="cpu")
    for m, arr in ((jm, jnp.asarray), (ours, torch.from_numpy)):
        m.predict(frame, None, None)
        m.update(arr(prior))
    ref = np.asarray(jm.predict(frame, jnp.asarray(flow), jnp.asarray(depth)))
    pose = ours.predict(frame, torch.from_numpy(flow), torch.from_numpy(depth))
    assert pose.device == ours.device and pose.dtype == torch.float32
    assert np.abs(ref - prior).max() > 1e-4                 # the net moved the pose
    np.testing.assert_allclose(pose.numpy(), ref, atol=1e-5, rtol=1e-5)


def test_macvo_runs_with_tartan_motion_net_on_the_cpu():
    """MAC-VO with ``Odometry.motion`` set to TartanMotionNet (the block of
    configs/experiment/macvo/Paper_Reproduce.yaml), the rest the Performant
    config with 2 decoder steps, on 3 frames of a 192x192 crop of the real
    clip, on the CPU: the motion model is built on the odometry's device and
    every pose is finite."""
    from macvo_tpu_torch.modules.frontend_tartanvo import TartanMotionNet
    from macvo_tpu_torch.odometry import MACVO
    from macvo_tpu_torch.utils.config import load_config
    from test_torch_port_odometry import Crop, real_sequence

    cfg = load_config(ROOT / "configs/experiment/macvo/MACVO_Performant.yaml")[0]
    paper = load_config(ROOT / "configs/experiment/macvo/Paper_Reproduce.yaml")[0]
    cfg.Odometry.frontend.args.weight = str(ROOT / "model/MACVO_FrontendCov.npz")
    cfg.Odometry.frontend.args.decoder_depth = 2
    cfg.Odometry.args.num_point = 64
    cfg.Odometry.args.num_map_point = 128
    cfg.Odometry.motion = paper.Odometry.motion
    cfg.Odometry.motion.args.weight = str(POSENET)
    odom = MACVO.from_config(cfg, device="cpu")
    assert isinstance(odom.MotionEstimator, TartanMotionNet) and odom.MotionEstimator.device.type == "cpu"
    odom.receive_frames(Crop(real_sequence(gt_frontend=False), 192, 3))
    poses = odom.graph.frames.data["pose"][:3]
    assert len(odom.graph.frames) == 3 and np.isfinite(poses).all()
    assert odom.MotionEstimator.prev_pose.device.type == "cpu"


@pytest.mark.parametrize("preprocess,applies", [
    ([{"type": "SmartResizeFrame", "args": {"height": 64, "width": 64, "interp": "nearest"}}], True),
    ({"TartanAirV2": [{"type": "SmartResizeFrame", "args": {"height": 64, "width": 64, "interp": "nearest"}}]},
     True),
    ({"KITTI": [{"type": "SmartResizeFrame", "args": {"height": 64, "width": 64, "interp": "nearest"}}]}, False),
    ([], False),
])
def test_runner_applies_the_preprocess_it_names(preprocess, applies):
    """A list-form Preprocess applies to every sequence, a mapping only to the
    sequence type it names (macvo_tpu/data/sequence.py:smart_transform): the
    runner's sequence gives 64x64 frames where the transform applies and the
    clip's own 640x640 frames where it does not."""
    from macvo_tpu_torch.__main__ import build_sequence
    from macvo_tpu_torch.utils.config import build_dynamic_config

    data = build_dynamic_config({"Sequence": {"type": "TartanAirV2", "args": {
        "root": str(ROOT / "assets/test_sequence/TartanAir2_abs_P000"), "compressed": True,
        "gtFlow": False, "gtDepth": False, "gtPose": True}}})[0]
    odom = build_dynamic_config({"Odometry": {}, "Preprocess": preprocess})[0]
    seq = build_sequence(data, odom)
    assert len(seq) == 10
    assert seq[3].stereo.imageL.shape == ((1, 64, 64, 3) if applies else (1, 640, 640, 3))
    assert seq[3].stereo.imageR.shape == seq[3].stereo.imageL.shape


def _euroc_like(seed=0, hz=20.0):
    """A smooth random trajectory: ground truth at 200 Hz over 3 s, estimate
    at ``hz`` (20 Hz: 58 stamps) on other timestamps, two more of them outside
    the ground truth's span (clamped to its ends). float64."""
    from macvo_tpu_torch.geometry import se3_np

    rng = np.random.default_rng(seed)
    t_gt = np.arange(600) / 200.0 + 0.0025
    twists = np.cumsum(rng.normal(scale=0.02, size=(600, 6)), axis=0) * 0.01
    gt = np.empty((600, 7))
    gt[0] = se3_np.identity(dtype=np.float64)
    for i in range(1, 600):
        gt[i] = se3_np.mul(gt[i - 1], se3_np.exp(twists[i]))
    t_est = np.concatenate([[0.0], 0.0137 + np.arange(int(2.9 * hz)) / hz, [3.2]])
    est = gt[np.clip(np.searchsorted(t_gt, t_est), 0, 599)] + rng.normal(scale=1e-3, size=(len(t_est), 7))
    est[:, 3:] /= np.linalg.norm(est[:, 3:], axis=1, keepdims=True)
    return t_gt, gt, t_est, est


def test_interpolate_pose_matches_jax_at_another_rate():
    """interpolate_pose / qinterp of the port (numpy) against the JAX ones
    (float64 on the CPU) on ground truth at 200 Hz queried at 20 Hz, ends
    included: 1e-9."""
    from macvo_tpu.geometry import interp as jinterp
    from macvo_tpu_torch.geometry import interp

    t_gt, gt, t_est, _ = _euroc_like()
    ours, outside = interp.interpolate_pose(gt, t_gt, t_est)
    ref, ref_outside = jinterp.interpolate_pose(jnp.asarray(gt), jnp.asarray(t_gt), jnp.asarray(t_est))
    np.testing.assert_array_equal(outside, np.asarray(ref_outside))
    assert outside[0] and outside[-1] and not outside[1:-1].any()
    np.testing.assert_allclose(ours, np.asarray(ref), atol=1e-9, rtol=1e-9)
    q = interp.qinterp(gt[:, 3:], t_gt, t_est)
    np.testing.assert_allclose(q, np.asarray(jinterp.qinterp(jnp.asarray(gt[:, 3:]), jnp.asarray(t_gt),
                                                           jnp.asarray(t_est))), atol=1e-9, rtol=1e-9)


@pytest.mark.parametrize("hz", [7.0, 55.0, 200.0, 400.0])
def test_interpolate_pose_matches_jax_at_other_rates(hz):
    """As above with the estimate at 7, 55, 200 (the ground truth's rate, on
    shifted stamps) and 400 Hz (two queries between each pair of ground-truth
    poses): 1e-9."""
    from macvo_tpu.geometry import interp as jinterp
    from macvo_tpu_torch.geometry import interp

    t_gt, gt, t_est, _ = _euroc_like(2, hz)
    ours, outside = interp.interpolate_pose(gt, t_gt, t_est)
    ref, ref_outside = jinterp.interpolate_pose(jnp.asarray(gt), jnp.asarray(t_gt), jnp.asarray(t_est))
    np.testing.assert_array_equal(outside, np.asarray(ref_outside))
    np.testing.assert_allclose(ours, np.asarray(ref), atol=1e-9, rtol=1e-9)


def test_result_dir_metrics_align_ground_truth_by_time(tmp_path):
    """The runner's evaluation of a result directory whose ref_poses.npy has
    other timestamps (200 Hz) than poses.npy (20 Hz): the ground truth is
    interpolated onto the estimate's timestamps, as the JAX package's
    evaluate_sandbox does; ATE / RTE / ROE / RPE agree with it to 1e-9."""
    from macvo_tpu.evaluation.trajectory import evaluate_sandbox as j_evaluate_sandbox
    from macvo_tpu.utils.sandbox import Sandbox
    from macvo_tpu_torch.evaluation import evaluate_all, evaluate_sandbox

    t_gt, gt, t_est, est = _euroc_like(1)
    np.save(tmp_path / "poses.npy", np.concatenate([t_est[:, None], est], axis=1))
    np.save(tmp_path / "ref_poses.npy", np.concatenate([t_gt[:, None], gt], axis=1))
    ours = evaluate_sandbox(tmp_path)
    ref = j_evaluate_sandbox(Sandbox.load(tmp_path))
    assert set(ours) == set(ref)
    for key in ref:
        np.testing.assert_allclose([ours[key].rmse, ours[key].mean, ours[key].max],
                                   [ref[key].rmse, ref[key].mean, ref[key].max], rtol=1e-9, atol=1e-12)
    by_index = evaluate_all(gt[: len(est)], est)          # what truncating to the estimate's length gave
    assert ours["ATE"].rmse < 0.1 * by_index["ATE"].rmse


def test_runner_writes_its_config_and_a_frame_2_trace(tmp_path, monkeypatch):
    """``python -m macvo_tpu_torch --device cpu`` on the GT configuration with
    ``profile: true``, 3 frames: the result directory holds the odometry config
    (with the sequence config as Data) as config.yaml and a torch.profiler
    trace of frame 2."""
    import json

    import yaml

    from macvo_tpu_torch.__main__ import main as run_main
    from test_torch_port_odometry import ASSET, GT_CONFIG

    odom = tmp_path / "gt.yaml"
    data = tmp_path / "seq.yaml"
    cfg = {**GT_CONFIG, "Odometry": {**GT_CONFIG["Odometry"], "name": "GT",
                                     "args": {**GT_CONFIG["Odometry"]["args"], "profile": True}}}
    seq = {"Sequence": {"type": "TartanAirV2", "args": {
        "root": str(ASSET), "compressed": True, "gtFlow": True, "gtDepth": True, "gtPose": True}}}
    odom.write_text(yaml.safe_dump(cfg))
    data.write_text(yaml.safe_dump(seq))
    run_main(["--odom", str(odom), "--data", str(data), "--seq_to", "3", "--device", "cpu",
              "--resultRoot", str(tmp_path / "results")])
    (run,) = (tmp_path / "results").iterdir()       # <resultRoot>/<name>/<stamp>
    (out,) = run.iterdir()
    saved = yaml.safe_load((out / "config.yaml").read_text())
    assert saved["Odometry"] == cfg["Odometry"] and saved["Data"] == seq
    trace = json.loads((out / "trace" / "frame2.json").read_text())
    assert len(trace["traceEvents"]) > 10
    assert np.load(out / "poses.npy").shape == (3, 8)


def test_float32_solve_whitens_ill_conditioned_covariances_as_jax():
    """Landmark covariances nearly of rank one along an oblique direction
    (0.2 along it, 3e-6 across: condition ~7e4, as the frontend's 3D
    covariances of far points are): the float32 solve gives the JAX float32
    solve's pose within 1e-4, and the float64 one's. A closed-form adjugate
    over the determinant in float32 cancelled there and moved the pose by
    0.048; on the real clip it froze the icp solve at its initial pose."""
    from test_torch_port_modules import _problem

    from macvo_tpu.backend.solver import TwoFrameData as JData
    from macvo_tpu.backend.solver import solve_two_frame as j_solve
    from macvo_tpu_torch.backend.solver import TwoFrameData, solve_two_frame

    fields, _ = _problem()
    rng = np.random.default_rng(5)

    def oblique(n):
        u = np.array([1.0, -0.57, 0.82]) + rng.normal(0, 0.05, (n, 3))
        u /= np.linalg.norm(u, axis=1, keepdims=True)
        uu = u[:, :, None] * u[:, None, :]
        return 0.1 * uu + 1.5e-6 * (np.eye(3) - uu)

    fields["cov_obs_c"], fields["cov_pts_w"] = oblique(64), oblique(64)
    f32 = {k: np.asarray(v, np.float32) if np.asarray(v).dtype != bool else np.asarray(v) for k, v in fields.items()}
    ref32 = np.asarray(j_solve(JData(**{k: jnp.asarray(v) for k, v in f32.items()}), graph_type="icp"))
    ref64 = np.asarray(j_solve(JData(**{k: jnp.asarray(v) for k, v in fields.items()}), graph_type="icp"))
    ours = solve_two_frame(TwoFrameData(**{k: torch.as_tensor(v) for k, v in f32.items()}), graph_type="icp")
    assert ours.dtype == torch.float32
    np.testing.assert_allclose(ours.numpy(), ref32, atol=1e-4, rtol=0)
    np.testing.assert_allclose(ours.numpy(), ref64, atol=1e-4, rtol=0)


def test_self_promotion_spelled_two_ways_keeps_the_shipped_calibration(tmp_path, monkeypatch):
    """``--candidate`` relative to the working directory, ``--shipped``
    absolute, the same file, with a shipped ``.calib.json`` (the measurement
    stubbed): the promotion finishes, the weights, the curve and the
    calibration are left as they were, and both records are rewritten."""
    import contextlib
    import importlib.util
    import io
    import json

    spec = importlib.util.spec_from_file_location("_torch_promote", ROOT / "scripts" / "torch_promote_checkpoint.py")
    promote = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(promote)
    model = tmp_path / "model"
    model.mkdir()
    files = {model / "MACVO_FrontendCov.npz": b"shipped weights",
             model / "MACVO_FrontendCov.calib.json": b'{"tau2": [1.5]}\n',
             model / "MACVO_FrontendCov_metrics.csv": b"step,split,loss,epe,px1,px3,nll\n"}
    for path, data in files.items():
        path.write_bytes(data)
    measured = {"flow_epe_px": 3.31, "ate_m": 0.038,
                "e2e": {k: {"rmse": 0.038, "mean": 0.031} for k in ("ATE", "RTE", "ROE", "RPE")}}
    monkeypatch.setattr(promote, "measure", lambda *a, **k: dict(measured))
    monkeypatch.chdir(tmp_path)
    with contextlib.redirect_stdout(io.StringIO()):
        out = promote.main(["--candidate", "model/MACVO_FrontendCov.npz", "--force", "--device", "cpu",
                            "--shipped", str(model / "MACVO_FrontendCov.npz"),
                            "--record", str(model / "MACVO_FrontendCov.eval.json"),
                            "--e2e-json", str(tmp_path / "eval_real_asset.json")])
    assert out["gate_passed"] is True               # no record before: nothing to beat
    assert {path: path.read_bytes() for path in files} == files
    record = json.loads((model / "MACVO_FrontendCov.eval.json").read_text())
    assert (record["weight"], record["promoted_from"], record["platform"]) == (
        "MACVO_FrontendCov.npz", "MACVO_FrontendCov.npz", "cpu")
    assert json.loads((tmp_path / "eval_real_asset.json").read_text())["metrics"] == measured["e2e"]
