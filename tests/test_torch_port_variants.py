"""Parity of the port's module variants with the JAX package, on the CPU: the
selectors, covariance models, filters, motion models, keyframe selector,
empty optimizer and map processors that Paper_Reproduce, the ablation
configs and MACVO_Synthetic need, and both odometries on a crop of the real
clip with the same keypoints. Every experiment config builds in the port.

Random keypoint draws differ by design (torch.Generator vs jax.random), so
selectors are compared through their eligibility masks, exactly, and the
odometries are given the same keypoints. Tolerances are stated per test.
"""

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from macvo_tpu.data.datasets.synthetic import SyntheticStereo as JSyntheticStereo
from macvo_tpu.data.datasets.tartanair import TartanAirV2 as JTartanAirV2
from macvo_tpu.data.frame import StereoData as JStereoData
from macvo_tpu.modules import covariance as jcov
from macvo_tpu.modules import frontend as jfrontend
from macvo_tpu.modules import keypoint as jkeypoint
from macvo_tpu.modules import map_processor as jmap
from macvo_tpu.modules import motion as jmotion
from macvo_tpu.modules import outlier as joutlier
from macvo_tpu.odometry import MACVO as JMACVO
from macvo_tpu.utils.config import build_dynamic_config as j_build
from macvo_tpu.utils.config import load_config as j_load
from macvo_tpu.worldmap import FRAME_FIELDS as J_FRAME_FIELDS
from macvo_tpu.worldmap import Store as JStore
from macvo_tpu_torch.data.datasets.synthetic import SyntheticStereo
from macvo_tpu_torch.data.datasets.tartanair import TartanAirV2
from macvo_tpu_torch.data.frame import StereoData
from macvo_tpu_torch.evaluation import evaluate_all
from macvo_tpu_torch.geometry import se3_np
from macvo_tpu_torch.modules import covariance, keypoint, map_processor, motion, outlier
from macvo_tpu_torch.modules.frontend import DepthOutput, MatchOutput
from macvo_tpu_torch.odometry import ODOMETRY_TYPES, MACVO, build_odometry
from macvo_tpu_torch.utils.config import build_dynamic_config, load_config
from macvo_tpu_torch.worldmap import FRAME_FIELDS, Store

ROOT = Path(__file__).parent.parent
ASSET = ROOT / "assets" / "test_sequence" / "TartanAir2_abs_P000"
EXPERIMENTS = sorted(str(p.relative_to(ROOT / "configs/experiment"))
                     for p in (ROOT / "configs/experiment").rglob("*.yaml") if p.parent.name != "common")
H, W = 48, 64


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _ns(d):
    return build_dynamic_config(d)[0]


def _frames(fx=40.0, baseline=0.25, image=None):
    """The same calibration (and left image) as a port StereoData and a JAX one."""
    image = np.zeros((1, H, W, 3), np.float32) if image is None else image
    K = np.array([[[fx, 0, W / 2], [0, fx, H / 2], [0, 0, 1]]], np.float32)
    common = dict(T_BS=np.array([[0, 0, 0, 0, 0, 0, 1.0]], np.float32), K=K,
                  baseline=np.array([baseline], np.float32), time_ns=np.zeros(1, np.int64))
    return (StereoData(imageL=torch.from_numpy(image), imageR=torch.from_numpy(image), **common),
            JStereoData(imageL=jnp.asarray(image), imageR=jnp.asarray(image), **common))


def _jax_mask(selector, jframe, d0=None, d1=None, match=None):
    """The JAX selector's eligibility mask: asked for every pixel, its valid
    draws are exactly the eligible positions."""
    uv, valid = selector.select_point(jframe, H * W, d0, d1, match, key=jax.random.PRNGKey(0))
    uv, valid = np.asarray(uv), np.asarray(valid)
    mask = np.zeros((H, W), bool)
    mask[uv[valid, 1], uv[valid, 0]] = True
    assert mask.sum() == valid.sum()
    return mask


def _maps(seed):
    rng = np.random.default_rng(seed)
    d0, d1 = (rng.uniform(0.5, 14.0, (1, H, W, 1)).astype(np.float32) for _ in range(2))
    c0, c1 = (rng.uniform(0.001, 2.0, (1, H, W, 1)).astype(np.float32) for _ in range(2))
    c0[0, 5:9, 10:14] = 0.001                       # a plateau: equal minima inside one NMS window
    c1[0, 20, 30] = np.nan
    fcov = np.stack([rng.uniform(0.05, 4, (H, W)), rng.uniform(0.05, 4, (H, W)),
                     rng.uniform(-0.02, 0.02, (H, W))], -1)[None].astype(np.float32)
    masks = [rng.random((1, H, W, 1)) > 0.1 for _ in range(2)]
    return d0, c0, d1, c1, fcov, masks


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("with_flow_cov", [True, False])
def test_cov_aware_selector_mask_matches_jax(seed, with_flow_cov):
    """CovAwareSelector's eligibility (quality (s_d0 + s_d1) x flow quality,
    min-NMS, border, max_depth auto = fx x baseline = 12 m, adaptive
    thresholds, model masks): exactly the JAX package's (same float32 math).
    Without a flow covariance the depth terms alone decide. The port's draw
    takes K distinct eligible positions."""
    d0, c0, d1, c1, fcov, (m0, mm) = _maps(seed)
    cfg = {"kernel_size": 3, "mask_width": 4, "max_depth": "auto", "max_depth_cov": 250.0, "max_match_cov": 3.0}
    frame, jframe = _frames(fx=48.0)
    t = torch.from_numpy
    ours_d0 = DepthOutput(depth=t(d0), cov=t(c0), mask=t(m0))
    ours_m = MatchOutput(flow=torch.zeros(1, H, W, 2), cov=t(fcov) if with_flow_cov else None, mask=t(mm))
    ours = keypoint.CovAwareSelector(_ns(cfg)).eligible(frame, ours_d0, DepthOutput(depth=t(d1), cov=t(c1)), ours_m)
    j = jnp.asarray
    ref = _jax_mask(jkeypoint.CovAwareSelector(j_build(cfg)[0]), jframe,
                    jfrontend.DepthOutput(depth=j(d0), cov=j(c0), mask=j(m0)),
                    jfrontend.DepthOutput(depth=j(d1), cov=j(c1)),
                    jfrontend.MatchOutput(flow=jnp.zeros((1, H, W, 2)), cov=j(fcov) if with_flow_cov else None,
                                          mask=j(mm)))
    np.testing.assert_array_equal(ours.numpy(), ref)
    assert 10 < ref.sum() < H * W // 4
    uv, valid = keypoint.CovAwareSelector(_ns(cfg)).select_point(
        frame, 10, ours_d0, DepthOutput(depth=t(d1), cov=t(c1)), ours_m, torch.Generator().manual_seed(0))
    uv = uv.numpy()
    assert valid.all() and ref[uv[:, 1], uv[:, 0]].all() and len({tuple(p) for p in uv.tolist()}) == 10


@pytest.mark.parametrize("name,cfg", [
    ("GradientSelector", {"mask_width": 4, "grad_std": 0.5}),
    ("SparseGradientSelector", {"mask_width": 4, "grad_std": 0.5, "nms_size": 5}),
    ("SparseGradienSelector", {"mask_width": 6, "grad_std": 1.0, "nms_size": 3}),
])
def test_gradient_selector_masks_match_jax(name, cfg):
    """|Laplacian| above mean + grad_std x std (population), border, and the
    local-maximum NMS: the same mask as the JAX package's, exactly."""
    image = np.random.default_rng(5).uniform(0, 1, (1, H, W, 3)).astype(np.float32)
    frame, jframe = _frames(image=image)
    ours = keypoint.IKeypointSelector.instantiate(name, _ns(cfg)).eligible(frame)
    ref = _jax_mask(jkeypoint.IKeypointSelector.instantiate(name, j_build(cfg)[0]), jframe)
    np.testing.assert_array_equal(ours.numpy(), ref)
    assert 5 < ref.sum() < H * W // 2


def test_selector_compose_splits_the_budget_with_child_generators():
    """Weights 1:3 of 40 points give 10 random + 30 gradient points, as in the
    JAX package; each child draws from its own generator, seeded from the
    parent's seed, so a run is reproducible and the children's streams differ."""
    image = np.random.default_rng(6).uniform(0, 1, (1, H, W, 3)).astype(np.float32)
    frame, jframe = _frames(image=image)
    cfg = {"selector_args": [{"type": "RandomSelector", "args": {"mask_width": 4}},
                             {"type": "GradientSelector", "args": {"mask_width": 4, "grad_std": 0.5}}],
           "weight": [1, 3]}
    keypoint.IKeypointSelector.is_valid_config(_ns({"type": "SelectorCompose", "args": cfg}))

    def draw(seed):
        sel = keypoint.SelectorCompose(_ns(cfg))
        gen = torch.Generator().manual_seed(seed)
        return [sel.select_point(frame, 40, None, None, None, gen) for _ in range(2)]

    (uv, valid), (uv_next, _) = draw(0)
    ref_uv, ref_valid = jkeypoint.SelectorCompose(j_build(cfg)[0]).select_point(
        jframe, 40, None, None, None, key=jax.random.PRNGKey(0))
    assert uv.shape == np.asarray(ref_uv).shape == (40, 2) and valid.shape == np.asarray(ref_valid).shape
    grad = keypoint.GradientSelector(_ns(cfg["selector_args"][1]["args"])).eligible(frame)
    assert valid.all() and grad[uv[10:, 1], uv[10:, 0]].all()
    assert ((uv[:10] >= 4) & (uv[:10] < torch.tensor([W - 4, H - 4]))).all()
    again, other = draw(0), draw(1)
    assert torch.equal(again[0][0], uv) and torch.equal(again[1][0], uv_next) and not torch.equal(uv, uv_next)
    assert not torch.equal(other[0][0], uv)


def _cov_inputs(seed=4, n=40):
    rng = np.random.default_rng(seed)
    depth = rng.uniform(1, 20, (1, H, W, 1)).astype(np.float32)
    dcov_map = rng.uniform(0.01, 1, (1, H, W, 1)).astype(np.float32)
    kp = np.stack([rng.integers(0, W, n), rng.integers(0, H, n)], -1).astype(np.float32)
    dcov = rng.uniform(0.01, 1, n).astype(np.float32)
    fcov = np.stack([rng.uniform(0.01, 5, n), rng.uniform(0.01, 5, n), rng.uniform(-0.3, 0.3, n)], -1)
    return depth, dcov_map, kp, dcov, fcov.astype(np.float32)


def _estimate(cfg_type, cfg_args, has_depth_cov=True, has_flow_cov=True):
    depth, dcov_map, kp, dcov, fcov = _cov_inputs()
    frame, jframe = _frames(fx=70.0)
    node = {"type": cfg_type, "args": cfg_args}
    ours = covariance.ICovariance2to3.instantiate(cfg_type, _ns(node).args).estimate(
        frame, torch.from_numpy(kp), DepthOutput(depth=torch.from_numpy(depth), cov=torch.from_numpy(dcov_map)),
        torch.from_numpy(dcov) if has_depth_cov else None, torch.from_numpy(fcov) if has_flow_cov else None)
    ref = jcov.ICovariance2to3.instantiate(cfg_type, j_build(node)[0].args).estimate(
        jframe, jnp.asarray(kp), jfrontend.DepthOutput(depth=jnp.asarray(depth), cov=jnp.asarray(dcov_map)),
        jnp.asarray(dcov) if has_depth_cov else None, jnp.asarray(fcov) if has_flow_cov else None)
    return ours, np.asarray(ref, np.float64), kp


MATCH = {"type": "MatchCovariance", "args": {"kernel_size": 7, "match_cov_default": 0.25,
                                            "min_flow_cov": 0.25, "min_depth_cov": 0.05}}


def test_no_covariance_is_the_identity_as_in_jax():
    ours, ref, kp = _estimate("NoCovariance", None)
    assert ours.dtype == torch.float32 and ours.shape == (len(kp), 3, 3)
    np.testing.assert_array_equal(ours.numpy(), ref)


def test_diagonalize_matches_jax():
    """MatchCovariance with its off-diagonal terms zeroed: MatchCovariance's
    tolerance (1e-5 relative), off-diagonals exactly 0."""
    ours, ref, _ = _estimate("Modifier_Diagonalize", MATCH)
    np.testing.assert_allclose(ours.numpy(), ref, rtol=1e-5, atol=1e-7)
    assert (ours.numpy()[:, ~np.eye(3, dtype=bool)] == 0).all()


def test_normalize_matches_jax():
    """MatchCovariance divided by its determinant. The port's covariances are
    fp32 and differ from JAX's by a relative eps_n per keypoint (held to 1e-5
    by MatchCovariance's own test); a determinant amplifies that by its
    condition number kappa_n = sum |a_ij C_ij| / |det| (C the cofactors), up
    to ~3e3 for these near-rank-one covariances. So each keypoint's quotient
    is held, normwise, to 2 (1 + kappa_n) eps_n of the JAX package's float64."""
    ours, ref, _ = _estimate("Modifier_Normalize", MATCH)
    sub, sub_ref, _ = _estimate("MatchCovariance", MATCH["args"])
    assert ours.dtype == torch.float32
    scale = np.abs(sub_ref).max(axis=(1, 2))
    eps = np.abs(sub.numpy() - sub_ref).max(axis=(1, 2)) / scale
    assert eps.max() <= 1e-5
    cof = np.stack([np.cross(sub_ref[:, 1], sub_ref[:, 2]), np.cross(sub_ref[:, 2], sub_ref[:, 0]),
                    np.cross(sub_ref[:, 0], sub_ref[:, 1])], axis=1)
    kappa = np.abs(cof * sub_ref).sum(axis=(1, 2)) / np.abs(np.linalg.det(sub_ref))
    err = np.abs(ours.numpy() - ref).max(axis=(1, 2)) / np.abs(ref).max(axis=(1, 2))
    assert (err <= 2 * (1 + kappa) * np.maximum(eps, np.finfo(np.float32).eps)).all(), (err, kappa, eps)


def test_normalize_determinant_is_float64_at_covariance_scale():
    """Entries near 1e-4 give determinants near 1e-12: the closed-form float64
    determinant equals numpy's LU one to 1e-12 relative, and the modifier's
    fp32 output is the float64 quotient up to one fp32 rounding (1e-6)."""
    rng = np.random.default_rng(9)
    a = rng.normal(0, 1e-2, (32, 3, 3))
    covs = (a @ a.transpose(0, 2, 1) + np.eye(3) * 1e-5).astype(np.float32)
    det = covariance.det_3x3_f64(torch.from_numpy(covs))
    assert det.dtype == torch.float64
    np.testing.assert_allclose(det.numpy(), np.linalg.det(covs.astype(np.float64)), rtol=1e-12)

    class Given(covariance.ICovariance2to3, register=False):
        def estimate(self, *args):
            return torch.from_numpy(covs)

    mod = covariance.Modifier_Normalize.__new__(covariance.Modifier_Normalize)
    mod.config, mod.submodule = None, Given(None)
    out = mod.estimate(None, None, None, None, None)
    ref = covs.astype(np.float64) / np.linalg.det(covs.astype(np.float64))[:, None, None]
    assert out.dtype == torch.float32 and np.isfinite(out.numpy()).all()
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-6)


def test_depth_covariance_matches_jax():
    """Depth variance along the ray + 1e-5 I: fp32 against float64, 1e-6 relative."""
    ours, ref, _ = _estimate("DepthCovariance", {"regularization": 1e-5})
    np.testing.assert_allclose(ours.numpy(), ref, rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("has_depth_cov,has_flow_cov", [(True, True), (True, False), (False, False)])
def test_gaussian_mixture_covariance_matches_jax(has_depth_cov, has_flow_cov):
    """The mixture's variance E[v + m^2] - mean^2 cancels in fp32 (the JAX
    side) at depths of 1-20 m: its error is absolute, of the order of
    mean^2 x eps. The bound is 1e-5 relative plus, for each keypoint,
    16 x mean^2 x eps(fp32) times the entry's largest projection factor
    (1, (du/fx)^2, (dv/fy)^2), not a bound relative to the variance."""
    ours, ref, kp = _estimate("GaussianMixtureCovariance", MATCH["args"], has_depth_cov, has_flow_cov)
    depth = _cov_inputs()[0][0, ..., 0]
    mean = depth[kp[:, 1].astype(int), kp[:, 0].astype(int)]           # the centre tap dominates the mean
    mean = np.maximum(mean, 20.0) if has_flow_cov else mean
    du, dv = (kp[:, 0] - W / 2) / 70.0, (kp[:, 1] - H / 2) / 70.0
    factor = np.maximum(1.0, np.maximum(du * du, dv * dv))
    atol = 16 * mean**2 * np.finfo(np.float32).eps * factor
    err = np.abs(ours.numpy() - ref)
    assert (err <= 1e-5 * np.abs(ref) + atol[:, None, None]).all(), float((err - 1e-5 * np.abs(ref)).max())


def _obs(seed=2, n=64):
    rng = np.random.default_rng(seed)
    return {"pixel1_d": rng.uniform(0.1, 5, (n, 1)).astype(np.float32),
            "pixel2_d": rng.uniform(0.1, 5, (n, 1)).astype(np.float32),
            "pixel1_d_cov": rng.uniform(0, 4, (n, 1)).astype(np.float32),
            "pixel2_d_cov": rng.uniform(0, 4, (n, 1)).astype(np.float32)}


@pytest.mark.parametrize("name,placeholder", [("LikelyFrontOfCamFilter", False),
                                              ("LikelyFrontOfCamFilter", True), ("IdentityFilter", False)])
def test_filters_match_jax(name, placeholder):
    """Keep-masks on the same observations, exactly. A -1 placeholder depth
    covariance anywhere turns LikelyFrontOfCamFilter off, as in JAX."""
    obs = _obs()
    if placeholder:
        obs["pixel2_d_cov"][7] = -1.0
    ours = outlier.IObservationFilter.instantiate(name, None).filter({k: torch.from_numpy(v) for k, v in obs.items()})
    ref = joutlier.IObservationFilter.instantiate(name, None).filter({k: jnp.asarray(v) for k, v in obs.items()})
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    assert ours.all() == (placeholder or name == "IdentityFilter")


def test_gt_motion_matches_jax_without_noise_and_draws_seeded_noise():
    """GTMotionwithNoise at noise_std 0 chains the ground-truth motion onto
    each updated pose as JAX does (fp32, 1e-6). With noise the draws come from
    its seeded torch.Generator: the same seed repeats them, another does not."""
    seq = SyntheticStereo({"n_frames": 4, "width": 32, "height": 24, "fx": 16.0, "fy": 16.0})
    frames = [seq[i] for i in range(4)]
    ours = motion.GTMotionwithNoise(_ns({"noise_std": 0.0}), device="cpu")
    ref = jmotion.GTMotionwithNoise(j_build({"noise_std": 0.0})[0])
    nudge = np.array([0.01, -0.02, 0.005, 0.0, 0.0, 0.0, 0.0], np.float32)
    for i, f in enumerate(frames):
        a, b = ours.predict(f, None, None), np.asarray(ref.predict(f, None, None))
        np.testing.assert_allclose(a.numpy(), b, atol=1e-6)
        if i:
            ours.update(a + torch.from_numpy(nudge))
            ref.update(jnp.asarray(b + nudge))

    def noisy(seed):
        model = motion.GTMotionwithNoise(_ns({"noise_std": 0.05, "seed": seed}), device="cpu")
        return torch.stack([model.predict(f, None, None) for f in frames])

    assert torch.equal(noisy(3), noisy(3)) and not torch.equal(noisy(3), noisy(4))
    drift = (noisy(3)[1:, :3] - torch.from_numpy(seq.poses[1:, :3] - seq.poses[0, :3])).abs().max()
    assert 0 < float(drift) < 0.5


@pytest.mark.parametrize("name", ["Naive", "PoseInterpolate", "MotionInterpolate"])
def test_map_processors_match_jax(name):
    """A 16-frame map with need_interp frames at both ends and in the middle:
    the same repaired indices, and poses within 1e-6 (PoseInterpolate in
    float32 with float32 frame stamps, MotionInterpolate in float64, as JAX)."""
    rng = np.random.default_rng(11)
    n = 16
    twists = np.cumsum(np.concatenate([rng.normal(0, 0.3, (n, 3)), rng.normal(0, 0.05, (n, 3))], 1), axis=0)
    poses = se3_np.exp(twists).astype(np.float32)
    need = np.zeros(n, bool)
    need[[0, 1, 2, 6, 7, 10, 14, 15]] = True
    rows = {"pose": poses, "T_BS": np.tile([0, 0, 0, 0, 0, 0, 1.0], (n, 1)).astype(np.float32),
            "need_interp": need, "time_ns": np.arange(n, dtype=np.int64), "K": np.tile(np.eye(3), (n, 1, 1)),
            "baseline": np.full(n, 0.25, np.float32)}
    ours, ref = Store(FRAME_FIELDS, 32), JStore(J_FRAME_FIELDS, 32)
    ours.push(rows)
    ref.push(rows)
    fixed = map_processor.IMapProcessor.instantiate(name, None).elaborate_map(ours)
    fixed_ref = jmap.IMapProcessor.instantiate(name, None).elaborate_map(ref)
    np.testing.assert_array_equal(fixed, fixed_ref)
    assert (len(fixed) > 0) == (name != "Naive")
    np.testing.assert_allclose(ours.data["pose"][:n], ref.data["pose"][:n], atol=1e-6)


def _pose_file_config(pose_file):
    return {"Odometry": {
        "args": {"num_point": 64, "edgewidth": 8, "match_cov_default": 0.25, "profile": False, "mapping": False},
        "frontend": {"type": "FrontendCompose", "args": {
            "depth": {"type": "GTDepth", "args": {}}, "match": {"type": "GTMatcher", "args": {}}}},
        "motion": {"type": "ReadPoseFile", "args": {"pose_file": str(pose_file)}},
        "keypoint": {"type": "RandomSelector", "args": {"mask_width": 8}},
        "mappoint": {"type": "RandomSelector", "args": {"mask_width": 8}},
        "outlier": {"type": "IdentityFilter", "args": {}},
        "cov": {"obs": {"type": "NoCovariance", "args": {}}},
        "postprocess": {"type": "PoseInterpolate", "args": {}},
        "keyframe": {"type": "UniformKeyframe", "args": {"keyframe_freq": 3}},
        "optimizer": {"type": "Empty_TwoFrame_PGO", "args": {"graph_type": "icp", "parallel": True,
                                                             "capacity": 128}},
    }}


def test_pose_file_uniform_keyframes_empty_optimizer_run_as_in_jax(tmp_path):
    """A 14-frame synthetic run: ReadPoseFile (a perturbed trajectory from a
    .txt file), UniformKeyframe(3), Empty_TwoFrame_PGO and PoseInterpolate.
    The optimizer keeps the motion model's pose, so the keypoint draws do not
    matter: every pose as the JAX package's, within 1e-5 (float32 chains)."""
    spec = {"n_frames": 14, "width": 64, "height": 48, "fx": 32.0, "fy": 32.0}
    seq, jseq = SyntheticStereo(spec), JSyntheticStereo(spec)
    rng = np.random.default_rng(12)
    noisy = seq.poses.astype(np.float64) + np.concatenate([rng.normal(0, 0.02, (14, 3)), np.zeros((14, 4))], 1)
    np.savetxt(tmp_path / "poses.txt", noisy)
    cfg = _pose_file_config(tmp_path / "poses.txt")
    MACVO.is_valid_config(_ns(cfg).Odometry)
    odom = MACVO.from_config(_ns(cfg), device="cpu")
    odom.receive_frames(seq)
    jodom = JMACVO.from_config(j_build(cfg)[0])
    jodom.receive_frames(jseq)
    ours, ref = odom.graph.frames.data["pose"], np.asarray(jodom.graph.frames.data["pose"])
    assert ours.shape == ref.shape == (14, 7)
    np.testing.assert_array_equal(odom.graph.frames.data["need_interp"], jodom.graph.frames.data["need_interp"])
    assert odom.graph.frames.data["need_interp"].sum() == 9
    np.testing.assert_allclose(ours, ref, atol=1e-5)
    motion_file = noisy[::3] - noisy[0]                 # keyframes follow the file's motion
    np.testing.assert_allclose(ours[::3, :3], motion_file[:, :3], atol=1e-4)


@pytest.mark.parametrize("path", EXPERIMENTS)
def test_every_experiment_config_is_valid_in_the_port(path, monkeypatch):
    """All 14 configs under configs/experiment/ pass the port's validation;
    the GT-frontend one and Paper_Reproduce (FlowFormerCov and the TartanVO
    pose net from the in-repo checkpoints) are built on the CPU."""
    cfg = load_config(ROOT / "configs/experiment" / path)[0]
    cls = ODOMETRY_TYPES[getattr(cfg.Odometry, "type", "MACVO")]
    cls.is_valid_config(cfg.Odometry)
    if path in ("macvo/MACVO_Synthetic.yaml", "macvo/Paper_Reproduce.yaml"):
        monkeypatch.chdir(ROOT)                        # the config names its checkpoints from the repo root
        system = build_odometry(cfg, device="cpu")
        assert isinstance(system, MACVO)


def test_the_experiment_configs_are_the_fourteen_shipped():
    assert len(EXPERIMENTS) == 14


def _crop(frame, to_backend, contiguous, h=96, w=128):
    s = frame.stereo
    y0, x0 = (640 - h) // 2, (640 - w) // 2
    K = np.array(s.K, np.float32)
    K[:, 0, 2] -= x0
    K[:, 1, 2] -= y0
    cut = (lambda x: contiguous(x[:, y0:y0 + h, x0:x0 + w]))
    return dataclasses.replace(frame, stereo=dataclasses.replace(s, K=to_backend(K), imageL=cut(s.imageL),
                                                                 imageR=cut(s.imageR)))


@pytest.fixture(scope="module")
def real_crops():
    args = {"root": str(ASSET), "compressed": True, "gtFlow": False, "gtDepth": False, "gtPose": True}
    jseq, seq = JTartanAirV2(args), TartanAirV2(args)
    return ([_crop(jseq[i], jnp.asarray, lambda x: x) for i in range(3)],
            [_crop(seq[i], lambda k: k, lambda x: x.contiguous()) for i in range(3)])


@pytest.fixture(scope="module")
def jax_frontend():
    """One JAX frontend for both learned configs (their frontend sections
    are the same): it compiles once."""
    return {}


def _learned(cfg):
    o = cfg.Odometry
    o.frontend.args.weight = str(ROOT / "model/MACVO_FrontendCov.npz")
    o.frontend.args.decoder_depth = 2
    o.args.edgewidth = 16
    if o.motion.type == "TartanMotionNet":
        o.motion.args.weight = str(ROOT / "model/TartanVO_posenet.npz")
    return cfg


@pytest.mark.parametrize("path", ["macvo/Paper_Reproduce.yaml", "macvo/ablation/TartanAirv2_ScaleNorm.yaml"])
def test_learned_configs_run_as_in_jax_with_the_same_keypoints(path, real_crops, jax_frontend):
    """Paper_Reproduce (CovAwareSelector's place taken by the keypoints below,
    TartanMotionNet, disp graph in float64, LikelyFrontOfCamFilter) and the
    ScaleNorm ablation (Modifier_Normalize, icp graph) on 3 frames of a
    96x128 crop, 2 decoder steps, through both MACVOs with the same 64
    keypoints every frame: every pose element within 1e-4 (fp32 frontends
    summed in other orders), and so the ATE on the crop (printed)."""
    rng = np.random.default_rng(0)
    uv = np.stack([rng.integers(16, 112, 64), rng.integers(16, 80, 64)], -1).astype(np.int32)

    class JFixed(jkeypoint.IKeypointSelector, register=False):
        def select_point(self, frame, num_point, d0, d1, match, key=None):
            return jnp.asarray(uv), jnp.ones(len(uv), bool)

    class Fixed(keypoint.IKeypointSelector, register=False):
        def select_point(self, frame, num_point, d0, d1, match, generator):
            return torch.as_tensor(uv), torch.ones(len(uv), dtype=torch.bool)

    jframes, frames = real_crops
    jodom = JMACVO.from_config(_learned(j_load(ROOT / "configs/experiment" / path)[0]))
    jodom.Frontend = jax_frontend.setdefault("frontend", jodom.Frontend)
    jodom.KeypointSelector = JFixed(None)
    jodom.receive_frames(jframes)
    odom = MACVO.from_config(_learned(load_config(ROOT / "configs/experiment" / path)[0]), device="cpu")
    odom.KeypointSelector = Fixed(None)
    odom.receive_frames(frames)
    ours, ref = odom.graph.frames.data["pose"][:3], np.asarray(jodom.graph.frames.data["pose"][:3])
    assert len(odom.graph.match) == len(jodom.graph.match) > 64
    assert np.linalg.norm(ours[-1, :3] - ours[0, :3]) > 0.1          # it moves
    np.testing.assert_allclose(ours, ref, atol=1e-4, rtol=0)
    gt = np.stack([f.gt_pose[0] for f in frames]).astype(np.float64)
    ate = {"port": evaluate_all(gt, ours.astype(np.float64))["ATE"].rmse,
           "jax": evaluate_all(gt, ref.astype(np.float64))["ATE"].rmse}
    print(f"{path}: ATE on the crop, m: {ate}")
    assert abs(ate["port"] - ate["jax"]) <= 1e-4
