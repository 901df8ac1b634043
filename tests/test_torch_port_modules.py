"""Parity of the port's keypoint, covariance and backend stages with the JAX package.

Selection: the random top-K draws differ by design (torch.Generator vs
jax.random), so the eligibility masks are compared exactly and the same
``kp_uv`` is fed to both covariance models. Backend: both solvers get the same
``TwoFrameData`` in float64 (the JAX suite runs x64 on the CPU).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from macvo_tpu.backend.solver import TwoFrameData as JData
from macvo_tpu.backend.solver import solve_two_frame as j_solve
from macvo_tpu.backend.two_frame_pgo import solve_sync_packed as j_solve_sync
from macvo_tpu.geometry import camera as jcam
from macvo_tpu.geometry import se3 as jse3
from macvo_tpu.odometry.layout import COL_KEEP, OBS_COLS, PACKED_SYNC_WIDTH
from macvo_tpu.ops.cov_project import match_covariance as j_match_cov
from macvo_tpu.ops.select import border_mask as j_border_mask
from macvo_tpu.ops.select import local_min_nms as j_local_min_nms
from macvo_tpu.ops.select import masked_median as j_masked_median
from macvo_tpu_torch.backend.solver import TwoFrameData, solve_two_frame
from macvo_tpu_torch.backend.two_frame_pgo import solve_sync_packed
from macvo_tpu_torch.modules.frontend import MatchOutput
from macvo_tpu_torch.modules.keypoint import CovAwareSelector_NoDepth, MappingPointSelector
from macvo_tpu_torch.modules.frontend import DepthOutput
from macvo_tpu_torch.ops.cov_project import match_covariance
from macvo_tpu_torch.ops.select import masked_median, masked_random_topk
from macvo_tpu_torch.utils.config import build_dynamic_config


def _flow_cov(rng, h=48, w=64):
    cov = np.stack([rng.uniform(0.05, 4, (h, w)), rng.uniform(0.05, 4, (h, w)),
                    rng.uniform(-0.02, 0.02, (h, w))], -1)
    cov[5:9, 10:14, 0] = 0.01          # a plateau: equal minima inside one NMS window
    cov[20, 30] = np.nan
    return cov.astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cov_aware_nodepth_mask_matches_jax(seed):
    """Eligibility mask of CovAwareSelector_NoDepth, exactly (same float32 math)."""
    rng = np.random.default_rng(seed)
    cov = _flow_cov(rng)
    model_mask = rng.random(cov.shape[:2]) > 0.1
    sel = CovAwareSelector_NoDepth(build_dynamic_config(
        {"kernel_size": 7, "mask_width": 8, "max_match_cov": 3.0})[0])
    ours = sel.eligible(MatchOutput(flow=torch.zeros(1, 48, 64, 2), cov=torch.from_numpy(cov)[None],
                                    mask=torch.from_numpy(model_mask)[None, ..., None]))
    jc = jnp.asarray(cov)
    flow_q = jc[..., 0] + jc[..., 1] - 2.0 * jc[..., 2]
    nms = j_local_min_nms(flow_q, 7)
    thresh = jnp.minimum(3.0, j_masked_median(flow_q, nms) * 1.5)
    ref = nms & j_border_mask(48, 64, 8) & (flow_q < thresh) & jnp.asarray(model_mask)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    assert ours.sum() > 10


def test_mapping_mask_and_topk_draw():
    rng = np.random.default_rng(3)
    depth = rng.uniform(0.5, 9, (1, 40, 50, 1)).astype(np.float32)
    dcov = rng.uniform(0, 0.01, (1, 40, 50, 1)).astype(np.float32)
    sel = MappingPointSelector(build_dynamic_config({"max_depth": 5.0, "max_depth_cov": 0.005, "mask_width": 4})[0])
    mask = sel.eligible(DepthOutput(depth=torch.from_numpy(depth), cov=torch.from_numpy(dcov)))
    d, c = depth[0, ..., 0], dcov[0, ..., 0]
    ref = (d < 5.0) & (c < 0.005) & np.asarray(j_border_mask(40, 50, 4))
    np.testing.assert_array_equal(mask.numpy(), ref)
    # The draw: K distinct eligible positions; the invalid tail when K exceeds them.
    uv, valid = masked_random_topk(mask, 100, torch.Generator().manual_seed(0))
    assert valid.all() and len({(int(u), int(v)) for u, v in uv}) == 100
    assert mask[uv[:, 1].long(), uv[:, 0].long()].all()
    uv, valid = masked_random_topk(mask, 2000, torch.Generator().manual_seed(0))
    assert int(valid.sum()) == int(mask.sum()) and (uv[~valid] == 0).all()


@pytest.mark.parametrize("n_true", [0, 1, 6, 7])
def test_masked_median_matches_jax(n_true):
    """numpy median semantics (mean of the middle pair), NaN when empty."""
    rng = np.random.default_rng(n_true)
    vals = rng.normal(size=(5, 6)).astype(np.float32)
    vals[0, 0] = np.nan
    mask = np.zeros((5, 6), bool)
    mask.reshape(-1)[rng.permutation(30)[:n_true]] = True
    ours = float(masked_median(torch.from_numpy(vals), torch.from_numpy(mask)))
    ref = float(j_masked_median(jnp.asarray(vals), jnp.asarray(mask)))
    np.testing.assert_allclose(ours, ref, equal_nan=True)


def _match_covariance_f64(depth, kp, dcov, fcov, fx, fy, cx, cy, kernel_size, match_cov_default,
                          min_flow_cov, min_depth_cov, has_flow_cov, has_depth_cov):
    """float64 numpy oracle of MatchCovariance, written from its definition."""
    n = kp.shape[0]
    fc = np.zeros((n, 3))
    fc[:, :2] = match_cov_default
    if has_flow_cov:
        fc = fcov.astype(np.float64)
        fc[:, :2] = np.maximum(fc[:, :2], min_flow_cov ** 2)
    su, sv, suv = fc[:, 0], fc[:, 1], fc[:, 2]
    det = su * sv - suv * suv
    half = kernel_size // 2
    g = np.arange(-half, half + 1, dtype=np.float64)
    gx, gy = g[:, None], g[None, :]                          # kernel[n, x, y]: x is the u-offset
    quad = (sv[:, None, None] * gx * gx - 2 * suv[:, None, None] * gx * gy + su[:, None, None] * gy * gy)
    z = np.exp(-0.5 * quad / det[:, None, None])
    z /= z.sum(axis=(1, 2), keepdims=True)
    h, w = depth.shape
    u_idx = np.clip(kp[:, 0].astype(np.int64)[:, None] + g.astype(np.int64), 0, w - 1)
    v_idx = np.clip(kp[:, 1].astype(np.int64)[:, None] + g.astype(np.int64), 0, h - 1)
    patches = depth.astype(np.float64)[v_idx[:, None, :], u_idx[:, :, None]]
    mean = (z * patches).sum(axis=(1, 2))
    var = (z * (patches - mean[:, None, None]) ** 2).sum(axis=(1, 2))
    if has_depth_cov and not has_flow_cov:
        var = dcov.astype(np.float64)
    sdd = np.maximum(var, min_depth_cov)
    du, dv, d2 = kp[:, 0] - cx, kp[:, 1] - cy, mean * mean
    s_xx = (du * du * sdd + d2 * su + su * sdd) / fx ** 2
    s_yy = (dv * dv * sdd + d2 * sv + sv * sdd) / fy ** 2
    s_xy = (du * dv * sdd + (d2 + sdd) * suv) / (fx * fy)
    s_xz, s_yz = sdd * du / fx, sdd * dv / fy
    return np.stack([np.stack([sdd, s_xz, s_yz], -1), np.stack([s_xz, s_xx, s_xy], -1),
                     np.stack([s_yz, s_xy, s_yy], -1)], -2)


@pytest.mark.parametrize("has_flow_cov,has_depth_cov", [(True, True), (True, False), (False, False), (False, True)])
def test_match_covariance_matches_jax(has_flow_cov, has_depth_cov):
    """Same kp_uv into both; fp32 sums over 31x31 patches: 1e-5 relative.
    Each side is first held against a float64 oracle, so a drift names the
    side that moved."""
    rng = np.random.default_rng(4)
    depth = rng.uniform(1, 20, (120, 160)).astype(np.float32)
    kp = np.stack([rng.integers(0, 160, 50), rng.integers(0, 120, 50)], -1).astype(np.float32)
    dcov = rng.uniform(0.01, 1, 50).astype(np.float32)
    fcov = np.stack([rng.uniform(0.01, 5, 50), rng.uniform(0.01, 5, 50), rng.uniform(-0.3, 0.3, 50)], -1)
    fcov = fcov.astype(np.float32)
    cam = (320.0, 300.0, 80.0, 60.0)
    args = (31, 0.25, 0.25, 0.05, has_flow_cov, has_depth_cov)
    ref = j_match_cov(jnp.asarray(depth), jnp.asarray(kp), jnp.asarray(dcov), jnp.asarray(fcov), *cam, *args)
    ours = match_covariance(torch.from_numpy(depth), torch.from_numpy(kp), torch.from_numpy(dcov),
                            torch.from_numpy(fcov), *cam, *args)
    oracle = _match_covariance_f64(depth, kp, dcov, fcov, *cam, *args)
    np.testing.assert_allclose(ours.numpy(), oracle, rtol=1e-5, atol=1e-7, err_msg="port against the f64 oracle")
    np.testing.assert_allclose(np.asarray(ref), oracle, rtol=1e-5, atol=1e-7, err_msg="JAX against the f64 oracle")
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-7)


def _problem(n=64, seed=0):
    rng = np.random.default_rng(seed)
    K = np.array([[320.0, 0, 320], [0, 320.0, 240], [0, 0, 1]])
    true_pose = np.asarray(jse3.normalize(jnp.asarray(
        np.concatenate([rng.normal(0, 0.5, 3), [0.05, 0.02, -0.03, 1.0]]))))
    pts_c = np.stack([rng.uniform(4, 20, n), rng.uniform(-3, 3, n), rng.uniform(-2, 2, n)], 1)
    pts_w = np.asarray(jse3.act(jnp.asarray(true_pose), jnp.asarray(pts_c))) + rng.normal(0, 0.02, (n, 3))
    kp2 = np.asarray(jcam.point_to_pixel_ned(jnp.asarray(pts_c), jnp.asarray(K))) + rng.normal(0, 0.5, (n, 2))
    init = np.asarray(jse3.mul(jnp.asarray(true_pose), jse3.exp(jnp.asarray([0.1, -0.05, 0.08, 0.02, -0.01, 0.03]))))
    mask = np.ones(n, bool)
    mask[::7] = False
    pts_w[1::9] += 3.0                                    # outliers for the Huber kernel
    fields = dict(
        pose0=init, points_w=pts_w, points_c=pts_c, kp2=kp2, disp2=K[0, 0] * 0.25 / pts_c[:, 0],
        cov_obs_c=np.tile(np.eye(3) * 0.01, (n, 1, 1)) + 0.002, cov_pts_w=np.tile(np.eye(3) * 0.02, (n, 1, 1)),
        cov_kp2=np.tile(np.eye(2) * 0.25, (n, 1, 1)), disp2_cov=np.full(n, 0.25), K=K,
        baseline=np.asarray(0.25), mask=mask)
    return fields, true_pose


@pytest.mark.parametrize("graph_type", ["icp", "reproj", "disp"])
def test_solve_two_frame_matches_jax(graph_type):
    """Same TwoFrameData (f64, noisy, masked rows, outliers) into both LM
    solvers: the same accept/reject path gives the same pose to 1e-9."""
    fields, _ = _problem()
    ref = j_solve(JData(**{k: jnp.asarray(v) for k, v in fields.items()}), graph_type=graph_type)
    ours = solve_two_frame(TwoFrameData(**{k: torch.as_tensor(np.array(v)) for k, v in fields.items()}),
                           graph_type=graph_type)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-9)


@pytest.mark.parametrize("graph_type", ["icp", "disp"])
def test_solve_sync_packed_matches_jax_with_poisoned_rows(graph_type):
    """Device-chained solve on a packed (K+1, 52) float32 sync array whose
    masked rows hold NaN/Inf: both sides give the same pose (float32 solve,
    1e-4) and it recovers the true motion."""
    rng = np.random.default_rng(3)
    n, cap = 32, 48
    K = np.array([[160.0, 0, 160], [0, 160.0, 120], [0, 0, 1]])
    anchor = np.asarray(jse3.normalize(jnp.asarray([0.3, -0.2, 0.1, 0.02, -0.01, 0.03, 1.0])), np.float32)
    motion = np.asarray(jse3.exp(jnp.asarray([0.2, -0.05, 0.03, 0.01, -0.02, 0.015])), np.float64)
    pts_c1 = np.stack([rng.uniform(4, 15, n), rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n)], 1)
    uv1 = np.asarray(jcam.point_to_pixel_ned(jnp.asarray(pts_c1), jnp.asarray(K)))
    pts_c2 = np.asarray(jse3.act(jse3.inv(jnp.asarray(motion)), jnp.asarray(pts_c1)))
    uv2 = np.asarray(jcam.point_to_pixel_ned(jnp.asarray(pts_c2), jnp.asarray(K)))
    sync = np.zeros((cap + 1, PACKED_SYNC_WIDTH), np.float32)

    def put(name, val):
        lo, hi = OBS_COLS[name]
        sync[:n, lo:hi] = np.asarray(val, np.float32).reshape(n, hi - lo)

    put("pixel1_uv", uv1)
    put("pixel2_uv", uv2)
    put("pixel1_d", pts_c1[:, :1])
    put("pixel2_d", pts_c2[:, :1])
    put("pixel2_disp", K[0, 0] * 0.25 / pts_c2[:, :1])
    put("pixel2_disp_cov", np.full((n, 1), 0.25))
    put("pixel2_uv_cov", np.tile([0.25, 0.25, 0.0], (n, 1)))
    put("obs1_covTc", np.tile((np.eye(3) * 0.01).ravel(), (n, 1)))
    put("obs2_covTc", np.tile((np.eye(3) * 0.01).ravel(), (n, 1)))
    sync[:n, COL_KEEP] = 1.0
    sync[n:cap, :] = np.nan
    sync[n + 1:cap:2, :] = np.inf
    sync[n:cap, COL_KEEP] = 0.0
    perturb = jse3.exp(jnp.asarray([0.08, -0.04, 0.05, 0.02, -0.01, 0.03], jnp.float64))
    sync[cap, 0:7] = np.asarray(jse3.mul(jse3.mul(jnp.asarray(anchor, jnp.float64), jnp.asarray(motion)), perturb))
    cam = np.array([K[0, 0], K[1, 1], K[0, 2], K[1, 2]], np.float32)

    ref = np.asarray(j_solve_sync(jnp.asarray(sync), jnp.asarray(anchor), jnp.asarray(cam),
                                  jnp.asarray(0.25, jnp.float32), graph_type))
    ours = solve_sync_packed(torch.from_numpy(sync), torch.from_numpy(anchor), torch.from_numpy(cam),
                             torch.tensor(0.25), graph_type).numpy()
    assert np.isfinite(ours).all()
    np.testing.assert_allclose(ours, ref, atol=1e-4)
    truth = np.asarray(jse3.mul(jnp.asarray(anchor, jnp.float64), jnp.asarray(motion)))
    err = np.linalg.norm(np.asarray(jse3.log(jse3.mul(jse3.inv(jnp.asarray(truth)), jnp.asarray(ours, jnp.float64)))))
    assert err < 1e-3


def test_motion_interpolate_matches_jax():
    """Lost-track frames repaired in motion space (f64 both sides, 1e-6 on
    the float32 pose store)."""
    from macvo_tpu.modules.map_processor import MotionInterpolate as JMotionInterpolate
    from macvo_tpu.worldmap import FRAME_FIELDS as J_FIELDS
    from macvo_tpu.worldmap import Store as JStore
    from macvo_tpu_torch.modules.map_processor import MotionInterpolate
    from macvo_tpu_torch.worldmap import FRAME_FIELDS, Store

    rng = np.random.default_rng(8)
    n = 12
    twists = np.concatenate([rng.normal(0, 0.3, (n, 3)), rng.normal(0, 0.05, (n, 3))], 1)
    poses = np.asarray(jse3.exp(jnp.asarray(twists)), np.float32)
    need = np.zeros(n, bool)
    need[[4, 5, 8]] = True
    rows = {"pose": poses, "T_BS": np.tile([0, 0, 0, 0, 0, 0, 1.0], (n, 1)).astype(np.float32),
            "need_interp": need, "time_ns": np.arange(n, dtype=np.int64), "K": np.tile(np.eye(3), (n, 1, 1)),
            "baseline": np.full(n, 0.25, np.float32)}
    ours, ref = Store(FRAME_FIELDS, 16), JStore(J_FIELDS, 16)
    ours.push(rows)
    ref.push(rows)
    fixed = MotionInterpolate(None).elaborate_map(ours)
    fixed_ref = JMotionInterpolate(None).elaborate_map(ref)
    np.testing.assert_array_equal(fixed, fixed_ref)
    np.testing.assert_allclose(ours.data["pose"][:n], ref.data["pose"][:n], atol=1e-6)
    assert not np.allclose(ours.data["pose"][:n], poses)


@pytest.mark.parametrize("enforce_positive", [False, True])
def test_flow_to_depth_matches_jax(enforce_positive):
    """Stereo flow -> depth, depth variance, disparity and mask (fp32, 1e-6 relative)."""
    from macvo_tpu.modules.frontend_network import _traced_flow_to_depth
    from macvo_tpu_torch.modules.frontend_network import flow_to_depth

    rng = np.random.default_rng(9)
    flow = rng.normal(0, 20, (1, 16, 24, 2)).astype(np.float32)
    cov = rng.uniform(0.01, 3, (1, 16, 24, 2)).astype(np.float32)
    ref = _traced_flow_to_depth(jnp.asarray(flow), jnp.asarray(cov), 0.25, 320.0, enforce_positive)
    ours = flow_to_depth(torch.from_numpy(flow), torch.from_numpy(cov), 0.25, 320.0, enforce_positive)
    for name in ("depth", "cov", "disparity", "disparity_uncertainty"):
        np.testing.assert_allclose(getattr(ours, name).numpy(), np.asarray(getattr(ref, name)), rtol=1e-6, err_msg=name)
    if enforce_positive:
        np.testing.assert_array_equal(ours.mask.numpy(), np.asarray(ref.mask))
    else:
        assert ours.mask is None and ref.mask is None
