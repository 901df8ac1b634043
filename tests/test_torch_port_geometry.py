"""Parity of the port's geometry (macvo_tpu_torch.geometry) with the JAX package.

Inputs are seeded numpy arrays in float64 fed to both sides; the JAX suite
runs with x64 on, so both compute in f64 and the tolerance is 1e-9: the two
evaluate the same closed forms, only the operation order of a few fused
expressions differs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from macvo_tpu.geometry import camera as jcam
from macvo_tpu.geometry import gaussian as jgauss
from macvo_tpu.geometry import se3 as jse3
from macvo_tpu_torch.geometry import camera as tcam
from macvo_tpu_torch.geometry import gaussian as tgauss
from macvo_tpu_torch.geometry import se3 as tse3

TOL = 1e-9


def _poses(rng, n):
    q = Rotation.random(n, random_state=rng).as_quat()
    return np.concatenate([rng.normal(size=(n, 3)), q], axis=-1)


def _close(t, j, tol=TOL):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=tol, rtol=tol)


@pytest.mark.parametrize("fn", ["exp", "log_of_exp", "mul", "inv", "act", "rotmat", "normalize"])
def test_se3_matches_jax(fn, rng):
    a, b = _poses(rng, 16), _poses(rng, 16)
    tw = rng.normal(scale=0.7, size=(16, 6))
    tw[:3] *= 1e-8   # small-angle branches
    pts = rng.normal(size=(16, 3))
    ta, tb, ttw, tp = (torch.from_numpy(x) for x in (a, b, tw, pts))
    if fn == "exp":
        _close(tse3.exp(ttw), jse3.exp(jnp.asarray(tw)))
    elif fn == "log_of_exp":
        _close(tse3.log(tse3.exp(ttw)), jse3.log(jse3.exp(jnp.asarray(tw))))
    elif fn == "mul":
        _close(tse3.mul(ta, tb), jse3.mul(jnp.asarray(a), jnp.asarray(b)))
    elif fn == "inv":
        _close(tse3.inv(ta), jse3.inv(jnp.asarray(a)))
    elif fn == "act":
        _close(tse3.act(ta, tp), jse3.act(jnp.asarray(a), jnp.asarray(pts)))
    elif fn == "rotmat":
        _close(tse3.rotmat(ta), jse3.rotmat(jnp.asarray(a)))
    else:
        _close(tse3.normalize(ta * 1.3), jse3.normalize(jnp.asarray(a * 1.3)))


def test_camera_matches_jax(rng):
    K = np.array([[320.0, 0, 320], [0, 310.0, 240], [0, 0, 1]])
    uv = rng.uniform(0, 640, size=(32, 2))
    d = rng.uniform(0.5, 30, size=(32,))
    tK, tuv, td = torch.from_numpy(K), torch.from_numpy(uv), torch.from_numpy(d)
    pts = tcam.pixel_to_point_ned(tuv, td, tK)
    _close(pts, jcam.pixel_to_point_ned(jnp.asarray(uv), jnp.asarray(d), jnp.asarray(K)))
    _close(tcam.point_to_pixel_ned(pts, tK), jcam.point_to_pixel_ned(jnp.asarray(pts.numpy()), jnp.asarray(K)))
    np.testing.assert_array_equal(tcam.in_bounds(tuv, 640, 480, 32).numpy(),
                                  np.asarray(jcam.in_bounds(jnp.asarray(uv), 640, 480, 32)))
    disp = rng.uniform(0.0, 40, size=(8, 8, 1))
    dcov = rng.uniform(0.01, 2, size=(8, 8, 1))
    _close(tcam.disparity_to_depth(torch.from_numpy(disp), 0.25, 320.0),
           jcam.disparity_to_depth(jnp.asarray(disp), 0.25, 320.0))
    _close(tcam.disparity_to_depth_cov(torch.from_numpy(disp), torch.from_numpy(dcov), 0.25, 320.0),
           jcam.disparity_to_depth_cov(jnp.asarray(disp), jnp.asarray(dcov), 0.25, 320.0), tol=1e-7)


def test_gaussian_kernels_match_jax(rng):
    a = rng.uniform(0.1, 20, size=(12,))
    c = rng.uniform(0.1, 20, size=(12,))
    b = rng.uniform(-0.9, 0.9, size=(12,)) * np.sqrt(a * c)
    cov = np.stack([np.stack([a, b], -1), np.stack([b, c], -1)], -2)
    ours = tgauss.gaussian_full_kernels(torch.from_numpy(cov), 31)
    ref = jgauss.gaussian_full_kernels(jnp.asarray(cov), 31)
    _close(ours, ref)
    np.testing.assert_allclose(ours.sum(dim=(-1, -2)).numpy(), 1.0, atol=1e-12)


def test_matrix_forms_and_relative_match_jax():
    """se3.matrix / from_matrix / quat_from_matrix / relative: each of
    Shepperd's four branches is reached (rotations near 0 and near pi about
    x, y and z), the same closed forms to 1e-9."""
    rng = np.random.default_rng(5)
    p = _poses(rng, 16)
    flips = Rotation.from_rotvec(np.array([[3.1, 0.0, 0.0], [0.0, 3.1, 0.0], [0.0, 0.0, 3.1], [0.0, 0.0, 0.0]]))
    p[:4, 3:] = flips.as_quat()
    _close(tse3.matrix(torch.from_numpy(p)), jse3.matrix(jnp.asarray(p)))
    m = np.asarray(jse3.matrix(jnp.asarray(p)))
    _close(tse3.quat_from_matrix(torch.from_numpy(m[:, :3, :3])), jse3.quat_from_matrix(jnp.asarray(m[:, :3, :3])))
    _close(tse3.from_matrix(torch.from_numpy(m)), jse3.from_matrix(jnp.asarray(m)))
    a, b = _poses(rng, 8), _poses(rng, 8)
    _close(tse3.relative(torch.from_numpy(a), torch.from_numpy(b)), jse3.relative(jnp.asarray(a), jnp.asarray(b)))


def test_mahalanobis_and_intrinsics_match_jax():
    rng = np.random.default_rng(6)
    x, mu = rng.normal(size=(20, 3)), rng.normal(size=(20, 3))
    a = rng.normal(size=(20, 3, 3))
    sigma = a @ a.transpose(0, 2, 1) + 0.5 * np.eye(3)
    _close(tgauss.mahalanobis(torch.from_numpy(x), torch.from_numpy(mu), torch.from_numpy(sigma)),
           jgauss.mahalanobis(jnp.asarray(x), jnp.asarray(mu), jnp.asarray(sigma)))
    inv = np.linalg.inv(sigma)
    _close(tgauss.mahalanobis_inv(torch.from_numpy(x), torch.from_numpy(mu), torch.from_numpy(inv)),
           jgauss.mahalanobis_inv(jnp.asarray(x), jnp.asarray(mu), jnp.asarray(inv)))
    np.testing.assert_array_equal(tcam.intrinsics(320.0, 310.0, 160.0, 120.0).numpy(),
                                  np.asarray(jcam.intrinsics(320.0, 310.0, 160.0, 120.0)))


def test_min_pool_and_score_topk_match_jax():
    """ops.select.min_pool2d and masked_score_topk: the same pool, and the
    same top-K positions and validity (distinct scores, fewer masked
    positions than K so the tail is invalid)."""
    from macvo_tpu.ops import select as jselect
    from macvo_tpu_torch.ops import select

    rng = np.random.default_rng(7)
    x = rng.normal(size=(12, 17)).astype(np.float32)
    np.testing.assert_array_equal(select.min_pool2d(torch.from_numpy(x), 5).numpy(),
                                  np.asarray(jselect.min_pool2d(jnp.asarray(x), 5)))
    score = x.copy()
    score[3, 4] = np.nan
    mask = rng.random((12, 17)) < 0.1
    k = int(mask.sum()) + 3
    uv, valid = select.masked_score_topk(torch.from_numpy(score), torch.from_numpy(mask), k)
    juv, jvalid = jselect.masked_score_topk(jnp.asarray(score), jnp.asarray(mask), k)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    np.testing.assert_array_equal(uv.numpy()[valid.numpy()], np.asarray(juv)[np.asarray(jvalid)])
    assert valid.sum() == int((mask & ~np.isnan(score)).sum())
