"""Parity of the port's TartanVO baseline (macvo_tpu_torch.models.tartanvo,
modules.frontend_tartanvo, odometry.baseline_tartanvo) with the JAX package,
on the CPU, on the trained checkpoints model/TartanVO_{flow,stereo,posenet}.npz.

Both sides load the same npz (JAX through its own loader, the port through
``flax_to_torch``) and see the same inputs: crops of the real TartanAir v2
clip, or seeded numpy arrays. The JAX modules jit once per file (module
fixtures). Every tolerance is fp32 rounding of the same math summed in
another order; each test states its own.
"""

import dataclasses
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from macvo_tpu.data.datasets.tartanair import TartanAirV2 as JTartanAirV2
from macvo_tpu.models.flowformer.weights import load_params
from macvo_tpu.models.tartanvo import PWCFlowNet as JPWC
from macvo_tpu.models.tartanvo import StereoCovNet as JStereo
from macvo_tpu.models.tartanvo import VOFlowRes as JPose
from macvo_tpu.models.tartanvo import resize_bilinear as j_resize_bilinear
from macvo_tpu.models.tartanvo import warp_features as j_warp_features
from macvo_tpu.modules import frontend_tartanvo as jft
from macvo_tpu.odometry.baseline_tartanvo import TartanVO as JTartanVO
from macvo_tpu.utils.config import build_dynamic_config as j_build_config
from macvo_tpu_torch.data.datasets.tartanair import TartanAirV2
from macvo_tpu_torch.evaluation import evaluate_all
from macvo_tpu_torch.models.flowformer.weights import flax_to_torch, load_state, transposed_convs
from macvo_tpu_torch.models.tartanvo import (
    PWCFlowNet,
    StereoCovNet,
    VOFlowRes,
    normalize_image,
    resize_bilinear,
    warp_features,
)
from macvo_tpu_torch.modules import frontend_tartanvo as ft
from macvo_tpu_torch.odometry import TartanVO
from macvo_tpu_torch.utils.config import build_dynamic_config, load_config

ROOT = Path(__file__).parent.parent
ASSET = ROOT / "assets" / "test_sequence" / "TartanAir2_abs_P000"
MODEL = ROOT / "model"
CKPT = {"flow": MODEL / "TartanVO_flow.npz", "stereo": MODEL / "TartanVO_stereo.npz",
        "posenet": MODEL / "TartanVO_posenet.npz"}
NETS = {"flow": (PWCFlowNet, JPWC, [(1, 64, 64, 3)] * 2), "stereo": (StereoCovNet, JStereo, [(1, 64, 64, 3)] * 2),
        "posenet": (VOFlowRes, JPose, [(1, 112, 160, 5)])}
JAX_CPU_RECORD = {"ATE": 1.613477, "RTE": 0.360225, "ROE": 3.962729}   # JAX on the CPU, 10 frames at 640x640


def _crop(frame, y0, x0, h, w, to_backend):
    """A (h, w) crop of a frame at (y0, x0) with the principal point moved;
    ``to_backend`` turns the numpy intrinsics back into the frame's array type."""
    s = frame.stereo
    K = np.array(s.K, dtype=np.float32)
    K[:, 0, 2] -= x0
    K[:, 1, 2] -= y0
    stereo = dataclasses.replace(s, K=to_backend(K), imageL=s.imageL[:, y0:y0 + h, x0:x0 + w],
                                 imageR=s.imageR[:, y0:y0 + h, x0:x0 + w])
    return dataclasses.replace(frame, stereo=stereo)


def _center(h, w):
    return (640 - h) // 2, (640 - w) // 2


@pytest.fixture(scope="module")
def clips():
    """The first frames of the real clip, JAX's loader and the port's."""
    args = {"root": str(ASSET), "compressed": True, "gtFlow": False, "gtDepth": False, "gtPose": True}
    jseq, seq = JTartanAirV2(args), TartanAirV2(args)
    return [jseq[i] for i in range(4)], [seq[i] for i in range(4)]


def _crops(clips, h, w, n):
    y0, x0 = _center(h, w)
    jframes, frames = clips
    return ([_crop(f, y0, x0, h, w, jnp.asarray) for f in jframes[:n]],
            [_crop(f, y0, x0, h, w, lambda k: k) for f in frames[:n]])


@pytest.fixture(scope="module")
def npz():
    out = {}
    for name, path in CKPT.items():
        with np.load(path) as data:
            out[name] = {k: data[k] for k in data.files}
    return out


@pytest.fixture(scope="module")
def nets(npz):
    """name -> (port module, jitted JAX apply on its params)."""
    out = {}
    for name, (cls, jcls, probe) in NETS.items():
        model = cls().eval()
        load_state(model, flax_to_torch(npz[name], transposed_convs(model)))
        jm = jcls()
        template = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), *[jnp.zeros(s) for s in probe])["params"])
        params = load_params(CKPT[name], template)
        out[name] = (model, jax.jit(lambda *a, jm=jm, params=params: jm.apply({"params": params}, *a)))
    return out


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("name,n_keys", [("flow", 126), ("stereo", 82), ("posenet", 140)])
def test_loader_consumes_every_key_with_its_shape(npz, name, n_keys):
    model = NETS[name][0]()
    state = flax_to_torch(npz[name], transposed_convs(model))
    assert len(state) == len(npz[name]) == n_keys
    load_state(model, state)                       # raises on a missing/unused key or a shape
    assert set(model.state_dict()) == set(state)
    bad = dict(state)
    key = next(k for k in bad if k.endswith("weight") and bad[k].dim() == 4)
    bad[key] = bad[key][:1]
    with pytest.raises(ValueError):
        load_state(model, bad)


def test_transposed_conv_kernels_are_flipped(npz):
    """flax ConvTranspose kernels (no flip) become ConvTranspose2d weights
    (flipped); plain convs keep the generic rule."""
    pwc, stereo = PWCFlowNet(), StereoCovNet()
    assert transposed_convs(pwc) == {f"up{k}{lvl}" for k in ("flow", "feat") for lvl in (2, 3, 4, 5)}
    assert transposed_convs(stereo) == {f"{d}.dec{i}" for d in ("disp_decoder", "cov_decoder") for i in
                                        (0, 1, 2, 3, 4, "_full")}
    state = flax_to_torch(npz["flow"], transposed_convs(pwc))
    k = npz["flow"]["upfeat3/kernel"]
    np.testing.assert_array_equal(state["upfeat3.weight"].numpy(), k[::-1, ::-1].transpose(2, 3, 0, 1))
    np.testing.assert_array_equal(state["pyramid.conv0a.weight"].numpy(),
                                  npz["flow"]["pyramid/conv0a/kernel"].transpose(3, 2, 0, 1))


def _real_pair(clips, h, w, right=False):
    jf, f = _crops(clips, h, w, 2)
    if right:
        return [normalize_image(x.stereo.imageL) for x in f[:1]] + [normalize_image(f[0].stereo.imageR)]
    return [normalize_image(x.stereo.imageL) for x in f]


def test_pwc_matches_jax_on_a_real_pair(clips, nets):
    """PWCFlowNet at 128x192 on two frames of the clip. Output in the net's
    flow_norm units (below 0.4 here): 2e-6 absolute."""
    model, japply = nets["flow"]
    i1, i2 = _real_pair(clips, 128, 192)
    with torch.inference_mode():
        ours = model(i1, i2).numpy()
    ref = np.asarray(japply(i1.numpy(), i2.numpy()))
    assert ours.shape == ref.shape == (1, 32, 48, 2)
    np.testing.assert_allclose(ours, ref, atol=2e-6, rtol=1e-5)


def test_stereo_matches_jax_on_a_real_pair(clips, nets):
    """StereoCovNet at 128x192 on the clip's first stereo pair: disparity
    (tens of px) and its variance, 1e-5 relative."""
    model, japply = nets["stereo"]
    il, ir = _real_pair(clips, 128, 192, right=True)
    with torch.inference_mode():
        disp, cov = model(il, ir)
    jdisp, jcov = japply(il.numpy(), ir.numpy())
    assert disp.shape == cov.shape == (1, 128, 192, 1)
    np.testing.assert_allclose(disp.numpy(), np.asarray(jdisp), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(cov.numpy(), np.asarray(jcov), rtol=1e-5, atol=1e-5)


def test_posenet_matches_jax(nets):
    """VOFlowRes at 112x160 on a seeded motion stack: 1e-5."""
    model, japply = nets["posenet"]
    x = (np.random.default_rng(11).normal(size=(2, 112, 160, 5)) * 0.5).astype(np.float32)
    with torch.inference_mode():
        ours = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(ours, np.asarray(japply(x)), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("src,dst", [((100, 150), (28, 40)), ((640, 640), (112, 160)), ((25, 40), (100, 160)),
                                     ((30, 50), (45, 20))])
def test_resize_bilinear_matches_jax(src, dst):
    """Shrinking (antialiased, as jax.image.resize does), growing, and both at
    once: 1e-5 on values of order 1."""
    x = np.random.default_rng(sum(src)).normal(size=(1, *src, 3)).astype(np.float32)
    ours = resize_bilinear(torch.from_numpy(x), dst).numpy()
    np.testing.assert_allclose(ours, np.asarray(j_resize_bilinear(jnp.asarray(x), dst)), atol=1e-5, rtol=1e-5)


def test_input_helpers_match_jax():
    """crop_to_multiple, make_intrinsics_layer and normalize_image: the same
    float32 arithmetic, so 1e-6."""
    from macvo_tpu.models import tartanvo as jtv
    from macvo_tpu_torch.models.tartanvo import crop_to_multiple, make_intrinsics_layer

    x = np.random.default_rng(4).uniform(size=(1, 100, 150, 3)).astype(np.float32)
    crop = crop_to_multiple(torch.from_numpy(x))
    assert crop.shape == (1, 64, 128, 3)
    np.testing.assert_array_equal(crop.numpy(), np.asarray(jtv.crop_to_multiple(jnp.asarray(x))))
    np.testing.assert_allclose(normalize_image(crop).numpy(), np.asarray(jtv.normalize_image(jnp.asarray(crop.numpy()))),
                               rtol=1e-6, atol=1e-6)
    args = (100, 150, 320.5, 318.0, 74.2, 51.7)
    np.testing.assert_allclose(make_intrinsics_layer(*args).numpy(), np.asarray(jtv.make_intrinsics_layer(*args)),
                               rtol=1e-6, atol=1e-6)


def test_warp_features_matches_jax_across_the_border():
    """Flows of up to +-1.5 map widths: most targets leave the map through
    every side; the in-bounds mask and the zero-padded corners as in JAX."""
    rng = np.random.default_rng(3)
    feat = rng.normal(size=(2, 12, 17, 5)).astype(np.float32)
    flow = (rng.uniform(-1.5, 1.5, size=(2, 12, 17, 2)) * np.array([17, 12])).astype(np.float32)
    flow[0, 0, 0] = [-0.25, 0.0]                      # just outside the left edge
    flow[0, 3, 16] = [0.0, 0.0]                       # on the right edge
    ref = np.asarray(j_warp_features(jnp.asarray(feat), jnp.asarray(flow)))
    ours = warp_features(torch.from_numpy(feat).permute(0, 3, 1, 2), torch.from_numpy(flow).permute(0, 3, 1, 2))
    ours = ours.permute(0, 2, 3, 1).numpy()
    assert (ref == 0).all(-1).mean() > 0.3 and (ref != 0).any(-1).mean() > 0.1
    np.testing.assert_allclose(ours, ref, atol=1e-6, rtol=1e-6)


@pytest.fixture(scope="module")
def modules():
    """(JAX, port) TartanVO modules on the shipped checkpoints."""
    def cfg(name, **kw):
        return SimpleNamespace(weight=str(CKPT[name]), **kw)

    jmods = (jft.TartanVOMatcher(cfg("flow")), jft.TartanVODepth(cfg("stereo", cov_mode="Est")),
             jft.TartanMotionNet(cfg("posenet")))
    mods = (ft.TartanVOMatcher(cfg("flow"), device="cpu"), ft.TartanVODepth(cfg("stereo", cov_mode="Est"), "cpu"),
            ft.TartanMotionNet(cfg("posenet"), device="cpu"))
    return jmods, mods


def _assert_same_nan_and_close(ours, ref, rtol, atol):
    ours, ref = ours.numpy(), np.asarray(ref)
    assert ours.shape == ref.shape
    np.testing.assert_array_equal(np.isnan(ours), np.isnan(ref))
    np.testing.assert_allclose(ours, ref, rtol=rtol, atol=atol)


def test_modules_match_jax_off_multiple_of_64(clips, modules):
    """The three modules on a 100x150 crop, which crops to 64x128 inside with
    margins of 18 rows and 11 columns: NaN positions and masks exactly equal;
    flow (a few px) 1e-5; depth, disparity and their variances, which span
    three decades, 2e-5 relative; the chained pose 1e-5."""
    (jm, jd, jp), (m, d, p) = modules
    (j0, j1), (f0, f1) = _crops(clips, 100, 150, 2)
    jmatch, match = jm.estimate(j0.stereo, j1.stereo), m.estimate(f0.stereo, f1.stereo)
    np.testing.assert_array_equal(match.mask.numpy(), np.asarray(jmatch.mask))
    assert match.mask.sum() == 64 * 128 and np.isnan(match.flow.numpy()).any()
    _assert_same_nan_and_close(match.flow, jmatch.flow, rtol=1e-5, atol=1e-5)

    jdepth, depth = jd.estimate(j1.stereo), d.estimate(f1.stereo)
    np.testing.assert_array_equal(depth.mask.numpy(), np.asarray(jdepth.mask))
    for field in ("depth", "cov", "disparity", "disparity_uncertainty"):
        _assert_same_nan_and_close(getattr(depth, field), getattr(jdepth, field), rtol=2e-5, atol=1e-6)

    for net in (jp, p):
        net.prev_pose = None
    np.testing.assert_array_equal(p.predict(f0, None, None).numpy(), np.asarray(jp.predict(j0, None, None)))
    stack = p.motion_input(f1, match.flow, depth.depth)
    assert stack.shape == (1, 112, 160, 5) and torch.isfinite(stack).all()
    pose = p.predict(f1, match.flow, depth.depth)
    jpose = jp.predict(j1, jmatch.flow, jdepth.depth)
    np.testing.assert_allclose(pose.numpy(), np.asarray(jpose), atol=1e-5, rtol=1e-5)


def _baseline_cfg():
    return {"Odometry": {
        "type": "TartanVO", "name": "TartanVO-Baseline",
        "match": {"type": "TartanVOMatcher", "args": {"weight": str(CKPT["flow"])}},
        "depth": {"type": "TartanVODepth", "args": {"weight": str(CKPT["stereo"]), "cov_mode": "Est"}},
        "keyframe": {"type": "AllKeyframe", "args": {}},
        "tartanvo": {"type": "TartanMotionNet", "args": {"weight": str(CKPT["posenet"])}},
    }}


def test_baseline_odometry_matches_jax_on_a_crop(clips):
    """The TartanVO odometry, JAX against the port, on 4 frames of a 128x192
    crop of the real clip: every pose element within 1e-4 (translation in m,
    quaternion)."""
    jframes, frames = _crops(clips, 128, 192, 4)
    jodom = JTartanVO.from_config(j_build_config(_baseline_cfg())[0])
    jodom.receive_frames(jframes)
    odom = TartanVO.from_config(build_dynamic_config(_baseline_cfg())[0], device="cpu")
    odom.receive_frames(frames)
    ref = np.asarray(jodom.graph.frames.data["pose"][:4])
    ours = odom.graph.frames.data["pose"][:4]
    assert len(odom.graph.frames) == 4 and not odom.graph.frames.data["need_interp"][:4].any()
    assert np.linalg.norm(ours[-1, :3] - ours[0, :3]) > 0.01     # it moves
    np.testing.assert_allclose(ours, ref, atol=1e-4, rtol=0)


def test_runner_needs_a_card_unless_asked_for_the_cpu(tmp_path, monkeypatch):
    """``python -m macvo_tpu_torch`` with the shipped TartanVO config: cuda by
    default (raises here, before loading anything), and on ``--device cpu``
    the baseline runs (first 2 frames) and writes its poses."""
    from macvo_tpu_torch.__main__ import main as run_main

    monkeypatch.chdir(ROOT)                        # the config names its checkpoints from the repo root
    argv = ["--odom", str(ROOT / "configs/experiment/baseline/TartanVO.yaml"),
            "--data", str(ROOT / "configs/sequence/TartanAirv2_RealAsset.yaml"), "--seq_to", "2",
            "--resultRoot", str(tmp_path / "results")]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            run_main(argv)
    run_main(argv + ["--device", "cpu"])
    (run,) = (tmp_path / "results").iterdir()       # <resultRoot>/<name>/<stamp>
    assert run.name == "TartanVO-Baseline"
    (out,) = run.iterdir()
    poses = np.load(out / "poses.npy")
    assert poses.shape == (2, 8) and np.isfinite(poses).all()


@pytest.mark.slow
def test_baseline_full_width_cpu_matches_the_jax_record():
    """The shipped config on the whole 10-frame clip at 640x640, on the CPU:
    ATE / RTE / ROE within 0.5 % of the JAX CPU record."""
    cfg = load_config(ROOT / "configs/experiment/baseline/TartanVO.yaml")[0]
    cfg.Odometry.match.args.weight = str(CKPT["flow"])
    cfg.Odometry.depth.args.weight = str(CKPT["stereo"])
    cfg.Odometry.tartanvo.args.weight = str(CKPT["posenet"])
    seq = TartanAirV2({"root": str(ASSET), "compressed": True, "gtFlow": False, "gtDepth": False, "gtPose": True})
    odom = TartanVO.from_config(cfg, device="cpu")
    odom.receive_frames(seq)
    est = odom.graph.frames.data["pose"][:10].astype(np.float64)
    gt = np.stack([np.asarray(seq[i].gt_pose[0]) for i in range(10)]).astype(np.float64)
    m = evaluate_all(gt, est)
    for key, ref in JAX_CPU_RECORD.items():
        assert abs(m[key].rmse - ref) <= 0.005 * ref, (key, m[key].rmse, ref)


# -- RAFTFlowCovNet, TartanVOCovMatcher and the random: weights option (PWC + RAFT-style covariance) --------

FLOWCOV = MODEL / "TartanVO_flowcov.npz"


def _flax_flat(params):
    from flax.traverse_util import flatten_dict

    return {"/".join(k): np.asarray(v) for k, v in flatten_dict(params).items()}


def _flax_init(jcls, probe, seed=0):
    jm = jcls()
    return jm, jax.jit(jm.init)(jax.random.PRNGKey(seed), *[jnp.zeros(s) for s in probe])["params"]


@pytest.mark.parametrize("name", ["flow", "stereo", "posenet", "flowcov"])
def test_random_weights_are_seeded_with_the_flax_shapes(name):
    """``random_state``: the same seed gives the same weights, another seed
    others, the global torch RNG is untouched, and every tensor has the shape
    of the flax init (its abstract evaluation) carried across by the port's
    weight functions, which check every key and shape."""
    from macvo_tpu.models.tartanvo import RAFTFlowCovNet as JRAFT
    from macvo_tpu_torch.models.flowformer.weights import random_state
    from macvo_tpu_torch.models.tartanvo import RAFTFlowCovNet

    cls, jcls, probe = {**NETS, "flowcov": (RAFTFlowCovNet, JRAFT, [(1, 64, 64, 3)] * 2)}[name]
    model = cls()
    jm = jcls()
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), *[jnp.zeros(s) for s in probe])["params"])
    params = jax.tree_util.tree_map(lambda x: np.zeros(x.shape, x.dtype), shapes)
    carried = flax_to_torch(_flax_flat(params), transposed_convs(model))
    load_state(model, carried)
    rng_before = torch.get_rng_state()
    a, b, c = random_state(model, 0), random_state(model, 0), random_state(model, 1)
    assert torch.equal(torch.get_rng_state(), rng_before)
    assert set(a) == set(carried)
    for key, value in carried.items():
        assert a[key].shape == value.shape and a[key].dtype == torch.float32
        assert torch.equal(a[key], b[key])
    kernels = [k for k in a if k.endswith("weight") and a[k].dim() == 4]
    assert all(not torch.equal(a[k], c[k]) for k in kernels)
    assert all(float(a[k].std()) > 0 for k in kernels)
    load_state(model, a)


def test_random_weight_option_of_the_tartanvo_host(monkeypatch):
    """``weight: random`` is seed 0 and ``random:<n>`` seed n; the host warns
    as the JAX host does; the same seed gives the same network."""
    from macvo_tpu_torch.models.flowformer.weights import random_seed

    assert (random_seed("random"), random_seed("random:7"), random_seed(str(CKPT["flow"]))) == (0, 7, None)
    warned = []
    monkeypatch.setattr(ft.Logger, "warning", lambda msg: warned.append(msg))
    a = ft.TartanVOMatcher(SimpleNamespace(weight="random"), device="cpu")
    b = ft.TartanVOMatcher(SimpleNamespace(weight="random:0"), device="cpu")
    c = ft.TartanVOCovMatcher(SimpleNamespace(weight="random:1"), device="cpu")
    assert len(warned) == 3 and "RANDOM weights (random)" in warned[0] and "PWCFlowNet" in warned[0]
    assert "RAFTFlowCovNet" in warned[2]
    for (k, va), vb in zip(a.net.state_dict().items(), b.net.state_dict().values()):
        assert torch.equal(va, vb), k
    assert not torch.equal(a.net.state_dict()["pyramid.conv0a.weight"], c.net.pwc.state_dict()["pyramid.conv0a.weight"])


def _raft_pair(jm, params, model, i1, i2):
    with torch.inference_mode():
        flow, covs = model(torch.as_tensor(i1), torch.as_tensor(i2))
    jflow, jcovs = jax.jit(lambda a, b: jm.apply({"params": params}, a, b))(jnp.asarray(i1), jnp.asarray(i2))
    return flow.numpy(), covs.numpy(), np.asarray(jflow), np.asarray(jcovs)


def test_raftcov_matches_jax_on_a_flax_init():
    """RAFTFlowCovNet at 64x64 on seeded images with a flax init carried
    across: the flow and all 4 log-sigma maps within PWCFlowNet's tolerance
    (2e-6 absolute, 1e-5 relative)."""
    from macvo_tpu.models.tartanvo import RAFTFlowCovNet as JRAFT
    from macvo_tpu_torch.models.tartanvo import RAFTFlowCovNet

    jm, params = _flax_init(JRAFT, [(1, 64, 64, 3)] * 2, seed=3)
    model = RAFTFlowCovNet().eval()
    load_state(model, flax_to_torch(_flax_flat(params), transposed_convs(model)))
    rng = np.random.default_rng(5)
    i1, i2 = (rng.normal(size=(2, 64, 64, 3)).astype(np.float32) for _ in range(2))
    flow, covs, jflow, jcovs = _raft_pair(jm, params, model, i1, i2)
    assert flow.shape == (2, 16, 16, 2) and covs.shape == jcovs.shape == (4, 2, 16, 16, 2)
    assert np.abs(jcovs).max() > 1e-3
    np.testing.assert_allclose(flow, jflow, atol=2e-6, rtol=1e-5)
    np.testing.assert_allclose(covs, jcovs, atol=2e-6, rtol=1e-5)


@pytest.fixture(scope="module")
def raft_real():
    """(JAX module, params, port module) on model/TartanVO_flowcov.npz."""
    from macvo_tpu.models.tartanvo import RAFTFlowCovNet as JRAFT
    from macvo_tpu_torch.models.tartanvo import RAFTFlowCovNet

    jm = JRAFT()
    template = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)),
                                              jnp.zeros((1, 64, 64, 3)))["params"])
    params = load_params(FLOWCOV, template)
    model = RAFTFlowCovNet().eval()
    with np.load(FLOWCOV) as data:
        load_state(model, flax_to_torch({k: data[k] for k in data.files}, transposed_convs(model)))
    return jm, params, model


def test_raftcov_matches_jax_on_the_checkpoint(clips, raft_real):
    """RAFTFlowCovNet with the trained checkpoint (220 arrays) on a 128x192
    crop of the clip: flow and the 4 log-sigma maps, PWCFlowNet's tolerance."""
    jm, params, model = raft_real
    i1, i2 = (x.numpy() for x in _real_pair(clips, 128, 192))
    flow, covs, jflow, jcovs = _raft_pair(jm, params, model, i1, i2)
    assert covs.shape == (4, 1, 32, 48, 2)
    np.testing.assert_allclose(flow, jflow, atol=2e-6, rtol=1e-5)
    np.testing.assert_allclose(covs, jcovs, atol=2e-6, rtol=1e-5)


@pytest.mark.slow
def test_raftcov_full_width_matches_jax_on_the_checkpoint(clips, raft_real):
    """The same at the clip's full 640x640 (the shape the card runs)."""
    jm, params, model = raft_real
    (_, _), (f0, f1) = _crops(clips, 640, 640, 2)
    i1, i2 = normalize_image(f0.stereo.imageL).numpy(), normalize_image(f1.stereo.imageL).numpy()
    flow, covs, jflow, jcovs = _raft_pair(jm, params, model, i1, i2)
    np.testing.assert_allclose(flow, jflow, atol=2e-6, rtol=1e-5)
    np.testing.assert_allclose(covs, jcovs, atol=2e-6, rtol=1e-5)


def test_cov_matcher_matches_jax_off_multiple_of_64(clips):
    """TartanVOCovMatcher on the checkpoint at a 100x150 crop (crops to 64x128
    inside, margins 18 and 11): mask and NaN positions exactly equal; flow 1e-5;
    the covariance (variances exp(2 log_sigma), not rescaled by FLOW_NORM) 2e-5
    relative; sigma_uv is 0."""
    jm = jft.TartanVOCovMatcher(SimpleNamespace(weight=str(FLOWCOV)))
    m = ft.TartanVOCovMatcher(SimpleNamespace(weight=str(FLOWCOV)), device="cpu")
    assert m.provide_cov
    (j0, j1), (f0, f1) = _crops(clips, 100, 150, 2)
    jout, out = jm.estimate(j0.stereo, j1.stereo), m.estimate(f0.stereo, f1.stereo)
    np.testing.assert_array_equal(out.mask.numpy(), np.asarray(jout.mask))
    assert out.mask.sum() == 64 * 128 and out.cov.shape == (1, 100, 150, 3)
    _assert_same_nan_and_close(out.flow, jout.flow, rtol=1e-5, atol=1e-5)
    _assert_same_nan_and_close(out.cov, jout.cov, rtol=2e-5, atol=1e-7)
    inside = out.mask[..., 0]
    assert (out.cov[..., 2][inside] == 0).all() and (out.cov[..., :2][inside] > 0).all()
