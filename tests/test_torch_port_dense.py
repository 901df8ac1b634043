"""The port's dense matchers and depths (FlowFormerMatcher, FlowFormerCovMatcher,
FlowFormerDepth, FlowFormerCovDepth), the ApplyGT modifiers, the random:
weights option of the FlowFormer host and ``evaluation/dense.py``, against the
JAX package on the CPU.

The FlowFormer modules run the shipped checkpoint in fp32 with 2 decoder steps
on a 64x96 crop of the real clip (the fp32 frontend tolerance of the network
tests, 1e-4 absolute and relative). The dense evaluation is held to JAX's on
the same module outputs (stub modules that return fixed arrays with NaN
margins and masks): 1e-6 relative.
"""

import dataclasses
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from macvo_tpu.data import frame as jframe
from macvo_tpu.evaluation import dense as jdense
from macvo_tpu.modules import frontend as jfrontend
from macvo_tpu.modules import frontend_network as jfn
from macvo_tpu_torch.data.datasets.tartanair import TartanAirV2
from macvo_tpu_torch.evaluation import dense
from macvo_tpu_torch.modules import frontend, frontend_network as fn
from macvo_tpu_torch.utils.config import build_dynamic_config

ROOT = Path(__file__).parent.parent
CKPT = ROOT / "model/MACVO_FrontendCov.npz"
CLIP = {"root": str(ROOT / "assets/test_sequence/TartanAir2_abs_P000"), "compressed": True,
        "gtFlow": True, "gtDepth": True, "gtPose": True}
H, W, Y0, X0 = 64, 96, 290, 270
FF_ARGS = {"weight": str(CKPT), "enc_dtype": "fp32", "dec_dtype": "fp32", "decoder_depth": 2,
           "enforce_positive_disparity": True}


@pytest.fixture(scope="module")
def frames():
    """Frames 0..2 of the clip, a 64x96 window with its ground truth, as
    (port StereoFrame-likes, JAX StereoFrame-likes) holding the same arrays."""
    seq = TartanAirV2(CLIP)
    ours, ref = [], []
    for i in range(3):
        s = seq[i].stereo
        crop = {k: getattr(s, k)[:, Y0:Y0 + H, X0:X0 + W].contiguous()
                for k in ("imageL", "imageR", "gt_flow", "flow_mask", "gt_depth")}
        crop["flow_mask"] = crop["flow_mask"] > 0.5
        K = s.K.copy()
        K[:, 0, 2] -= X0
        K[:, 1, 2] -= Y0
        ours.append(SimpleNamespace(stereo=dataclasses.replace(s, K=K, **crop)))
        ref.append(SimpleNamespace(stereo=jframe.StereoData(
            T_BS=s.T_BS, K=K, baseline=s.baseline, time_ns=s.time_ns,
            **{k: jnp.asarray(v.numpy()) for k, v in crop.items()})))
    return ours, ref


def _close(ours, ref, atol=1e-4, rtol=1e-4, what=""):
    ours, ref = ours.numpy(), np.asarray(ref)
    assert ours.shape == ref.shape, (what, ours.shape, ref.shape)
    np.testing.assert_array_equal(np.isnan(ours), np.isnan(ref), err_msg=what)
    np.testing.assert_allclose(ours, ref, atol=atol, rtol=rtol, err_msg=what)


@pytest.fixture(scope="module")
def ff_modules():
    """{name: (port module, JAX module)} for the four FlowFormer modules; each
    side's modules share one runner (one model load, one JAX compile)."""
    cfg = build_dynamic_config(FF_ARGS)[0]
    names = ("FlowFormerMatcher", "FlowFormerCovMatcher", "FlowFormerDepth", "FlowFormerCovDepth")
    out = {name: (getattr(fn, name)(cfg, device="cpu"), getattr(jfn, name)(cfg)) for name in names}
    for i in (0, 1):
        for pair in out.values():
            pair[i].runner = out[names[0]][i].runner
    return out


def test_flowformer_matchers_match_jax(frames, ff_modules):
    """FlowFormerMatcher and FlowFormerCovMatcher on a pair: flow (and the
    covariance, sigma_uv 0) within the fp32 tolerance; the plain matcher's
    flow equals the cov matcher's bit for bit."""
    (f0, f1, _), (j0, j1, _) = frames
    m, jm = ff_modules["FlowFormerMatcher"]
    cm, jcm = ff_modules["FlowFormerCovMatcher"]
    assert (m.provide_cov, cm.provide_cov) == (False, True)
    out, cout = m.estimate(f0.stereo, f1.stereo), cm.estimate(f0.stereo, f1.stereo)
    jout, jcout = jm.estimate(j0.stereo, j1.stereo), jcm.estimate(j0.stereo, j1.stereo)
    assert out.cov is None and out.mask is None and out.flow.shape == (1, H, W, 2)
    _close(out.flow, jout.flow, what="flow")
    _close(cout.flow, jcout.flow, what="cov matcher flow")
    _close(cout.cov, jcout.cov, what="cov")
    assert torch.equal(out.flow, cout.flow) and (cout.cov[..., 2] == 0).all()


def test_flowformer_depths_match_jax(frames, ff_modules):
    """FlowFormerDepth and FlowFormerCovDepth (enforce_positive_disparity) on
    a stereo frame: depth, disparity, their variances and the positive-flow
    mask; the two give the same depth."""
    (f0, _, _), (j0, _, _) = frames
    d, jd = ff_modules["FlowFormerDepth"]
    cd, jcd = ff_modules["FlowFormerCovDepth"]
    assert (d.provide_cov, cd.provide_cov) == (False, True)
    out, jout = d.estimate(f0.stereo), jd.estimate(j0.stereo)
    cout, jcout = cd.estimate(f0.stereo), jcd.estimate(j0.stereo)
    assert out.cov is None and out.mask is None
    for field in ("depth", "disparity"):
        _close(getattr(out, field), getattr(jout, field), what=field)
    for field in ("depth", "cov", "disparity", "disparity_uncertainty"):
        _close(getattr(cout, field), getattr(jcout, field), rtol=2e-4, what=f"cov depth {field}")
    np.testing.assert_array_equal(cout.mask.numpy(), np.asarray(jcout.mask))
    assert torch.equal(out.depth, cout.depth)


def test_flowformer_configs_are_checked_as_jax_checks_them():
    """``matmul_precision`` is taken and checked; FlowFormerCovDepth asks only
    for ``weight``, as the JAX module does (its last ``is_valid_config``)."""
    ok = {"weight": "w.npz", "matmul_precision": "highest"}
    for name in ("FlowFormerMatcher", "FlowFormerCovMatcher", "FlowFormerDepth", "FlowFormerCovDepth"):
        for args in (ok, {"weight": "w.npz"}, {"weight": "w.npz", "enforce_positive_disparity": "yes"}):
            cfg = build_dynamic_config({"type": name, "args": args})[0]
            frontend.IMatcher.is_valid_config(cfg) if "Matcher" in name else frontend.IStereoDepth.is_valid_config(cfg)
            getattr(jfn, name).is_valid_config(cfg.args)
        for bad in ({}, {"weight": 3}, {"weight": "w.npz", "matmul_precision": "fast"}):
            with pytest.raises(ValueError):
                getattr(fn, name).is_valid_config(build_dynamic_config(bad)[0] if bad else SimpleNamespace())


def test_flowformer_compose_matches_jax(frames):
    """FrontendCompose(FlowFormerCovDepth, FlowFormerCovMatcher) on a pair,
    built from one config on each side: depth of t2 and the match t1->t2."""
    cfg = build_dynamic_config({"depth": {"type": "FlowFormerCovDepth", "args": FF_ARGS},
                                "match": {"type": "FlowFormerCovMatcher", "args": FF_ARGS}})[0]
    (f0, f1, _), (j0, j1, _) = frames
    ours = frontend.FrontendCompose(cfg, device="cpu")
    ref = jfrontend.FrontendCompose(cfg)
    assert ours.provide_cov == tuple(ref.provide_cov) == (True, True)
    (depth, match), (jdepth, jmatch) = ours.estimate_pair(f0.stereo, f1.stereo), ref.estimate_pair(j0.stereo, j1.stereo)
    for field in ("depth", "cov", "disparity"):
        _close(getattr(depth, field), getattr(jdepth, field), rtol=2e-4, what=field)
    _close(match.flow, jmatch.flow, what="flow")
    _close(match.cov, jmatch.cov, what="flow cov")


def _modifier(kind, inner):
    return build_dynamic_config({"type": kind, "args": {"module": inner}})[0]


@pytest.mark.parametrize("kind,inner", [
    ("ApplyGTDepthCov", {"type": "GTDepth", "args": {}}),
    ("ApplyGTMatchCov", {"type": "GTMatcher", "args": {}}),
    ("ApplyGTMatchMask", {"type": "GTMatcher", "args": {}}),
    ("ApplyGTMatchCov", {"type": "FlowFormerMatcher", "args": FF_ARGS}),
    ("ApplyGTMatchMask", {"type": "FlowFormerMatcher", "args": FF_ARGS}),
])
def test_apply_gt_modifiers_match_jax(frames, kind, inner):
    """Each modifier around an oracle and around a small FlowFormerMatcher:
    the outputs of the JAX modifier (exact around an oracle; the fp32
    tolerance around the network), and a frame without the ground truth it
    reads raises."""
    (f0, f1, _), (j0, j1, _) = frames
    cfg = _modifier(kind, inner)
    iface = frontend.IStereoDepth if kind == "ApplyGTDepthCov" else frontend.IMatcher
    jiface = jfrontend.IStereoDepth if kind == "ApplyGTDepthCov" else jfrontend.IMatcher
    iface.is_valid_config(cfg)
    ours = iface.instantiate(kind, cfg.args, device="cpu")
    ref = jiface.instantiate(kind, cfg.args)
    assert ours.provide_cov == ref.provide_cov
    tol = {"atol": 0, "rtol": 0} if inner["type"].startswith("GT") else {}
    if kind == "ApplyGTDepthCov":
        out, jout = ours.estimate(f0.stereo), ref.estimate(j0.stereo)
        fields = ("depth", "cov")
        missing = "gt_depth"
    else:
        out, jout = ours.estimate(f0.stereo, f1.stereo), ref.estimate(j0.stereo, j1.stereo)
        fields = ("flow", "cov", "mask")
        missing = "gt_flow" if kind == "ApplyGTMatchCov" else "flow_mask"
    for field in fields:
        a, b = getattr(out, field), getattr(jout, field)
        assert (a is None) == (b is None), field
        if a is not None:
            _close(a.float(), np.asarray(b, np.float32), what=field, **tol)
    bare = dataclasses.replace(f0.stereo, **{missing: None})
    with pytest.raises(ValueError, match=kind):
        ours.estimate(bare) if kind == "ApplyGTDepthCov" else ours.estimate(bare, f1.stereo)


def test_flowformer_random_weights_are_seeded_with_the_flax_shapes():
    """``weight: random[:seed]`` on the FlowFormer host: every tensor has the
    shape of the flax init (abstract evaluation, carried across by the port's
    weight functions), one seed gives one network, another seed another, and
    the global torch RNG is untouched."""
    from macvo_tpu.models.flowformer import FlowFormerConfig as JConfig
    from macvo_tpu.models.flowformer import FlowFormerCov as JModel
    from flax.traverse_util import flatten_dict
    from macvo_tpu_torch.models.flowformer import FlowFormerConfig, FlowFormerCov
    from macvo_tpu_torch.models.flowformer.weights import flax_to_torch, load_state, transposed_convs

    jm = JModel(JConfig(decoder_depth=2, inference_only=True))
    probe = jnp.zeros((1, 64, 64, 3))
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), probe, probe)["params"])
    flat = {"/".join(k): np.zeros(v.shape, np.float32) for k, v in flatten_dict(shapes).items()}
    rng_before = torch.get_rng_state()
    runners = [fn._FlowFormerRunner(build_dynamic_config({**FF_ARGS, "weight": w})[0], torch.device("cpu"))
               for w in ("random", "random:0", "random:1")]
    assert torch.equal(torch.get_rng_state(), rng_before)
    a, b, c = (r.model.state_dict() for r in runners)
    model = FlowFormerCov(FlowFormerConfig(decoder_depth=2))
    carried = flax_to_torch(flat, transposed_convs(model))
    load_state(model, carried)                                  # every key and shape checked
    assert set(a) == set(carried) and all(a[k].shape == v.shape for k, v in carried.items())
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["memory_encoder.perceiver.latents"], c["memory_encoder.perceiver.latents"])
    img = torch.rand(1, 64, 64, 3, generator=torch.Generator().manual_seed(2))
    with torch.inference_mode():
        flow, cov = runners[1].inference(img, img.flip(2))
    assert flow.shape == (1, 64, 64, 2) and torch.isfinite(flow).all() and torch.isfinite(cov).all()


# -- evaluation/dense.py on stub outputs -----------------------------------------------------------------------

class _Stub:
    """A module returning fixed outputs, in turn, built for either package."""

    def __init__(self, outputs):
        self.outputs = list(outputs)

    def estimate(self, *frames):
        return self.outputs.pop(0)


def _stub_outputs(frames, seed):
    """Per-frame (flow, cov, depth, depth_cov) near the ground truth, with a
    NaN margin, a few non-finite entries and zero variances."""
    rng = np.random.default_rng(seed)
    out = []
    for f in frames:
        s = f.stereo
        flow = s.gt_flow.numpy() + rng.normal(scale=1.5, size=(1, H, W, 2)).astype(np.float32)
        cov = np.exp(rng.normal(size=(1, H, W, 3))).astype(np.float32)
        depth = s.gt_depth.numpy() * np.exp(rng.normal(scale=0.05, size=(1, H, W, 1))).astype(np.float32)
        dcov = np.exp(rng.normal(scale=2.0, size=(1, H, W, 1))).astype(np.float32)
        for a in (flow, cov, depth, dcov):
            a[:, :3] = np.nan
        flow[0, 10, 10] = np.inf
        cov[0, 20, 20, :2] = 0.0
        dcov[0, 30, 30] = 0.0
        out.append((flow, cov, depth, dcov))
    return out


@pytest.mark.parametrize("use_gt_mask", [False, True])
def test_dense_evaluation_matches_jax(frames, use_gt_mask):
    """evaluate_flow / evaluate_flowcov over the pairs and evaluate_depth /
    evaluate_depthcov over the frames, the same stub outputs on both sides:
    every summary field within 1e-6 relative."""
    ours_f, ref_f = frames
    # Far pixels: gt depth beyond max_depth and a flow beyond max_flow somewhere.
    outs = _stub_outputs(ours_f, seed=4)

    def run(evaluate, frame_list, make, n, **kw):
        return evaluate(_Stub([make(o) for o in outs[:n]]), frame_list, **kw)

    cases = [
        ("evaluate_flow", 2, lambda o, M, t: M.MatchOutput(flow=t(o[0])), {"use_gt_mask": use_gt_mask}),
        ("evaluate_flowcov", 2, lambda o, M, t: M.MatchOutput(flow=t(o[0]), cov=t(o[1])), {"use_gt_mask": use_gt_mask}),
        ("evaluate_depth", 3, lambda o, M, t: M.DepthOutput(depth=t(o[2])), {"max_depth": 20.0}),
        ("evaluate_depthcov", 3, lambda o, M, t: M.DepthOutput(depth=t(o[2]), cov=t(o[3])), {"max_depth": 20.0}),
    ]
    for name, n, make, kw in cases:
        ours = run(getattr(dense, name), ours_f, lambda o: make(o, frontend, torch.from_numpy), n, **kw)
        ref = run(getattr(jdense, name), ref_f, lambda o: make(o, jfrontend, jnp.asarray), n, **kw)
        assert type(ours).__name__ == type(ref).__name__
        for field in dataclasses.fields(ref):
            a, b = getattr(ours, field.name), getattr(ref, field.name)
            assert np.isfinite(a), (name, field.name)
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=0, err_msg=f"{name}.{field.name}")


def test_dense_summaries_aggregate_as_jax():
    """mean / median of the summary dataclasses, field by field."""
    rng = np.random.default_rng(1)
    for cls, jcls, how in ((dense.FlowPerformance, jdense.FlowPerformance, "mean"),
                           (dense.FlowCovPerformance, jdense.FlowCovPerformance, "mean"),
                           (dense.DepthPerformance, jdense.DepthPerformance, "median"),
                           (dense.DepthCovPerformance, jdense.DepthCovPerformance, "mean")):
        n = len(dataclasses.fields(cls))
        vals = rng.normal(size=(5, n)).tolist()
        ours = getattr(cls, how)([cls(*v) for v in vals])
        ref = getattr(jcls, how)([jcls(*v) for v in vals])
        assert dataclasses.astuple(ours) == dataclasses.astuple(ref)
