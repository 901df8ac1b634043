"""The port's geometry precision guard, its native PNG engine and the six
tools ported from the JAX package's ``scripts/``, against the JAX package.

* precision (``utils/precision.py``): the fp32 and float64 solves, the
  device-chained sync solve and the keypoint and mapping pipelines give the
  same bits inside a caller's bf16 autocast with TF32 switched on as outside
  it, and match the JAX solver; the guard restores every setting of both
  TF32 APIs and the autocast state, also after an exception, and nests.
* native (``native/``): the port's libpng engine and its pool decode what
  the JAX package's engine decodes, bit for bit, which is cv2's 8-bit
  samples times float32(1/255); TartanAirV2 on the clip equals the JAX
  loader's with both engines on; a file the engine cannot read gives None.
* the flow-error analysis and the checkpoint gate: both packages' ``main``
  on the same stubbed matcher outputs / measurements, in temporary paths.
* the FLOPs analyzer: parameters as JAX's, the latent-attention formula as
  ``FlopCounterMode``'s count of the kernel's plain version, and FLOPs as
  the dot/conv FLOPs of the JAX function's jaxpr.
* the two stage profilers and the accuracy-gap diagnosis: CPU smoke runs at
  a small size with every stage and field.
"""

from __future__ import annotations

import contextlib
import importlib.util
import io
import json
import math
import sys
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

from macvo_tpu_torch import native
from macvo_tpu_torch.utils import precision

ROOT = Path(__file__).parent.parent
CLIP_ROOT = ROOT / "assets" / "test_sequence" / "TartanAir2_abs_P000"
CLIP_CONFIG = "configs/sequence/TartanAirv2_RealAsset.yaml"


@pytest.fixture(autouse=True)
def _few_threads_and_settings_kept():
    """Two torch threads; every precision setting as it was after the test."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    saved = precision.settings()
    yield
    precision.restore(saved)
    torch.set_num_threads(prev)


def _script(name: str):
    spec = importlib.util.spec_from_file_location(f"_script_{name}", ROOT / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


# -- precision ----------------------------------------------------------------------------------------

def _read_back() -> dict:
    """Every TF32-related setting as the two APIs read it back ("raises"
    where torch refuses to read a legacy flag)."""
    b = torch.backends
    out = {}
    for name, read in (("float32_matmul_precision", torch.get_float32_matmul_precision),
                       ("cuda.matmul.allow_tf32", lambda: b.cuda.matmul.allow_tf32),
                       ("cudnn.allow_tf32", lambda: b.cudnn.allow_tf32)):
        try:
            out[name] = read()
        except RuntimeError:
            out[name] = "raises"
    for name, holder in (("root", b), ("cuda.matmul", b.cuda.matmul), ("cudnn", b.cudnn),
                         ("cudnn.conv", b.cudnn.conv), ("cudnn.rnn", b.cudnn.rnn), ("mkldnn", b.mkldnn),
                         ("mkldnn.matmul", b.mkldnn.matmul), ("mkldnn.conv", b.mkldnn.conv),
                         ("mkldnn.rnn", b.mkldnn.rnn)):
        out[f"{name}.fp32_precision"] = holder.fp32_precision
    return out


def _assert_off(settings: dict) -> None:
    assert settings["float32_matmul_precision"] == "highest"
    assert settings["cuda.matmul.allow_tf32"] is False and settings["cudnn.allow_tf32"] is False
    for name in ("cuda.matmul", "cudnn.conv", "cudnn.rnn", "mkldnn.matmul", "mkldnn.conv", "mkldnn.rnn"):
        assert settings[f"{name}.fp32_precision"] == "ieee", name


CALLER_POLICIES = {
    "default": lambda: None,
    "legacy_tf32_on": lambda: (setattr(torch.backends.cuda.matmul, "allow_tf32", True),
                               setattr(torch.backends.cudnn, "allow_tf32", True)),
    "legacy_tf32_off": lambda: (setattr(torch.backends.cuda.matmul, "allow_tf32", False),
                                setattr(torch.backends.cudnn, "allow_tf32", False)),
    "matmul_high": lambda: torch.set_float32_matmul_precision("high"),
    "matmul_medium": lambda: torch.set_float32_matmul_precision("medium"),
    "new_api_tf32": lambda: (setattr(torch.backends.cuda.matmul, "fp32_precision", "tf32"),
                             setattr(torch.backends.cudnn.conv, "fp32_precision", "tf32")),
    "new_api_parent_tf32": lambda: setattr(torch.backends.cudnn, "fp32_precision", "tf32"),
}


@pytest.mark.parametrize("policy", sorted(CALLER_POLICIES))
def test_guard_turns_tf32_off_and_restores_every_setting(policy):
    """Inside ``highest()`` both APIs read TF32 off, autocast is off; after
    it (nested, and after an exception) every setting and the autocast state
    are as the caller left them."""
    CALLER_POLICIES[policy]()
    before = _read_back()
    with torch.autocast("cpu", dtype=torch.bfloat16):
        with precision.highest():
            inside = _read_back()
            assert not torch.is_autocast_enabled("cpu")
            with precision.highest():
                assert _read_back() == inside
            assert _read_back() == inside
        assert torch.is_autocast_enabled("cpu")
        with pytest.raises(ValueError), precision.highest():
            raise ValueError("inside the guard")
        assert torch.is_autocast_enabled("cpu")
    _assert_off(inside)
    assert _read_back() == before


def test_fp32_network_policy_and_tf32_enabled_read_back():
    """``tf32_off`` leaves TF32 off in both APIs (and left set, as the
    five fp32 network sites need); ``tf32_enabled`` turns it on for its body
    and restores the policy after."""
    precision.tf32_off()
    off = _read_back()
    _assert_off(off)
    with precision.tf32_enabled():
        on = _read_back()
        assert on["cuda.matmul.allow_tf32"] is True and on["cudnn.allow_tf32"] is True
        assert on["cuda.matmul.fp32_precision"] == "tf32" and on["cudnn.conv.fp32_precision"] == "tf32"
        with precision.highest():
            _assert_off(_read_back())
        assert _read_back() == on
    assert _read_back() == off


def _solve_inputs(dtype):
    from test_torch_port_modules import _problem

    fields, _ = _problem()
    return fields, {k: torch.as_tensor(np.array(v)).to(dtype) if np.asarray(v).dtype != bool
                    else torch.as_tensor(np.array(v)) for k, v in fields.items()}


@contextlib.contextmanager
def _callers_policy():
    """What a PyTorch caller commonly sets: a bf16 autocast and TF32 on."""
    with precision.tf32_enabled(), torch.autocast("cpu", dtype=torch.bfloat16):
        yield


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["fp32", "f64"])
@pytest.mark.parametrize("graph_type", ["icp", "reproj", "disp"])
def test_solve_two_frame_is_the_same_under_a_callers_autocast(graph_type, dtype):
    """The same problem inside a bf16 autocast with TF32 on gives the same
    bits as outside it (the parent raised there in fp32: linalg.solve got a
    bf16 right-hand side), and matches the JAX solver as
    ``test_solve_two_frame_matches_jax`` does (f64: 1e-9; fp32 against the
    f64 JAX solve: 1e-4, the device chain's bound)."""
    import jax.numpy as jnp

    from macvo_tpu.backend.solver import TwoFrameData as JData
    from macvo_tpu.backend.solver import solve_two_frame as j_solve
    from macvo_tpu_torch.backend.solver import TwoFrameData, solve_two_frame

    fields, tensors = _solve_inputs(dtype)
    plain = solve_two_frame(TwoFrameData(**tensors), graph_type=graph_type)
    with _callers_policy():
        guarded = solve_two_frame(TwoFrameData(**tensors), graph_type=graph_type)
    assert guarded.dtype == dtype
    np.testing.assert_array_equal(guarded.numpy(), plain.numpy())
    ref = np.asarray(j_solve(JData(**{k: jnp.asarray(v) for k, v in fields.items()}), graph_type=graph_type))
    np.testing.assert_allclose(guarded.double().numpy(), ref, atol=1e-9 if dtype == torch.float64 else 1e-4)


@pytest.mark.parametrize("graph_type", ["icp", "disp"])
def test_sync_solve_and_packed_solve_are_the_same_under_a_callers_autocast(graph_type):
    """The device-chained solve on a float32 sync array (with poisoned masked
    rows), and ``solve_two_frame_packed``, give the same bits inside a bf16
    autocast with TF32 on; the sync solve matches JAX's within 1e-4."""
    import jax.numpy as jnp
    from test_torch_port_modules import _sync_problem

    from macvo_tpu.backend.two_frame_pgo import solve_sync_packed as j_solve_sync
    from macvo_tpu_torch.backend.solver import solve_two_frame_packed
    from macvo_tpu_torch.backend.two_frame_pgo import solve_sync_packed

    sync, anchor, cam, _ = _sync_problem()
    args = (torch.from_numpy(sync), torch.from_numpy(anchor), torch.from_numpy(cam), torch.tensor(0.25), graph_type)
    plain = solve_sync_packed(*args)
    with _callers_policy():
        guarded = solve_sync_packed(*args)
    np.testing.assert_array_equal(guarded.numpy(), plain.numpy())
    ref = np.asarray(j_solve_sync(jnp.asarray(sync), jnp.asarray(anchor), jnp.asarray(cam),
                                  jnp.asarray(0.25, jnp.float32), graph_type))
    np.testing.assert_allclose(guarded.numpy(), ref, atol=1e-4)

    fields, _ = _solve_inputs(torch.float32)
    packed = torch.zeros(65, 33)
    packed[:64, 0:3] = torch.as_tensor(fields["points_w"])
    packed[:64, 3:6] = torch.as_tensor(fields["points_c"])
    packed[:64, 6:8] = torch.as_tensor(fields["kp2"])
    packed[:64, 8] = torch.as_tensor(fields["disp2"])
    packed[:64, 9:18] = torch.as_tensor(fields["cov_obs_c"]).reshape(64, 9)
    packed[:64, 18:27] = torch.as_tensor(fields["cov_pts_w"]).reshape(64, 9)
    packed[:64, 27:31] = torch.as_tensor(fields["cov_kp2"]).reshape(64, 4)
    packed[:64, 31] = torch.as_tensor(fields["disp2_cov"])
    packed[:64, 32] = torch.as_tensor(fields["mask"]).float()
    packed[64, 0:7] = torch.as_tensor(np.array(fields["pose0"]))
    packed[64, 7:12] = torch.tensor([320.0, 320.0, 320.0, 240.0, 0.25])
    plain = solve_two_frame_packed(packed, graph_type)
    with _callers_policy():
        guarded = solve_two_frame_packed(packed, graph_type)
    np.testing.assert_array_equal(guarded.numpy(), plain.numpy())


def test_keypoint_and_mapping_pipelines_are_the_same_under_a_callers_autocast():
    """The odometry ``bench.py`` builds (random weights) at 96x128: the
    keypoint pipeline's packed array and the mapping pipeline's points are
    the same bits inside a bf16 autocast with TF32 on as outside it."""
    pipeline = _script("torch_profile_pipeline")
    from macvo_tpu_torch.modules.frontend import DepthOutput, MatchOutput

    odom = pipeline.fast_odometry(torch.device("cpu"), "random:0")
    gen = torch.Generator().manual_seed(1)
    h, w = 96, 128
    stereo = _synthetic_stereo(h, w)
    depth_map = 2.0 + 28.0 * torch.rand((1, h, w, 1), generator=gen)
    cov_map = 0.01 + torch.rand((1, h, w, 1), generator=gen)
    depth = DepthOutput(depth=depth_map, cov=cov_map, disparity=80.0 / depth_map, disparity_uncertainty=cov_map)
    match = MatchOutput(flow=3.0 * torch.randn((1, h, w, 2), generator=gen),
                        cov=0.1 + torch.rand((1, h, w, 3), generator=gen))
    pose = torch.tensor([0.1, -0.2, 0.3, 0.0, 0.0, 0.0, 1.0])

    def run():
        odom.generator.manual_seed(0)
        return (odom.keypoint_pipeline(stereo[0], stereo[1], depth, depth, match, pose, pose),
                odom.mapping_pipeline(stereo[0], depth, depth, match, pose))

    with torch.inference_mode():
        plain = run()
        with _callers_policy():
            guarded = run()
    for a, b in zip(guarded, plain):
        assert a.dtype == torch.float32
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def _synthetic_stereo(h: int, w: int):
    from macvo_tpu_torch.data.datasets.synthetic import SyntheticStereo

    seq = SyntheticStereo({"n_frames": 2, "width": w, "height": h, "fx": 80.0, "fy": 80.0,
                           "cx": w / 2.0, "cy": h / 2.0})
    return seq[0].stereo, seq[1].stereo


# -- native PNG engine ------------------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pngs(tmp_path_factory):
    """8- and 16-bit PNGs (RGB, gray, RGBA) of random content."""
    root = tmp_path_factory.mktemp("pngs")
    rng = np.random.default_rng(0)
    images = {
        "rgb8": rng.integers(0, 256, (37, 53, 3), dtype=np.uint8),
        "gray8": rng.integers(0, 256, (29, 41), dtype=np.uint8),
        "rgba8": rng.integers(0, 256, (23, 31, 4), dtype=np.uint8),
        "rgb16": rng.integers(0, 65536, (19, 27, 3), dtype=np.uint16),
        "gray16": rng.integers(0, 65536, (17, 22), dtype=np.uint16),
    }
    paths = {}
    for name, img in images.items():
        paths[name] = root / f"{name}.png"
        assert cv2.imwrite(str(paths[name]), img)
    return paths


def _bits(x: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(x, np.float32).view(np.uint32)


def _cv2_bytes_scaled(path) -> np.ndarray:
    """cv2's 8-bit RGB samples of ``path`` times float32(1/255), the engine's scale."""
    rgb = cv2.cvtColor(cv2.imread(str(path), cv2.IMREAD_COLOR), cv2.COLOR_BGR2RGB)
    return rgb.astype(np.float32) * np.float32(1.0 / 255.0)


def _clip_pngs(n: int = 3) -> list:
    return sorted((CLIP_ROOT / "image_lcam_front").glob("*.png"))[:n]


def test_native_engine_decodes_as_the_jax_engine_and_cv2(pngs):
    """Every PNG (8- and 16-bit, gray, RGBA, three of the clip's frames):
    the port's engine equals the JAX package's bit for bit, and cv2's 8-bit
    samples times float32(1/255) bit for bit (cv2's own x / 255 differs in the
    last bit for some samples)."""
    from macvo_tpu import native as jnative

    assert native.available() and native.decoder() == "native"
    for path in list(pngs.values()) + _clip_pngs():
        ours, ref = native.decode_png(path), jnative.decode_png(path)
        assert ours is not None and ours.dtype == np.float32 and ours.ndim == 3 and ours.shape[2] == 3
        np.testing.assert_array_equal(_bits(ours), _bits(ref), err_msg=str(path))
        np.testing.assert_array_equal(_bits(ours), _bits(_cv2_bytes_scaled(path)), err_msg=str(path))


def test_native_pool_decodes_a_batch_and_reports_failures(pngs, tmp_path):
    """The pool's batch equals one-by-one decoding bit for bit; a missing
    file raises IOError; an unreadable one gives None from ``decode_png``."""
    from macvo_tpu import native as jnative

    paths = _clip_pngs(4)
    pool, jpool = native.NativeDecodePool(3), jnative.NativeDecodePool(3)
    try:
        batch = pool.decode_batch(paths, 640, 640)
        np.testing.assert_array_equal(_bits(batch), _bits(jpool.decode_batch(paths, 640, 640)))
        for i, path in enumerate(paths):
            np.testing.assert_array_equal(_bits(batch[i]), _bits(native.decode_png(path)))
        with pytest.raises(IOError):
            pool.decode_batch([tmp_path / "missing.png"], 640, 640)
    finally:
        pool.close()
        jpool.close()
    bad = tmp_path / "not_a_png.png"
    bad.write_bytes(b"garbage")
    assert native.decode_png(bad) is None
    assert native.decode_png(pngs["rgb8"], max_h=10) is None      # larger than the caller's buffer


def test_tartanair_v2_on_the_clip_equals_the_jax_loader_with_both_engines_on():
    """Every frame of the clip (images, ground-truth depth and flow, K,
    baseline, times, pose) bit for bit, each package reading its PNGs
    through its native engine."""
    from test_torch_port_datasets import assert_frames_equal

    from macvo_tpu import native as jnative
    from macvo_tpu.data.datasets.tartanair import TartanAirV2 as JTartanAirV2
    from macvo_tpu_torch.data.datasets.tartanair import TartanAirV2

    assert native.available() and jnative.available()
    cfg = {"root": str(CLIP_ROOT), "compressed": True, "gtFlow": True, "gtDepth": True, "gtPose": True}
    ours, ref = TartanAirV2(cfg), JTartanAirV2(cfg)
    assert len(ours) == len(ref) == 10
    for i in range(len(ref)):
        assert_frames_equal(ours[i], ref[i])


def test_an_engine_that_cannot_build_falls_back_to_cv2(tmp_path, monkeypatch, caplog):
    """A source g++ rejects: one warning, ``decode_png`` None, ``available``
    False, and ``load_image`` reads with cv2 (x / 255)."""
    from macvo_tpu_torch.data.datasets import tartanair

    broken = tmp_path / "loader.cpp"
    broken.write_text("this is not C++\n")
    monkeypatch.setattr(native, "_SRC", broken)
    monkeypatch.setattr(native, "_BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_BUILD_FAILED", False)
    warnings = []
    monkeypatch.setattr(native.Logger, "warning", lambda msg, *a, **k: warnings.append(msg))
    path = _clip_pngs(1)[0]
    assert native.decode_png(path) is None and native.decode_png(path) is None
    assert not native.available() and native.decoder() == "cv2"
    assert len(warnings) == 1 and "cv2" in warnings[0]
    rgb = cv2.cvtColor(cv2.imread(str(path), cv2.IMREAD_COLOR), cv2.COLOR_BGR2RGB)
    np.testing.assert_array_equal(tartanair.load_image(path)[0], rgb.astype(np.float32) / 255.0)


# -- flow-error analysis ----------------------------------------------------------------------------------

class _StubMatcher:
    """``estimate`` returns the ground-truth flow plus seeded noise growing
    with its magnitude, the same arrays in both packages."""

    def __init__(self, as_output) -> None:
        self.as_output, self.calls = as_output, 0

    def estimate(self, s0, s1):
        gt = np.asarray(s0.gt_flow.cpu() if isinstance(s0.gt_flow, torch.Tensor) else s0.gt_flow, np.float32)
        rng = np.random.default_rng(self.calls)
        self.calls += 1
        noise = rng.normal(0.0, 1.0, gt.shape).astype(np.float32) * (0.2 + 0.05 * np.abs(gt))
        return self.as_output(gt + noise)


def test_flow_error_analysis_matches_the_jax_script(tmp_path, monkeypatch):
    """Both scripts' ``main`` on the clip (fp32 args) with the matcher stubbed
    to the same flow maps: the same JSON record (overall EPE and every
    bucket's range, share, EPE and error share, to 1e-6) and printout."""
    from types import SimpleNamespace

    from macvo_tpu.modules.frontend import IMatcher as JIMatcher
    from macvo_tpu_torch.modules.frontend import IMatcher

    monkeypatch.chdir(ROOT)
    monkeypatch.setattr(JIMatcher, "instantiate",
                        lambda *a, **k: _StubMatcher(lambda f: SimpleNamespace(flow=f)))
    monkeypatch.setattr(IMatcher, "instantiate",
                        lambda *a, **k: _StubMatcher(lambda f: SimpleNamespace(flow=torch.from_numpy(f))))
    jax_out, out = tmp_path / "jax.json", tmp_path / "port.json"
    monkeypatch.setattr(sys, "argv", ["flow_error_analysis", "--data", CLIP_CONFIG, "--dtype", "fp32",
                                      "--device", "cpu", "--out", str(jax_out)])
    jax_text, text = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(jax_text):
        _script("flow_error_analysis").main()
    with contextlib.redirect_stdout(text):
        rec = _script("torch_flow_error_analysis").main(
            ["--data", CLIP_CONFIG, "--dtype", "fp32", "--device", "cpu", "--out", str(out)])
    ref = json.loads(jax_out.read_text())
    assert json.loads(out.read_text()) == rec
    assert rec["n_px"] == ref["n_px"] == 9 * 640 * 640
    assert rec["epe_overall"] == pytest.approx(ref["epe_overall"], abs=1e-6)
    assert rec["buckets"].keys() == ref["buckets"].keys() == {"gt_flow_magnitude_px", "gt_depth_m", "image_row_band"}
    for name, rows in ref["buckets"].items():
        assert len(rec["buckets"][name]) == len(rows)
        for ours, theirs in zip(rec["buckets"][name], rows):
            assert ours.keys() == theirs.keys()
            for key in theirs:
                np.testing.assert_allclose(ours[key], theirs[key], atol=1e-6, err_msg=f"{name} {key}")
    assert text.getvalue().replace(str(out), "OUT") == jax_text.getvalue().replace(str(jax_out), "OUT")


# -- checkpoint promotion ---------------------------------------------------------------------------------

MEASURED = {"flow_epe_px": 3.1, "ate_m": 0.03,
            "e2e": {"ATE": {"rmse": 0.03, "mean": 0.028}, "RTE": {"rmse": 0.01, "mean": 0.009},
                    "ROE": {"rmse": 0.2, "mean": 0.18}, "RPE": {"rmse": 0.02, "mean": 0.019}}}
SHIPPED_RECORD = {"weight": "MACVO_FrontendCov.npz", "flow_epe_px": 3.3079, "ate_m": 0.0372}
# scenario -> (shipped record, measured EPE / ATE, candidate files, shipped calib, flags)
SCENARIOS = {
    "first_promotion": (None, (3.1, 0.03), ("csv", "calib"), False, []),
    "better_on_both": (SHIPPED_RECORD, (3.1, 0.03), ("csv",), True, []),
    "worse_epe": (SHIPPED_RECORD, (3.5, 0.03), ("csv", "calib"), True, []),
    "worse_ate_forced": (SHIPPED_RECORD, (3.1, 0.05), ("calib",), False, ["--force"]),
    "dry_run": (SHIPPED_RECORD, (3.1, 0.03), ("csv", "calib"), True, ["--dry-run"]),
    "self_refresh": (SHIPPED_RECORD, (3.5, 0.05), (), True, ["--force", "--self"]),
}


def _promotion_tree(base: Path, scenario: str) -> tuple[Path, list[str]]:
    record, _, cand_files, shipped_calib, flags = SCENARIOS[scenario]
    (base / "model").mkdir(parents=True)
    (base / "model" / "MACVO_FrontendCov.npz").write_bytes(b"shipped weights")
    if record is not None:
        (base / "model" / "MACVO_FrontendCov.eval.json").write_text(json.dumps(record))
    if shipped_calib:
        (base / "model" / "MACVO_FrontendCov.calib.json").write_text('{"tau2": [1.0]}')
    cand = base / "model" / "MACVO_FrontendCov.npz"
    if "--self" not in flags:
        (base / "cand").mkdir()
        cand = base / "cand" / "MACVO_FrontendCov_v2.npz"
        cand.write_bytes(b"candidate weights")
        if "csv" in cand_files:
            (base / "cand" / "MACVO_FrontendCov_v2_metrics.csv").write_text("step,loss\n1,0.5\n")
        if "calib" in cand_files:
            (base / "cand" / "MACVO_FrontendCov_v2.calib.json").write_text('{"tau2": [2.0]}')
    return cand, [f for f in flags if f != "--self"]


def _tree_contents(base: Path) -> dict:
    out = {}
    for path in sorted(base.rglob("*")):
        if path.is_file():
            data = path.read_bytes()
            if path.suffix == ".json" and path.name != "MACVO_FrontendCov.calib.json" and b"measured_utc" in data:
                rec = json.loads(data)
                rec.pop("measured_utc")
                rec.pop("hardware")
                data = rec
            out[str(path.relative_to(base))] = data
    return out


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_promotion_gate_matches_the_jax_script(scenario, tmp_path, monkeypatch):
    """Both scripts' ``main`` with ``measure`` stubbed to the same numbers,
    each in its own temporary tree (the JAX script's SHIPPED / RECORD /
    E2E_JSON monkeypatched, the port's given as flags): the same gate
    decision and exit code, the same files afterwards (weights, metrics CSV,
    calibration copied or removed), and the same records but for their time
    and hardware."""
    _, (epe, ate), *_ = SCENARIOS[scenario]
    measured = dict(MEASURED, flow_epe_px=epe, ate_m=ate)
    results = {}
    for side in ("jax", "port"):
        base = tmp_path / side
        cand, flags = _promotion_tree(base, scenario)
        paths = {"SHIPPED": base / "model" / "MACVO_FrontendCov.npz",
                 "RECORD": base / "model" / "MACVO_FrontendCov.eval.json", "E2E_JSON": base / "eval_real_asset.json"}
        module = _script("promote_checkpoint" if side == "jax" else "torch_promote_checkpoint")
        monkeypatch.setattr(module, "measure", lambda *a, **k: json.loads(json.dumps(measured)))
        argv = ["--candidate", str(cand)] + flags + ["--device", "cpu"]
        if side == "jax":
            for name, path in paths.items():
                monkeypatch.setattr(module, name, path)
            monkeypatch.setattr(sys, "argv", ["promote_checkpoint"] + argv)
            run = module.main
        else:
            argv += ["--shipped", str(paths["SHIPPED"]), "--record", str(paths["RECORD"]),
                     "--e2e-json", str(paths["E2E_JSON"])]
            run = lambda: module.main(argv)      # noqa: E731
        code = 0
        with contextlib.redirect_stdout(io.StringIO()):
            try:
                run()
            except SystemExit as exc:
                code = exc.code
        results[side] = (code, _tree_contents(base))
    assert results["port"][0] == results["jax"][0]
    assert results["port"][1] == results["jax"][1]
    expected_code = 2 if scenario == "worse_epe" else 0
    assert results["port"][0] == expected_code


# -- FLOPs analyzer -----------------------------------------------------------------------------------------

def _jaxpr_flops(jaxpr, mult: int = 1) -> int:
    """dot_general and conv FLOPs (2 a multiply-add) of a jaxpr, through its
    sub-jaxprs (a scan's body times its length)."""
    from jax.extend import core as jcore

    total = 0
    for eqn in jaxpr.eqns:
        name = eqn.primitive.name
        if name == "dot_general":
            (contract, _), _ = eqn.params["dimension_numbers"]
            lhs = eqn.invars[0].aval.shape
            total += 2 * math.prod(eqn.outvars[0].aval.shape) * math.prod(lhs[i] for i in contract) * mult
        elif name == "conv_general_dilated":
            rhs = eqn.invars[1].aval.shape
            out_features = rhs[eqn.params["dimension_numbers"].rhs_spec[0]]
            total += 2 * math.prod(eqn.outvars[0].aval.shape) * math.prod(rhs) // out_features * mult
        for value in eqn.params.values():
            for sub in value if isinstance(value, (list, tuple)) else [value]:
                inner = getattr(sub, "jaxpr", sub)
                if isinstance(inner, jcore.Jaxpr):
                    total += _jaxpr_flops(inner, mult * (eqn.params.get("length", 1) if name == "scan" else 1))
    return total


@pytest.fixture(scope="module")
def jax_flowformer():
    """The JAX FlowFormerCov at 64x96, batch 2, 2 decoder steps, fp32: its
    parameter count and the dot/conv FLOPs of its forward's jaxpr."""
    import jax
    import jax.numpy as jnp

    from macvo_tpu.models.flowformer import FlowFormerConfig, FlowFormerCov

    model = FlowFormerCov(FlowFormerConfig(encoder_dtype="fp32", decoder_dtype="fp32", decoder_depth=2,
                                           inference_only=True))
    img = jnp.zeros((2, 64, 96, 3), jnp.float32)
    params = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), img[:1], img[:1])["params"])
    closed = jax.make_jaxpr(lambda p, a, b: model.apply({"params": p}, a, b)["flow_final"])(params, img, img)
    return {"params": sum(math.prod(x.shape) for x in jax.tree.leaves(params)),
            "flops": _jaxpr_flops(closed.jaxpr)}


def test_flops_analyzer_parameters_equal_jax(jax_flowformer):
    """``params_M`` of the port's script equals JAX's script's rounding of
    the same count; the counts themselves are equal."""
    from macvo_tpu_torch.models.flowformer import FlowFormerConfig, FlowFormerCov

    ours = sum(p.numel() for p in FlowFormerCov(FlowFormerConfig(decoder_depth=2)).parameters())
    assert ours == jax_flowformer["params"]
    with contextlib.redirect_stdout(io.StringIO()):
        report = _script("torch_flops_analyzer").main(["--device", "cpu", "--height", "64", "--width", "96",
                                                       "--decoder_depth", "2", "--dtype", "fp32"])
    assert report["params_M"] == round(jax_flowformer["params"] / 1e6, 2)
    assert report["resolution"] == "64x96" and report["batch"] == 2
    assert report["flops_G"] > 0 and report["hbm_bytes_G"] > 0


@pytest.mark.parametrize("n,t", [(7, 13), (192, 2), (50, 100)])
def test_latent_attn_flop_formula_equals_the_counter_on_its_plain_version(n, t):
    from torch.utils.flop_counter import FlopCounterMode

    from macvo_tpu_torch.ops.latent_attn import folded_flops, latent_attn_folded_torch

    gen = torch.Generator().manual_seed(0)
    args = [torch.randn(s, generator=gen) for s in ((n, t, 64), (64, 8), (64, 128), (8, 128))]
    with FlopCounterMode(display=False) as counter:
        latent_attn_folded_torch(*args)
    assert counter.get_total_flops() == folded_flops(n, t)


def test_flops_are_the_jax_functions_dot_and_conv_flops(jax_flowformer):
    """At 64x96, batch 2, 2 decoder steps, fp32. The JAX package runs the
    cost perceiver's input stage unfused off the TPU, so the port's unfused
    count (grad mode) is held to the jaxpr's dot/conv FLOPs within 0.5 %
    (measured: +0.30 %). The gap is in how each package writes a few small
    products, not in the network: the JAX perceiver computes its attention
    scores and weighted sums (input stage, the 8x8 intra-latent layers, the
    vertical layers) as broadcast multiplies and sums for the TPU's vector
    unit, which a dot/conv count does not see, and the port as batched
    matmuls (+39.3 MFLOPs here); the JAX decoder samples its cost window and
    upsamples by matmuls of tent and mask weights (-2.3 MFLOPs), the port by
    gathers and sums. The convolutions agree exactly. The script's
    ``flops_G`` counts the folded kernel instead: the unfused count less
    the unfused input stage, plus the formula."""
    analyzer = _script("torch_flops_analyzer")
    from macvo_tpu_torch.models.flowformer import FlowFormerConfig, FlowFormerCov
    from macvo_tpu_torch.ops.latent_attn import folded_flops

    torch.manual_seed(0)
    model = FlowFormerCov(FlowFormerConfig(encoder_dtype="fp32", decoder_dtype="fp32", decoder_depth=2,
                                           inference_only=True)).eval()
    img = torch.zeros(2, 64, 96, 3)
    unfused, folded = analyzer.count(model, img, unfused=True), analyzer.count(model, img)
    assert unfused["latent_attn_calls"] == [] and folded["latent_attn_calls"] == [[192, 2]]
    assert abs(unfused["flops"] / jax_flowformer["flops"] - 1) < 0.005
    n, t = 192, 2
    unfused_stage = 2 * n * (t * 64 * 128 + 2 * t * 128 * 128 + 8 * 128 * 128 + 2 * 8 * t * 128 + 8 * 128 * 128)
    assert folded["flops"] == unfused["flops"] - unfused_stage + folded_flops(n, t)


# -- profilers and the gap diagnosis: CPU smoke runs -------------------------------------------------------

FRONTEND_STAGES = ["twins batch2 (cnet pass)", "twins batch4 (fnet pass)", "all-pairs correlation",
                   "memory encoder (corr+perceiver)", "decoder scan x12", "encode_flow_token x1",
                   "perceiver: input cross-attn", "perceiver: intra layer x1", "perceiver: vertical layer x1",
                   "perceiver: patchify+embed", "FULL forward (pair batch2)"]
PIPELINE_STAGES = ["keypoint pipeline (fused)", "mapping pipeline (fused)", "two-frame LM solve (disp, 256 obs)"]
FIELDS = ("wall_ms", "device_ms", "kernels", "busy")


def _printed_stages(text: str) -> list[str]:
    return [line[:36].rstrip() for line in text.splitlines() if " wall_ms " in line]


@pytest.mark.parametrize("dtype", ["bf16", "fp32"])
def test_frontend_profiler_reports_every_jax_stage(dtype, tmp_path):
    """``--device cpu`` at 64x96: every stage name of the JAX script (12
    decoder steps) in its order, each with the four fields (the device's
    three are None on the CPU), printed and in the JSON written to --out."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        report = _script("torch_profile_frontend").main(
            ["--device", "cpu", "--height", "64", "--width", "96", "--dtype", dtype, "--reps", "1",
             "--out", str(tmp_path / "frontend.json")])
    assert [r["stage"] for r in report["stages"]] == FRONTEND_STAGES
    assert _printed_stages(out.getvalue()) == FRONTEND_STAGES
    assert json.loads((tmp_path / "frontend.json").read_text()) == report
    for row in report["stages"]:
        assert row["wall_ms"] > 0 and all(row[f] is None for f in FIELDS[1:]), row


def test_pipeline_profiler_reports_every_jax_stage():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        report = _script("torch_profile_pipeline").main(["--device", "cpu", "--height", "96", "--width", "128",
                                                         "--reps", "1"])
    assert [r["stage"] for r in report["stages"]] == PIPELINE_STAGES
    assert _printed_stages(out.getvalue()) == PIPELINE_STAGES
    for row in report["stages"]:
        assert row["wall_ms"] > 0 and all(f in row for f in FIELDS), row


def test_gap_diagnosis_reports_its_stages(tmp_path):
    """``--device cpu`` on a 96x96 crop of the clip, 2 decoder steps: stage
    A's three legs with EPE / px1 / px3 and the three flow deltas (zero
    between two CPU legs: TF32 does not exist there), stage B's two E2E legs."""
    with contextlib.redirect_stdout(io.StringIO()):
        rec = _script("torch_diagnose_platform_gap").main(
            ["--device", "cpu", "--size", "96", "--decoder_depth", "2", "--pairs", "2", "--cpu_pairs", "1",
             "--stages", "AB", "--out", str(tmp_path / "gap.json")])
    assert json.loads((tmp_path / "gap.json").read_text()) == rec
    flow = rec["stageA"]["flow"]
    assert set(flow) == {"card_policy", "card_tf32", "cpu"}
    assert flow["card_policy"]["pairs"] == 2 and flow["cpu"]["pairs"] == 1
    for leg in flow.values():
        assert all(math.isfinite(leg[k]) for k in ("epe", "px1", "px3"))
    assert rec["stageA"]["mean_abs_flow_delta_px"] == {
        "card_tf32_vs_cpu": [0.0], "card_policy_vs_cpu": [0.0], "card_tf32_vs_policy": [0.0, 0.0]}
    for leg in rec["stageB_e2e"].values():
        assert {"ATE", "RTE", "ROE", "secs"} <= set(leg)
