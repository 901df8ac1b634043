"""The port's analysis tooling against the JAX package's: the host-side
extensions (``utils/extensions.py``), ``covariance_2to3_diag``, and the
calibration and quality scripts (``scripts/torch_*.py`` against
``scripts/*.py``) on the same data, weights and modules.

The JAX scripts hard-code 12 decoder steps; their runs here take 2 (the
port's scripts have ``--decoder_depth``) by wrapping the JAX package's config
builder or frontend factory for the duration of the run, which changes
nothing else of the script.
"""

from __future__ import annotations

import contextlib
import importlib.util
import io
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).parent.parent
CKPT = ROOT / "model/MACVO_FrontendCov.npz"


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _script(name: str):
    spec = importlib.util.spec_from_file_location(f"_script_{name}", ROOT / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _run_jax_script(name: str, argv: list[str], monkeypatch) -> str:
    """Run ``scripts/<name>.py``'s main with ``argv``; its standard output."""
    module = _script(name)
    monkeypatch.setattr(sys, "argv", [name] + argv)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        module.main()
    return out.getvalue()


def _json_lines(text: str) -> list[dict]:
    return [json.loads(line) for line in text.splitlines() if line.startswith("{")]


# -- extensions ----------------------------------------------------------------------------------------

@pytest.mark.parametrize("pushes", [[3], [2, 2, 2], [1, 4], [7], [5, 1, 1, 1]])
def test_circular_buffer_matches_jax(pushes):
    from macvo_tpu.utils.extensions import CircularBuffer as JBuffer
    from macvo_tpu_torch.utils.extensions import CircularBuffer

    ours, ref = CircularBuffer(4, (2,)), JBuffer(4, (2,))
    start = 0
    for n in pushes:
        rows = np.arange(start, start + n * 2, dtype=np.float32).reshape(n, 2)
        start += n * 2
        ours.push(rows if n > 1 else rows[0])
        ref.push(rows if n > 1 else rows[0])
        assert len(ours) == len(ref)
        np.testing.assert_array_equal(ours.array, ref.array)
        np.testing.assert_array_equal(ours[-1], ref[-1])


def test_grid_recorder_matches_jax(tmp_path):
    from macvo_tpu.utils.extensions import GridRecorder as JGrid
    from macvo_tpu_torch.utils.extensions import GridRecorder

    rng = np.random.default_rng(0)
    ours, ref = GridRecorder((-2.0, 2.0), (-1.0, 3.0), bins=(16, 8)), JGrid((-2.0, 2.0), (-1.0, 3.0), bins=(16, 8))
    for _ in range(3):
        xs, ys = rng.normal(0, 1.5, 500), rng.normal(1, 1.5, 500)
        ours.record(xs, ys)
        ref.record(xs, ys)
    np.testing.assert_array_equal(ours.grid, ref.grid)
    np.testing.assert_array_equal(ours.density, ref.density)
    assert ours.density.sum() == pytest.approx(1.0)
    ours.save(tmp_path / "ours.npz")
    loaded, jloaded = GridRecorder.load(tmp_path / "ours.npz"), JGrid.load(tmp_path / "ours.npz")
    np.testing.assert_array_equal(loaded.grid, jloaded.grid)
    assert loaded.x_range == jloaded.x_range and loaded.bins == jloaded.bins
    assert GridRecorder((0, 1), (0, 1), (2, 2)).density.sum() == 0


def test_chain_matches_jax():
    from macvo_tpu.utils.extensions import Chain as JChain
    from macvo_tpu_torch.utils.extensions import Chain

    fns = [lambda x: x + 1, lambda x: x * 3, lambda x: x - 2]
    ours = Chain(fns[0]) >> fns[1] >> Chain(fns[2])
    ref = JChain(fns[0]) >> fns[1] >> JChain(fns[2])
    assert ours(4) == ref(4) == 13


def test_covariance_2to3_diag_matches_jax():
    import jax.numpy as jnp

    from macvo_tpu.ops.cov_project import covariance_2to3_diag as j_diag
    from macvo_tpu_torch.ops.cov_project import covariance_2to3_diag, covariance_2to3_full

    rng = np.random.default_rng(1)
    args = [rng.uniform(0.1, 2.0, 50) for _ in range(3)] + [rng.uniform(0, 640, 50), rng.uniform(0, 480, 50),
                                                           rng.uniform(1, 30, 50)]
    ours = covariance_2to3_diag(*[torch.from_numpy(a) for a in args], 320.0, 310.0, 320.0, 240.0)
    ref = j_diag(*[jnp.asarray(a) for a in args], 320.0, 310.0, 320.0, 240.0)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-12, atol=0)
    suu, svv, sdd, u, v, d = [torch.from_numpy(a) for a in args]
    full = covariance_2to3_full(suu, torch.zeros_like(suu), svv, sdd, u, v, d, 320.0, 310.0, 320.0, 240.0)
    assert torch.equal(ours, full)


# -- calibration ----------------------------------------------------------------------------------------

@pytest.fixture(scope="module")
def holdout_world(tmp_path_factory):
    """A 3-frame 96x64 randomized world (seed 1049, the holdout's) in TartanAir
    v1 layout, written by scripts/torch_gen_randomized.py's writer."""
    root = tmp_path_factory.mktemp("worlds")
    _script("torch_gen_randomized").gen_one((1049, 3, 96, 64, str(root)))
    return root / "seq_1049"


def _with_depth_2(build):
    def wrapped(d):
        if d.get("type") == "FlowFormerCovMatcher":
            d = json.loads(json.dumps(d))
            d["args"]["decoder_depth"] = 2
        return build(d)

    return wrapped


def test_fit_cov_temperature_matches_jax(holdout_world, tmp_path, monkeypatch):
    """Both fitters on the same world and npz weights (fp32, 2 decoder steps,
    2 pairs, 4 bands): band edges and temperatures within 1e-4 relative, the
    fit's coverages within one pixel's share; the file goes to ``--out``,
    never beside the weight."""
    import macvo_tpu.utils.config as jconfig

    monkeypatch.setattr(jconfig, "build_dynamic_config", _with_depth_2(jconfig.build_dynamic_config))
    common = ["--weight", str(CKPT), "--root", str(holdout_world), "--max_pairs", "2", "--bands", "4",
              "--dtype", "fp32"]
    _run_jax_script("fit_cov_temperature", common + ["--device", "cpu", "--out", str(tmp_path / "jax.json")],
                    monkeypatch)
    ref = json.loads((tmp_path / "jax.json").read_text())
    ours = _script("torch_fit_cov_temperature").main(
        common + ["--decoder_depth", "2", "--device", "cpu", "--out", str(tmp_path / "port.json")])
    assert json.loads((tmp_path / "port.json").read_text())["tau2"] == ours["tau2"]
    assert not CKPT.with_suffix(".calib.json").exists()
    assert len(ours["log10_sigma_edges"]) == 3 and np.all(np.diff(ours["log10_sigma_edges"]) > 0)
    np.testing.assert_allclose(ours["log10_sigma_edges"], ref["log10_sigma_edges"], rtol=1e-4)
    np.testing.assert_allclose(ours["tau2"], ref["tau2"], rtol=1e-4)
    pixels = 2 * 96 * 64
    for key in ("fit_coverage_raw", "fit_coverage_recalibrated"):
        for q in ("p50", "p90", "p95"):
            assert abs(ours[key][q] - ref[key][q]) <= 1.0 / pixels * 2, (key, q)


def test_fitted_calibration_loads_back(holdout_world, tmp_path):
    """The port's loader reads what the port's fitter wrote, and the matcher
    applies it: with the file, each pixel's variance is the raw one times
    its band's temperature."""
    from types import SimpleNamespace

    from macvo_tpu_torch.data.datasets.tartanair import TartanAir
    from macvo_tpu_torch.modules.frontend_network import FlowFormerCovMatcher, load_cov_calib

    out = tmp_path / "fit.calib.json"
    rec = _script("torch_fit_cov_temperature").main(
        ["--weight", str(CKPT), "--root", str(holdout_world), "--max_pairs", "1", "--bands", "3", "--dtype", "fp32",
         "--decoder_depth", "2", "--device", "cpu", "--out", str(out)])
    edges, tau2 = load_cov_calib(str(out), str(CKPT))
    np.testing.assert_allclose(edges.numpy(), rec["log10_sigma_edges"], rtol=1e-6)
    np.testing.assert_allclose(tau2.numpy(), rec["tau2"], rtol=1e-6)
    seq = TartanAir({"root": str(holdout_world), "gtFlow": True, "gtDepth": False, "gtPose": True})
    args = dict(weight=str(CKPT), enc_dtype="fp32", dec_dtype="fp32", decoder_depth=2)
    raw = FlowFormerCovMatcher(SimpleNamespace(cov_calib="none", **args), device="cpu").estimate(
        seq[0].stereo, seq[1].stereo)
    cal = FlowFormerCovMatcher(SimpleNamespace(cov_calib=str(out), **args), device="cpu").estimate(
        seq[0].stereo, seq[1].stereo)
    var = raw.cov[..., :2].double()
    band = torch.searchsorted(edges.double(), (0.5 * torch.log10(0.5 * (var[..., 0] + var[..., 1]))).contiguous())
    np.testing.assert_allclose(cal.cov[..., :2].numpy(), (var * tau2.double()[band][..., None]).numpy(), rtol=1e-5)


def test_cov_calibration_matches_jax(tmp_path, monkeypatch):
    """Both calibration scripts on one synthetic pair (320x240, the shipped
    npz at fp32 with 2 decoder steps): EPE, NLL and chi-square coverages within
    1e-4 (relative for EPE and NLL), the grid's counts within 0.1 % of its
    total, and both write their json and grid (and png)."""
    import macvo_tpu.modules.frontend as jfrontend

    build = jfrontend.IFrontend.instantiate.__func__

    def instantiate(cls, name, config, *a, **k):
        config.decoder_depth = 2
        return build(cls, name, config, *a, **k)

    monkeypatch.setattr(jfrontend.IFrontend, "instantiate", classmethod(instantiate))
    common = ["--weight", str(CKPT), "--data", "synthetic", "--max_pairs", "1"]
    _run_jax_script("cov_calibration", common + ["--device", "cpu", "--out", str(tmp_path / "jax")], monkeypatch)
    ours = _script("torch_cov_calibration").main(
        common + ["--decoder_depth", "2", "--device", "cpu", "--out", str(tmp_path / "port")])
    ref = json.loads((tmp_path / "jax.json").read_text())
    assert json.loads((tmp_path / "port.json").read_text()) == ours
    for key in ("epe", "nll"):
        assert ours[key] == pytest.approx(ref[key], rel=1e-4), key
    for q, value in ours["chi2_coverage"].items():
        assert abs(value - ref["chi2_coverage"][q]) <= 1e-4, q
    grid, jgrid = np.load(tmp_path / "port_grid.npz")["grid"], np.load(tmp_path / "jax_grid.npz")["grid"]
    assert grid.sum() > 0 and np.abs(grid - jgrid).sum() <= 1e-3 * jgrid.sum()
    assert (tmp_path / "port.png").exists()


# -- quality reports -----------------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny_data(tmp_path_factory):
    path = tmp_path_factory.mktemp("data") / "syn.yaml"
    path.write_text("Sequence:\n  type: SyntheticStereo\n  args: {n_frames: 3, width: 96, height: 64, "
                    "fx: 48.0, fy: 48.0, seed: 5}\n")
    return str(path)


FF = {"weight": str(CKPT), "enc_dtype": "fp32", "dec_dtype": "fp32", "decoder_depth": 2}


@pytest.mark.parametrize("module", [{"type": "GTDepth", "args": {}},
                                    {"type": "FlowFormerCovDepth", "args": FF}], ids=["GTDepth", "FlowFormerCovDepth"])
def test_depth_quality_matches_jax(tiny_data, module, monkeypatch):
    """The depth report (and the depth covariance report where the module
    has one) against the JAX script's on the same module: equal for the GT
    oracle, within 1e-3 relative for the network at fp32."""
    spec = json.dumps(module)
    ref = {k: v for line in _json_lines(_run_jax_script("depth_quality", ["--data", tiny_data, "--module", spec],
                                                        monkeypatch)) for k, v in line.items()}
    ours = _script("torch_depth_quality").main(["--data", tiny_data, "--module", spec, "--device", "cpu"])
    assert set(ours) == set(ref)
    for section, fields in ref.items():
        for key, value in fields.items():
            assert ours[section][key] == pytest.approx(value, rel=1e-3, abs=1e-6), (section, key)


@pytest.mark.parametrize("modules", [
    [{"type": "GTMatcher", "args": {}}],
    [{"type": "ApplyGTMatchMask", "args": {"module": {"type": "GTMatcher", "args": {}}}},
     {"type": "FlowFormerCovMatcher", "args": FF}],
], ids=["GTMatcher", "mask+FlowFormerCovMatcher"])
def test_match_quality_matches_jax(tiny_data, modules, monkeypatch):
    """The flow report of each matcher (and its flow covariance report where
    it has one) against the JAX script's, in the order given."""
    argv = ["--data", tiny_data]
    for m in modules:
        argv += ["--module", json.dumps(m)]
    ref = {}
    for line in _json_lines(_run_jax_script("match_quality", argv, monkeypatch)):
        ref.setdefault(line["module"], {}).update({k: v for k, v in line.items() if k != "module"})
    ours = _script("torch_match_quality").main(argv + ["--device", "cpu"])
    assert [r["module"] for r in ours] == list(ref)
    for rec in ours:
        for section in set(rec) - {"module"}:
            for key, value in ref[rec["module"]][section].items():
                assert rec[section][key] == pytest.approx(value, rel=1e-3, abs=1e-6), (rec["module"], section, key)


def test_montecarlo_cov_exits_zero():
    """The closed-form projection agrees with the sampled covariance within
    the script's default tolerance (5 %) on 200,000 samples a case."""
    import subprocess

    out = subprocess.run([sys.executable, str(ROOT / "scripts/torch_montecarlo_cov.py"), "--samples", "200000"],
                         capture_output=True, text=True, timeout=300, env={"PYTHONPATH": str(ROOT), "PATH": ""})
    assert out.returncode == 0, out.stdout + out.stderr
    assert "worst-case relative error" in out.stdout


def test_montecarlo_cov_fails_above_its_tolerance():
    assert _script("torch_montecarlo_cov").main(["--samples", "20000", "--tol", "1e-6"]) == 1


def test_visualize_flow_writes_its_figures(tiny_data, tmp_path):
    pytest.importorskip("matplotlib")
    written = _script("torch_visualize_flow").main(["--data", tiny_data, "--out", str(tmp_path / "flow"),
                                                   "--device", "cpu"])
    assert [p.name for p in written] == ["flow_0000.png", "flow_0001.png"]
    assert all(p.stat().st_size > 1000 for p in written)
