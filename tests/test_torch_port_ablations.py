"""The port's ablation runner (scripts/torch_run_ablations.py) against the JAX
package's (scripts/run_ablations.py) with the same ``--ablation_dir`` and
``--frames``, on the CPU.

The directory holds two of the ablation configs, cut to 2 decoder steps (the
checkpoint's path made absolute). Both runners must run the same configs, in
the same order, on the same 3 frames of ``Synthetic_Holdout``; the port's
poses must be finite. ATE is not compared: the keypoint draws differ by design
(``torch.Generator`` against ``jax.random``).
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import yaml

ROOT = Path(__file__).parent.parent
DATA = ROOT / "configs/sequence/Synthetic_Holdout.yaml"
CONFIGS = ("TartanAirv2_Vanilla", "TartanAirv2_CovOpt")   # file-name order: CovOpt, then Vanilla


def _script(name):
    import importlib.util

    spec = importlib.util.spec_from_file_location(name, ROOT / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def ablation_dir(tmp_path_factory):
    out = tmp_path_factory.mktemp("ablation_configs")
    for name in CONFIGS:
        cfg = yaml.safe_load((ROOT / "configs/experiment/macvo/ablation" / f"{name}.yaml").read_text())
        frontend = cfg["Odometry"]["frontend"]["args"]
        frontend["decoder_depth"] = 2
        frontend["weight"] = str(ROOT / "model/MACVO_FrontendCov.npz")
        (out / f"{name}.yaml").write_text(yaml.safe_dump(cfg))
    return out


def test_port_ablation_runner_runs_the_jax_runners_configs_and_frames(ablation_dir, tmp_path, monkeypatch):
    from macvo_tpu.odometry import MACVO

    jax_runs = []
    receive = MACVO.receive_frames

    def recording(self, sequence, saveto=None, **kw):
        jax_runs.append((Path(saveto.folder).name, [int(i) for i in sequence.indices]))
        return receive(self, sequence, saveto=saveto, **kw)

    monkeypatch.setattr(MACVO, "receive_frames", recording)
    monkeypatch.chdir(tmp_path)          # the JAX runner writes its sandbox under ./results
    monkeypatch.setattr(sys, "argv", ["run_ablations.py", "--data", str(DATA), "--ablation_dir", str(ablation_dir),
                                      "--frames", "3", "--out", str(tmp_path / "jax_table.md"), "--device", "cpu"])
    _script("run_ablations").main()

    port = _script("torch_run_ablations")
    port_runs = []
    run_variant = port.run_variant

    def recording_variant(name, cfg, frames, device, seed):
        port_runs.append((name, [f.frame_idx for f in frames]))
        return run_variant(name, cfg, frames, device, seed)

    monkeypatch.setattr(port, "run_variant", recording_variant)
    monkeypatch.setattr(sys, "argv", ["torch_run_ablations.py", "--data", str(DATA), "--ablation_dir",
                                      str(ablation_dir), "--frames", "3", "--device", "cpu",
                                      "--out", str(tmp_path / "port_table")])
    port.main()

    names = [c.removeprefix("TartanAirv2_") for c in sorted(CONFIGS)]
    assert jax_runs == [(n, [0, 1, 2]) for n in names]
    assert port_runs == jax_runs
    rows = json.loads((tmp_path / "port_table.json").read_text())["rows"]
    assert sorted(r["variant"] for r in rows) == sorted(names)
    for r in rows:
        assert r["frames"] == 3 and r["finite"] and np.isfinite(r["ATE_m"])


def test_port_ablation_runner_defaults_to_the_shipped_configs(monkeypatch, tmp_path):
    """Without ``--ablation_dir`` the port's runner keeps its config list:
    every config of configs/experiment/macvo/ablation, in file-name order."""
    port = _script("torch_run_ablations")
    seen = []

    def stub_variant(name, cfg, frames, device, seed):     # records the order; runs nothing
        seen.append(name)
        return {"variant": name, "seed": seed, "frames": len(frames), "ATE_m": 0.0, "RTE_m_per_frame": 0.0,
                "ROE_deg_per_frame": 0.0, "lost_frames": 0, "steady_frame_ms_median": None}

    monkeypatch.setattr(port, "run_variant", stub_variant)
    monkeypatch.setattr(sys, "argv", ["torch_run_ablations.py", "--data", str(DATA), "--frames", "1",
                                      "--device", "cpu", "--out", str(tmp_path / "table")])
    port.main()
    shipped = sorted((ROOT / "configs/experiment/macvo/ablation").glob("*.yaml"))
    assert seen == [p.stem.removeprefix("TartanAirv2_") for p in shipped] and len(seen) == 9
