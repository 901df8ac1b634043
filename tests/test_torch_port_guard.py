"""Guards of the PyTorch/CUDA port: no JAX on its import path, CUDA by
default with a clear error without a card, and a chip smoke script that
fails off the card instead of printing a result."""

import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).parent.parent
PACKAGE = ROOT / "macvo_tpu_torch"


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT)
    return env


def test_importing_the_whole_port_loads_no_jax():
    code = (
        "import pkgutil, sys, importlib, macvo_tpu_torch\n"
        "for m in pkgutil.walk_packages(macvo_tpu_torch.__path__, 'macvo_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in ('jax', 'jaxlib', 'flax', 'macvo_tpu'))\n"
        "print(len([k for k in sys.modules if k.startswith('macvo_tpu_torch')]))\n"
        "assert not bad, bad\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=_env(), capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) > 30


@pytest.mark.parametrize("path", sorted(str(p.relative_to(ROOT)) for p in PACKAGE.rglob("*.py"))
                         + sorted(str(p.relative_to(ROOT)) for p in (ROOT / "scripts").glob("torch_*.py"))
                         + ["chip_smoke.py"])
def test_no_source_imports_jax_or_the_jax_package(path):
    tree = ast.parse((ROOT / path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in ("jax", "jaxlib", "flax", "macvo_tpu"), f"{path}: imports {name}"


def test_cuda_is_the_default_and_raises_without_a_card():
    from macvo_tpu_torch.utils.device import resolve_device

    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            resolve_device()
    assert resolve_device("cpu").type == "cpu"
    with pytest.raises(ValueError):
        resolve_device("meta")


def test_chip_smoke_without_a_card_exits_nonzero_with_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke.py would run for real")
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")], cwd=ROOT, env=_env(),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_chip_smoke_alone_in_a_directory_fails(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "chip_smoke.py", "--device", "cpu"], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_chip_smoke_rehearses_every_phase_on_the_cpu():
    """The script's CPU rehearsal (hidden ``--device cpu --size``): every phase
    runs, on a 96x96 crop of the real clip (the synthetic one at its own
    320x240), the kernels line is printed, and the run still
    exits non-zero without the final ``ok`` line."""
    env = _env()
    env["OMP_NUM_THREADS"] = "2"
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"), "--device", "cpu", "--size", "96"],
                         cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 3, out.stderr[-2000:]
    ends = {json.loads(line)["phase"] for line in out.stdout.splitlines()
            if line.startswith("{\"t_s\"") and json.loads(line)["event"] == "end"}
    assert ends == {"device", "kernel", "network", "gt", "performant", "fast", "tartanvo", "synthetic", "paper",
                    "ablation", "train", "datasets", "dense", "tartanvo_cov", "train_tvo", "runner", "posenet",
                    "experiment", "batch", "parallel", "calib"}
    kernels = [json.loads(line) for line in out.stdout.splitlines() if line.startswith('{"kernels"')]
    assert len(kernels) == 1 and {k["name"] for k in kernels[0]["kernels"]} == {
        "latent_cross_attention[bf16]", "latent_cross_attention[fp32]", "local_correlation",
        "local_correlation_backward"}
    assert '"ok": true' not in out.stdout


def test_cuda_marker_is_registered(pytestconfig):
    assert any(m.startswith("cuda:") for m in pytestconfig.getini("markers"))
