"""``scripts/torch_kernel_compare.py``'s argument handling, on a machine without
a card: ``--old`` may hold any subset of the three kernel sources, and the
script stops with a message (no traceback, no build) where there is no card or
nothing to compare."""

import importlib.util
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent


def _script():
    spec = importlib.util.spec_from_file_location("torch_kernel_compare", ROOT / "scripts/torch_kernel_compare.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("present", [("correlation_bwd.cu",), ("correlation.cu", "correlation_bwd.cu"),
                                     ("latent_attn.cu",), ("correlation.cu", "latent_attn.cu", "correlation_bwd.cu")])
def test_compare_script_takes_a_partial_old_directory(tmp_path, present):
    script = _script()
    for name in present:
        (tmp_path / name).write_text("// an earlier source\n")
    (tmp_path / "libcorrelation_bwd_0123.so").write_bytes(b"")   # a build left by an earlier run
    assert script.old_sources(tmp_path) == {name: tmp_path / name for name in present}


def test_compare_script_raises_cleanly_without_a_card(tmp_path, monkeypatch):
    script = _script()
    (tmp_path / "correlation_bwd.cu").write_text("// an earlier source\n")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="needs an NVIDIA card"):
        script.main(["--old", str(tmp_path)])
    assert not list(tmp_path.glob("*.so"))          # nothing was built


def test_compare_script_rejects_an_old_directory_without_sources(tmp_path):
    script = _script()
    with pytest.raises(SystemExit, match="holds none of"):
        script.main(["--old", str(tmp_path)])
    with pytest.raises(SystemExit, match="no such directory"):
        script.main(["--old", str(tmp_path / "missing")])
