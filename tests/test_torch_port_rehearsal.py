"""The CPU rehearsal of chip_smoke.py, one group of phases a case.

    python chip_smoke.py --device cpu --size 96 --phases kernel network gt ...

(hidden arguments): the named phases run, after ``device``, on a 96x96 crop
of the real clip (the synthetic one at its own 320x240); each builds what it
needs itself. The script's phases are split into groups that each finish
well inside their case's limit; a last test holds the groups to the script's
full phase list, so a new phase cannot go unrehearsed.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).parent.parent

GROUPS = {
    "kernels_and_odometry": ("kernel", "network", "gt", "performant", "fast", "tartanvo", "synthetic", "paper",
                             "ablation"),
    "training_and_data": ("train", "datasets"),
    "dense_trainers_and_runners": ("dense", "tartanvo_cov", "train_tvo", "runner", "posenet", "experiment"),
    "batch_parallel_calib_tools": ("batch", "parallel", "calib", "tools"),
}


@pytest.mark.parametrize("group", GROUPS)
def test_chip_smoke_rehearses_a_group_of_phases_on_the_cpu(group):
    """Every phase of the group (and ``device``) ends; the group with
    ``kernel`` prints the kernels line with the four kernels, the others none;
    the run exits 3 (a CPU rehearsal) without the final ``ok`` line."""
    phases = GROUPS[group]
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT)
    env["OMP_NUM_THREADS"] = "2"
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"), "--device", "cpu", "--size", "96",
                          "--phases", *phases], cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 3, out.stderr[-2000:]
    ends = {json.loads(line)["phase"] for line in out.stdout.splitlines()
            if line.startswith("{\"t_s\"") and json.loads(line)["event"] == "end"}
    assert ends == {"device", *phases}
    kernels = [json.loads(line) for line in out.stdout.splitlines() if line.startswith('{"kernels"')]
    if "kernel" in phases:
        assert len(kernels) == 1 and {k["name"] for k in kernels[0]["kernels"]} == {
            "latent_cross_attention[bf16]", "latent_cross_attention[fp32]", "local_correlation",
            "local_correlation_backward"}
    else:
        assert not kernels
    assert '"ok": true' not in out.stdout


def test_rehearsal_groups_hold_every_phase_of_the_full_run_once():
    import chip_smoke

    grouped = [phase for phases in GROUPS.values() for phase in phases]
    assert len(grouped) == len(set(grouped))
    assert set(grouped) == set(chip_smoke.PHASES)
