"""The CPU rehearsal of chip_smoke.py, shared by the ``test_torch_port_rehearsal_<group>.py`` files.

    python chip_smoke.py --device cpu --size 96 --phases kernel network gt ...

(hidden arguments): the named phases run, after ``device``, on a 96x96 crop
of the real clip (the synthetic one at its own 320x240; the phases that make
their own data make it small); each builds what it needs itself. The
script's phases are split into groups, one file a group, each finishing well
inside its case's limit; ``test_torch_port_rehearsal.py`` holds the groups
of all the files to the script's full phase list, so a new phase cannot go
unrehearsed.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).parent.parent
GROUP_FILES = "test_torch_port_rehearsal_*.py"
KERNELS = {"latent_cross_attention[bf16]", "latent_cross_attention[fp32]", "local_correlation",
           "local_correlation_backward"}


def rehearse(phases) -> None:
    """Every phase of the group (and ``device``) ends; the group with
    ``kernel`` prints the kernels line with the four kernels, the others none;
    the run exits 3 (a CPU rehearsal) without the final ``ok`` line."""
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
        assert len(kernels) == 1 and {k["name"] for k in kernels[0]["kernels"]} == KERNELS
    else:
        assert not kernels
    assert '"ok": true' not in out.stdout
