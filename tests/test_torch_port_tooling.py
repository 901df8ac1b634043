"""The runner's tooling in the port against the JAX package, on the CPU: the
result sandbox (and the repair of a run overwriting another's results), the
stage timer and ``--timing``, ``--saveplt`` and its figures, the table and
CSV helpers, ``Trajectory.as_motions``, the viz helpers, and the batch
experiment runner ``scripts/torch_experiment_macvo.py``."""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
SYNTH = ROOT / "configs/experiment/macvo/MACVO_Synthetic.yaml"
STAGES = {"Odom_Runtime", "Frontend.estimate", "KP pipeline", "Sync consume", "TwoframePGO.dispatch"}


def _script(name: str, where: Path = ROOT / "scripts"):
    spec = importlib.util.spec_from_file_location(f"_script_{name}", where / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _env() -> dict:
    return dict(os.environ, PYTHONPATH=str(ROOT), JAX_PLATFORMS="cpu")


def _fixed_stamp(monkeypatch, stamp: str = "01_02_030405"):
    """Hold the clock the result sandbox reads (``time.strftime``) at ``stamp``."""
    real = time.strftime
    monkeypatch.setattr(time, "strftime", lambda fmt, *a: stamp if fmt == "%m_%d_%H%M%S" else real(fmt, *a))
    return stamp


# -- the result sandbox ----------------------------------------------------------------------------

def test_two_runs_with_one_stamp_keep_two_result_directories(tmp_path, monkeypatch):
    """Repair: the runner named its directory <name>_<second> and reused it, so
    a second run in the same second overwrote the first run's poses. Now each
    run gets its own sandbox <root>/<name>/<stamp>[_<i>] with its metadata."""
    from macvo_tpu_torch.__main__ import main

    stamp = _fixed_stamp(monkeypatch)
    for n in (3, 2):
        main(["--odom", str(SYNTH), "--seq_to", str(n), "--noeval", "--device", "cpu",
              "--resultRoot", str(tmp_path)])
    runs = tmp_path / "MACVO-Synthetic"
    assert sorted(p.name for p in runs.iterdir()) == [stamp, f"{stamp}_1"]
    for sub, n in ((stamp, 3), (f"{stamp}_1", 2)):
        assert np.load(runs / sub / "poses.npy").shape == (n, 8)
        meta = (runs / sub / "metadata.yaml").read_text()
        assert "git_sha" in meta and "argv" in meta and "time" in meta


def _tree(root: Path) -> list:
    return sorted(str(p.relative_to(root)) for p in root.rglob("*"))


def test_sandbox_behaves_as_the_jax_sandbox(tmp_path, monkeypatch):
    """create (the suffix on a taken stamp) / load / path / config / new_child /
    children.txt / get_children / get_leaves: the same directories, files and
    answers in both packages."""
    import yaml

    from macvo_tpu.utils.sandbox import Sandbox as JSandbox
    from macvo_tpu_torch.utils.sandbox import Sandbox

    stamp = _fixed_stamp(monkeypatch)
    import datetime as dt

    class _Now(dt.datetime):
        @classmethod
        def now(cls, tz=None):
            return dt.datetime(2026, 1, 2, 3, 4, 5)

    monkeypatch.setattr("macvo_tpu.utils.sandbox.datetime.datetime", _Now)
    for cls, sub in ((Sandbox, "ours"), (JSandbox, "ref")):
        a, b = cls.create(tmp_path / sub, "Run"), cls.create(tmp_path / sub, "Run")
        assert a.folder.name == stamp and b.folder.name == f"{stamp}_1"
        a.config = SimpleNamespace(Odometry=SimpleNamespace(name="X", args=SimpleNamespace(k=1)))
        c1 = a.new_child("seqA")
        a.new_child("seqB")
        c1.new_child("inner")
        assert [c.folder.name for c in a.get_children()] == ["seqA", "seqB"]
        assert sorted(c.folder.name for c in a.get_leaves()) == ["inner", "seqB"]
        assert b.get_leaves()[0].folder == b.folder and b.get_children() == []
        loaded = cls.load(a.folder)
        assert loaded.config.Odometry.name == "X" and loaded.path("x.npy") == a.folder / "x.npy"
        assert loaded.path("config.yaml").exists()
        assert set(yaml.safe_load((a.folder / "metadata.yaml").read_text())) == {"time", "git_sha", "argv"}
        with pytest.raises(FileNotFoundError):
            cls.load(tmp_path / sub / "missing")
    assert _tree(tmp_path / "ours") == _tree(tmp_path / "ref")
    for rel in ("Run/" + stamp + "/children.txt", "Run/" + stamp + "/config.yaml",
                "Run/" + stamp + "/seqA/children.txt"):
        assert (tmp_path / "ours" / rel).read_bytes() == (tmp_path / "ref" / rel).read_bytes(), rel


@pytest.mark.parametrize("package", ["macvo_tpu_torch", "macvo_tpu"])
def test_autoremove_deletes_the_sandbox_at_exit(tmp_path, package):
    """set_autoremove: the sandbox is there while the process runs and gone after it exits."""
    code = (f"from {package}.utils.sandbox import Sandbox\n"
            f"box = Sandbox.create({str(tmp_path)!r}, 'Run')\n"
            "box.set_autoremove()\n"
            "(box.folder / 'poses.npy').write_bytes(b'x')\n"
            "print(box.folder, box.folder.exists())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300,
                         env=_env())
    assert out.returncode == 0, out.stderr
    folder, existed = out.stdout.split()
    assert existed == "True" and not Path(folder).exists()
    assert (tmp_path / "Run").exists()


def test_runner_autoremove_leaves_no_result_directory(tmp_path):
    """``python -m macvo_tpu_torch --autoremove``: the run writes its results,
    and its sandbox is gone when the process exits."""
    out = subprocess.run([sys.executable, "-m", "macvo_tpu_torch", "--odom", str(SYNTH), "--seq_to", "2",
                          "--autoremove", "--device", "cpu", "--resultRoot", str(tmp_path)],
                         cwd=ROOT, env=_env(), capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr
    assert "ATE" in out.stdout                       # it ran and evaluated its sandbox
    assert list((tmp_path / "MACVO-Synthetic").iterdir()) == []


# -- --timing and --saveplt against macvo.py ---------------------------------------------------

@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """A 3-frame GT run (MACVO_Synthetic.yaml) of macvo.py and of the port,
    both with --timing --saveplt, and the port again without them."""
    from macvo_tpu.utils import timer as jtimer
    from macvo_tpu_torch.__main__ import main

    root = tmp_path_factory.mktemp("runs")
    argv = ["--odom", str(SYNTH), "--seq_to", "3", "--timing", "--saveplt", "--device", "cpu"]
    jtimer.reset()
    old = sys.argv
    sys.argv = ["macvo.py"] + argv + ["--resultRoot", str(root / "jax")]
    try:
        _script("macvo", ROOT).main()
    finally:
        sys.argv = old
        jtimer.setup(False)
        jtimer.reset()
    (jax_box,) = (root / "jax" / "MACVO-Synthetic").iterdir()
    timed = main(argv + ["--resultRoot", str(root / "port")])
    plain = main(["--odom", str(SYNTH), "--seq_to", "3", "--device", "cpu", "--resultRoot", str(root / "plain")])
    return SimpleNamespace(jax=jax_box, timed=timed.folder, plain=plain.folder)


def test_timing_records_the_stages_macvo_py_records(runs):
    """elapsed_time.json: the same stage names as macvo.py's, the same number
    of records under each (one Odom_Runtime a frame)."""
    ours = json.loads((runs.timed / "elapsed_time.json").read_text())
    ref = json.loads((runs.jax / "elapsed_time.json").read_text())
    assert set(ours) == set(ref) == STAGES
    assert {k: len(v) for k, v in ours.items()} == {k: len(v) for k, v in ref.items()}
    assert len(ours["Odom_Runtime"]) == 3
    assert all(np.isfinite(v).all() and min(v) >= 0 for v in ours.values())


def test_timing_does_not_change_the_poses(runs):
    """The timer only reads clocks: the poses with and without --timing are bit-identical."""
    a, b = np.load(runs.timed / "poses.npy"), np.load(runs.plain / "poses.npy")
    assert a.shape == (3, 8) and np.array_equal(a, b)
    assert not (runs.plain / "elapsed_time.json").exists() and not (runs.plain / "plots").exists()


def test_saveplt_writes_the_figures_macvo_py_writes(runs):
    assert sorted(p.name for p in (runs.timed / "plots").iterdir()) == \
        sorted(p.name for p in (runs.jax / "plots").iterdir()) == \
        ["MACVO-Synthetic_RotationErr.png", "MACVO-Synthetic_Trajectory.png", "MACVO-Synthetic_TranslationErr.png"]


def test_saveplt_without_matplotlib_says_so_before_the_run(tmp_path, monkeypatch):
    """No matplotlib: --saveplt raises a clear ImportError, and no run starts
    (no sandbox is made)."""
    from macvo_tpu_torch.__main__ import main

    real = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec", lambda name, *a: None if name == "matplotlib" else real(name, *a))
    with pytest.raises(ImportError, match="--saveplt .* matplotlib"):
        main(["--odom", str(SYNTH), "--seq_to", "2", "--saveplt", "--device", "cpu", "--resultRoot", str(tmp_path)])
    assert list(tmp_path.iterdir()) == []


def test_the_package_imports_without_matplotlib():
    """Every module off the viz and plot path imports with matplotlib absent."""
    code = ("import sys, pkgutil, importlib\n"
            "sys.modules['matplotlib'] = None\n"
            "import macvo_tpu_torch\n"
            "skip = ('macvo_tpu_torch.viz.plot_trajectory', 'macvo_tpu_torch.evaluation.plot_seq',\n"
            "        'macvo_tpu_torch.evaluation.plot_speed')\n"
            "n = 0\n"
            "for m in pkgutil.walk_packages(macvo_tpu_torch.__path__, 'macvo_tpu_torch.'):\n"
            "    if m.name not in skip:\n"
            "        importlib.import_module(m.name); n += 1\n"
            "from macvo_tpu_torch.viz import fig_plt, has_rerun, rerun_viz\n"
            "print(n)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300,
                         env=_env())
    assert out.returncode == 0, out.stderr
    assert int(out.stdout) > 30


# -- the timer ----------------------------------------------------------------------------------

def test_timer_off_records_and_synchronises_nothing():
    from macvo_tpu_torch.utils import timer

    timer.setup(False)
    timer.reset()
    with timer.cpu_time("a"), timer.device_time("b", torch.device("cpu")):
        pass
    timer.cpu_timeit("c")(lambda: None)()
    timer.device_timeit("d", "cpu")(lambda: None)()
    assert not timer.is_active() and timer.records() == {} and timer._STATE.pending == []


def test_timer_report_and_file_match_jax(tmp_path, capsys):
    """Sections on the CPU (host time for a device section there), the
    decorators, the report's text and elapsed_time.json, against the JAX
    timer fed the same records."""
    from macvo_tpu.utils import timer as jtimer
    from macvo_tpu_torch.utils import timer

    timer.setup(True)
    timer.reset()
    try:
        with timer.cpu_time("Odom_Runtime"):
            x = torch.ones(4) * 2
        with timer.device_time("Frontend.forward (device)", x):
            x = x + 1
        timer.cpu_timeit("KP pipeline")(lambda: None)()
        assert timer.device_timeit("Sync consume", "cpu")(lambda: 5)() == 5
        recs = {k: list(v) for k, v in timer.records().items()}
        assert {k: len(v) for k, v in recs.items()} == {"Odom_Runtime": 1, "Frontend.forward (device)": 1,
                                                       "KP pipeline": 1, "Sync consume": 1}
        assert timer._STATE.pending == []         # on the CPU nothing waits to be resolved
        timer.save_elapsed(tmp_path / "ours.json")
        capsys.readouterr()
        ours = timer.report()
        printed = capsys.readouterr().out
    finally:
        timer.setup(False)
        timer.reset()
    jtimer.reset()
    jtimer._STATE.records.update(recs)
    try:
        assert ours == jtimer.report() and printed == ours + "\n"
        jtimer.save_elapsed(tmp_path / "ref.json")
    finally:
        jtimer.reset()
    assert (tmp_path / "ours.json").read_bytes() == (tmp_path / "ref.json").read_bytes()


# -- tables, CSV, motions -----------------------------------------------------------------------

ROWS = [["ATE", 0.1234567, float("nan")], ["RTE", 1e-9, 3], ["Average", "x,y", -2.5]]


def test_print_as_table_and_save_as_csv_match_jax(tmp_path, capsys, monkeypatch):
    """The same text as the JAX helper's plain (non-rich) branch; the same CSV bytes."""
    from macvo_tpu.utils import logging as jlogging
    from macvo_tpu_torch.utils.logging import print_as_table, save_as_csv

    monkeypatch.setattr(jlogging, "_HAS_RICH", False)
    headers = ["metric", "a", "b"]
    for title in ("Evaluation — X", None):
        print_as_table(headers, ROWS, title=title)
        ours = capsys.readouterr().out
        jlogging.print_as_table(headers, ROWS, title=title)
        assert ours == capsys.readouterr().out
    save_as_csv(headers, ROWS, tmp_path / "ours.csv")
    jlogging.save_as_csv(headers, ROWS, tmp_path / "ref.csv")
    assert (tmp_path / "ours.csv").read_bytes() == (tmp_path / "ref.csv").read_bytes()


def _traj(n=30, seed=0):
    from scipy.spatial.transform import Rotation

    rng = np.random.default_rng(seed)
    ts = np.linspace(0, 2 * np.pi, n)
    pos = np.stack([np.cos(ts), np.sin(ts), 0.05 * ts], axis=1)
    quat = Rotation.from_euler("z", ts[:, None]).as_quat()
    poses = np.concatenate([pos, quat], axis=1)
    noisy = poses.copy()
    noisy[:, :3] += 0.01 * rng.standard_normal((n, 3))
    return poses, noisy


def test_as_motions_matches_jax():
    from macvo_tpu.evaluation.trajectory import Trajectory as JTrajectory
    from macvo_tpu_torch.evaluation.trajectory import Trajectory

    _, poses = _traj(17, seed=4)
    times = np.arange(17) * 0.1
    ours = Trajectory(poses, times).as_motions()
    ref = JTrajectory(poses, times).as_motions()
    assert ours.shape == (16, 4, 4)
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-12)


def test_evaluation_takes_a_sandbox_or_a_path(tmp_path):
    from macvo_tpu_torch.evaluation import evaluate_sandbox, load_sandbox_trajectories
    from macvo_tpu_torch.utils.sandbox import Sandbox

    box = _fake_sandbox(tmp_path)
    for saveto in (box, box.folder, str(box.folder)):
        gt, est = load_sandbox_trajectories(saveto)
        assert len(gt) == len(est) == 30
    assert evaluate_sandbox(box)["ATE"].rmse == evaluate_sandbox(box.folder)["ATE"].rmse
    assert isinstance(box, Sandbox)


# -- viz helpers --------------------------------------------------------------------------------

def test_flow_to_color_matches_jax():
    from macvo_tpu.viz.plot_axes import flow_to_color as jflow_to_color
    from macvo_tpu_torch.viz.plot_axes import flow_to_color

    flow = np.random.default_rng(1).normal(0, 5, size=(24, 32, 2)).astype(np.float32)
    flow[3, 4] = np.nan
    for max_mag in (None, 4.0):
        np.testing.assert_array_equal(flow_to_color(flow, max_mag), jflow_to_color(flow, max_mag))


def test_cov_rendering_helpers_match_jax():
    from macvo_tpu.viz.rerun_viz import cov_det_colormap as jcolormap
    from macvo_tpu.viz.rerun_viz import cov_eigen_axes as jaxes
    from macvo_tpu_torch.viz.interface import has_rerun
    from macvo_tpu_torch.viz.rerun_viz import cov_det_colormap, cov_eigen_axes, log_points

    rng = np.random.default_rng(0)
    pos = rng.standard_normal((5, 3)).astype(np.float32)
    A = rng.standard_normal((5, 3, 3))
    cov = A @ A.transpose(0, 2, 1) + 0.1 * np.eye(3)
    for ours, ref in zip(cov_eigen_axes(pos, cov), jaxes(pos, cov)):
        assert ours.shape == (15, 3)
        np.testing.assert_array_equal(ours, ref)
    np.testing.assert_array_equal(cov_det_colormap(cov), jcolormap(cov))
    a, b = cov_eigen_axes(pos, cov)
    np.testing.assert_allclose((a + b) / 2, np.repeat(pos, 3, axis=0), atol=1e-5)
    if not has_rerun():
        assert log_points("map", pos, covariances=cov) is None      # a no-op without the rerun sdk


# -- figures (counterpart of tests/test_plotting.py, on the port's fake sandbox) ---------------

def _fake_sandbox(root: Path, package: str = "macvo_tpu_torch"):
    sandbox = importlib.import_module(f"{package}.utils.sandbox").Sandbox
    box = sandbox.create(root, "FakeRun")
    gt, est = _traj()
    t = np.arange(len(gt), dtype=np.float64)[:, None] * 0.1
    np.save(box.path("poses.npy"), np.concatenate([t, est], axis=1))
    np.save(box.path("ref_poses.npy"), np.concatenate([t, gt], axis=1))
    np.save(box.path("need_interp.npy"), np.arange(len(gt)) % 7 == 0)
    with open(box.path("elapsed_time.json"), "w") as f:
        json.dump({"Odom_Runtime": [100.0 + i for i in range(len(gt))]}, f)
    return box


def test_figure_builders(tmp_path):
    from macvo_tpu_torch.viz.plot_trajectory import (analyze_roe_cdf, analyze_rotation, analyze_rte_cdf,
                                                     analyze_translation, plot_speed_figure, plot_trajectory_figure)

    gt, est = _traj()
    paths = [
        plot_trajectory_figure([("GT", gt), ("est", est)], tmp_path / "traj.png",
                               need_interp=np.arange(len(gt)) % 7 == 0),
        analyze_translation([("est", gt, est)], tmp_path / "trans.png"),
        analyze_rotation([("est", gt, est)], tmp_path / "rot.png"),
        analyze_rte_cdf([("est", gt, est)], tmp_path / "rtecdf.png"),
        analyze_roe_cdf([("est", gt, est)], tmp_path / "roecdf.png"),
        plot_speed_figure([("run", np.abs(np.random.default_rng(0).normal(0.1, 0.02, 50)))], tmp_path / "speed.png"),
    ]
    for p in paths:
        assert p.exists() and p.stat().st_size > 1000, p


def _pixels_differing(a: Path, b: Path) -> float:
    import cv2

    x, y = cv2.imread(str(a), cv2.IMREAD_UNCHANGED), cv2.imread(str(b), cv2.IMREAD_UNCHANGED)
    assert x is not None and x.shape == y.shape, (a, b)
    return float(np.any(x != y, axis=-1).mean())


def test_plot_seq_figures_match_jax_pixel_for_pixel(tmp_path):
    """plot_separately / plot_jointly on the same sandbox in both packages:
    the same file names, and each port PNG differs from the JAX one in at
    most 0.5 % of its pixels (measured: 0 %, the same arrays into the same
    matplotlib calls)."""
    from macvo_tpu.evaluation import plot_seq as jplot_seq
    from macvo_tpu_torch.evaluation import plot_seq

    box = _fake_sandbox(tmp_path / "box")
    for mod, sub in ((plot_seq, "ours"), (jplot_seq, "ref")):
        mod.plot_separately([str(box.folder)], tmp_path / sub)
        mod.plot_jointly([str(box.folder), str(box.folder)], tmp_path / sub)
    names = sorted(p.name for p in (tmp_path / "ref").glob("*.png"))
    assert names == sorted(p.name for p in (tmp_path / "ours").glob("*.png"))
    assert len(names) == 3 + 5 and "Combined_RTEcdf.png" in names
    shares = {n: _pixels_differing(tmp_path / "ours" / n, tmp_path / "ref" / n) for n in names}
    assert max(shares.values()) <= 0.005, shares


def test_plot_seq_cli_recursive_and_plot_speed_cli(tmp_path):
    """The command lines: plot_seq --recursive expands a batch sandbox to its
    leaves; plot_speed reads each elapsed_time.json (its PNG matches JAX's)."""
    from macvo_tpu.evaluation import plot_speed as jplot_speed
    from macvo_tpu_torch.evaluation import plot_seq, plot_speed
    from macvo_tpu_torch.utils.sandbox import Sandbox

    box = _fake_sandbox(tmp_path / "box")
    parent = Sandbox.create(tmp_path / "batch", "Batch")
    for name in ("a", "b"):
        child = parent.new_child(name)
        for f in ("poses.npy", "ref_poses.npy", "need_interp.npy", "elapsed_time.json"):
            child.path(f).write_bytes(box.path(f).read_bytes())
    plot_seq.main(["--spaces", str(parent.folder), "--recursive", "--out", str(tmp_path / "figs")])
    names = sorted(p.name for p in (tmp_path / "figs").iterdir())
    assert "a_Trajectory.png" in names and "b_RotationErr.png" in names and "Combined_Trajectory.png" in names
    plot_speed.main(["--spaces", str(box.folder), "--out", str(tmp_path / "speed.png")])
    old = sys.argv
    sys.argv = ["plot_speed", "--spaces", str(box.folder), "--out", str(tmp_path / "ref_speed.png")]
    try:
        jplot_speed.main()
    finally:
        sys.argv = old
    assert _pixels_differing(tmp_path / "speed.png", tmp_path / "ref_speed.png") <= 0.005


def test_matplotlib_figure_builders_take_tensors(tmp_path):
    """plot_macvo / plot_reprojerr / plot_imatcher with the port's tensors
    (bf16 among them) through the gated registry."""
    from macvo_tpu_torch.viz.interface import fig_plt
    from macvo_tpu_torch.viz.matplotlib_viz import plot_imatcher, plot_macvo, plot_reprojerr

    fig_plt.set_mode(None, "image")
    fig_plt.set_save_dir(tmp_path)
    try:
        g = torch.Generator().manual_seed(0)
        frame = SimpleNamespace(imageL=torch.rand((1, 48, 64, 3), generator=g))
        kp = torch.rand((20, 2), generator=g) * 40
        obs = {"pixel1_uv": kp, "pixel2_uv": kp + 1.0,
               "pixel2_uv_cov": torch.tensor([1.0, 1.0, 0.1]).repeat(20, 1)}
        depth_out = SimpleNamespace(cov=torch.rand((1, 48, 64, 1), generator=g) + 0.01)
        match_out = SimpleNamespace(cov=(torch.rand((1, 48, 64, 3), generator=g) + 0.1).to(torch.bfloat16),
                                    flow=torch.randn((1, 48, 64, 2), generator=g))
        p1 = plot_macvo(obs, frame, frame, depth_out, match_out, save_path=tmp_path / "macvo.png")
        p2 = plot_reprojerr(kp, kp + 1.0, torch.eye(2).repeat(20, 1, 1), frame, save_path=tmp_path / "reproj.png")
        p3 = plot_imatcher(match_out, frame, frame)          # numbered by the registry
    finally:
        fig_plt.set_mode(None, "none")
    for p in (p1, p2, p3):
        assert p is not None and Path(p).stat().st_size > 1000
    assert Path(p3).name == "plot_imatcher_00000.png"


# -- the batch experiment runner ----------------------------------------------------------------

def test_experiment_runner_writes_what_the_jax_runner_writes(tmp_path):
    """scripts/torch_experiment_macvo.py against scripts/experiment_macvo.py:
    the GT configuration over two short sequences, on the CPU. The same
    columns and rows in evaluation.csv (finite, within the GT bounds of
    tests/test_e2e.py), the same children.txt."""
    import csv

    seqs = [str(ROOT / "configs/sequence/Synthetic_Demo.yaml"), str(ROOT / "configs/sequence/Synthetic_Holdout.yaml")]
    argv = ["--odom", str(SYNTH), "--data", *seqs, "--seq_to", "3"]
    parent = _script("torch_experiment_macvo").main(argv + ["--device", "cpu", "--resultRoot", str(tmp_path / "ours")])
    old = sys.argv
    sys.argv = ["experiment_macvo.py"] + argv + ["--resultRoot", str(tmp_path / "ref")]
    try:
        _script("experiment_macvo").main()
    finally:
        sys.argv = old
    (ref,) = (tmp_path / "ref" / "MACVO-Synthetic_batch").iterdir()
    assert parent.folder.parent.name == "MACVO-Synthetic_batch"
    assert (parent.folder / "children.txt").read_text() == (ref / "children.txt").read_text() == \
        "Synthetic_Demo\nSynthetic_Holdout\n"
    ours = list(csv.reader((parent.folder / "evaluation.csv").open()))
    theirs = list(csv.reader((ref / "evaluation.csv").open()))
    assert ours[0] == theirs[0] == ["sequence", "ATE rmse", "RTE rmse", "ROE rmse", "RPE rmse"]
    assert [r[0] for r in ours] == [r[0] for r in theirs] == ["sequence", "Synthetic_Demo", "Synthetic_Holdout",
                                                               "Average"]
    for rows in (ours, theirs):
        vals = np.array([[float(v) for v in r[1:]] for r in rows[1:]])
        assert np.isfinite(vals).all()
        assert (vals[:, 0] <= 0.002).all() and (vals[:, 1] <= 0.0025).all() and (vals[:, 2] <= 0.045).all()
        np.testing.assert_allclose(vals[-1], vals[:-1].mean(axis=0), rtol=1e-12)
    for child in ("Synthetic_Demo", "Synthetic_Holdout"):
        assert np.load(parent.folder / child / "poses.npy").shape == (3, 8)
