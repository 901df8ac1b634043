"""The pose net's trainer and the randomized worlds it reads, in the port
against the JAX package, on the CPU: ``scripts/torch_gen_randomized.py``
against ``scripts/gen_randomized.py`` (byte for byte), the SyntheticStereo
writer's command line against the JAX one, and
``macvo_tpu_torch.train.posenet`` against ``scripts/train_posenet.py``
(the samples exactly; one step within 1e-6 of the loss, 1e-5 of each
leaf's gradient and weight scale; the written checkpoint in the JAX
``TartanMotionNet``)."""

from __future__ import annotations

import importlib.util
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
WORLD_HW = (48, 64)          # (height, width) of the trainer's test worlds; build_samples resizes to 112x160


def _script(name: str):
    spec = importlib.util.spec_from_file_location(f"_script_{name}", ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _same_files(ours: Path, ref: Path) -> list:
    files = sorted(p.relative_to(ref) for p in ref.rglob("*") if p.is_file())
    assert files == sorted(p.relative_to(ours) for p in ours.rglob("*") if p.is_file())
    for rel in files:
        assert (ours / rel).read_bytes() == (ref / rel).read_bytes(), rel
    return files


def test_randomized_world_is_byte_identical_to_the_jax_writer(tmp_path):
    """gen_one: a 6-frame world at 96x128, every file byte for byte."""
    ours = _script("torch_gen_randomized").gen_one((1003, 6, 128, 96, str(tmp_path / "ours")))
    ref = _script("gen_randomized").gen_one((1003, 6, 128, 96, str(tmp_path / "ref")))
    assert ours.startswith(str(tmp_path / "ours" / "seq_1003")) and ref.startswith(str(tmp_path / "ref" / "seq_1003"))
    files = _same_files(tmp_path / "ours" / "seq_1003", tmp_path / "ref" / "seq_1003")
    assert len(files) == 6 * 3 + 5 + 1          # images, depths, flows of 5 pairs (the last frame has none), poses


def test_gen_randomized_main_writes_seeded_worlds(tmp_path):
    """The command line: --n_seqs worlds named seq_<seed0 + i>, through the spawn pool."""
    out = subprocess.run([sys.executable, str(ROOT / "scripts/torch_gen_randomized.py"), "--out", str(tmp_path),
                          "--n_seqs", "2", "--n_frames", "2", "--width", "32", "--height", "24", "--seed0", "7",
                          "--workers", "2"], capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert sorted(p.name for p in tmp_path.iterdir()) == ["seq_0007", "seq_0008"]
    assert out.stdout.count("done:") == 2
    assert all((tmp_path / s / "pose_left.txt").exists() for s in ("seq_0007", "seq_0008"))


def test_synthetic_writer_command_line_matches_jax(tmp_path):
    """``python -m <package>.data.datasets.synthetic``: the same files, byte for byte."""
    env = dict(os.environ, PYTHONPATH=str(ROOT), JAX_PLATFORMS="cpu")
    for pkg, sub in (("macvo_tpu_torch", "ours"), ("macvo_tpu", "ref")):
        out = subprocess.run([sys.executable, "-m", f"{pkg}.data.datasets.synthetic", "--out", str(tmp_path / sub),
                              "--n_frames", "3", "--width", "64", "--height", "48"], cwd=ROOT, env=env,
                             capture_output=True, text=True, timeout=300)
        assert out.returncode == 0, out.stderr
        assert "Wrote synthetic TartanAir-layout sequence to" in out.stdout
    assert len(_same_files(tmp_path / "ours", tmp_path / "ref")) == 3 * 3 + 2 + 1


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Two 24-frame randomized worlds (the holdout count assumes 24 frames)."""
    root = tmp_path_factory.mktemp("worlds")
    gen = _script("torch_gen_randomized")
    for seed in (1000, 1001):
        gen.gen_one((seed, 24, WORLD_HW[1], WORLD_HW[0], str(root)))
    return root


def _roots(data: Path) -> list:
    return sorted(p for p in data.glob("seq_*") if (p / "pose_left.txt").exists())


@pytest.fixture(scope="module")
def samples(worlds):
    from macvo_tpu_torch.train.posenet import build_samples

    return build_samples(_roots(worlds), holdout=1)


def test_build_samples_equals_jax(worlds, samples):
    """The same stacks and twists, exactly: the same cv2 resizes and numpy
    arithmetic on the same files, the crops drawn by default_rng(11)."""
    (Xtr, Ytr), (Xev, Yev) = samples
    (jXtr, jYtr), (jXev, jYev) = _script("train_posenet").build_samples(_roots(worlds), holdout=1)
    for ours, ref in ((Xtr, jXtr), (Ytr, jYtr), (Xev, jXev), (Yev, jYev)):
        assert ours.dtype == ref.dtype == np.float32 and ours.shape == ref.shape
        np.testing.assert_array_equal(ours, ref)
    assert Xtr.shape[1:] == (112, 160, 5) and Ytr.shape[1:] == (6,)
    # the held-out count assumes 23 pairs a world, which the loader's 23 flow files make 22
    assert Xev.shape[0] == 23 * 3 and Xtr.shape[0] + Xev.shape[0] == 2 * 22 * 3
    assert np.isfinite(Xtr).all() and np.isfinite(Ytr).all()


def test_schedule_is_onecycle_for_short_runs():
    """The trainer's lr follows optax's linear_onecycle_schedule at any run
    length (the FlowFormerCov trainer's rule of a constant lr under 20 steps
    does not apply), and the optimizer clips nothing."""
    from macvo_tpu_torch.train.posenet import build_model, make_optimizer

    for steps in (5, 20, 400):
        model = build_model(torch.device("cpu"))
        opt, schedule = make_optimizer(model, steps, 1e-4)
        ref = optax.linear_onecycle_schedule(steps, 1e-4)
        np.testing.assert_allclose([schedule(i) for i in range(steps + 2)],
                                   [float(ref(i)) for i in range(steps + 2)], rtol=1e-6, atol=1e-12)
        assert opt.defaults["weight_decay"] == 1e-5 and opt.defaults["eps"] == 1e-8


def _jax_step(model, steps: int, lr: float):
    """scripts/train_posenet.py's loss and step, restated (they live inside its main)."""
    opt = optax.adamw(optax.linear_onecycle_schedule(steps, lr), weight_decay=1e-5)

    def loss_fn(p, xb, yb):
        d = jnp.abs(model.apply({"params": p}, xb) - yb)
        return jnp.mean(jnp.where(d < 1.0, 0.5 * d * d, d - 0.5))

    @jax.jit
    def step(params, opt_state, xb, yb):
        loss, grads = jax.value_and_grad(loss_fn)(params, xb, yb)
        updates, opt_state = opt.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss, grads

    return opt, step


def _flat(tree) -> dict:
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_one_training_step_matches_jax(samples, tmp_path):
    """One step from the same flax weights (written by the JAX package, read
    by the port's loader) on the same batch (default_rng(0)) and lr: the loss
    within 1e-6 relative; each leaf's gradient within 1e-5 of that leaf's
    largest gradient; each updated weight within 1e-5 of its leaf's scale.
    A first Adam step moves a weight by lr g / (|g| + eps), so where |g| is
    within a few eps a gradient's rounding shows in the update: a bias that
    starts at 0 has the scale lr itself, and is held, as phase 12 of
    chip_smoke.py holds updates, within 1e-3 lr where its gradient is at
    least 1e-2 of its leaf's largest and 100 eps (the step's direction decided)."""
    from macvo_tpu.models.flowformer.weights import save_params as jsave
    from macvo_tpu.models.tartanvo.posenet import VOFlowRes as JVOFlowRes
    from macvo_tpu_torch.models.flowformer.weights import load_flax_checkpoint, torch_to_flax, transposed_convs
    from macvo_tpu_torch.train.posenet import build_model, make_optimizer, make_step, smooth_l1

    (Xtr, Ytr), _ = samples
    steps, lr = 20, 1e-4
    idx = np.random.default_rng(0).integers(0, Xtr.shape[0], 16)
    xb, yb = Xtr[idx], Ytr[idx]

    jmodel = JVOFlowRes()
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.zeros((1,) + Xtr.shape[1:]))["params"]
    jsave(tmp_path / "init.npz", params)
    jopt, jstep = _jax_step(jmodel, steps, lr)
    jparams, _, jloss, jgrads = jstep(params, jopt.init(params), xb, yb)

    model = build_model(torch.device("cpu"))
    load_flax_checkpoint(model, tmp_path / "init.npz")
    transposed = transposed_convs(model)
    smooth_l1(model(torch.from_numpy(xb)), torch.from_numpy(yb)).backward()
    grads = torch_to_flax({n: p.grad for n, p in model.named_parameters()}, transposed)
    model.zero_grad(set_to_none=True)
    opt, schedule = make_optimizer(model, steps, lr)
    loss = make_step(model, opt, schedule, torch.device("cpu"))(0, xb, yb)

    assert abs(float(loss) - float(jloss)) <= 1e-6 * abs(float(jloss))
    ours, ref, before, ref_grads = torch_to_flax(model.state_dict(), transposed), _flat(jparams), _flat(params), \
        _flat(jgrads)
    assert sorted(ours) == sorted(ref) == sorted(grads)
    lr0 = schedule(0)
    for name, r in ref.items():
        g = ref_grads[name]
        assert float(np.abs(grads[name] - g).max()) <= 1e-5 * float(np.abs(g).max()), name
        assert not np.array_equal(r, before[name]), name        # every leaf took the step
        if np.any(before[name]):
            assert float(np.abs(ours[name] - r).max()) <= 1e-5 * float(np.abs(r).max()), name
        else:
            decided = (np.abs(g) >= 1e-2 * np.abs(g).max()) & (np.abs(g) >= 100 * 1e-8)
            assert decided.any(), name
            assert float(np.abs(ours[name] - r)[decided].max()) <= 1e-3 * lr0, name


def test_main_writes_a_checkpoint_both_motion_nets_load(worlds, tmp_path):
    """``main`` on the CPU: finite losses, one record a step, an npz in the
    layout of model/TartanVO_posenet.npz that the JAX and the port's
    TartanMotionNet load and run on the same input within 1e-5."""
    from macvo_tpu.modules.frontend_tartanvo import TartanMotionNet as JMotion
    from macvo_tpu_torch.modules.frontend_tartanvo import TartanMotionNet
    from macvo_tpu_torch.train.posenet import main

    out = tmp_path / "posenet.npz"
    rec = main(["--data", str(worlds), "--holdout", "1", "--steps", "3", "--batch", "4", "--out", str(out),
                "--device", "cpu"])
    assert len(rec["steps"]) == 3 and np.isfinite([s["loss"] for s in rec["steps"]]).all()
    assert rec["train"] == 2 * 22 * 3 - 69 and rec["eval"] == 69 and rec["evals"] == []
    assert np.isfinite(list(rec["final_eval"].values())).all()
    with np.load(out) as a, np.load(ROOT / "model/TartanVO_posenet.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        assert all(a[k].shape == b[k].shape and a[k].dtype == b[k].dtype for k in a.files)

    rng = np.random.default_rng(3)
    meta = SimpleNamespace(height=48, width=64, fx=40.0, fy=40.0, cx=32.0, cy=24.0, frame_baseline=0.25)
    frame = SimpleNamespace(stereo=meta)
    flow = rng.normal(scale=2.0, size=(1, 48, 64, 2)).astype(np.float32)
    depth = rng.uniform(1.0, 20.0, size=(1, 48, 64, 1)).astype(np.float32)
    prior = np.array([0.3, -0.1, 0.5, 0.0, 0.0, np.sin(0.2), np.cos(0.2)], np.float32)
    jm = JMotion(SimpleNamespace(weight=str(out)))
    ours = TartanMotionNet(SimpleNamespace(weight=str(out)), device="cpu")
    for m, arr in ((jm, jnp.asarray), (ours, torch.from_numpy)):
        m.predict(frame, None, None)
        m.update(arr(prior))
    ref = np.asarray(jm.predict(frame, jnp.asarray(flow), jnp.asarray(depth)))
    pose = ours.predict(frame, torch.from_numpy(flow), torch.from_numpy(depth)).numpy()
    assert np.isfinite(ref).all()
    np.testing.assert_allclose(pose, ref, atol=1e-5, rtol=1e-5)


def test_main_needs_worlds_and_a_card_unless_told(tmp_path):
    from macvo_tpu_torch.train.posenet import main

    with pytest.raises(FileNotFoundError, match="torch_gen_randomized"):
        main(["--data", str(tmp_path), "--device", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            main(["--data", str(tmp_path)])
