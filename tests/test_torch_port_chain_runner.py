"""The port's training runner on ``FlowFormerCov_randomized_smoke.yaml``
against the JAX runner, on the CPU, in a temporary working directory holding
worlds written by ``scripts/torch_gen_randomized.py`` (the recipe reads
``./data/randomized/seq_100{0,1}`` and ``./assets``): the port writes the
checkpoint layout the JAX runner writes on the same recipe, and the eval row
it would write before any update is within 1 % of the JAX package's.
"""

from __future__ import annotations

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from macvo_tpu.data import SequenceBase as JSequenceBase
from macvo_tpu.data.datasets.train import make_eval_pairs as j_make_eval_pairs
from macvo_tpu.models.flowformer import FlowFormerConfig as JConfig
from macvo_tpu.models.flowformer import FlowFormerCov as JModel
from macvo_tpu.models.flowformer.weights import load_params
from macvo_tpu.train.run import make_eval_fn as j_make_eval_fn
from macvo_tpu_torch.models.flowformer import load_flax_checkpoint
from macvo_tpu_torch.train import run
from macvo_tpu_torch.utils.config import load_config
from test_torch_port_chain import CKPT, ROOT, _cv2_reads_and_few_threads, worlds  # noqa: F401  (fixtures)


def _jax_runner(argv: list) -> None:
    """``python -m macvo_tpu.train.run`` through its ``main``, as the JAX
    package trains: without x64 (the suite turns it on, and the runner would
    then draw two leaves in float64 and write them so), its model's init
    compiled (``create_train_state`` runs the flax init eagerly, a minute and
    a half on a CPU at 96x128; jitted it gives the same arrays)."""
    from macvo_tpu.train import run as jrun
    from macvo_tpu.train import step as jstep

    def create_train_state(model, cfg, rng, sample_shape):
        probe = jnp.zeros(sample_shape, jnp.float32)
        params = jax.jit(model.init)(rng, probe, probe)["params"]
        opt = jstep.make_optimizer(cfg, params)
        return jstep.TrainState(params=params, opt_state=opt.init(params), step=jnp.zeros((), jnp.int32)), opt

    with pytest.MonkeyPatch.context() as mp, jax.enable_x64(False):
        mp.setattr(sys, "argv", ["macvo_tpu.train.run"] + argv)
        mp.setattr(jstep, "create_train_state", create_train_state)
        jrun.main()


def test_runner_on_the_randomized_smoke_recipe_writes_the_jax_layout(worlds, monkeypatch):
    """Both runners on the smoke recipe as shipped (bf16, 2 decoder steps,
    96x128, stereo draws, jitter, noise, the clip's eval pairs), from the
    shipped checkpoint, in the worlds' root as the working directory: the JAX
    runner for one step, the port's for the recipe's three. The checkpoints
    hold the same keys with the same shapes (float32), the port's metrics
    rows and ``.done``. The eval row before any update (each package's
    ``make_eval_fn`` over its runner's eval pairs on the restored weights),
    with the recipe's networks in fp32: epe, px1, px3 and nll within 1 % of
    the JAX package's (measured 3e-7). In the recipe's bf16 the port's
    autocast rounds elsewhere than the JAX modules' bf16 dtypes (a difference
    by design, ``ROADMAP.md``): epe, px3 and nll 0.2-0.3 % apart, px1 (3.6 %
    of the pixels within 1 px of the truth) 2.4 % apart."""
    monkeypatch.chdir(worlds)
    recipe = ROOT / "configs/train/FlowFormerCov_randomized_smoke.yaml"
    common = ["--config", str(recipe), "--restore", str(CKPT), "--log_freq", "1"]
    _jax_runner(common + ["--steps", "1", "--out", "jax/ckpt.npz"])
    run.main(common + ["--out", "port/ckpt.npz", "--device", "cpu"])
    with np.load("jax/ckpt.npz") as ref, np.load("port/ckpt.npz") as ours:
        assert set(ours.files) == set(ref.files)
        assert all(ours[k].shape == ref[k].shape and ours[k].dtype == ref[k].dtype == np.float32 for k in ref.files)
    assert Path("port/ckpt.done").read_text().startswith("steps=3 mode=flow")
    rows = Path("port/ckpt_metrics.csv").read_text().strip().splitlines()
    assert [r.split(",")[:2] for r in rows[1:]] == [["1", "train"], ["2", "train"], ["3", "train"], ["3", "eval"]]

    cfg = load_config(recipe)[0]
    cfg.Model.encoder_dtype = cfg.Model.decoder_dtype = "fp32"
    h, w = int(cfg.Train.image_height), int(cfg.Train.image_width)
    model = run.build_model(cfg, torch.device("cpu"), int(cfg.Train.seed))
    load_flax_checkpoint(model, CKPT)
    pairs = run.eval_pairs(cfg, h, w)
    evaluate = run.make_eval_fn(model, float(cfg.Train.max_flow))
    ours = {k: float(np.mean([float(evaluate(b)[k]) for b in pairs])) for k in ("epe", "px1", "px3", "nll")}
    jpairs = j_make_eval_pairs(JSequenceBase.from_config(cfg.Eval.Sequence), h, w,
                               max_frames=int(cfg.Eval.max_frames))
    assert len(jpairs) == len(pairs) == 4
    jm = JModel(JConfig(decoder_depth=int(cfg.Model.decoder_depth), encoder_dtype=str(cfg.Model.encoder_dtype),
                        decoder_dtype=str(cfg.Model.decoder_dtype)))
    probe = jnp.zeros((1, h, w, 3), jnp.float32)
    with jax.enable_x64(False):
        jparams = load_params(CKPT, jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), probe, probe)["params"]))
        jeval = jax.jit(j_make_eval_fn(jm, float(cfg.Train.max_flow)))
        ms = [jax.device_get(jeval(jparams, b)) for b in jpairs]
    ref = {k: float(np.mean([m[k] for m in ms])) for k in ours}
    for k in ours:
        assert abs(ours[k] - ref[k]) <= 0.01 * abs(ref[k]), (k, ours, ref)
