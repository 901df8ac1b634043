"""Parity of the shipped checkpoint's training chain with the JAX package,
on the CPU, on worlds written by ``scripts/torch_gen_randomized.py`` in
TartanAir layout (the randomized recipes' data; both loaders decode with cv2,
as in ``test_torch_port_datasets.py``):

* ``TrainPairDataset`` over two written worlds with the randomized recipe's
  data section (its ``stereo_prob`` and sensor noise; the unseeded
  ``PhotometricJitter`` left out) gives the JAX dataset's batches under the
  same seed, bit for bit. ``test_torch_port_transforms.py`` pins the mixture
  on scenes rendered in memory; these batches are read from the files.
* One ``cov`` step of the cov recipe (tail weight 3.0, as the chain runs it)
  in fp32, from a flax init converted through the JAX package's npz writer,
  on such a batch: the port's step against ``macvo_tpu``'s within the
  step-parity bounds of ``chip_smoke.py``'s phase ``train``.

The runners on the randomized smoke recipe: ``test_torch_port_chain_runner.py``.
"""

from __future__ import annotations

import importlib.util
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from macvo_tpu.data.datasets.train import TrainPairDataset as JTrainPairDataset
from macvo_tpu.data.datasets.train import make_eval_pairs as j_make_eval_pairs
from macvo_tpu.models.flowformer import FlowFormerConfig as JConfig
from macvo_tpu.models.flowformer import FlowFormerCov as JModel
from macvo_tpu.models.flowformer.weights import flatten_params, load_params
from macvo_tpu.models.flowformer.weights import save_params as j_save_params
from macvo_tpu.train.run import make_eval_fn as j_make_eval_fn
from macvo_tpu.train.step import TrainConfig as JTrainConfig
from macvo_tpu.train.step import TrainState as JTrainState
from macvo_tpu.train.step import make_optimizer as j_make_optimizer
from macvo_tpu.train.step import make_train_step as j_make_train_step
from macvo_tpu_torch.data.datasets.train import TrainPairDataset, upcast_batch
from macvo_tpu_torch.models.flowformer import FlowFormerConfig, FlowFormerCov, load_flax_checkpoint
from macvo_tpu_torch.models.flowformer.weights import torch_to_flax
from macvo_tpu_torch.train import run
from macvo_tpu_torch.train.step import create_optimizer, make_train_step
from macvo_tpu_torch.utils.config import load_config, namespace_to_dict

ROOT = Path(__file__).resolve().parent.parent
CKPT = ROOT / "model" / "MACVO_FrontendCov.npz"
WORLD = (4, 128, 96)         # frames, width, height of the written worlds
H, W, DEPTH = 64, 96, 2
# step parity (chip_smoke.PARITY_BOUNDS): relative loss; each leaf's gradient over its scale; a weight's update
# over (1e-3 lr + two ulps of the weight) where the first Adam step's direction is decided
LOSS_REL, GRAD_REL, UPDATE_SHARE = 1e-5, 1e-4, 1.0


def _script(name: str):
    spec = importlib.util.spec_from_file_location(f"_script_{name}", ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True, scope="module")
def _cv2_reads_and_few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr("macvo_tpu.native.decode_png", lambda *args, **kwargs: None)
        mp.setattr("macvo_tpu_torch.native.decode_png", lambda *args, **kwargs: None)
        yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory) -> Path:
    """``data/randomized/seq_1000`` and ``seq_1001`` under a temporary root,
    written by the port's world writer, with ``assets`` beside them."""
    root = tmp_path_factory.mktemp("chain")
    gen = _script("torch_gen_randomized")
    for seed in (1000, 1001):
        gen.gen_one((seed, *WORLD, str(root / "data" / "randomized")))
    (root / "assets").symlink_to(ROOT / "assets")
    return root


def _recipe_data(worlds: Path, recipe: str = "FlowFormerCov_randomized.yaml") -> dict:
    """The recipe's data section on the written worlds, without the
    unseeded PhotometricJitter."""
    data = namespace_to_dict(load_config(ROOT / "configs/train" / recipe)[0].Data)
    seqs = [dict(s, args=dict(s["args"], root=str(worlds / s["args"]["root"]))) for s in data["Sequences"]
            if (worlds / s["args"]["root"]).exists()]
    assert len(seqs) == 2
    return {"configs": seqs, "transforms": [t for t in data["transforms"] if t["type"] != "PhotometricJitter"],
            "stereo_prob": float(data["stereo_prob"])}


def test_train_pairs_from_written_worlds_match_jax_bit_for_bit(worlds):
    """Four batches of 4 pairs at 64x96: every array equal in dtype, shape and
    bits; both the temporal and the stereo branch were drawn."""
    data = _recipe_data(worlds)
    assert data["stereo_prob"] == 0.35 and [t["type"] for t in data["transforms"]] == ["AddImageNoise"]
    ours, ref = TrainPairDataset(**data), JTrainPairDataset(**data)
    assert len(ours) == len(ref) == 2 * (WORLD[0] - 2)      # the last frame of a world has no flow
    it_o, it_r = ours.batches(4, H, W, seed=7), ref.batches(4, H, W, seed=7)
    stereo = []
    for _ in range(4):
        a, b = next(it_o), next(it_r)
        assert set(a) == set(b) == {"img1", "img2", "gt_flow", "flow_mask"}
        for k in a:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        stereo += [bool((f[..., 1] == 0).all()) for f in a["gt_flow"]]
    it_o.close()
    it_r.close()
    assert any(stereo) and not all(stereo)


@pytest.fixture(scope="module")
def flax_init(tmp_path_factory):
    """A flax init of the fp32 FlowFormerCov (2 decoder steps), written by
    the JAX package's npz writer."""
    jm = JModel(JConfig(decoder_depth=DEPTH, encoder_dtype="fp32", decoder_dtype="fp32"))
    probe = jnp.zeros((1, H, W, 3), jnp.float32)
    params = jax.device_get(jax.jit(jm.init)(jax.random.PRNGKey(7), probe, probe)["params"])
    # float32 as without x64 (the suite enables it: the perceiver's latents would draw in float64)
    params = jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), params)
    path = tmp_path_factory.mktemp("init") / "flax_init.npz"
    j_save_params(path, params)
    return jm, params, path


def test_one_cov_step_from_a_flax_init_matches_jax(worlds, flax_init):
    """The cov recipe's first step (its onecycle lr, clip, AdamW, tail weight
    3.0) on a batch of the written worlds, fp32 on both sides (JAX gets the
    port's upcast batch): the loss, each trainable leaf's clipped gradient
    (Adam's first moment over 1 - beta1), each weight's update where the
    first Adam step's direction is decided, and the frozen leaves untouched."""
    jm, params, path = flax_init
    cfg = load_config(ROOT / "configs/train/FlowFormerCov_randomized_cov.yaml")[0]
    tcfg = run.train_config(cfg, tail_weight=3.0)
    assert tcfg.training_mode == "cov" and tcfg.num_steps == 4000
    it = TrainPairDataset(**_recipe_data(worlds)).batches(2, H, W, seed=int(cfg.Train.seed))
    batch = {k: v.numpy() for k, v in upcast_batch(next(it), "cpu").items()}
    it.close()

    jcfg = JTrainConfig(lr=tcfg.lr, weight_decay=tcfg.weight_decay, clip=tcfg.clip, num_steps=tcfg.num_steps,
                        gamma=tcfg.gamma, max_flow=tcfg.max_flow, training_mode="cov", tail_weight=3.0)
    jopt = j_make_optimizer(jcfg, params)
    state = JTrainState(params=params, opt_state=jopt.init(params), step=jnp.zeros((), jnp.int32))
    state, jaux = jax.device_get(jax.jit(j_make_train_step(jm, jopt, jcfg))(state, batch))
    j_after = flatten_params(state.params)
    j_grad = {k: v / 0.1 for k, v in flatten_params(optax.tree_utils.tree_get(state.opt_state, "mu")).items()
              if isinstance(v, np.ndarray)}

    model = FlowFormerCov(FlowFormerConfig(decoder_depth=DEPTH, encoder_dtype="fp32", decoder_dtype="fp32",
                                           inference_only=False))
    load_flax_checkpoint(model, path)
    before = torch_to_flax(model.state_dict())
    opt = create_optimizer(model, tcfg)
    aux = make_train_step(model, opt, tcfg, "cpu")(batch)
    after = torch_to_flax(model.state_dict())
    grad = torch_to_flax({n: opt.adamw.state[p]["exp_avg"] / 0.1 for n, p in model.named_parameters()
                          if p.requires_grad})
    lr = opt.adamw.param_groups[0]["lr"]

    assert abs(float(aux["loss"]) - float(jaux["loss"])) <= LOSS_REL * abs(float(jaux["loss"]))
    assert set(grad) == set(j_grad) and all("cov_" in k for k in grad)
    gmax = max(float(np.abs(g).max()) for g in j_grad.values())
    for k, g in j_grad.items():
        assert np.abs(grad[k] - g).max() <= GRAD_REL * max(float(np.abs(g).max()), 1e-4 * gmax), k
    checked = 0
    for k in after:
        if k not in grad:                                   # frozen: bit for bit, on both sides
            np.testing.assert_array_equal(after[k], before[k], err_msg=k)
            np.testing.assert_array_equal(j_after[k], before[k], err_msg=k)
            continue
        g = j_grad[k]
        sure = (np.abs(g) >= 1e-2 * np.abs(g).max()) & (np.abs(g) >= 100 * 1e-8)
        w = np.abs(before[k])
        ulp = np.nextafter(w, np.inf, dtype=np.float32) - w
        diff = np.abs((after[k] - before[k]) - (j_after[k] - before[k]))
        assert (diff <= UPDATE_SHARE * (1e-3 * lr + 2 * ulp))[sure].all(), k
        checked += int(sure.sum())
    assert checked > 1000
