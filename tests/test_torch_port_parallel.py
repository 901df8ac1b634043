"""Parity of the port's multi-process and multi-sequence paths
(``macvo_tpu_torch.parallel``, ``make_sharded_train_step``) with the JAX
package's mesh programs.

Multi-process tests start 2 ``gloo`` processes on 127.0.0.1
(``parallel.mesh.spawn_group``): a rendezvous and collective timeout of 120 s
and a join limit of 120 s, so a hang fails the test instead of the suite's
clock. The workers are the module-level ``_*_worker`` functions below; the
spawned processes import this module, so it imports neither JAX nor the JAX
package at its top (the tests import them inside).
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from macvo_tpu_torch.parallel.mesh import spawn_group

ROOT = Path(__file__).parent.parent
CKPT = ROOT / "model/MACVO_FrontendCov.npz"
CLIP = {"root": str(ROOT / "assets/test_sequence/TartanAir2_abs_P000"), "compressed": True,
        "gtFlow": True, "gtDepth": True, "gtPose": True}
TIMEOUT_S = 120.0
H, W = 64, 96


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


# -- the observation-sharded solve -------------------------------------------------------------------

def _fields(n: int):
    from tests.test_torch_port_modules import _problem

    return _problem(n=n)[0]


def _port_data(fields):
    from macvo_tpu_torch.backend.solver import TwoFrameData

    return TwoFrameData(**{k: torch.as_tensor(np.array(v)) for k, v in fields.items()})


def test_pad_to_multiple_matches_jax():
    import jax.numpy as jnp

    from macvo_tpu.backend.solver import TwoFrameData as JData
    from macvo_tpu.parallel import pad_to_multiple as j_pad
    from macvo_tpu_torch.parallel import pad_to_multiple

    fields = _fields(13)
    ours = pad_to_multiple(_port_data(fields), 4)
    ref = j_pad(JData(**{k: jnp.asarray(v) for k, v in fields.items()}), 4)
    assert ours.mask.shape == (16,) and not ours.mask[13:].any()
    for name in ours._fields:
        np.testing.assert_array_equal(getattr(ours, name).numpy(), np.asarray(getattr(ref, name)), err_msg=name)
    assert pad_to_multiple(_port_data(_fields(12)), 4).mask.shape == (12,)


def _solve_worker(rank, size, device, fields, graph_type):
    from macvo_tpu_torch.parallel import make_sharded_solver

    return make_sharded_solver(None, graph_type)(_port_data(fields)).numpy()


@pytest.mark.parametrize("graph_type", ["icp", "disp"])
def test_two_rank_sharded_solve_matches_single_and_jax(graph_type):
    """37 observations (padded to 38) over 2 gloo ranks: both ranks give the
    same pose, within 1e-6 of the port's single solve and of the JAX
    package's solve on the same data (float64)."""
    import jax.numpy as jnp

    from macvo_tpu.backend.solver import TwoFrameData as JData
    from macvo_tpu.backend.solver import solve_two_frame as j_solve
    from macvo_tpu_torch.backend.solver import solve_two_frame

    fields = _fields(37)
    poses = spawn_group(_solve_worker, 2, args=(fields, graph_type), device="cpu", timeout_s=TIMEOUT_S)
    np.testing.assert_array_equal(poses[0], poses[1])
    single = solve_two_frame(_port_data(fields), graph_type=graph_type).numpy()
    ref = np.asarray(j_solve(JData(**{k: jnp.asarray(v) for k, v in fields.items()}), graph_type=graph_type))
    np.testing.assert_allclose(poses[0], single, atol=1e-6)
    np.testing.assert_allclose(poses[0], ref, atol=1e-6)


def test_solver_reduce_sums_every_shard_term():
    """``reduce`` sees each system (loss, A, b: 43 values) and each candidate
    set (17 losses); the identity reduce leaves the solve bit for bit."""
    from macvo_tpu_torch.backend.solver import solve_two_frame

    data = _port_data(_fields(20))
    seen = []

    def reduce(x):
        seen.append(tuple(x.shape))
        return x

    assert torch.equal(solve_two_frame(data, reduce=reduce), solve_two_frame(data))
    assert set(seen) == {(43,), (17,)} and seen.count((43,)) == seen.count((17,)) == 10


# -- the data-parallel training step -----------------------------------------------------------------

def _tiny_model():
    from macvo_tpu_torch.models.flowformer import FlowFormerConfig, FlowFormerCov
    from macvo_tpu_torch.models.flowformer.weights import build_with_weights

    return build_with_weights(lambda: FlowFormerCov(FlowFormerConfig(decoder_depth=2)), str(CKPT))


def _recording_optimizer(model, tcfg):
    """The port's optimizer, keeping a copy of the gradients it is given
    (after any all-reduce, before its clip)."""
    from macvo_tpu_torch.train import Optimizer, apply_freeze

    class Recording(Optimizer):
        def step(self):
            self.seen = [p.grad.detach().clone() for p in self.params]
            super().step()

    return Recording(apply_freeze(model, tcfg.training_mode), tcfg)


def _train_batch():
    """A global batch of 4 pairs of the clip, 32x48 windows with their
    ground-truth flow, whose halves have different masks: the first two rows
    keep every pixel, the last two a quarter of them."""
    from macvo_tpu_torch.data.datasets.tartanair import TartanAirV2

    seq = TartanAirV2(CLIP)
    h, w = 32, 48
    rows = {"img1": [], "img2": [], "gt_flow": []}
    for i, (y0, x0) in enumerate(((300, 280), (120, 60), (420, 500), (200, 330))):
        s0, s1 = seq[i].stereo, seq[i + 1].stereo
        rows["img1"].append(s0.imageL[0, y0:y0 + h, x0:x0 + w].numpy())
        rows["img2"].append(s1.imageL[0, y0:y0 + h, x0:x0 + w].numpy())
        rows["gt_flow"].append(s0.gt_flow[0, y0:y0 + h, x0:x0 + w].numpy())
    batch = {k: np.stack(v) for k, v in rows.items()}
    batch["img1"] = np.round(batch["img1"] * 255).astype(np.uint8)
    batch["img2"] = np.round(batch["img2"] * 255).astype(np.uint8)
    mask = np.ones((4, h, w, 1), bool)
    mask[2:, :, 12:] = False
    batch["flow_mask"] = mask
    return batch


def _tcfg(mode, tail_weight):
    from macvo_tpu_torch.train import TrainConfig

    return TrainConfig(num_steps=100, training_mode=mode, tail_weight=tail_weight)


def _train_worker(rank, size, device, mode, tail_weight):
    from macvo_tpu_torch.train import make_sharded_train_step

    model = _tiny_model()
    tcfg = _tcfg(mode, tail_weight)
    opt = _recording_optimizer(model, tcfg)
    aux = make_sharded_train_step(model, opt, tcfg, device)(_train_batch())
    return {"aux": {k: float(v) for k, v in aux.items()}, "grads": [g.numpy() for g in opt.seen],
            "params": [p.detach().numpy() for p in opt.params]}


@pytest.mark.parametrize("mode,tail_weight", [("flow", 0.0), ("cov", 0.5)])
def test_two_rank_train_step_is_the_global_batch_step(mode, tail_weight):
    """2 gloo ranks, 2 rows each, against one process on the global batch of
    4 (the shipped checkpoint, 2 decoder steps): the loss and metrics within
    1e-6, each trainable leaf's all-reduced gradient within 1e-5 of the
    leaf's scale, and both ranks end with the same parameters. A leaf's scale
    is its largest |gradient|, floored at 1 % of the largest leaf's: the
    leaves below that (the attention key biases, whose exact gradient is 0,
    and the decoder's query path) hold fp32 rounding of the batch split, not
    a gradient. Averaging the ranks' own batch means instead misses the
    global loss by far more than 1e-6 (the halves' masks differ)."""
    from macvo_tpu_torch.data.datasets.train import upcast_batch
    from macvo_tpu_torch.train import make_train_step
    from macvo_tpu_torch.train.step import make_loss_fn

    ranks = spawn_group(_train_worker, 2, args=(mode, tail_weight), device="cpu", timeout_s=TIMEOUT_S)
    model = _tiny_model()
    tcfg = _tcfg(mode, tail_weight)
    opt = _recording_optimizer(model, tcfg)
    batch = _train_batch()
    with torch.no_grad():
        loss_fn = make_loss_fn(model, tcfg)
        halves = [float(loss_fn(upcast_batch({k: v[i:i + 2] for k, v in batch.items()}, "cpu"))[0])
                  for i in (0, 2)]
    aux = {k: float(v) for k, v in make_train_step(model, opt, tcfg, "cpu")(batch).items()}

    for key, value in aux.items():
        assert abs(ranks[0]["aux"][key] - value) <= 1e-6 * max(1.0, abs(value)), (key, ranks[0]["aux"][key], value)
    naive = 0.5 * (halves[0] + halves[1])
    assert abs(naive - aux["loss"]) > 1e-3 * abs(aux["loss"]), (naive, aux["loss"])
    assert len(ranks[0]["grads"]) == len(opt.seen) > 0
    floor = 1e-2 * max(float(g.abs().max()) for g in opt.seen)
    for ours, ref in zip(ranks[0]["grads"], opt.seen):
        ref = ref.numpy()
        scale = max(float(np.abs(ref).max()), floor)
        assert float(np.abs(ours - ref).max()) <= 1e-5 * scale, scale
    for a, b in zip(ranks[0]["params"], ranks[1]["params"]):
        np.testing.assert_array_equal(a, b)


# -- the batched frontend and odometry ---------------------------------------------------------------

def _clip_windows():
    """Frames 0..2 of the clip in two 64x96 windows (two "sequences"), as
    port StereoData and JAX StereoData holding the same arrays."""
    import jax.numpy as jnp

    from macvo_tpu.data import frame as jframe
    from macvo_tpu_torch.data.datasets.tartanair import TartanAirV2

    seq = TartanAirV2(CLIP)
    ours, ref = [[], []], [[], []]
    for i in range(3):
        s = seq[i].stereo
        for j, (y0, x0) in enumerate(((290, 270), (430, 180))):
            crop = {k: getattr(s, k)[:, y0:y0 + H, x0:x0 + W].contiguous() for k in ("imageL", "imageR")}
            K = s.K.copy()
            K[:, 0, 2] -= x0
            K[:, 1, 2] -= y0
            ours[j].append(dataclasses.replace(s, K=K, gt_flow=None, flow_mask=None, gt_depth=None, **crop))
            ref[j].append(jframe.StereoData(T_BS=s.T_BS, K=K, baseline=s.baseline, time_ns=s.time_ns,
                                            **{k: jnp.asarray(v.numpy()) for k, v in crop.items()}))
    return ours, ref


FF_ARGS = {"weight": str(CKPT), "enc_dtype": "fp32", "dec_dtype": "fp32", "decoder_depth": 2,
           "enforce_positive_disparity": True}


@pytest.fixture(scope="module")
def batched():
    from macvo_tpu.parallel import BatchedFrontend as JBatched
    from macvo_tpu.parallel import make_mesh as j_make_mesh
    from macvo_tpu_torch.parallel import BatchedFrontend

    cfg = SimpleNamespace(**FF_ARGS)
    return BatchedFrontend(cfg, "cpu"), JBatched(cfg, j_make_mesh((1,), ("data",))), _clip_windows()


def _close(ours, ref, what, atol=1e-4, rtol=1e-4):
    ours, ref = ours.numpy(), np.asarray(ref)
    assert ours.shape == ref.shape, what
    np.testing.assert_array_equal(np.isnan(ours), np.isnan(ref), err_msg=what)
    np.testing.assert_allclose(ours, ref, atol=atol, rtol=rtol, err_msg=what)


def test_batched_frontend_matches_jax(batched):
    """2 sequences at 64x96, 2 decoder steps, the shipped npz on both sides:
    forward_depths and forward_pairs give each sequence's disparity and its
    variance (the network's outputs; depth is their reciprocal, which blows
    up the far pixels' rounding), its positive-disparity mask and its match
    within the network's fp32 parity bound (1e-4)."""
    ours, ref, (seqs, jseqs) = batched
    depths = ours.forward_depths([s[0] for s in seqs])
    jdepths = ref.forward_depths([s[0] for s in jseqs])
    pairs = ours.forward_pairs([s[0] for s in seqs], [s[1] for s in seqs])
    jpairs = ref.forward_pairs([s[0] for s in jseqs], [s[1] for s in jseqs])
    assert len(depths) == len(pairs) == 2
    for i in range(2):
        for field in ("disparity", "disparity_uncertainty"):
            _close(getattr(depths[i], field), getattr(jdepths[i], field), f"depth0[{i}].{field}")
            _close(getattr(pairs[i][0], field), getattr(jpairs[i][0], field), f"depth1[{i}].{field}")
        np.testing.assert_array_equal(pairs[i][0].mask.numpy(), np.asarray(jpairs[i][0].mask))
        _close(pairs[i][1].flow, jpairs[i][1].flow, f"flow[{i}]")
        _close(pairs[i][1].cov, jpairs[i][1].cov, f"match cov[{i}]")


def test_batched_frontend_matches_the_unbatched_frontend(batched):
    """The batched outputs of each sequence against FlowFormerCovFrontend's
    own (estimate_depth, then estimate_pair) on the CPU: the same network on
    the same pairs, its flows and variances within 1e-5."""
    from macvo_tpu_torch.modules.frontend_network import FlowFormerCovFrontend

    ours, _, (seqs, _) = batched
    single = FlowFormerCovFrontend(SimpleNamespace(**FF_ARGS), device="cpu")
    pairs = ours.forward_pairs([s[1] for s in seqs], [s[2] for s in seqs])
    for i, seq in enumerate(seqs):
        single.estimate_depth(seq[1])
        depth, match = single.estimate_pair(seq[1], seq[2])
        for a, b, what in ((pairs[i][0].disparity, depth.disparity, "disparity"),
                           (pairs[i][0].disparity_uncertainty, depth.disparity_uncertainty, "disparity cov"),
                           (pairs[i][1].flow, match.flow, "flow"), (pairs[i][1].cov, match.cov, "match cov")):
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5, rtol=1e-5, err_msg=f"{what}[{i}]")


def test_batched_odometry_gt_motion_matches_gt():
    """tests/test_parallel.py's GT-composed run through the port's
    BatchedOdometry: 4 synthetic sequences at 64x96, the FlowFormerCov
    frontend with random weights for the machinery, exact GT motion and the
    empty optimizer, so every trajectory equals its ground truth (ATE < 1e-5);
    one batched forward a step."""
    from macvo_tpu_torch.data.datasets.synthetic import SyntheticStereo
    from macvo_tpu_torch.evaluation import evaluate_all
    from macvo_tpu_torch.parallel import BatchedOdometry
    from macvo_tpu_torch.utils.config import build_dynamic_config

    cfg, _ = build_dynamic_config({"Odometry": {
        "args": {"num_point": 128, "edgewidth": 20, "match_cov_default": 0.25, "profile": False, "mapping": False},
        "frontend": {"type": "FlowFormerCovFrontend", "args": {
            "weight": "random:0", "enc_dtype": "fp32", "dec_dtype": "fp32",
            "enforce_positive_disparity": False, "decoder_depth": 1}},
        "motion": {"type": "GTMotionwithNoise", "args": {"noise_std": 0.0}},
        "keypoint": {"type": "RandomSelector", "args": {"mask_width": 24}},
        "mappoint": {"type": "RandomSelector", "args": {"mask_width": 24}},
        "outlier": {"type": "CovarianceSanityFilter", "args": {}},
        "cov": {"obs": {"type": "MatchCovariance", "args": {
            "kernel_size": 5, "match_cov_default": 0.25, "min_flow_cov": 0.25, "min_depth_cov": 0.05}}},
        "postprocess": {"type": "PoseInterpolate", "args": {}},
        "keyframe": {"type": "AllKeyframe", "args": {}},
        "optimizer": {"type": "Empty_TwoFrame_PGO", "args": {"graph_type": "icp", "parallel": True, "capacity": 256}},
    }})
    seqs = [SyntheticStereo({"n_frames": 4, "width": 96, "height": 64, "fx": 48.0, "fy": 48.0, "seed": 7 + i})
            for i in range(4)]
    driver = BatchedOdometry(cfg, n_sequences=4, device="cpu")
    calls = []
    forward = driver.frontend.runner.inference
    driver.frontend.runner.inference = lambda a, b: calls.append(a.shape[0]) or forward(a, b)
    driver.run(seqs)
    assert calls == [4, 8, 8, 8]
    for system, seq in zip(driver.systems, seqs):
        est = system.graph.frames.data["pose"][:len(system.graph.frames)].astype(np.float64)
        assert est.shape[0] == 4
        assert evaluate_all(seq.poses.astype(np.float64), est)["ATE"].rmse < 1e-5


def test_batched_odometry_splits_sequences_over_a_mesh():
    """With a mesh of R ranks each rank runs its contiguous share; a count
    that does not split raises."""
    from macvo_tpu_torch.parallel import BatchedOdometry
    from macvo_tpu_torch.utils.config import build_dynamic_config

    class Mesh:
        def __init__(self, size, rank):
            self._size, self._rank = size, rank

        def size(self):
            return self._size

        def get_rank(self):
            return self._rank

    cfg, _ = build_dynamic_config({"Odometry": {
        "args": {"num_point": 16, "edgewidth": 4, "match_cov_default": 0.25, "profile": False, "mapping": False},
        "frontend": {"type": "FlowFormerCovFrontend", "args": {
            "weight": "random:0", "enc_dtype": "fp32", "dec_dtype": "fp32",
            "enforce_positive_disparity": False, "decoder_depth": 1}},
        "motion": {"type": "StaticMotionModel", "args": {}},
        "keypoint": {"type": "RandomSelector", "args": {"mask_width": 4}},
        "mappoint": {"type": "RandomSelector", "args": {"mask_width": 4}},
        "outlier": {"type": "CovarianceSanityFilter", "args": {}},
        "cov": {"obs": {"type": "NoCovariance", "args": {}}},
        "postprocess": {"type": "Naive", "args": {}},
        "keyframe": {"type": "AllKeyframe", "args": {}},
        "optimizer": {"type": "Empty_TwoFrame_PGO", "args": {"graph_type": "icp", "parallel": True, "capacity": 32}},
    }})
    assert BatchedOdometry(cfg, 6, mesh=Mesh(3, 1), device="cpu").indices == [2, 3]
    with pytest.raises(ValueError):
        BatchedOdometry(cfg, 5, mesh=Mesh(2, 0), device="cpu")


def test_precomputed_frontend_is_registered_under_the_jax_name():
    import macvo_tpu.parallel  # noqa: F401  (registers the JAX shim)
    import macvo_tpu_torch.parallel  # noqa: F401
    from macvo_tpu.modules.frontend import IFrontend as JFrontend
    from macvo_tpu_torch.modules.frontend import IFrontend

    assert "_PrecomputedFrontend" in IFrontend.registered()
    assert set(IFrontend.registered()) == set(JFrontend.registered())


def test_parallel_package_exports_the_jax_names():
    import macvo_tpu.parallel as jpar
    import macvo_tpu_torch.parallel as par

    assert par.__all__ == jpar.__all__


def test_runner_under_torchrun_is_the_one_process_run(tmp_path):
    """``torchrun --nproc_per_node 2 -m macvo_tpu_torch.train.run --device cpu``
    (gloo) against the runner in one process, one cov step of batch 2 from the
    shipped checkpoint on FlowFormerCov_synth_cov.yaml's recipe in fp32 (bf16
    would round the two batch splits apart) with one SyntheticStereo
    sequence as its data (seeded pair draws, no unseeded transform, no Eval): the same logged loss (1e-5 relative), checkpoints
    within one Adam step's size of each other (2 lr), and only rank 0 writes
    (one metrics file with one train row, one done marker)."""
    import csv
    import os
    import shutil
    import subprocess
    import sys

    from macvo_tpu_torch.parallel.mesh import free_port
    from macvo_tpu_torch.utils.config import load_config, save_config

    cfg = load_config(ROOT / "configs/train/FlowFormerCov_synth_cov.yaml")[1]
    cfg["Data"] = {"Sequence": {"type": "SyntheticStereo", "args": {
        "n_frames": 4, "width": 96, "height": 64, "fx": 48.0, "fy": 48.0, "seed": 3}}}
    cfg.pop("Eval")
    cfg["Model"].update(encoder_dtype="fp32", decoder_dtype="fp32")
    save_config(cfg, tmp_path / "recipe.yaml")
    args = ["-m", "macvo_tpu_torch.train.run", "--config", str(tmp_path / "recipe.yaml"),
            "--restore", str(CKPT), "--device", "cpu", "--height", "64", "--width", "96", "--batch", "2",
            "--steps", "1", "--log_freq", "1"]
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="2")
    torchrun = shutil.which("torchrun") or pytest.skip("torchrun is not installed")
    runs = {"one": [sys.executable] + args, "two": [torchrun, "--nproc_per_node", "2", "--master_port",
                                                      str(free_port())] + args}
    losses, weights = {}, {}
    for name, cmd in runs.items():
        out = tmp_path / name
        out.mkdir()
        res = subprocess.run(cmd + ["--out", str(out / "ckpt.npz")], cwd=out, env=env, capture_output=True,
                             text=True, timeout=TIMEOUT_S * 2)
        assert res.returncode == 0, res.stderr[-3000:]
        assert sorted(p.name for p in out.iterdir()) == ["ckpt.done", "ckpt.npz", "ckpt_metrics.csv"]
        rows = [r for r in csv.DictReader((out / "ckpt_metrics.csv").open()) if r["split"] == "train"]
        assert len(rows) == 1
        losses[name] = float(rows[0]["loss"])
        with np.load(out / "ckpt.npz") as data:
            weights[name] = {k: data[k] for k in data.files}
    assert losses["two"] == pytest.approx(losses["one"], rel=1e-5)
    lr = 12.5e-5
    for key, value in weights["one"].items():
        assert float(np.abs(weights["two"][key] - value).max()) <= 2 * lr, key


def _mesh_worker(rank, size, device):
    from torch.distributed.tensor import Replicate, Shard

    from macvo_tpu_torch.parallel import make_mesh, replicated, sharded

    mesh = make_mesh(device="cpu")
    grid = make_mesh((1, 2), ("data", "obs"), device="cpu")
    return {"size": mesh.size(), "names": mesh.mesh_dim_names, "rank": mesh.get_rank(),
            "grid": tuple(grid.mesh.shape), "replicated": replicated(mesh) == Replicate(),
            "sharded": sharded(grid, "obs") == [Replicate(), Shard(0)]}


def test_meshes_and_placements_over_two_gloo_ranks():
    """make_mesh over the group (1-D ``data`` by default, or named axes),
    and the placements standing for JAX's P() and P(axis); a single process
    needs no group (init_distributed is a no-op)."""
    import torch.distributed as dist

    from macvo_tpu_torch.parallel import init_distributed

    recs = spawn_group(_mesh_worker, 2, device="cpu", timeout_s=TIMEOUT_S)
    assert [r["rank"] for r in recs] == [0, 1]
    assert all(r["size"] == 2 and r["names"] == ("data",) and r["grid"] == (1, 2) for r in recs)
    assert all(r["replicated"] and r["sharded"] for r in recs)
    init_distributed(None, 1, 0, device="cpu")
    assert not dist.is_initialized()
