"""Entry points of the port for a driver: one forward of the flagship model,
and a dry run of the multi-process paths (port of ``__graft_entry__.py``).

    python -c "import macvo_tpu_torch.entry as e; fn, args = e.entry(); print(fn(*args)[0].shape)"
    python -c "import macvo_tpu_torch.entry as e; e.dryrun_multichip(1)"          # one card, NCCL
    python -c "import macvo_tpu_torch.entry as e; e.dryrun_multichip(2, 'cpu')"   # two CPU processes, gloo

:func:`dryrun_multichip` starts one process a device, joins them in a
``torch.distributed`` group on ``127.0.0.1`` (``nccl`` on the cards,
``gloo`` on the CPU) and runs in them the three multi-process paths: one
data-parallel ``cov`` training step, the observation-sharded solve against
the single solve, and :class:`~macvo_tpu_torch.parallel.BatchedOdometry`
with one sequence a rank. The processes join within a time limit; a process
that fails or outlives it fails the dry run.
"""

from __future__ import annotations

import time

import torch

from .utils.device import resolve_device

#: seconds the dry run's processes may take, all together, before it fails
DRYRUN_TIMEOUT_S = 120.0


def entry(device: str | torch.device = "cuda"):
    """``(fn, example_args)`` for FlowFormerCov at ``decoder_depth`` 4 on a
    1x64x96 pair: ``fn(params, image1, image2) -> (flow_final,
    normalize_cov(cov_final))``, ``params`` a state_dict of the model (the
    example's: the port's seeded ``random:0`` weights) and the images
    (1,64,96,3) in [0,1] on ``device``."""
    from .models.flowformer import FlowFormerConfig, FlowFormerCov, normalize_cov
    from .models.flowformer.weights import build_with_weights

    device = resolve_device(device)
    model = build_with_weights(lambda: FlowFormerCov(FlowFormerConfig(decoder_depth=4)), "random:0")
    model = model.to(device).eval()
    img1 = torch.zeros((1, 64, 96, 3), dtype=torch.float32, device=device)
    img2 = torch.zeros((1, 64, 96, 3), dtype=torch.float32, device=device)

    @torch.inference_mode()
    def fn(params, image1, image2):
        out = torch.func.functional_call(model, params, (image1, image2))
        return out["flow_final"], normalize_cov(out["cov_final"])

    return fn, (dict(model.state_dict()), img1, img2)


def _sharded_train_step(device: torch.device, rank: int, size: int) -> float:
    """One data-parallel ``cov`` step at 32x32, one sample a rank; the global loss."""
    from .models.flowformer import FlowFormerConfig, FlowFormerCov
    from .models.flowformer.weights import build_with_weights
    from .train import TrainConfig, create_optimizer, make_sharded_train_step

    model = build_with_weights(lambda: FlowFormerCov(FlowFormerConfig(decoder_depth=2)), "random:0").to(device)
    tcfg = TrainConfig(num_steps=100, training_mode="cov")
    step = make_sharded_train_step(model, create_optimizer(model, tcfg), tcfg, device)
    gen = torch.Generator().manual_seed(1)
    h = w = 32
    batch = {"img1": torch.rand((size, h, w, 3), generator=gen), "img2": torch.rand((size, h, w, 3), generator=gen),
             "gt_flow": torch.randn((size, h, w, 2), generator=gen),
             "flow_mask": torch.ones((size, h, w, 1), dtype=torch.bool)}
    loss = float(step(batch)["loss"])
    if not torch.isfinite(torch.tensor(loss)):
        raise AssertionError(f"non-finite training loss {loss}")
    return loss


def solve_example(n_obs: int, dtype=torch.float64, device="cpu", seed: int = 3):
    """A seeded two-frame ICP block of ``n_obs`` observations seen from a
    small random pose (the dry run's and the tests' solve)."""
    from .backend.solver import TwoFrameData
    from .geometry import camera, se3

    gen = torch.Generator().manual_seed(seed)

    def uniform(lo, hi):
        return lo + (hi - lo) * torch.rand((n_obs,), generator=gen, dtype=dtype)

    pose = se3.exp(0.05 * torch.randn((6,), generator=gen, dtype=dtype))
    pts_c = torch.stack([uniform(4.0, 20.0), uniform(-3.0, 3.0), uniform(-2.0, 2.0)], dim=1)
    K = torch.tensor([[320.0, 0, 160], [0, 320.0, 120], [0, 0, 1]], dtype=dtype)
    eye3 = (torch.eye(3, dtype=dtype) * 0.01).expand(n_obs, 3, 3)
    data = TwoFrameData(
        pose0=pose, points_w=se3.act(pose, pts_c), points_c=pts_c, kp2=camera.point_to_pixel_ned(pts_c, K),
        disp2=K[0, 0] * 0.25 / pts_c[:, 0], cov_obs_c=eye3, cov_pts_w=eye3,
        cov_kp2=(torch.eye(2, dtype=dtype) * 0.25).expand(n_obs, 2, 2),
        disp2_cov=torch.full((n_obs,), 0.25, dtype=dtype), K=K, baseline=torch.tensor(0.25, dtype=dtype),
        mask=torch.ones((n_obs,), dtype=torch.bool))
    return TwoFrameData(*(x.to(device) for x in data))


def _sharded_solve(device: torch.device, size: int) -> float:
    """Largest |pose difference| of the observation-sharded solve against the single solve."""
    from .backend.solver import solve_two_frame
    from .parallel import make_sharded_solver

    data = solve_example(8 * size + 1, device=device)
    pose_sharded = make_sharded_solver(None, "icp")(data)
    pose_single = solve_two_frame(data, graph_type="icp")
    err = float((pose_sharded - pose_single).abs().max())
    if err >= 1e-6:
        raise AssertionError(f"sharded BA diverged from the single solve: {err}")
    return err


DRYRUN_ODOMETRY = {"Odometry": {
    "args": {"num_point": 32, "edgewidth": 4, "match_cov_default": 0.25, "profile": False, "mapping": False},
    "frontend": {"type": "FlowFormerCovFrontend", "args": {
        "weight": "random:0", "enc_dtype": "fp32", "dec_dtype": "fp32",
        "enforce_positive_disparity": False, "decoder_depth": 1}},
    "motion": {"type": "StaticMotionModel", "args": {}},
    "keypoint": {"type": "RandomSelector", "args": {"mask_width": 8}},
    "mappoint": {"type": "RandomSelector", "args": {"mask_width": 8}},
    "outlier": {"type": "CovarianceSanityFilter", "args": {}},
    "cov": {"obs": {"type": "MatchCovariance", "args": {
        "kernel_size": 7, "match_cov_default": 0.25, "min_flow_cov": 0.25, "min_depth_cov": 0.05}}},
    "postprocess": {"type": "PoseInterpolate", "args": {}},
    "keyframe": {"type": "AllKeyframe", "args": {}},
    "optimizer": {"type": "Local_TwoFrame_PGO", "args": {"graph_type": "icp", "parallel": True, "capacity": 64}},
}}


def _batched_odometry(device: torch.device, size: int) -> tuple[float, float]:
    """frames/s of BatchedOdometry at 64x96 (decoder_depth 1): one sequence
    on one rank alone, then ``size`` sequences over the ranks, one a rank."""
    import torch.distributed as dist

    from .data.datasets.synthetic import SyntheticStereo
    from .parallel import BatchedOdometry, make_mesh
    from .utils.config import build_dynamic_config

    cfg, _ = build_dynamic_config(DRYRUN_ODOMETRY)
    n_frames, hh, ww = 8, 64, 96

    def frames(seed):
        seq = SyntheticStereo({"n_frames": n_frames, "width": ww, "height": hh, "fx": ww / 2.0, "fy": ww / 2.0,
                               "seed": seed})
        return [seq[i].to(device) for i in range(n_frames)]

    def run(n_seq: int, mesh) -> float:
        seqs = [frames(7 + i) for i in range(n_seq)]
        driver = BatchedOdometry(cfg, n_sequences=n_seq, mesh=mesh, device=device)
        driver.step([s[0] for s in seqs])
        driver.step([s[1] for s in seqs])
        dist.barrier()
        t0 = time.perf_counter()
        for i in range(2, n_frames):
            driver.step([s[i] for s in seqs])
        driver.finish()
        if device.type == "cuda":
            torch.cuda.synchronize()
        dist.barrier()
        return n_seq * (n_frames - 2) / (time.perf_counter() - t0)

    fps_1 = run(1, None)
    fps_n = run(size, make_mesh((size,), ("data",), device=device))
    return fps_1, fps_n


def _dryrun_worker(rank: int, size: int, device: torch.device) -> dict:
    import torch.distributed as dist

    loss = _sharded_train_step(device, rank, size)
    err = _sharded_solve(device, size)
    fps_1, fps_n = _batched_odometry(device, size)
    return {"loss": loss, "solve_max_abs_diff": err, "frames_per_s_1seq": fps_1, "frames_per_s_nseq": fps_n,
            "ranks": size, "backend": dist.get_backend()}


def dryrun_multichip(n_devices: int, device: str | torch.device = "cuda",
                     timeout_s: float = DRYRUN_TIMEOUT_S) -> dict:
    """Run the multi-process paths in ``n_devices`` processes (one a card, or
    CPU processes with ``device="cpu"``); returns rank 0's record and prints
    its summary. Raises if a process fails or the run outlives ``timeout_s``."""
    from .parallel.mesh import spawn_group

    device = resolve_device(device)
    if device.type == "cuda" and torch.cuda.device_count() < n_devices:
        raise RuntimeError(f"need {n_devices} cards, have {torch.cuda.device_count()}")
    rec = spawn_group(_dryrun_worker, n_devices, device=device, timeout_s=timeout_s)[0]
    print(f"dryrun_multichip({n_devices}): one sharded train step OK, loss={rec['loss']:.4f}; "
          f"obs-sharded BA matches the single solve (|diff|={rec['solve_max_abs_diff']:.2e}); "
          f"batched odometry {rec['frames_per_s_nseq']:.2f} frames/s over {n_devices} sequences "
          f"(1 sequence alone {rec['frames_per_s_1seq']:.2f}) on {rec['backend']}", flush=True)
    return rec
