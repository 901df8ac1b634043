"""The port's CUDA kernels on the card, against their plain versions.

This file imports no JAX, so it runs on a machine with a card and no JAX:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_port_kernels_cuda.py

(``--noconftest`` skips tests/conftest.py, which configures JAX.) Every test
is marked ``cuda`` and skips, from inside its fixture, where there is no card.
"""

import numpy as np
import pytest
import torch

from macvo_tpu_torch.ops import correlation, latent_attn


def _inputs(n, t, seed=7):
    rng = np.random.default_rng(seed)
    shapes = [((n, t, 64), 1.0), ((64, 128), 0.1), ((128,), 0.1), ((64, 128), 0.1), ((128,), 0.1),
              ((8, 128), 1.0), ((128, 128), 0.1), ((8, 128), 1.0)]
    return [(rng.normal(size=s) * k).astype(np.float32) for s, k in shapes]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n,t", [(12800, 100), (37, 1), (5, 333), (3, 512), (1001, 100), (131, 17),
                                 (4606, 78), (9212, 78), (5640, 96)])
@pytest.mark.parametrize("dtype,atol,rtol", [(torch.float32, 1e-4, 1e-4), (torch.bfloat16, 1e-2, 1.6e-2)])
def test_latent_attn_kernel_matches_plain(cuda_device, n, t, dtype, atol, rtol):
    """Kernel vs plain version; (12800, 100) is the 640x640 shape, (4606, 78)
    and (9212, 78) a KITTI frame at 376x780 (depth, pair), (5640, 96) a EuRoC
    frame at 480x752. fp32: the
    folded form sums in another order (1e-4). bf16 output: at most two bf16
    roundings apart (rtol 2^-6)."""
    args = [torch.from_numpy(a).to(cuda_device) for a in _inputs(n, t)]
    args[0] = args[0].to(dtype)
    before = latent_attn.latent_cross_attention.launches
    out = latent_attn.latent_cross_attention(*args)
    torch.cuda.synchronize()
    assert latent_attn.latent_cross_attention.launches == before + 1
    assert out.dtype == dtype and out.shape == (n, 8, 128)
    ref = latent_attn.latent_cross_attention_torch(*args)
    torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=rtol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol,rtol", [(torch.float32, 1e-4, 1e-4), (torch.bfloat16, 1e-2, 1.6e-2)])
def test_latent_attn_folded_entry_launches_the_kernel(cuda_device, dtype, atol, rtol):
    """The entry the cost perceiver calls, with weights folded beforehand, at
    the 640x640 shape: one launch, the plain version's result (tolerances as
    above)."""
    args = [torch.from_numpy(a).to(cuda_device) for a in _inputs(12800, 100)]
    args[0] = args[0].to(dtype)
    folded = latent_attn.fold_weights(*args[1:])
    before = latent_attn.latent_cross_attention.launches
    out = latent_attn.latent_attn_folded(args[0], *folded)
    torch.cuda.synchronize()
    assert latent_attn.latent_cross_attention.launches == before + 1
    ref = latent_attn.latent_cross_attention_torch(*args)
    torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=rtol)
    with pytest.raises(TypeError):
        latent_attn.latent_attn_folded(args[0], folded[0].double(), *folded[1:])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol,rtol", [(torch.float32, 1e-4, 1e-4), (torch.bfloat16, 1e-2, 1.6e-2)])
def test_latent_attn_kernel_agrees_in_every_run(cuda_device, dtype, atol, rtol):
    """The folded entry 40 times at the 640x640 shape (N = 12,800, T = 100):
    every run agrees with the plain version (tolerances as above) and is
    bit-identical to the first. A pixel's sums run in a fixed order whatever
    warp takes it, so any difference between runs is a race between the warps
    that share a pixel or a ring slot."""
    args = [torch.from_numpy(a).to(cuda_device) for a in _inputs(12800, 100, seed=11)]
    args[0] = args[0].to(dtype)
    folded = latent_attn.fold_weights(*args[1:])
    ref = latent_attn.latent_cross_attention_torch(*args).float()
    first = latent_attn.latent_attn_folded(args[0], *folded)
    for _ in range(39):
        out = latent_attn.latent_attn_folded(args[0], *folded)
        torch.testing.assert_close(out.float(), ref, atol=atol, rtol=rtol)
        assert torch.equal(out, first)
    torch.testing.assert_close(first.float(), ref, atol=atol, rtol=rtol)


@pytest.mark.cuda
def test_latent_attn_kernel_rejects_what_it_cannot_take(cuda_device):
    args = [torch.from_numpy(a).to(cuda_device) for a in _inputs(8, 4)]
    with pytest.raises(ValueError):
        latent_attn.latent_cross_attention(args[0][:, :, :32], *args[1:])
    with pytest.raises(ValueError):
        latent_attn.latent_cross_attention(args[0].transpose(0, 1), *args[1:])
    with pytest.raises(ValueError):
        latent_attn.latent_cross_attention(torch.zeros(2, latent_attn.MAX_TOKENS + 1, 64, device=cuda_device),
                                           *args[1:])
    with pytest.raises(TypeError):
        latent_attn.latent_cross_attention(args[0].half(), *args[1:])


@pytest.mark.cuda
def test_latent_attn_kernel_rejects_inputs_that_require_grad(cuda_device):
    """The kernel is forward-only: both entries raise on a tensor that requires
    grad (tokens or a weight) and launch nothing; the perceiver trains through
    its unfused input stage instead."""
    args = [torch.from_numpy(a).to(cuda_device) for a in _inputs(8, 4)]
    folded = latent_attn.fold_weights(*args[1:])
    before = latent_attn.latent_cross_attention.launches
    with pytest.raises(RuntimeError, match="grad"):
        latent_attn.latent_cross_attention(args[0].clone().requires_grad_(), *args[1:])
    with pytest.raises(RuntimeError, match="grad"):
        latent_attn.latent_cross_attention(args[0], args[1].clone().requires_grad_(), *args[2:])
    with pytest.raises(RuntimeError, match="grad"):
        latent_attn.latent_attn_folded(args[0].clone().requires_grad_(), *folded)
    with pytest.raises(RuntimeError, match="grad"):
        latent_attn.latent_attn_folded(args[0], folded[0].clone().requires_grad_(), *folded[1:])
    assert latent_attn.latent_cross_attention.launches == before
    with torch.no_grad():
        latent_attn.latent_attn_folded(args[0], *folded)
    assert latent_attn.latent_cross_attention.launches == before + 1


# The 640x640 PWC forward calls the correlation at these (B, C, H, W), plus an odd shape.
CORR_SHAPES = [(1, 32, 160, 160), (1, 64, 80, 80), (1, 96, 40, 40), (1, 128, 20, 20), (1, 196, 10, 10),
               (2, 48, 37, 53)]
# Shapes for each channel split (cluster size) the wrapper picks on a 132-SM H100, with W
# not a multiple of the 4-pixel run or the 32-pixel tile, C not a multiple of the
# 8-channel chunk, and B = 2.
CORR_SPLITS = [((1, 20, 150, 150), 1), ((1, 20, 96, 150), 2), ((1, 44, 70, 75), 4), ((2, 60, 21, 45), 4),
               ((1, 100, 9, 13), 8), ((2, 3, 5, 7), 1)]


def _corr_inputs(shape, device, seed=3):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(device) for _ in range(2)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", CORR_SHAPES)
def test_correlation_kernel_matches_plain(cuda_device, shape):
    """Kernel vs plain version, one launch each: fp32 channel sums in another
    order (1e-5)."""
    f1, f2 = _corr_inputs(shape, cuda_device)
    before = correlation.local_correlation.launches
    out = correlation.local_correlation(f1, f2)
    torch.cuda.synchronize()
    assert correlation.local_correlation.launches == before + 1
    assert out.shape == (shape[0], 81, shape[2], shape[3])
    torch.testing.assert_close(out, correlation.local_correlation_torch(f1, f2), atol=1e-5, rtol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,split", CORR_SPLITS)
def test_correlation_kernel_matches_plain_at_each_split(cuda_device, shape, split):
    """Each channel split the wrapper chooses, at shapes off every multiple the
    kernel works in: one launch, the plain version's result (1e-5)."""
    assert correlation.cluster_size(*shape, sms=132) == split
    f1, f2 = _corr_inputs(shape, cuda_device)
    before = correlation.local_correlation.launches
    out = correlation.local_correlation(f1, f2)
    torch.cuda.synchronize()
    assert correlation.local_correlation.launches == before + 1
    torch.testing.assert_close(out, correlation.local_correlation_torch(f1, f2), atol=1e-5, rtol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,split", [((1, 32, 160, 160), 1), ((1, 64, 80, 80), 4), ((1, 96, 40, 40), 8),
                                         ((1, 128, 20, 20), 8), ((1, 196, 10, 10), 8), ((2, 48, 37, 53), 4),
                                         ((1, 12, 10, 10), 1), ((64, 196, 10, 10), 1)])
def test_channel_split_fills_a_132_sm_card(cuda_device, shape, split):
    """The launcher's channel split (cluster size), as the built library reports
    it, for the five shapes of a 640x640 PWC forward on a 132-SM H100, the odd
    shape, too few channels to split (12 < 2 chunks) and a batch large enough to
    fill the card alone."""
    assert correlation.cluster_size(*shape, sms=132) == split


@pytest.mark.cuda
def test_correlation_kernel_rejects_what_it_cannot_take(cuda_device):
    f1, f2 = _corr_inputs((1, 16, 12, 20), cuda_device)
    before = correlation.local_correlation.launches
    with pytest.raises(TypeError):
        correlation.local_correlation(f1.double(), f2.double())
    with pytest.raises(TypeError):
        correlation.local_correlation(f1.half(), f2.half())
    with pytest.raises(ValueError):
        correlation.local_correlation(f1.transpose(2, 3), f2.transpose(2, 3))
    with pytest.raises(ValueError):
        correlation.local_correlation(f1, f2, radius=3)
    with pytest.raises(ValueError):
        correlation.local_correlation(f1, f2[:, :8])
    with pytest.raises(RuntimeError):
        correlation.local_correlation(f1.requires_grad_(), f2)
    assert correlation.local_correlation.launches == before


@pytest.mark.cuda
def test_pwc_forward_launches_the_correlation_five_times(cuda_device):
    """One PWC forward at 128x192 runs the kernel once per decoded level and
    agrees with the same network on the CPU (TF32 off; cuDNN sums in another
    order: 1e-4 relative)."""
    from pathlib import Path

    from macvo_tpu_torch.models.flowformer import load_flax_checkpoint
    from macvo_tpu_torch.models.tartanvo import PWCFlowNet

    torch.backends.cudnn.allow_tf32 = False
    model = PWCFlowNet().eval()
    load_flax_checkpoint(model, Path(__file__).parent.parent / "model" / "TartanVO_flow.npz")
    rng = np.random.default_rng(5)
    imgs = [torch.from_numpy(rng.normal(size=(1, 128, 192, 3)).astype(np.float32)) for _ in range(2)]
    with torch.inference_mode():
        ref = model(*imgs)
        model.to(cuda_device)
        before = correlation.local_correlation.launches
        out = model(*(x.to(cuda_device) for x in imgs))
        torch.cuda.synchronize()
    assert correlation.local_correlation.launches == before + 5
    torch.testing.assert_close(out.cpu(), ref, atol=1e-4 * float(ref.abs().max()), rtol=1e-4)


@pytest.mark.cuda
def test_macvo_with_tartan_motion_net_runs_on_the_card(cuda_device):
    """MAC-VO with the TartanMotionNet motion model (Paper_Reproduce.yaml's
    block) and the Performant frontend at 2 decoder steps, 3 frames of a
    192x192 crop of the real clip, on the card: the pose net and the pose
    chain stay on the card (the device-chained backend hands it card poses),
    and every pose is finite."""
    import dataclasses
    from pathlib import Path

    from macvo_tpu_torch.data import DevicePrefetcher
    from macvo_tpu_torch.data.datasets.tartanair import TartanAirV2
    from macvo_tpu_torch.modules.frontend_tartanvo import TartanMotionNet
    from macvo_tpu_torch.odometry import MACVO
    from macvo_tpu_torch.utils.config import load_config

    root = Path(__file__).parent.parent
    cfg = load_config(root / "configs/experiment/macvo/MACVO_Performant.yaml")[0]
    cfg.Odometry.frontend.args.weight = str(root / "model/MACVO_FrontendCov.npz")
    cfg.Odometry.frontend.args.decoder_depth = 2
    cfg.Odometry.args.num_point = 64
    cfg.Odometry.args.num_map_point = 128
    cfg.Odometry.motion = load_config(root / "configs/experiment/macvo/Paper_Reproduce.yaml")[0].Odometry.motion
    cfg.Odometry.motion.args.weight = str(root / "model/TartanVO_posenet.npz")
    seq = TartanAirV2({"root": str(root / "assets/test_sequence/TartanAir2_abs_P000"), "compressed": True,
                       "gtFlow": False, "gtDepth": False, "gtPose": True})

    def crop(f, size=192):
        s = f.stereo
        y0, x0 = (s.height - size) // 2, (s.width - size) // 2
        K = s.K.copy()
        K[:, 0, 2] -= x0
        K[:, 1, 2] -= y0
        cut = (lambda x: x[:, y0:y0 + size, x0:x0 + size].contiguous())
        return dataclasses.replace(f, stereo=dataclasses.replace(s, K=K, imageL=cut(s.imageL), imageR=cut(s.imageR)))

    odom = MACVO.from_config(cfg, device=cuda_device)
    assert isinstance(odom.MotionEstimator, TartanMotionNet) and odom.MotionEstimator.device.type == "cuda"
    odom.receive_frames(DevicePrefetcher([crop(seq[i]) for i in range(3)], cuda_device))
    poses = odom.graph.frames.data["pose"][:3]
    assert len(odom.graph.frames) == 3 and np.isfinite(poses).all()
    assert odom.MotionEstimator.prev_pose.device.type == "cuda"


@pytest.mark.cuda
def test_macvo_on_a_kitti_layout_runs_on_the_card(cuda_device, tmp_path):
    """The runner's sequence on the first 3 frames of the clip written as a
    KITTI layout: MACVO_Performant's shipped Preprocess takes them to 376x780,
    the frontend (2 decoder steps) pads them to 376x784 and launches the fp32
    kernel once a frame on 4,606 or 9,212 pixels; every pose is finite."""
    from pathlib import Path

    import chip_smoke
    from macvo_tpu_torch.__main__ import build_sequence
    from macvo_tpu_torch.data import DevicePrefetcher
    from macvo_tpu_torch.odometry import MACVO
    from macvo_tpu_torch.utils.config import build_dynamic_config, load_config

    root = Path(__file__).parent.parent
    clip = chip_smoke.read_clip(3)
    seq_root = chip_smoke.write_kitti_layout(tmp_path, clip["left"], clip["right"], chip_smoke.CLIP_K,
                                             chip_smoke.CLIP_BASELINE, clip["times_s"], clip["poses"])
    cfg = load_config(root / "configs/experiment/macvo/MACVO_Performant.yaml")[0]
    cfg.Odometry.frontend.args.weight = str(root / "model/MACVO_FrontendCov.npz")
    cfg.Odometry.frontend.args.decoder_depth = 2
    data = build_dynamic_config({"Sequence": {"type": "KITTI", "args": {"root": str(seq_root), "gt_pose": True}}})[0]
    seq = build_sequence(data, cfg)
    assert seq[0].stereo.imageL.shape == (1, 376, 780, 3)
    odom = MACVO.from_config(cfg, device=cuda_device)
    latent_attn.reset_launches()
    odom.receive_frames(DevicePrefetcher(seq, cuda_device))
    assert latent_attn.latent_cross_attention.launches_by_dtype == {"fp32": 3, "bf16": 0}
    poses = odom.graph.frames.data["pose"][:3]
    assert len(odom.graph.frames) == 3 and np.isfinite(poses).all()


def _train_setup(cuda_device, mode, dtype, lr=1e-4):
    """FlowFormerCov (2 decoder steps, full widths) from the shipped checkpoint
    on the card, the mode's optimizer and step, and a seeded 64x96 batch."""
    from pathlib import Path

    from macvo_tpu_torch.models.flowformer import FlowFormerConfig, FlowFormerCov, load_flax_checkpoint
    from macvo_tpu_torch.train.step import TrainConfig, create_optimizer, make_train_step, set_matmul_precision

    model = FlowFormerCov(FlowFormerConfig(decoder_depth=2, encoder_dtype=dtype, decoder_dtype=dtype))
    load_flax_checkpoint(model, Path(__file__).parent.parent / "model" / "MACVO_FrontendCov.npz")
    model.to(cuda_device)
    set_matmul_precision(model)
    cfg = TrainConfig(lr=lr, num_steps=10, training_mode=mode)
    opt = create_optimizer(model, cfg)
    rng = np.random.default_rng(6)
    batch = {"img1": rng.integers(0, 256, (2, 64, 96, 3), dtype=np.uint8),
             "img2": rng.integers(0, 256, (2, 64, 96, 3), dtype=np.uint8),
             "gt_flow": rng.normal(0, 2, (2, 64, 96, 2)).astype(np.float16),
             "flow_mask": rng.random((2, 64, 96, 1)) > 0.1}
    return model, make_train_step(model, opt, cfg, cuda_device), batch


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bf16", "fp32"])
def test_cov_step_launches_the_fused_kernel_and_keeps_the_frozen_weights(cuda_device, dtype):
    """A cov-mode step needs no gradient upstream of the covariance branch, so
    the cost perceiver runs the fused kernel, once a step, on tokens of the
    model's type; every parameter outside the branch stays bit-identical, and
    the branch moves."""
    from macvo_tpu_torch.train.step import is_trainable

    model, step, batch = _train_setup(cuda_device, "cov", dtype)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    for i in range(2):
        latent_attn.reset_launches()
        aux = step(batch)
        torch.cuda.synchronize()
        assert latent_attn.latent_cross_attention.launches_by_dtype == {"fp32": 0, "bf16": 0, dtype: 1}
        assert np.isfinite(float(aux["loss"]))
    moved = {n for n, p in model.named_parameters() if not torch.equal(before[n], p)}
    assert moved and all(is_trainable(n, "cov") for n in moved)
    assert all(torch.equal(before[n], p) for n, p in model.named_parameters() if not is_trainable(n, "cov"))


@pytest.mark.cuda
def test_flow_steps_then_the_fused_forward_matches_the_unfused_one(cuda_device):
    """Flow mode trains the perceiver through its unfused input stage (no
    kernel launch during a step). After two steps a forward without gradients
    refolds the moved weights and runs the kernel (fp32), and equals the
    unfused forward within 1e-3 px (the kernel's fp32 error, ~1e-6, through
    two decoder steps)."""
    model, step, batch = _train_setup(cuda_device, "flow", "fp32", lr=1e-3)
    perceiver = model.memory_encoder.perceiver
    folded_at_start = perceiver._folded_key
    launches = latent_attn.latent_cross_attention.launches
    for _ in range(2):
        step(batch)
    torch.cuda.synchronize()
    assert latent_attn.latent_cross_attention.launches == launches
    assert perceiver._fold_key() != folded_at_start
    x = [torch.from_numpy(batch[k]).to(cuda_device).float() / 255.0 for k in ("img1", "img2")]
    with torch.no_grad():
        fused = model(*x)
    torch.cuda.synchronize()
    assert latent_attn.latent_cross_attention.launches == launches + 1
    unfused = model(*x)
    for k in ("flow_final", "cov_final"):
        torch.testing.assert_close(fused[k], unfused[k].detach(), atol=1e-3, rtol=1e-3)
