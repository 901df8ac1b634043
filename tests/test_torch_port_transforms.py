"""Parity of the port's training data with the JAX package: the frame
transforms (``macvo_tpu_torch/data/transform.py``), ``RandomizedStereo``
and the training batches (``data/datasets/train.py``, the runner's
single-sequence batches).

Everything here is host numpy with the same arithmetic on both sides, so the
comparisons are exact (bit for bit) unless a test says otherwise. The
counterparts of ``tests/test_randomized.py`` close the file.
"""

from pathlib import Path

import ml_dtypes
import numpy as np
import pytest
import torch

from macvo_tpu.data import transform as jtransform
from macvo_tpu.data.datasets.randomized import RandomizedStereo as JRandomized
from macvo_tpu.data.datasets.synthetic import SyntheticStereo as JSynthetic
from macvo_tpu.data.datasets.tartanair import TartanAirV2 as JTartanAirV2
from macvo_tpu.data.datasets.train import TrainPairDataset as JTrainPairDataset
from macvo_tpu.data.datasets.train import make_eval_pairs as j_make_eval_pairs
from macvo_tpu.train.run import make_pair_batches as j_make_pair_batches
from macvo_tpu_torch.data import StereoData, StereoFrame, transform
from macvo_tpu_torch.data.datasets.randomized import RandomizedStereo
from macvo_tpu_torch.data.datasets.synthetic import SyntheticStereo
from macvo_tpu_torch.data.datasets.train import TrainPairDataset, make_eval_pairs, upcast_batch
from macvo_tpu_torch.train.run import make_pair_batches

ROOT = Path(__file__).parent.parent
CLIP = {"root": str(ROOT / "assets/test_sequence/TartanAir2_abs_P000"), "compressed": True,
        "gtFlow": True, "gtDepth": True, "gtPose": True}
FIELDS = ("imageL", "imageR", "gt_flow", "flow_mask", "gt_depth")


def _np(x):
    return None if x is None else (x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x))


def assert_frames_equal(ours, ref):
    """Every dense field, K, baseline, pose and index equal bit for bit."""
    np.testing.assert_array_equal(ours.idx, ref.idx)
    for name in FIELDS:
        a, b = _np(getattr(ours.stereo, name)), _np(getattr(ref.stereo, name))
        assert (a is None) == (b is None), name
        if a is not None:
            assert a.dtype == b.dtype and a.shape == b.shape, (name, a.dtype, b.dtype, a.shape, b.shape)
            np.testing.assert_array_equal(a, b, err_msg=name)
    for name in ("K", "baseline", "T_BS", "time_ns"):
        np.testing.assert_array_equal(np.asarray(getattr(ours.stereo, name)), np.asarray(getattr(ref.stereo, name)))
    np.testing.assert_array_equal(_np(ours.gt_pose), _np(ref.gt_pose))


def to_port(frame, index=None):
    """The port's frame holding the same numbers as a JAX package frame."""
    s = frame.stereo
    return StereoFrame(idx=np.asarray(frame.idx) if index is None else np.array([index]),
                       gt_pose=None if frame.gt_pose is None else np.asarray(frame.gt_pose),
                       stereo=StereoData(T_BS=np.asarray(s.T_BS), K=np.asarray(s.K), baseline=np.asarray(s.baseline),
                                         time_ns=np.asarray(s.time_ns),
                                         **{k: None if getattr(s, k) is None else torch.from_numpy(np.array(getattr(s, k)))
                                            for k in FIELDS}))


@pytest.fixture(scope="module")
def clip_frames():
    """Frame 1 of the real clip (float flow mask, depth) as the JAX package
    loads it, and the same numbers as the port's frame."""
    ref = JTartanAirV2(CLIP)[1]
    ours = to_port(ref)
    assert_frames_equal(ours, ref)
    return ours, ref


def test_transforms_register_the_same_names():
    assert set(transform.IDataTransform.registered()) == set(jtransform.IDataTransform.registered())


@pytest.mark.parametrize("name,args", [
    ("ScaleFrame", {"scale_u": 2.0, "scale_v": 2.0}),
    ("ScaleFrame", {"scale_u": 3.0, "scale_v": 1.5, "interp": "nearest"}),
    ("CenterCropFrame", {"width": 320, "height": 240}),
    ("SmartResizeFrame", {"width": 200, "height": 120}),
    ("SmartResizeFrame", {"width": 96, "height": 160, "interp": "nearest"}),
    ("AddImageNoise", {"stdv": 0.0196}),
    ("CastDataType", {"dtype": "float32"}),
    ("CastDataType", {"dtype": "float16"}),
])
def test_transform_matches_jax_bit_for_bit(clip_frames, name, args):
    ours_in, ref_in = clip_frames
    transform.IDataTransform.is_valid_config(_ns({"type": name, "args": _ns(args)}))
    ours = transform.IDataTransform.instantiate(name, args)(ours_in)
    ref = jtransform.IDataTransform.instantiate(name, args)(ref_in)
    assert_frames_equal(ours, ref)


def test_cast_to_bfloat16_rounds_as_ml_dtypes(clip_frames):
    """Round to nearest even on both sides: the same 16 bits."""
    ours_in, ref_in = clip_frames
    ours = transform.CastDataType({"dtype": "bfloat16"})(ours_in)
    ref = jtransform.CastDataType({"dtype": "bfloat16"})(ref_in)
    for name in ("imageL", "imageR"):
        a = getattr(ours.stereo, name)
        b = np.asarray(getattr(ref.stereo, name))
        assert a.dtype == torch.bfloat16 and b.dtype == ml_dtypes.bfloat16
        np.testing.assert_array_equal(a.view(torch.int16).numpy(), b.view(np.int16))
    assert ours.stereo.gt_flow is ours_in.stereo.gt_flow


def test_add_image_noise_is_seeded_by_the_frame_index(clip_frames):
    ours_in, _ = clip_frames
    t = transform.AddImageNoise({"stdv": 0.05})
    a, b = t(ours_in), t(ours_in)
    torch.testing.assert_close(a.stereo.imageL, b.stereo.imageL, rtol=0, atol=0)
    other = transform.AddImageNoise({"stdv": 0.05})(to_port(clip_frames[1], index=2))
    assert not np.allclose(_np(a.stereo.imageL - ours_in.stereo.imageL),
                           _np(other.stereo.imageL - ours_in.stereo.imageL))


def test_photometric_jitter_ranges_and_untouched_ground_truth(clip_frames):
    """Unseeded draws (as in JAX): outputs stay float32 in [0,1], the ground
    truth and calibration are the very same objects, two calls differ, and
    with strength 0 the jitter is the identity up to the 1e-4 floor."""
    ours_in, _ = clip_frames
    out1 = transform.PhotometricJitter({"strength": 1.0})(ours_in)
    out2 = transform.PhotometricJitter({"strength": 1.0})(ours_in)
    for out in (out1, out2):
        for name in ("imageL", "imageR"):
            img = getattr(out.stereo, name)
            assert img.dtype == torch.float32 and img.shape == ours_in.stereo.imageL.shape
            assert float(img.min()) >= 0.0 and float(img.max()) <= 1.0
        for name in ("gt_flow", "flow_mask", "gt_depth"):
            assert getattr(out.stereo, name) is getattr(ours_in.stereo, name)
        assert out.stereo.K is ours_in.stereo.K and out.gt_pose is ours_in.gt_pose
    assert not torch.equal(out1.stereo.imageL, out2.stereo.imageL)
    assert not torch.equal(out1.stereo.imageL, out1.stereo.imageR)   # each image draws its own
    ident = transform.PhotometricJitter({"strength": 0.0})(ours_in)
    np.testing.assert_array_equal(_np(ident.stereo.imageL), np.clip(_np(ours_in.stereo.imageL), 1e-4, 1.0))
    with pytest.raises(ValueError):
        transform.PhotometricJitter.is_valid_config(_ns({"strength": 3.0}))


def test_center_crop_larger_than_the_image_raises(clip_frames):
    with pytest.raises(ValueError):
        transform.CenterCropFrame({"width": 700, "height": 64})(clip_frames[0])


def _ns(d):
    from types import SimpleNamespace

    return SimpleNamespace(**d)


RANDOMIZED = {"n_frames": 3, "width": 96, "height": 64, "fx": 48.0, "fy": 48.0, "seed": 5}


@pytest.mark.parametrize("cfg", [RANDOMIZED, dict(RANDOMIZED, supersample=2, seed=8)])
def test_randomized_stereo_matches_jax_bit_for_bit(cfg):
    ours, ref = RandomizedStereo(dict(cfg)), JRandomized(dict(cfg))
    assert len(ours) == len(ref) == 3
    np.testing.assert_array_equal(ours.poses, ref.poses)
    for i in range(3):
        assert_frames_equal(ours[i], ref[i])
    assert ours[2].stereo.gt_flow is None            # the last frame has no successor


SYNTH = [{"type": "SyntheticStereo",
          "args": {"n_frames": 4, "width": 96, "height": 64, "fx": 48.0, "fy": 48.0, "seed": s}}
         for s in (1, 2)]
MIXTURE = SYNTH + [{"type": "RandomizedStereo", "args": RANDOMIZED}]
NOISE = [{"type": "AddImageNoise", "args": {"stdv": 0.01}}]


@pytest.mark.parametrize("stereo_prob", [0.0, 0.5])
def test_train_pair_batches_match_jax_bit_for_bit(stereo_prob):
    """The mixture, the noise transform, the stereo draws and the random crops:
    three batches of the stream, every array equal in dtype and bits."""
    ours = TrainPairDataset(MIXTURE, transforms=NOISE, stereo_prob=stereo_prob)
    ref = JTrainPairDataset(MIXTURE, transforms=NOISE, stereo_prob=stereo_prob)
    assert len(ours) == len(ref) == 8
    it_o, it_r = ours.batches(3, 48, 64, seed=9), ref.batches(3, 48, 64, seed=9)
    for _ in range(3):
        a, b = next(it_o), next(it_r)
        assert set(a) == set(b) == {"img1", "img2", "gt_flow", "flow_mask"}
        for k in a:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    it_o.close()
    it_r.close()


def test_eval_pairs_and_single_sequence_batches_match_jax_bit_for_bit():
    args = SYNTH[0]["args"]
    ours = make_eval_pairs(SyntheticStereo(dict(args)), 48, 64, max_frames=2)
    ref = j_make_eval_pairs(JSynthetic(dict(args)), 48, 64, max_frames=2)
    assert len(ours) == len(ref) == 4
    for a, b in zip(ours, ref):
        assert set(a) == set(b)
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    it_o = make_pair_batches(SyntheticStereo(dict(args)), 2, 48, 64, np.random.default_rng(4))
    it_r = j_make_pair_batches(JSynthetic(dict(args)), 2, 48, 64, np.random.default_rng(4))
    for _ in range(2):
        a, b = next(it_o), next(it_r)
        assert set(a) == set(b)
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_upcast_batch_restores_float32():
    rng = np.random.default_rng(0)
    batch = {"img1": rng.integers(0, 256, (1, 4, 6, 3), dtype=np.uint8),
             "img2": rng.random((1, 4, 6, 3)).astype(np.float32),
             "gt_flow": rng.normal(size=(1, 4, 6, 2)).astype(np.float16),
             "flow_mask": np.ones((1, 4, 6, 1), bool)}
    out = upcast_batch(batch, "cpu")
    assert out["img1"].dtype == torch.float32
    np.testing.assert_array_equal(out["img1"].numpy(), batch["img1"].astype(np.float32) / 255.0)
    np.testing.assert_array_equal(out["img2"].numpy(), batch["img2"])
    np.testing.assert_array_equal(out["gt_flow"].numpy(), batch["gt_flow"].astype(np.float32))
    assert out["flow_mask"].dtype == torch.bool


def test_train_pair_dataset_mixture():
    """Counterpart of tests/test_train.py::test_train_pair_dataset_mixture."""
    ds = TrainPairDataset(SYNTH, transforms=[{"type": "AddImageNoise", "args": {"stdv": 0.01}}])
    assert len(ds) == 6
    f0, _ = ds.get_pair(0)
    assert f0.stereo.imageL.shape == (1, 64, 96, 3)
    it = ds.batches(batch_size=2, height=48, width=64, seed=0)
    b = next(it)
    assert b["img1"].shape == (2, 48, 64, 3) and b["gt_flow"].shape == (2, 48, 64, 2)
    b2 = next(it)
    assert not np.allclose(b["img1"], b2["img1"])
    it.close()
    ev = make_eval_pairs(SyntheticStereo(dict(SYNTH[0]["args"])), 48, 64, max_frames=2)
    assert len(ev) == 4 and ev[0]["img1"].shape == (1, 48, 64, 3)
    assert ev[1]["gt_flow"][..., 0].max() < 0
    assert np.abs(ev[1]["gt_flow"][..., 1]).max() == 0


# -- counterparts of tests/test_randomized.py, on the port ----------------------


@pytest.fixture(scope="module")
def seq():
    return RandomizedStereo({"n_frames": 3, "width": 256, "height": 192, "fx": 128.0, "fy": 128.0, "seed": 3})


def _bilinear(img, u, v):
    H, W = img.shape[:2]
    u0 = np.clip(np.floor(u).astype(int), 0, W - 2)
    v0 = np.clip(np.floor(v).astype(int), 0, H - 2)
    fu, fv = u - u0, v - v0
    return (img[v0, u0] * ((1 - fu) * (1 - fv))[..., None] + img[v0, u0 + 1] * (fu * (1 - fv))[..., None]
            + img[v0 + 1, u0] * ((1 - fu) * fv)[..., None] + img[v0 + 1, u0 + 1] * (fu * fv)[..., None])


def test_randomized_shapes_and_ranges(seq):
    s = seq[0].stereo
    assert s.imageL.shape == (1, 192, 256, 3) and s.gt_depth.shape == (1, 192, 256, 1)
    assert s.gt_flow.shape == (1, 192, 256, 2)
    assert 0.0 <= float(s.imageL.min()) and float(s.imageL.max()) <= 1.0
    assert float(s.flow_mask.float().mean()) > 0.5
    assert torch.isfinite(s.gt_flow).all()


def test_randomized_flow_photometric_consistency(seq):
    imgA, imgB = seq[0].stereo.imageL[0].numpy(), seq[1].stereo.imageL[0].numpy()
    flow = seq[0].stereo.gt_flow[0].numpy()
    valid = seq[0].stereo.flow_mask[0, ..., 0].numpy() > 0.5
    H, W = imgA.shape[:2]
    u, v = np.meshgrid(np.arange(W, dtype=np.float64), np.arange(H, dtype=np.float64))
    err = np.abs(_bilinear(imgB, u + flow[..., 0], v + flow[..., 1]) - imgA).mean(-1)
    assert float(err[valid].mean()) < 0.035
    assert err[valid].mean() < 0.5 * np.abs(imgB - imgA).mean(-1)[valid].mean()


def test_randomized_stereo_disparity_consistency(seq):
    s = seq[0].stereo
    imgL, imgR, depth = s.imageL[0].numpy(), s.imageR[0].numpy(), s.gt_depth[0, ..., 0].numpy()
    disp = 128.0 * 0.25 / np.maximum(depth, 1e-6)
    H, W = imgL.shape[:2]
    u, v = np.meshgrid(np.arange(W, dtype=np.float64), np.arange(H, dtype=np.float64))
    us = u - disp
    inb = (us >= 0) & (us <= W - 1) & (depth < 1e4)
    err = np.abs(_bilinear(imgR, us, v) - imgL).mean(-1)
    assert float(np.median(err[inb])) < 0.02


def test_randomized_depth_statistics_outdoor(seq):
    d = seq[0].stereo.gt_depth[0, ..., 0].numpy()
    assert (d < 60).mean() > 0.2 and (d > 1000).mean() > 0.05


def test_randomized_seed_determinism_and_diversity():
    a1 = RandomizedStereo({"n_frames": 2, "width": 64, "height": 48, "seed": 11})
    a2 = RandomizedStereo({"n_frames": 2, "width": 64, "height": 48, "seed": 11})
    b = RandomizedStereo({"n_frames": 2, "width": 64, "height": 48, "seed": 12})
    torch.testing.assert_close(a1[0].stereo.imageL, a2[0].stereo.imageL, rtol=0, atol=0)
    assert float((a1[0].stereo.imageL - b[0].stereo.imageL).abs().mean()) > 0.01
