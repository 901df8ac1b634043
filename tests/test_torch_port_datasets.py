"""Parity of the port's data layer for the user's own stereo data with the
JAX package: the KITTI, EuRoC (stereo and stereo-inertial), VBR and
GeneralStereo loaders, the shared rectification, the IMU stack, the
sequence plumbing (``smart_transform``, preload, transform), the
FlowFormerCov frontend's covariance recalibration (``cov_calib``) and its
padding, and the runner on a KITTI layout with the config's ``Preprocess``.

The layouts are written into ``tmp_path`` from crops of the real clip with
``chip_smoke.py``'s writers (VBR's here). Loaders are host numpy and cv2 on
both sides, so frames, K, baseline, ``T_BS``, times and ground truth are
compared bit for bit; interpolated ground truth (EuRoC, VBR) at the
tolerance each test states. The JAX loaders that read through its
``load_image`` (GeneralStereo, TartanAir) decode PNGs with the package's
native libpng engine where it is built, whose x/255 differs from cv2's in
the last bit (6e-8); here they take the package's cv2 path, which the port
copies.
"""

import dataclasses
import json
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch
import yaml

import chip_smoke
from macvo_tpu.data import frame as jframe
from macvo_tpu.data import imu as jimu
from macvo_tpu.data import sequence as jsequence
from macvo_tpu.data import transform as jtransform
from macvo_tpu.data.datasets import euroc as jeuroc
from macvo_tpu.data.datasets import general as jgeneral
from macvo_tpu.data.datasets import kitti as jkitti
from macvo_tpu.data.datasets import rectify as jrectify
from macvo_tpu.data.datasets import vbr as jvbr
from macvo_tpu.data.datasets.tartanair import TartanAirV2 as JTartanAirV2
from macvo_tpu_torch.data import AttitudeData, IMUData, StereoData, StereoFrame, StereoInertialFrame
from macvo_tpu_torch.data import imu as pimu
from macvo_tpu_torch.data import sequence as psequence
from macvo_tpu_torch.data.datasets import euroc as peuroc
from macvo_tpu_torch.data.datasets import general as pgeneral
from macvo_tpu_torch.data.datasets import kitti as pkitti
from macvo_tpu_torch.data.datasets import rectify as prectify
from macvo_tpu_torch.data.datasets import vbr as pvbr
from macvo_tpu_torch.data.datasets.tartanair import TartanAirV2
from macvo_tpu_torch.utils.config import build_dynamic_config, load_config

ROOT = Path(__file__).parent.parent
CKPT = ROOT / "model" / "MACVO_FrontendCov.npz"
CALIB = ROOT / "model" / "MACVO_FrontendCov_v4_candidate.calib.json"
CLIP = {"root": str(ROOT / "assets/test_sequence/TartanAir2_abs_P000"), "compressed": True,
        "gtFlow": False, "gtDepth": False, "gtPose": True}
DENSE = ("imageL", "imageR", "gt_flow", "flow_mask", "gt_depth")


def _np(x):
    return None if x is None else (x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x))


def assert_frames_equal(ours, ref, gt_atol=0.0):
    """Dense fields, K, baseline, T_BS, times and index bit for bit; the
    ground-truth pose within ``gt_atol`` (0: bit for bit)."""
    np.testing.assert_array_equal(ours.idx, ref.idx)
    for name in DENSE:
        a, b = _np(getattr(ours.stereo, name)), _np(getattr(ref.stereo, name))
        assert (a is None) == (b is None), name
        if a is not None:
            assert a.dtype == b.dtype and a.shape == b.shape, (name, a.dtype, b.dtype, a.shape, b.shape)
            np.testing.assert_array_equal(a, b, err_msg=name)
    for name in ("K", "baseline", "T_BS", "time_ns"):
        a, b = np.asarray(getattr(ours.stereo, name)), np.asarray(getattr(ref.stereo, name))
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert (ours.gt_pose is None) == (ref.gt_pose is None)
    if ours.gt_pose is not None:
        np.testing.assert_allclose(_np(ours.gt_pose), _np(ref.gt_pose), atol=gt_atol, rtol=0)


def assert_sequences_equal(ours, ref, gt_atol=0.0):
    assert type(ours).__name__ == type(ref).__name__ and len(ours) == len(ref)
    for i in range(len(ref)):
        assert_frames_equal(ours[i], ref[i], gt_atol)


@pytest.fixture(autouse=True, scope="module")
def _jax_reads_with_cv2():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr("macvo_tpu.native.decode_png", lambda *args, **kwargs: None)
        yield


@pytest.fixture(scope="module")
def clip():
    """The clip's 10 frames: a 96x128 center crop of each image (K moved to
    match), its times, NED poses and IMU."""
    c = chip_smoke.read_clip(10)
    for cam in ("left", "right"):
        c[cam] = [np.ascontiguousarray(im[272:368, 256:384]) for im in c[cam]]
    c["K"] = (320.0, 320.0, 320.0 - 256, 320.0 - 272)
    return c


# -- KITTI ------------------------------------------------------------------------------------------

@pytest.fixture(scope="module")
def kitti_root(clip, tmp_path_factory):
    return chip_smoke.write_kitti_layout(tmp_path_factory.mktemp("kitti"), clip["left"], clip["right"], clip["K"],
                                         chip_smoke.CLIP_BASELINE, clip["times_s"], clip["poses"])


@pytest.mark.parametrize("gt_pose", [True, False])
def test_kitti_matches_jax(kitti_root, gt_pose):
    cfg = {"root": str(kitti_root), "gt_pose": gt_pose}
    ours, ref = pkitti.KITTI(cfg), jkitti.KITTI(cfg)
    assert_sequences_equal(ours, ref)
    assert ours[0].stereo.imageL.shape == (1, 96, 128, 3) and ours.baseline == pytest.approx(0.25, rel=1e-12)


def test_kitti_ground_truth_is_the_clip_in_edn(kitti_root, clip):
    """poses/00.txt holds the clip's left-camera poses with EDN axes; the
    loader's T_BS (the EDN->NED roll) takes the estimate into the same frame."""
    from macvo_tpu_torch.geometry import se3_np

    seq = pkitti.KITTI({"root": str(kitti_root), "gt_pose": True})
    edn = np.stack([seq[i].gt_pose[0] for i in range(len(seq))]).astype(np.float64)
    T_BS = seq.T_BS.astype(np.float64)
    ned = se3_np.mul(se3_np.mul(se3_np.inv(T_BS), edn), T_BS)
    np.testing.assert_allclose(ned[:, :3], clip["poses"][:, :3], atol=1e-5)
    np.testing.assert_allclose(np.abs(np.sum(ned[:, 3:] * clip["poses"][:, 3:], axis=1)), 1.0, atol=1e-6)


# -- GeneralStereo ----------------------------------------------------------------------------------

@pytest.mark.parametrize("variant", ["fps", "times.txt", "pose_file"])
def test_general_stereo_matches_jax(clip, tmp_path, variant):
    root = chip_smoke.write_general_layout(
        tmp_path / "seq", clip["left"][:4], clip["right"][:4],
        times_s=clip["times_s"][:4] + 0.05 if variant == "times.txt" else None,
        poses=clip["poses"][:4] if variant == "pose_file" else None)
    fx, fy, cx, cy = clip["K"]
    cfg = {"root": str(root), "fx": fx, "fy": fy, "cx": cx, "cy": cy, "baseline": 0.25}
    if variant == "fps":
        cfg["fps"] = 7.5
    if variant == "pose_file":
        cfg["pose_file"] = str(root / "pose_lcam_front.txt")
    ours, ref = pgeneral.GeneralStereo(cfg), jgeneral.GeneralStereo(cfg)
    assert_sequences_equal(ours, ref)
    if variant == "fps":
        assert int(ours[1].stereo.time_ns[0]) == int(1e9 / 7.5)


# -- EuRoC ------------------------------------------------------------------------------------------

def _euroc_extrinsic():
    from macvo_tpu_torch.geometry import se3_np

    T = np.eye(4)
    T[:3, :3] = se3_np.quat_to_matrix(se3_np.exp(np.array([0, 0, 0, 0.002, -0.003, 0.004]))[3:])
    T[:3, 3] = (0.11, 0.0005, -0.0004)
    return T


@pytest.fixture(scope="module")
def euroc_root(clip, tmp_path_factory):
    """Five raw gray 752x480 frames; ground truth at the camera stamps, so the
    loader keeps the middle three; the clip's IMU over the same 0.4 s."""
    n, t0 = 5, chip_smoke.EUROC_T0_NS
    T_right = _euroc_extrinsic()
    raw = [chip_smoke.euroc_raw_images(l, r, clip["K"], T_right) for l, r in zip(clip["left"][:n], clip["right"][:n])]
    t_cam = t0 + np.round(clip["times_s"][:n].astype(np.float64) * 1e9).astype(np.int64)
    imu = clip["imu"]
    k = imu["imu_time"] <= 0.4 + 1e-6
    mats = chip_smoke.ned_to_edn(clip["poses"][:n])
    from macvo_tpu_torch.geometry import se3_np

    return chip_smoke.write_euroc_layout(
        tmp_path_factory.mktemp("euroc") / "MH_01", [r[0] for r in raw], [r[1] for r in raw], raw[0][2], T_right,
        t_cam, (t0 + np.round(imu["imu_time"][k] * 1e9).astype(np.int64), imu["gyro"][k], imu["acc"][k]),
        (t_cam, mats[:, :3, 3], se3_np.quat_from_matrix(mats[:, :3, :3]), imu["vel_global"][::10][:n]))


@pytest.mark.parametrize("name,gt_pose", [("EuRoC", True), ("EuRoC", False), ("EuRoC_NoIMU", True)])
def test_euroc_matches_jax(euroc_root, name, gt_pose):
    """Rectified frames and K bit for bit; the ground truth interpolated onto
    the camera stamps within 1e-12 (float64 before the float32 cast: equal)."""
    cfg = {"root": str(euroc_root), "gt_pose": gt_pose}
    ours, ref = getattr(peuroc, name)(cfg), getattr(jeuroc, name)(cfg)
    assert_sequences_equal(ours, ref, gt_atol=1e-12)
    assert len(ours) == (3 if gt_pose else 5)
    assert ours[0].stereo.imageL.shape == (1, 480, 752, 3)
    img = ours[0].stereo.imageL[0]
    assert torch.equal(img[..., 0], img[..., 1]) and torch.equal(img[..., 1], img[..., 2])   # gray, 3 channels


def test_euroc_rectification_recovers_the_clip(euroc_root, clip):
    """The writer undid the loader's own rectification: each rectified image
    is the clip's image seen through the rectified K (the loader's), within
    2 gray levels on average where the clip covers it (two bilinear
    resamplings apart)."""
    seq = peuroc.EuRoC({"root": str(euroc_root), "gt_pose": True})
    fx, fy, cx, cy = clip["K"]
    A = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1.0]]) @ np.linalg.inv(seq.K.astype(np.float64))
    u, v = np.meshgrid(np.arange(752.0), np.arange(480.0))
    mx, my = (A[i, 0] * u + A[i, 1] * v + A[i, 2] for i in (0, 1))
    inside = (mx > 1) & (mx < 126) & (my > 1) & (my < 94)
    assert inside.sum() > 5000
    for cam, image in (("left", seq[0].stereo.imageL), ("right", seq[0].stereo.imageR)):
        gray = cv2.cvtColor(clip[cam][1], cv2.COLOR_BGR2GRAY)       # loader frame 0 is written frame 1
        expected = cv2.remap(gray, mx.astype(np.float32), my.astype(np.float32), cv2.INTER_LINEAR)
        diff = np.abs(image[0, ..., 0].numpy() * 255 - expected)[inside]
        assert diff.mean() < 2.0, (cam, float(diff.mean()))


def test_euroc_imu_matches_jax(euroc_root):
    """Every frame is a StereoInertialFrame; its IMU samples and attitude
    equal the JAX package's bit for bit."""
    cfg = {"root": str(euroc_root), "gt_pose": True}
    ours, ref = peuroc.EuRoC_IMU(cfg), jeuroc.EuRoC_IMU(cfg)
    assert len(ours) == len(ref) == 3
    for i in range(len(ref)):
        a, b = ours[i], ref[i]
        assert isinstance(a, StereoInertialFrame)
        assert_frames_equal(a, b, gt_atol=1e-12)
        for mine, theirs in ((a.imu, b.imu), (a.attitude, b.attitude)):
            for field in dataclasses.fields(theirs):
                x, y = getattr(mine, field.name), np.asarray(getattr(theirs, field.name))
                assert x.dtype == y.dtype and x.shape == y.shape, field.name
                np.testing.assert_array_equal(x, y, err_msg=field.name)
    assert [ours[i].imu.acc.shape[1] for i in range(3)] == [1, 10, 10]


def test_rectify_pair_matches_jax(euroc_root):
    """Maps and K of both cameras, and the kept stamps, bit for bit."""
    ours = [peuroc._load_camera(euroc_root / c, d) for c, d in (("cam0", peuroc.DIST_CAM0), ("cam1", peuroc.DIST_CAM1))]
    ref = [jeuroc._load_camera(euroc_root / c, d) for c, d in (("cam0", jeuroc.DIST_CAM0), ("cam1", jeuroc.DIST_CAM1))]
    ours[1].apply_mask(np.arange(len(ours[1])) != 2)          # one right image missing: its stamp goes
    ref[1].apply_mask(np.arange(len(ref[1])) != 2)
    K = prectify.rectify_pair(*ours, peuroc.EUROC_SIZE)
    K_ref = jrectify.rectify_pair(*ref, jeuroc.EUROC_SIZE)
    np.testing.assert_array_equal(K, K_ref)
    for a, b in zip(ours, ref):
        assert len(a) == len(b) == 4
        np.testing.assert_array_equal(a.times_ns, b.times_ns)
        np.testing.assert_array_equal(a.K, b.K)
        for m, n in zip(a.maps, b.maps):
            np.testing.assert_array_equal(m, n)
    np.testing.assert_array_equal(prectify.matrix_to_pose7(_euroc_extrinsic()),
                                  jrectify.matrix_to_pose7(_euroc_extrinsic()))
    np.testing.assert_array_equal(prectify.NED2EDN_MAT, jrectify.NED2EDN_MAT)


# -- VBR --------------------------------------------------------------------------------------------

def write_vbr_layout(root: Path, clip, n: int = 4) -> Path:
    """VBR layout: ``vbr_calib.yaml``, ``camera_{left,right}/data/<ns>.png`` at
    VBR's 1388x700, and the TUM ground truth ``<root.name>_gt.txt`` (one
    row every 50 ms from 20 ms before the first frame)."""
    t0 = 1_700_000_000_000_000_000
    T_l, T_r = np.eye(4), np.eye(4)
    T_r[:3, 3] = (0.5, 0.001, 0.0)
    calib = {side: {"intrinsics": [700.0, 700.0, 694.0, 350.0], "T_b": T.tolist(),
                    "distortion_coeffs": [-0.05, 0.01, 0.0001, -0.0002]}
             for side, T in (("cam_l", T_l), ("cam_r", T_r))}
    root.mkdir(parents=True)
    (root / "vbr_calib.yaml").write_text(yaml.safe_dump(calib))
    times = t0 + np.arange(n) * 100_000_000
    for cam, images in (("camera_left", clip["left"]), ("camera_right", clip["right"])):
        (root / cam / "data").mkdir(parents=True)
        for t, img in zip(times, images[:n]):
            cv2.imwrite(str(root / cam / "data" / f"{t}.png"), cv2.resize(img, (1388, 700)))
    t_gt = np.arange(-0.02, (n - 1) * 0.1 + 0.05, 0.05)
    rng = np.random.default_rng(4)
    q = rng.normal(size=(len(t_gt), 4)) * 0.02 + [0, 0, 0, 1]
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    rows = np.concatenate([(t0 / 1e9 + t_gt)[:, None], np.cumsum(rng.normal(size=(len(t_gt), 3)), 0) * 0.1, q], 1)
    np.savetxt(root / f"{root.name}_gt.txt", rows, fmt="%.9f")
    return root


@pytest.mark.parametrize("gt_pose", [True, False])
def test_vbr_matches_jax(clip, tmp_path, gt_pose):
    root = write_vbr_layout(tmp_path / "spagna_train0", clip)
    cfg = {"root": str(root), "gt_pose": gt_pose}
    ours, ref = pvbr.VBR_Stereo(cfg), jvbr.VBR_Stereo(cfg)
    assert_sequences_equal(ours, ref, gt_atol=1e-12)
    assert len(ours) == 4 and ours.baseline == ref.baseline
    assert ours[0].stereo.imageL.shape == (1, 700, 1388, 3)


# -- IMU --------------------------------------------------------------------------------------------

def _simulated_equal(a, b, rtol):
    for field in dataclasses.fields(b):
        x, y = getattr(a, field.name), getattr(b, field.name)
        assert x.dtype == y.dtype and x.shape == y.shape, field.name
        if x.dtype.kind in "iub":
            np.testing.assert_array_equal(x, y, err_msg=field.name)
        else:
            np.testing.assert_allclose(x, y, rtol=rtol, atol=0, err_msg=field.name)


@pytest.mark.parametrize("noise", [False, True])
def test_imu_simulator_matches_jax(noise):
    """The same poses through both simulators (and a noise generator of the
    same seed): equal, float64 splines in one order (rtol 0)."""
    poses = np.loadtxt(ROOT / "assets/test_sequence/TartanAir2_abs_P000/pose_lcam_front.txt")
    ours = pimu.IMUSimulator(poses, noise=pimu.IMUNoiseGenerator(**pimu.EPSON_M365, seed=3) if noise else None)
    ref = jimu.IMUSimulator(poses, noise=jimu.IMUNoiseGenerator(**jimu.EPSON_M365, seed=3) if noise else None)
    _simulated_equal(ours.data, ref.data, rtol=0)
    for i in (0, 4, 9):
        for mine, theirs in zip(ours.between_frames(i), ref.between_frames(i)):
            for field in dataclasses.fields(theirs):
                np.testing.assert_array_equal(getattr(mine, field.name), np.asarray(getattr(theirs, field.name)))


def test_imu_noise_generator_matches_jax():
    """Seeded numpy draws: the same biases and noisy samples, bit for bit."""
    rng = np.random.default_rng(5)
    acc, gyro = rng.normal(size=(50, 3)), rng.normal(size=(50, 3))
    ours, ref = pimu.IMUNoiseGenerator(**pimu.EPSON_M365, seed=9), jimu.IMUNoiseGenerator(**jimu.EPSON_M365, seed=9)
    for _ in range(3):
        for a, b in zip(ours.propagate(acc, gyro), ref.propagate(acc, gyro)):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(ours.acc_bias, ref.acc_bias)
    np.testing.assert_array_equal(ours.gyro_bias, ref.gyro_bias)
    cfg = build_dynamic_config(pimu.EPSON_M365)[0]
    pimu.IMUNoiseGenerator.is_valid_config(cfg)
    cfg.acc_bias = [0.1, 0.2]
    with pytest.raises(ValueError, match="acc_bias"):
        pimu.IMUNoiseGenerator.is_valid_config(cfg)


def test_load_tartanair_imu_matches_jax():
    """The real asset's imu/ (v2 names, Euler ori_global): equal bit for bit."""
    imu_dir = ROOT / "assets/test_sequence/TartanAir2_abs_P000/imu"
    ours, ref = pimu.load_tartanair_imu(imu_dir), jimu.load_tartanair_imu(imu_dir)
    _simulated_equal(ours, ref, rtol=0)
    assert int(ours.cam_to_imu[1]) == 10


def test_imu_frame_types_collate_as_jax():
    rng = np.random.default_rng(2)
    items = [dict(time_ns=rng.integers(0, 10**9, (1, 4)), acc=rng.normal(size=(1, 4, 3)).astype(np.float32),
                  gyro=rng.normal(size=(1, 4, 3)).astype(np.float32), gravity=np.array([[0, 0, 9.81]], np.float32))
             for _ in range(3)]
    ours = IMUData.collate([IMUData(**d) for d in items])
    ref = jframe.IMUData.collate([jframe.IMUData(**d) for d in items])
    for field in dataclasses.fields(ref):
        np.testing.assert_array_equal(getattr(ours, field.name), np.asarray(getattr(ref, field.name)))
    att = [AttitudeData(*(rng.normal(size=s) for s in ((1, 2), (1, 2, 3), (1, 2, 3), (1, 2, 4), (1, 3), (1, 3), (1, 4))))
           for _ in range(2)]
    assert AttitudeData.collate(att).gt_rot.shape == (2, 2, 4)


def test_inertial_frame_keeps_its_imu_through_the_prefetcher():
    """StereoFrame.to keeps the class and the IMU / attitude leaves (host
    numpy, the same objects) while the images move."""
    from macvo_tpu_torch.data import DevicePrefetcher

    imu = IMUData(time_ns=np.arange(3)[None], acc=np.zeros((1, 3, 3), np.float32),
                  gyro=np.ones((1, 3, 3), np.float32), gravity=np.array([[0, 0, 9.81]], np.float32))
    stereo = StereoData(T_BS=np.zeros((1, 7), np.float32), K=np.eye(3, dtype=np.float32)[None],
                        baseline=np.array([0.1], np.float32), time_ns=np.array([5]),
                        imageL=torch.zeros(1, 8, 8, 3), imageR=torch.zeros(1, 8, 8, 3))
    frame = StereoInertialFrame(idx=np.array([0]), stereo=stereo, imu=imu, attitude=None)

    class Seq:
        def __len__(self):
            return 2

        def __getitem__(self, i):
            return frame

    (moved, _) = list(DevicePrefetcher(Seq(), "cpu"))
    assert type(moved) is StereoInertialFrame and moved.imu is imu and moved.attitude is None
    assert isinstance(moved.imu.acc, np.ndarray)


# -- sequence plumbing ------------------------------------------------------------------------------

RESIZE = [{"type": "SmartResizeFrame", "args": {"height": 60, "width": 100, "interp": "nearest"}}]


@pytest.mark.parametrize("name,preprocess,applies", [
    ("list", RESIZE, True),
    ("mapping", {"KITTI": RESIZE, "GeneralStereo": [{"type": "CenterCropFrame", "args": {"width": 8, "height": 8}}]},
     True),
    ("unmatched", {"TartanAirV2": RESIZE}, False),
])
def test_smart_transform_matches_jax(kitti_root, name, preprocess, applies):
    cfg = {"root": str(kitti_root), "gt_pose": True}
    ours = psequence.smart_transform(pkitti.KITTI(cfg), preprocess)
    ref = jsequence.smart_transform(jkitti.KITTI(cfg), preprocess)
    assert type(ours).__name__ == type(ref).__name__ == ("TransformSequence" if applies else "KITTI")
    assert_sequences_equal(ours, ref)
    assert ours[0].stereo.imageL.shape[1:3] == ((60, 100) if applies else (96, 128))


def test_shipped_preprocess_matches_jax(kitti_root):
    """configs/experiment/common/preprocess.yaml on a KITTI sequence: 376x780,
    nearest after a cv2 resize, bit for bit."""
    pre, _ = load_config(ROOT / "configs/experiment/common/preprocess.yaml")
    cfg = {"root": str(kitti_root), "gt_pose": True}
    ours = psequence.smart_transform(pkitti.KITTI(cfg).clip(0, 2), pre)
    ref = jsequence.smart_transform(jkitti.KITTI(cfg).clip(0, 2), pre)
    assert_sequences_equal(ours, ref)
    assert ours[1].stereo.imageL.shape == (1, 376, 780, 3)


def test_preload_and_transform_after_a_clip_match_jax():
    """clip(1, 9, 3) -> transform -> preload on the clip: the same three
    frames (local indices, transformed images), read once by the pool."""
    ours = TartanAirV2(CLIP).clip(1, 9, 3).transform(
        psequence.IDataTransform.instantiate("CenterCropFrame", {"width": 64, "height": 48}))
    ref = JTartanAirV2(CLIP).clip(1, 9, 3).transform(
        jtransform.IDataTransform.instantiate("CenterCropFrame", {"width": 64, "height": 48}))
    assert len(ours) == len(ref) == 3
    assert_sequences_equal(ours, ref)
    pre, pre_ref = ours.preload(), ref.preload()
    assert type(pre).__name__ == "PreloadedSequence" and len(pre) == 3
    assert_sequences_equal(pre, pre_ref)
    assert pre[2] is pre[2] and pre.transform([]) is pre
    pre.clip(1, None)
    assert len(pre) == 2 and pre[0] is pre._frames[1]
    np.testing.assert_array_equal(pre[0].stereo.time_ns, ref[1].stereo.time_ns)


# -- the frontend: cov_calib and padding ------------------------------------------------------------

@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _crop_frames(h, w, n=2):
    """Frames 0..n-1 of the clip, a (h, w) window near the centre, as the
    port's and the JAX package's StereoData."""
    seq = TartanAirV2(CLIP)
    out = []
    for i in range(n):
        s = seq[i].stereo
        img = {k: getattr(s, k)[:, 290:290 + h, 270:270 + w].contiguous() for k in ("imageL", "imageR")}
        K = s.K.copy()
        K[:, 0, 2] -= 270
        K[:, 1, 2] -= 290
        ours = dataclasses.replace(s, K=K, **img)
        ref = jframe.StereoData(T_BS=s.T_BS, K=K, baseline=s.baseline, time_ns=s.time_ns,
                                imageL=img["imageL"].numpy(), imageR=img["imageR"].numpy())
        out.append((ours, ref))
    return out


def _frontend_outputs(calib, h, w, with_jax=True):
    """[port, JAX] outputs of FlowFormerCovFrontend (fp32, shipped weights,
    2 decoder steps): estimate_depth(f0), the cached pair (f0, f1), the cold
    pair (f0, f1) — disparity, its variance, flow and its covariance."""
    from macvo_tpu.modules.frontend_network import FlowFormerCovFrontend as JFrontend
    from macvo_tpu_torch.modules.frontend_network import FlowFormerCovFrontend

    args = {"weight": str(CKPT), "enc_dtype": "fp32", "dec_dtype": "fp32", "decoder_depth": 2,
            "enforce_positive_disparity": False}
    if calib is not None:
        args["cov_calib"] = calib
    cfg = build_dynamic_config(args)[0]
    (f0, j0), (f1, j1) = _crop_frames(h, w)
    outs = []
    runs = [(FlowFormerCovFrontend(cfg, device="cpu"), f0, f1)] + ([(JFrontend(cfg), j0, j1)] if with_jax else [])
    for fe, a, b in runs:
        depth0 = fe.estimate_depth(a)
        cached = fe.estimate_pair(a, b)
        fe._feat_cache = None
        cold = fe.estimate_pair(a, b)
        outs.append({"depth": (depth0.disparity, depth0.disparity_uncertainty),
                     "cached": (cached[0].disparity, cached[0].disparity_uncertainty, cached[1].flow, cached[1].cov),
                     "cold": (cold[0].disparity, cold[0].disparity_uncertainty, cold[1].flow, cold[1].cov)})
    return outs


def _assert_outputs_close(ours, ref):
    """fp32 frontend tolerance of the network tests: 1e-4 absolute and relative."""
    for path, values in ref.items():
        for i, (a, b) in enumerate(zip(ours[path], values)):
            b = np.asarray(b)
            assert a.shape == b.shape, (path, i, a.shape, b.shape)
            np.testing.assert_allclose(a.numpy(), b, atol=1e-4, rtol=1e-4, err_msg=f"{path}[{i}]")


def test_frontend_cov_calib_matches_jax():
    """With the candidate calibration file the port rescales the variances by
    band as the JAX frontend does (the port ignored cov_calib before), on the
    depth, cached-pair and cold-pair paths; 48x64 crop, no padding."""
    ours, ref = _frontend_outputs(str(CALIB), 48, 64)
    _assert_outputs_close(ours, ref)
    (plain,) = _frontend_outputs("none", 48, 64, with_jax=False)
    tau2 = json.loads(CALIB.read_text())["tau2"]
    ratio = torch.cat([(ours[p][1] / plain[p][1]).flatten() for p in ("depth", "cached", "cold")])
    assert all(min(abs(r - t) / t for t in tau2) < 1e-4 for r in ratio.tolist())


def test_frontend_pads_an_uneven_input_as_jax():
    """45x93 pads to 48x96 as (1, 2, 1, 2): the frontend's outputs on every
    path equal JAX's within the fp32 tolerance, unpadded to 45x93."""
    from macvo_tpu_torch.models.flowformer import InputPadder

    assert InputPadder((1, 45, 93, 3))._pad == (1, 2, 1, 2)
    ours, ref = _frontend_outputs(None, 45, 93)
    assert ours["depth"][0].shape == (1, 45, 93, 1)
    _assert_outputs_close(ours, ref)


def test_recalibrate_takes_the_band_below_an_edge(tmp_path):
    """A value on an edge takes the lower band (jnp.searchsorted's left side):
    variance 1 -> log10 sigma 0, the edge between tau2[1] and tau2[2]."""
    from macvo_tpu.modules.frontend_network import _FlowFormerRunner as JRunner
    from macvo_tpu_torch.modules.frontend_network import load_cov_calib, recalibrate

    path = tmp_path / "w.calib.json"
    path.write_text(json.dumps({"log10_sigma_edges": [-1.0, 0.0, 0.5], "tau2": [2.0, 3.0, 5.0, 7.0]}))
    cov = np.array([[[1.0, 1.0], [0.01, 0.01], [10.0, 10.0], [1e-30, 0.0], [0.5, 2.0], [1e3, 1e3]]], np.float32)
    ours = recalibrate(torch.from_numpy(cov), load_cov_calib(str(path), "unused.npz"))
    calib = JRunner._load_calib(None, str(path), "unused.npz")
    ref = np.asarray(JRunner._recalibrate(type("R", (), {"calib": calib})(), cov))
    np.testing.assert_array_equal(ours.numpy(), ref)
    np.testing.assert_array_equal(ours[0, :, 0].numpy(), cov[0, :, 0] * [3.0, 2.0, 5.0, 2.0, 5.0, 7.0])


@pytest.mark.parametrize("calib,calibrated", [
    ("auto", False), ("none", False), (None, False), ("", False), (str(CALIB), True)])
def test_cov_calib_values(calib, calibrated):
    """"auto" with no <weight>.calib.json beside the weight (the shipped
    weight) and the off values give no calibration; a path loads it; each is
    a valid config value."""
    from macvo_tpu_torch.modules.frontend_network import FlowFormerCovFrontend, load_cov_calib

    assert (load_cov_calib(calib, str(CKPT)) is not None) == calibrated
    FlowFormerCovFrontend.is_valid_config(build_dynamic_config({
        "weight": str(CKPT), "enc_dtype": "fp32", "dec_dtype": "fp32", "decoder_depth": 2,
        "enforce_positive_disparity": False, "cov_calib": calib})[0])


def test_cov_calib_auto_finds_the_file_beside_the_weight_and_a_missing_path_raises(tmp_path):
    from macvo_tpu_torch.modules.frontend_network import FlowFormerCovFrontend, load_cov_calib

    weight = tmp_path / "w.npz"
    assert load_cov_calib("auto", str(weight)) is None
    weight.with_suffix(".calib.json").write_text(CALIB.read_text())
    edges, tau2 = load_cov_calib("auto", str(weight))
    assert edges.shape == (7,) and tau2.shape == (8,) and tau2.dtype == torch.float32
    with pytest.raises(FileNotFoundError):
        load_cov_calib(str(tmp_path / "missing.calib.json"), str(weight))
    with pytest.raises(ValueError, match="cov_calib"):
        FlowFormerCovFrontend.is_valid_config(build_dynamic_config({
            "weight": "w.npz", "enc_dtype": "fp32", "dec_dtype": "fp32", "decoder_depth": 2,
            "enforce_positive_disparity": False, "cov_calib": 3})[0])


# -- the runner on a KITTI layout -------------------------------------------------------------------

def test_runner_on_a_kitti_layout_with_its_preprocess(kitti_root, tmp_path):
    """``python -m macvo_tpu_torch --device cpu --preload`` with
    MACVO_Performant (its shipped KITTI Preprocess cut to 60x100, 2 decoder
    steps, 64 points) on the first 3 frames of a 96x128 KITTI layout: the
    frames it feeds equal JAX's smart_transform output bit for bit, the poses
    are finite and it evaluates against poses/00.txt."""
    from macvo_tpu_torch.__main__ import build_sequence, main
    from macvo_tpu_torch.utils.config import save_config

    cfg, cfg_dict = load_config(ROOT / "configs/experiment/macvo/MACVO_Performant.yaml")
    cfg_dict["Odometry"]["frontend"]["args"].update(weight=str(CKPT), decoder_depth=2)
    cfg_dict["Odometry"]["args"].update(num_point=64)
    cfg_dict["Odometry"]["args"]["edgewidth"] = 8
    for t in ("keypoint", "mappoint"):
        cfg_dict["Odometry"][t]["args"]["mask_width"] = 8
    cfg_dict["Preprocess"]["KITTI"][0]["args"].update(height=60, width=100)
    odom, data = tmp_path / "odom.yaml", tmp_path / "data.yaml"
    save_config(cfg_dict, odom)
    data_dict = {"Sequence": {"type": "KITTI", "args": {"root": str(kitti_root), "gt_pose": True}}}
    data.write_text(yaml.safe_dump(data_dict))

    odom_cfg = load_config(odom)[0]
    seq = build_sequence(build_dynamic_config(data_dict)[0], odom_cfg, None, 3, preload=True)
    ref = jsequence.smart_transform(jkitti.KITTI(data_dict["Sequence"]["args"]).clip(None, 3),
                                    cfg_dict["Preprocess"]).preload()
    assert type(seq).__name__ == "PreloadedSequence" and len(seq) == 3
    assert_sequences_equal(seq, ref)
    assert seq[0].stereo.imageL.shape == (1, 60, 100, 3)

    main(["--odom", str(odom), "--data", str(data), "--seq_to", "3", "--preload", "--device", "cpu",
          "--resultRoot", str(tmp_path / "results")])
    (out,) = (tmp_path / "results").iterdir()
    poses = np.load(out / "poses.npy")
    assert poses.shape == (3, 8) and np.isfinite(poses).all()
    assert np.load(out / "ref_poses.npy").shape == (3, 8)
    assert yaml.safe_load((out / "config.yaml").read_text())["Data"] == data_dict
