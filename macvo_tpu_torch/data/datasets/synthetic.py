"""Procedural synthetic stereo sequence with exact ground truth
(port of ``macvo_tpu/data/datasets/synthetic.py``).

A multi-plane 3D scene rendered analytically, so depth, optical flow and
poses are exact by construction. Generation is numpy on the host, the same
arithmetic as the JAX package's, so a config and seed give the same images,
depths, flows and poses bit for bit; the frames carry them as CPU tensors
(``DevicePrefetcher`` moves them to the card). The scene can also be written
to disk in TartanAir v1 layout, as the JAX package's writer writes it:
``python -m macvo_tpu_torch.data.datasets.synthetic --out <dir> [--n_frames
10 --width 640 --height 480]``.

Conventions: NED world/camera (x forward, y right, z down), uv east-down,
pose = camera-to-world ``[t, q_xyzw]``.
"""

from __future__ import annotations

from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

from ...geometry import se3_np as se3
from ..frame import StereoData, StereoFrame
from ..sequence import SequenceBase


class _Plane:
    """Infinite textured plane: points p with n·p = d; texture over (e1, e2)."""

    def __init__(self, n, d, e1, e2, tex_seed: int) -> None:
        self.n = np.asarray(n, dtype=np.float64)
        self.n /= np.linalg.norm(self.n)
        self.d = float(d)
        self.e1 = np.asarray(e1, dtype=np.float64)
        self.e2 = np.asarray(e2, dtype=np.float64)
        rng = np.random.default_rng(tex_seed)
        # A mixture of random sinusoids per RGB channel: dense gradients everywhere.
        self.freqs = rng.uniform(0.3, 4.0, size=(3, 6, 2))
        self.phases = rng.uniform(0, 2 * np.pi, size=(3, 6))
        self.amps = rng.uniform(0.5, 1.0, size=(3, 6))

    def texture(self, u: np.ndarray, v: np.ndarray) -> np.ndarray:
        """(...,) plane coordinates -> (...,3) RGB in [0.1, 0.9]."""
        out = np.zeros(u.shape + (3,), dtype=np.float64)
        for c in range(3):
            acc = np.zeros_like(u)
            for k in range(self.freqs.shape[1]):
                fu, fv = self.freqs[c, k]
                acc += self.amps[c, k] * np.sin(fu * u + fv * v + self.phases[c, k])
            out[..., c] = acc
        out -= out.min(axis=(0, 1), keepdims=True)
        out /= np.maximum(out.max(axis=(0, 1), keepdims=True), 1e-9)
        return 0.1 + 0.8 * out


def default_scene(seed: int = 7) -> list[_Plane]:
    """Floor, ceiling, two walls and a far wall: a corridor along +x."""
    return [
        _Plane(n=[0, 0, 1], d=2.0, e1=[1, 0, 0], e2=[0, 1, 0], tex_seed=seed),      # floor z=2
        _Plane(n=[0, 0, 1], d=-3.0, e1=[1, 0, 0], e2=[0, 1, 0], tex_seed=seed + 1),  # ceiling z=-3
        _Plane(n=[0, 1, 0], d=4.0, e1=[1, 0, 0], e2=[0, 0, 1], tex_seed=seed + 2),   # right wall y=4
        _Plane(n=[0, 1, 0], d=-4.0, e1=[1, 0, 0], e2=[0, 0, 1], tex_seed=seed + 3),  # left wall y=-4
        _Plane(n=[1, 0, 0], d=60.0, e1=[0, 1, 0], e2=[0, 0, 1], tex_seed=seed + 4),  # far wall x=60
    ]


def default_trajectory(n_frames: int, seed: int | None = None) -> np.ndarray:
    """(N,7) smooth forward motion with gentle yaw, pitch and lateral sway.
    ``seed`` randomizes speed, sway and rotation; ``None`` is the canonical
    trajectory the end-to-end bounds are pinned on."""
    if seed is None:
        speed, ay, az, fy_, fz_, a_yaw, a_pitch = 0.15, 0.4, 0.2, 2.0, 3.0, 0.06, 0.03
    else:
        rng = np.random.default_rng(seed)
        speed = rng.uniform(0.08, 0.22)
        ay, az = rng.uniform(0.1, 0.7), rng.uniform(0.05, 0.4)
        fy_, fz_ = rng.uniform(1.0, 3.5), rng.uniform(1.5, 4.5)
        a_yaw, a_pitch = rng.uniform(0.02, 0.12), rng.uniform(0.01, 0.06)
    poses = []
    for i in range(n_frames):
        s = i / max(n_frames - 1, 1)
        t = np.array([2.0 * s * max(n_frames - 1, 1) * speed, ay * np.sin(fy_ * s), az * np.sin(fz_ * s)])
        yaw = a_yaw * np.sin(2.5 * s)
        pitch = a_pitch * np.sin(1.7 * s)
        twist = np.array([0.0, 0.0, 0.0, 0.0, pitch, yaw], dtype=np.float32)
        rot = np.asarray(se3.exp(twist))
        poses.append(np.concatenate([t.astype(np.float32), rot[3:]]))
    return np.stack(poses)


class SceneRenderer:
    def __init__(self, planes: list[_Plane], K: np.ndarray, width: int, height: int) -> None:
        self.planes = planes
        self.K = K
        self.W, self.H = width, height
        u, v = np.meshgrid(np.arange(width), np.arange(height))
        fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
        # NED ray per pixel, unit forward component.
        self.rays = np.stack([np.ones_like(u, dtype=np.float64), (u - cx) / fx, (v - cy) / fy], axis=-1)
        self.uv = np.stack([u, v], axis=-1).astype(np.float64)

    def _intersect(self, R: np.ndarray, t: np.ndarray):
        """Per-pixel (depth, world point, plane index)."""
        rays_w = self.rays @ R.T
        depth = np.full((self.H, self.W), np.inf)
        plane_idx = np.full((self.H, self.W), -1, dtype=np.int32)
        for i, pl in enumerate(self.planes):
            denom = rays_w @ pl.n
            s = (pl.d - pl.n @ t) / np.where(np.abs(denom) < 1e-9, 1e-9, denom)
            valid = (s > 0.1) & (s < depth)
            depth = np.where(valid, s, depth)
            plane_idx = np.where(valid, i, plane_idx)
        pts_w = t[None, None] + rays_w * depth[..., None]
        return depth, pts_w, plane_idx

    def _shade(self, pts_w: np.ndarray, plane_idx: np.ndarray) -> np.ndarray:
        img = np.zeros((self.H, self.W, 3), dtype=np.float64)
        for i, pl in enumerate(self.planes):
            mask = plane_idx == i
            if not mask.any():
                continue
            img[mask] = pl.texture(pts_w @ pl.e1, pts_w @ pl.e2)[mask]
        return img

    def render(self, pose: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """pose (7,) camera-to-world -> (image (H,W,3), depth (H,W), plane ids)."""
        R = np.asarray(se3.rotmat(pose.astype(np.float32))).astype(np.float64)
        t = pose[:3].astype(np.float64)
        depth, pts_w, plane_idx = self._intersect(R, t)
        return self._shade(pts_w, plane_idx).astype(np.float32), depth.astype(np.float32), plane_idx

    def flow(self, pose_a: np.ndarray, pose_b: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Exact optical flow from frame a's pixels to frame b: (H,W,2) and a valid mask."""
        Ra = np.asarray(se3.rotmat(pose_a.astype(np.float32))).astype(np.float64)
        _, pts_w, plane_a = self._intersect(Ra, pose_a[:3].astype(np.float64))
        Rb = np.asarray(se3.rotmat(pose_b.astype(np.float32))).astype(np.float64)
        pts_b = (pts_w - pose_b[:3].astype(np.float64)[None, None]) @ Rb      # R_b^T (p - t_b)
        fx, fy, cx, cy = self.K[0, 0], self.K[1, 1], self.K[0, 2], self.K[1, 2]
        x = np.maximum(pts_b[..., 0], 1e-6)
        ub = fx * pts_b[..., 1] / x + cx
        vb = fy * pts_b[..., 2] / x + cy
        flow = np.stack([ub, vb], axis=-1) - self.uv
        valid = ((pts_b[..., 0] > 0.1) & (ub >= 0) & (ub <= self.W - 1) & (vb >= 0) & (vb <= self.H - 1)
                 & (plane_a >= 0))
        return flow.astype(np.float32), valid


class SyntheticStereo(SequenceBase[StereoFrame]):
    """In-memory synthetic sequence. Config: n_frames, width, height, fx, fy,
    cx, cy, baseline, seed, traj_seed, and the gtFlow / gtDepth / gtPose flags."""

    def __init__(self, config) -> None:
        cfg = self.config_dict2ns(config)
        self.n_frames = int(getattr(cfg, "n_frames", 10))
        W, H = int(getattr(cfg, "width", 640)), int(getattr(cfg, "height", 480))
        fx = float(getattr(cfg, "fx", 320.0))
        fy = float(getattr(cfg, "fy", 320.0))
        cx = float(getattr(cfg, "cx", W / 2))
        cy = float(getattr(cfg, "cy", H / 2))
        self.K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], dtype=np.float32)
        self.baseline = float(getattr(cfg, "baseline", 0.25))
        self.gt_flow_on = bool(getattr(cfg, "gtFlow", True))
        self.gt_depth_on = bool(getattr(cfg, "gtDepth", True))
        self.gt_pose_on = bool(getattr(cfg, "gtPose", True))
        traj_seed = getattr(cfg, "traj_seed", None)
        self.renderer = SceneRenderer(default_scene(int(getattr(cfg, "seed", 7))), self.K.astype(np.float64), W, H)
        self.poses = default_trajectory(self.n_frames, None if traj_seed is None else int(traj_seed))
        self._cache: dict[int, StereoFrame] = {}
        super().__init__(self.n_frames)

    def _right_pose(self, pose: np.ndarray) -> np.ndarray:
        """Right camera: +baseline along the camera's y (east) axis."""
        offset = se3.from_t_q(np.array([0.0, self.baseline, 0.0], dtype=np.float32),
                              np.array([0.0, 0.0, 0.0, 1.0], dtype=np.float32))
        return np.asarray(se3.mul(pose.astype(np.float32), offset))

    def __getitem__(self, local_index: int) -> StereoFrame:
        index = self.get_index(local_index)
        if index not in self._cache:
            pose = self.poses[index]
            imgL, depth, _ = self.renderer.render(pose)
            imgR, _, _ = self.renderer.render(self._right_pose(pose))
            flow = flow_mask = None
            if self.gt_flow_on and index + 1 < self.n_frames:
                flow, valid = self.renderer.flow(pose, self.poses[index + 1])
                flow, flow_mask = torch.from_numpy(flow[None]), torch.from_numpy(valid[None, ..., None])
            self._cache[index] = StereoFrame(
                idx=np.array([local_index]),
                gt_pose=pose[None] if self.gt_pose_on else None,
                stereo=StereoData(
                    T_BS=np.asarray(se3.identity((1,))),
                    K=self.K[None],
                    baseline=np.array([self.baseline], dtype=np.float32),
                    time_ns=np.array([int(index * 1e8)], dtype=np.int64),
                    imageL=torch.from_numpy(imgL[None]),
                    imageR=torch.from_numpy(imgR[None]),
                    gt_flow=flow,
                    flow_mask=flow_mask,
                    gt_depth=torch.from_numpy(depth[None, ..., None]) if self.gt_depth_on else None,
                ),
            )
        frame = self._cache[index]
        # The clip may remap indices: stamp the local one.
        return StereoFrame(idx=np.array([local_index]), gt_pose=frame.gt_pose, stereo=frame.stereo)

    @classmethod
    def is_valid_config(cls, config) -> None:
        cls._enforce_config_spec(config, {"n_frames": lambda v: isinstance(v, int) and v > 1})


def write_sequence_tartanair_layout(seq, out_dir: str | Path) -> Path:
    """Write any StereoFrame sequence to disk in TartanAir v1 layout
    (image_left/right pngs, depth npy, flow npy with a mask channel,
    pose_left.txt)."""
    import cv2

    out = Path(out_dir)
    for sub in ("image_left", "image_right", "depth_left", "flow"):
        (out / sub).mkdir(parents=True, exist_ok=True)
    poses = []
    for i in range(len(seq)):
        frame = seq[i]
        s = frame.stereo
        for name, img in (("image_left", s.imageL[0]), ("image_right", s.imageR[0])):
            bgr = cv2.cvtColor((np.asarray(img) * 255).astype(np.uint8), cv2.COLOR_RGB2BGR)
            cv2.imwrite(str(out / name / f"{i:06d}_{'left' if name == 'image_left' else 'right'}.png"), bgr)
        np.save(out / "depth_left" / f"{i:06d}_left_depth.npy", np.asarray(s.gt_depth[0, ..., 0], np.float32))
        if s.gt_flow is not None:
            flow3 = np.concatenate([np.asarray(s.gt_flow[0]), np.asarray(s.flow_mask[0], np.float32)], axis=-1)
            np.save(out / "flow" / f"{i:06d}_{i + 1:06d}_flow.npy", flow3.astype(np.float32))
        poses.append(np.asarray(frame.gt_pose[0]))
    np.savetxt(out / "pose_left.txt", np.stack(poses), fmt="%.8f")
    return out


def write_tartanair_layout(out_dir: str | Path, config: dict | None = None) -> Path:
    """Write a SyntheticStereo sequence of ``config`` in TartanAir v1 layout."""
    return write_sequence_tartanair_layout(SyntheticStereo(SimpleNamespace(**(config or {}))), out_dir)


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description="Write a SyntheticStereo sequence in TartanAir v1 layout")
    ap.add_argument("--out", required=True)
    ap.add_argument("--n_frames", type=int, default=10)
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--height", type=int, default=480)
    args = ap.parse_args()
    path = write_tartanair_layout(args.out, {"n_frames": args.n_frames, "width": args.width, "height": args.height})
    print(f"Wrote synthetic TartanAir-layout sequence to {path}")
