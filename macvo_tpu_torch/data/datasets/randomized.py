"""Domain-randomized procedural stereo scenes, the training-data engine
(port of ``macvo_tpu/data/datasets/randomized.py``).

Randomized outdoor worlds with exact ground truth: analytic ray casting over
planes, spheres, boxes and a far sky dome; seeded value-noise, Voronoi,
stripe and brick textures with analytic anti-aliasing; Lambertian shading
from a static light; occlusion-aware flow masks from a depth test in the
target frame; trajectories up to ~0.5 m and ~7 deg a frame. Generation is
numpy on the host, the same arithmetic as the JAX package's, so a config and
seed give the same images, depths, flows, masks and poses bit for bit; the
frames carry them as CPU tensors.

Conventions: NED camera (x fwd, y right, z down), uv east-down,
pose = camera-to-world [t, q_xyzw].
"""

from __future__ import annotations

import numpy as np
import torch

from ...geometry import se3_np as se3
from ..frame import StereoData, StereoFrame
from ..sequence import SequenceBase

# -- procedural textures ---------------------------------------------------------


def _mix64(a: np.ndarray) -> np.ndarray:
    """SplitMix64 finalizer — integer hash, vectorized."""
    a = (a + np.uint64(0x9E3779B97F4A7C15)) & np.uint64(0xFFFFFFFFFFFFFFFF)
    a = ((a ^ (a >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)) & np.uint64(0xFFFFFFFFFFFFFFFF)
    a = ((a ^ (a >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)) & np.uint64(0xFFFFFFFFFFFFFFFF)
    return a ^ (a >> np.uint64(31))


def _hash01(ix: np.ndarray, iy: np.ndarray, seed: int) -> np.ndarray:
    """Lattice hash -> uniform [0,1)."""
    h = _mix64(ix.astype(np.uint64) * np.uint64(73856093)
               ^ iy.astype(np.uint64) * np.uint64(19349663)
               ^ np.uint64(seed))
    return (h >> np.uint64(11)).astype(np.float64) / float(1 << 53)


def _smooth(t: np.ndarray) -> np.ndarray:
    return t * t * (3.0 - 2.0 * t)


def value_noise(u: np.ndarray, v: np.ndarray, seed: int) -> np.ndarray:
    """Bilinear-interpolated lattice noise in [0,1]."""
    iu, iv = np.floor(u), np.floor(v)
    fu, fv = _smooth(u - iu), _smooth(v - iv)
    iu = iu.astype(np.int64)
    iv = iv.astype(np.int64)
    n00 = _hash01(iu, iv, seed)
    n10 = _hash01(iu + 1, iv, seed)
    n01 = _hash01(iu, iv + 1, seed)
    n11 = _hash01(iu + 1, iv + 1, seed)
    return (n00 * (1 - fu) + n10 * fu) * (1 - fv) + (n01 * (1 - fu) + n11 * fu) * fv


def _band_atten(period: float, footprint) -> np.ndarray | float:
    """Analytic anti-aliasing: attenuation in [0,1] for a texture band of
    spatial ``period`` (world units) sampled with per-pixel ``footprint``
    (world units/pixel). Bands below ~2 pixels fade to their mean — the
    closed-form equivalent of mipmapping, so distant surfaces do not turn
    into frame-decorrelated white noise."""
    if footprint is None:
        return 1.0
    return np.clip(period / (2.0 * footprint + 1e-12) - 0.5, 0.0, 1.0)


def fbm_noise(u: np.ndarray, v: np.ndarray, seed: int, octaves: int = 4,
              footprint=None) -> np.ndarray:
    """Fractal sum of value noise — natural-looking multi-scale texture."""
    out = np.zeros_like(u, dtype=np.float64)
    amp, norm = 1.0, 0.0
    for k in range(octaves):
        a = amp * _band_atten(2.0 ** (-k), footprint)
        out += a * value_noise(u * (2.0 ** k), v * (2.0 ** k), seed + 101 * k) \
            + (amp - a) * 0.5
        norm += amp
        amp *= 0.55
    return out / norm


def brick_field(u: np.ndarray, v: np.ndarray, seed: int,
                footprint=None) -> np.ndarray:
    """Staggered brick/block pattern with dark mortar joints and per-brick
    albedo jitter — the dominant texture family of the real TartanAir v2
    asset (brick walls, paved ground). Rows have unit height, bricks are two
    units wide, odd rows shift by one unit. Returns a scalar field in [0,1];
    ``footprint`` fades the joints (then the whole pattern) to the mean where
    they fall below pixel scale, mirroring the other generators' analytic AA.
    """
    row = np.floor(v)
    off = np.where(row.astype(np.int64) % 2 == 0, 0.0, 1.0)
    col = np.floor((u + off) / 2.0)
    albedo = 0.30 + 0.55 * _hash01(col.astype(np.int64), row.astype(np.int64), seed)
    bu = (u + off) % 2.0
    du = np.minimum(bu, 2.0 - bu)          # distance to vertical joint (u units)
    dv = np.minimum(v % 1.0, 1.0 - (v % 1.0))  # distance to horizontal joint
    mw = 0.07                               # joint half-width in row units
    joint = (du < mw) | (dv < mw)
    val = np.where(joint, 0.10, albedo)
    # joints alias first (period ~2*mw), then the brick grid itself (period 1)
    a_joint = _band_atten(4.0 * mw, footprint)
    val = a_joint * val + (1.0 - a_joint) * albedo
    a_grid = _band_atten(1.0, footprint)
    return a_grid * val + (1.0 - a_grid) * 0.55


def voronoi_cells(u: np.ndarray, v: np.ndarray, seed: int) -> np.ndarray:
    """Nearest-feature cell id in [0,1] — sharp random polygonal edges."""
    iu, iv = np.floor(u).astype(np.int64), np.floor(v).astype(np.int64)
    best = np.full(u.shape, np.inf)
    cell = np.zeros(u.shape)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            cx = iu + dx
            cy = iv + dy
            px = cx + _hash01(cx, cy, seed + 7)
            py = cy + _hash01(cx, cy, seed + 13)
            d = (u - px) ** 2 + (v - py) ** 2
            take = d < best
            best = np.where(take, d, best)
            cell = np.where(take, _hash01(cx, cy, seed + 29), cell)
    return cell


class RandomTexture:
    """Seeded mixture of generators with a random 2-anchor palette.

    ``footprint`` (world units per pixel at each sample) drives analytic
    anti-aliasing: each generator band fades to its mean where its period is
    sub-pixel."""

    def __init__(self, seed: int) -> None:
        rng = np.random.default_rng(seed)
        self.seed = seed
        w = rng.dirichlet(np.ones(4) * 0.7)
        self.weights = w
        self.scales = rng.uniform(0.15, 2.5, size=3)
        self.stripe_ang = rng.uniform(0, np.pi)
        self.stripe_freq = rng.uniform(0.5, 3.0)
        self.stripe_duty = rng.uniform(0.3, 0.7)
        # brick rows per world unit: 1.5-6 -> 17-67 cm brick height, the
        # high-frequency regular structure real flow nets feed on
        self.brick_scale = rng.uniform(1.5, 6.0)
        self.brick_ang = rng.uniform(-0.15, 0.15)  # near-axis-aligned courses
        # palette: 2 anchor colors lerped by the scalar field
        self.c0 = rng.uniform(0.05, 0.95, size=3)
        self.c1 = rng.uniform(0.05, 0.95, size=3)
        # guarantee contrast (flow matching needs gradients)
        while np.abs(self.c0 - self.c1).sum() < 0.6:
            self.c1 = rng.uniform(0.0, 1.0, size=3)

    def __call__(self, u: np.ndarray, v: np.ndarray, footprint=None) -> np.ndarray:
        field = np.zeros_like(u, dtype=np.float64)
        # fbm
        if self.weights[0] >= 0.05:
            s = self.scales[0]
            fp = None if footprint is None else footprint * s
            field += self.weights[0] * fbm_noise(u * s, v * s, self.seed, footprint=fp)
        # voronoi (cell size ~ 1/scale)
        if self.weights[1] >= 0.05:
            s = self.scales[1]
            a = _band_atten(1.0 / s, footprint)
            val = voronoi_cells(u * s, v * s, self.seed + 1000)
            field += self.weights[1] * (a * val + (1.0 - a) * 0.5)
        # stripes (period = 1/(scale*freq))
        if self.weights[2] >= 0.05:
            s = self.scales[2]
            a = _band_atten(1.0 / (s * self.stripe_freq), footprint)
            sv = (u * s) * np.cos(self.stripe_ang) + (v * s) * np.sin(self.stripe_ang)
            val = ((sv * self.stripe_freq) % 1.0 < self.stripe_duty).astype(np.float64)
            field += self.weights[2] * (a * val + (1.0 - a) * self.stripe_duty)
        # bricks (rows per unit = brick_scale)
        if self.weights[3] >= 0.05:
            s = self.brick_scale
            ca, sa = np.cos(self.brick_ang), np.sin(self.brick_ang)
            ub = (u * ca - v * sa) * s
            vb = (u * sa + v * ca) * s
            fp = None if footprint is None else footprint * s
            field += self.weights[3] * brick_field(ub, vb, self.seed + 4000, fp)
        field = np.clip(field, 0.0, 1.0)[..., None]
        return self.c0 * (1 - field) + self.c1 * field


# -- primitives ------------------------------------------------------------------

_BIG = 1e30


class _Primitive:
    """Interface: intersect rays, return hit distance (inf if miss); surface
    coords (u,v) and normal at world points."""

    texture: RandomTexture

    def intersect(self, origin: np.ndarray, rays: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def surface(self, pts: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """pts (...,3) -> (u, v, normal(...,3))."""
        raise NotImplementedError


class PlanePrim(_Primitive):
    def __init__(self, n, d, seed: int) -> None:
        self.n = np.asarray(n, np.float64)
        self.n /= np.linalg.norm(self.n)
        self.d = float(d)
        # orthonormal tangent frame for texture coords
        a = np.array([1.0, 0, 0]) if abs(self.n[0]) < 0.9 else np.array([0, 1.0, 0])
        self.e1 = np.cross(self.n, a)
        self.e1 /= np.linalg.norm(self.e1)
        self.e2 = np.cross(self.n, self.e1)
        self.texture = RandomTexture(seed)

    def intersect(self, origin, rays):
        denom = rays @ self.n
        s = (self.d - origin @ self.n) / np.where(np.abs(denom) < 1e-12, 1e-12, denom)
        return np.where((s > 0.05) & (np.abs(denom) > 1e-9), s, _BIG)

    def surface(self, pts):
        return pts @ self.e1, pts @ self.e2, np.broadcast_to(self.n, pts.shape)


class SpherePrim(_Primitive):
    def __init__(self, center, radius: float, seed: int, inside: bool = False) -> None:
        self.c = np.asarray(center, np.float64)
        self.r = float(radius)
        self.inside = inside  # sky dome: camera inside, hit far shell
        self.texture = RandomTexture(seed)

    def intersect(self, origin, rays):
        oc = origin - self.c
        b = rays @ oc
        c = oc @ oc - self.r * self.r
        disc = b * b - c
        sq = np.sqrt(np.maximum(disc, 0.0))
        s = (-b + sq) if self.inside else (-b - sq)
        return np.where((disc > 0) & (s > 0.05), s, _BIG)

    def surface(self, pts):
        rel = pts - self.c
        n = rel / np.maximum(np.linalg.norm(rel, axis=-1, keepdims=True), 1e-12)
        # angular coords scaled by an effective radius capped at 60: a 30 km
        # sky dome would otherwise alias procedural noise into per-pixel
        # white noise (texture frequency ~ r per radian).
        r_eff = min(self.r, 60.0)
        az = np.arctan2(n[..., 1], n[..., 0]) * r_eff
        po = np.arccos(np.clip(n[..., 2], -1, 1)) * r_eff
        return az, po, (-n if self.inside else n)


class SkyDome(SpherePrim):
    """Far emissive shell shaded by ray direction: vertical gradient +
    sun glow around the light direction + fbm cloud bands — the real asset's
    sky is a bright gradient with backlit clouds, not procedural noise.
    Direction-based shading is photometrically consistent across nearby
    views because the shell sits at 30 km (direction change ~1e-5 rad)."""

    def __init__(self, center, radius: float, seed: int,
                 sun_dir: np.ndarray) -> None:
        super().__init__(center, radius, seed, inside=True)
        self.seed = seed
        rng = np.random.default_rng(seed)
        t = rng.uniform()
        self.zenith = np.array([0.30, 0.42, 0.68]) * (1 - t) \
            + np.array([0.55, 0.65, 0.82]) * t
        w = rng.uniform()
        self.horizon = np.array([0.92, 0.80, 0.62]) * w \
            + np.array([0.88, 0.90, 0.94]) * (1 - w)
        self.sun = -np.asarray(sun_dir, np.float64)  # toward the sun
        self.sun /= np.linalg.norm(self.sun)
        self.glow_exp = rng.uniform(8.0, 64.0)
        self.glow_gain = rng.uniform(0.3, 1.0)
        self.cloud_amt = rng.uniform(0.0, 0.55)
        self.cloud_scale = rng.uniform(2.0, 6.0)

    def shade(self, dirs: np.ndarray) -> np.ndarray:
        """dirs (M,3) unit world rays -> (M,3) RGB in [0,1]."""
        elev = np.clip(-dirs[..., 2], 0.0, 1.0) ** 0.6  # NED: up = -z
        base = self.horizon[None] * (1 - elev[..., None]) \
            + self.zenith[None] * elev[..., None]
        # Clouds are sampled on the (x, y) direction components directly —
        # a seam-free domain — rather than over arctan2 azimuth, whose ±pi
        # wrap put a spurious high-gradient vertical seam in the sky that
        # moved with camera yaw.
        c = fbm_noise(dirs[..., 0] * self.cloud_scale,
                      dirs[..., 1] * self.cloud_scale
                      + np.arccos(np.clip(dirs[..., 2], -1, 1)) * self.cloud_scale,
                      self.seed + 77, octaves=3)
        base = base + (self.cloud_amt * (c - 0.5) * (1 - 0.5 * elev))[..., None]
        cos = np.clip(dirs @ self.sun, 0.0, 1.0)
        glow = self.glow_gain * cos ** self.glow_exp \
            + 1.5 * cos ** (self.glow_exp * 8.0)
        base = base + glow[..., None] * np.array([1.0, 0.95, 0.85])[None]
        return np.clip(base, 0.0, 1.0)


class BoxPrim(_Primitive):
    def __init__(self, lo, hi, seed: int) -> None:
        self.lo = np.asarray(lo, np.float64)
        self.hi = np.asarray(hi, np.float64)
        self.texture = RandomTexture(seed)

    def intersect(self, origin, rays):
        inv = 1.0 / np.where(np.abs(rays) < 1e-12, 1e-12, rays)
        t0 = (self.lo - origin) * inv
        t1 = (self.hi - origin) * inv
        tmin = np.minimum(t0, t1).max(axis=-1)
        tmax = np.maximum(t0, t1).min(axis=-1)
        hit = (tmax > np.maximum(tmin, 0.05))
        return np.where(hit, np.maximum(tmin, 0.05), _BIG)

    def surface(self, pts):
        # dominant face by proximity; planar coords on that face
        center = 0.5 * (self.lo + self.hi)
        half = np.maximum(0.5 * (self.hi - self.lo), 1e-9)
        rel = (pts - center) / half
        ax = np.argmax(np.abs(rel), axis=-1)
        n = np.zeros_like(pts)
        idx = np.indices(ax.shape)
        n[(*idx, ax)] = np.sign(rel[(*idx, ax)])
        u = np.where(ax == 0, pts[..., 1], pts[..., 0])
        v = np.where(ax == 2, pts[..., 1], pts[..., 2])
        return u, v, n


# -- randomized world ------------------------------------------------------------


def build_random_world(seed: int) -> tuple[list[_Primitive], np.ndarray, dict]:
    """Seeded outdoor-ish world: ground plane, sky dome, 0-2 large walls,
    6-14 floating boxes/spheres at 2-40 m.
    Returns (primitives, light_dir, shading dict with light/ambient RGB)."""
    rng = np.random.default_rng(seed)
    prims: list[_Primitive] = []
    # directional light drawn FIRST so the sky's sun matches it
    light = rng.normal(size=3)
    light[2] = -abs(light[2]) - 0.5  # from above (NED z points down)
    light /= np.linalg.norm(light)
    # ground (z down is positive in NED -> ground at z = +h below camera)
    prims.append(PlanePrim([0, 0, 1], rng.uniform(1.5, 4.0), seed * 7 + 1))
    # sky dome: far emissive shell (matches the real asset's ~30 km sky)
    prims.append(SkyDome([0, 0, 0], 30000.0, seed * 7 + 2, sun_dir=light))
    # optional large walls
    for k in range(rng.integers(0, 3)):
        ang = rng.uniform(0, 2 * np.pi)
        n = np.array([np.cos(ang), np.sin(ang), 0.0])
        prims.append(PlanePrim(n, rng.uniform(12.0, 45.0), seed * 7 + 3 + k))
    # floating structure: boxes and spheres scattered ahead of the start pose
    n_obj = int(rng.integers(6, 15))
    for k in range(n_obj):
        center = np.array([
            rng.uniform(3.0, 45.0),            # ahead
            rng.uniform(-20.0, 20.0),          # lateral
            rng.uniform(-6.0, 2.0),            # vertical (NED: +down)
        ])
        size = rng.uniform(0.4, 6.0)
        if rng.random() < 0.5:
            prims.append(SpherePrim(center, size * 0.6, seed * 31 + 17 * k))
        else:
            half = rng.uniform(0.3, 1.0, size=3) * size * 0.5
            prims.append(BoxPrim(center - half, center + half, seed * 31 + 17 * k + 5))
    # warm-vs-neutral sun with a complementary cool ambient (real-asset look:
    # low warm sun + blue skylight); grayscale-equivalent weights preserved
    warm = rng.uniform(0.0, 1.0)
    light_rgb = (np.array([0.52, 0.45, 0.33]) * warm
                 + np.array([0.45, 0.45, 0.45]) * (1 - warm))
    ambient_rgb = (np.array([0.50, 0.55, 0.62]) * warm
                   + np.array([0.55, 0.55, 0.55]) * (1 - warm))
    return prims, light, {"light_rgb": light_rgb, "ambient_rgb": ambient_rgb}


def random_trajectory(n_frames: int, seed: int) -> np.ndarray:
    """(N,7) trajectory with real-asset-scale motion: speed up to ~0.5 m/frame,
    per-frame rotation up to ~7 deg, smooth random walk in twist space."""
    rng = np.random.default_rng(seed)
    speed = rng.uniform(0.05, 0.5)
    # heading random walk: smooth but aggressive
    rot_amp = np.deg2rad(rng.uniform(0.5, 7.0))
    # low-pass-filtered white noise for twist components
    w_rot = rng.normal(size=(n_frames, 3))
    w_trn = rng.normal(size=(n_frames, 3))
    alpha = rng.uniform(0.5, 0.9)
    for i in range(1, n_frames):
        w_rot[i] = alpha * w_rot[i - 1] + (1 - alpha) * w_rot[i]
        w_trn[i] = alpha * w_trn[i - 1] + (1 - alpha) * w_trn[i]
    pose = se3.identity((), np.float64)
    poses = [pose]
    fwd_bias = rng.uniform(0.3, 1.0)
    for i in range(1, n_frames):
        v = np.array([fwd_bias, 0, 0]) + 0.4 * w_trn[i]
        v = v / max(np.linalg.norm(v), 1e-9) * speed * rng.uniform(0.5, 1.2)
        phi = w_rot[i] * rot_amp * np.array([0.4, 1.0, 1.0])  # roll damped
        step = np.concatenate([v, phi]).astype(np.float64)
        pose = se3.mul(pose, se3.exp(step))
        poses.append(pose)
    return np.stack(poses).astype(np.float32)


class WorldRenderer:
    """Analytic ray-cast renderer over a primitive list with exact GT."""

    def __init__(self, prims: list[_Primitive], light: np.ndarray,
                 K: np.ndarray, width: int, height: int,
                 shading: dict | None = None) -> None:
        self.prims = prims
        self.light = light
        shading = shading or {}
        self.light_rgb = np.asarray(shading.get("light_rgb", [0.45, 0.45, 0.45]))
        self.ambient_rgb = np.asarray(shading.get("ambient_rgb", [0.55, 0.55, 0.55]))
        self.K = K
        self.W, self.H = width, height
        u, v = np.meshgrid(np.arange(width), np.arange(height))
        fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
        rays = np.stack(
            [np.ones_like(u, np.float64), (u - cx) / fx, (v - cy) / fy], axis=-1)
        self.rays = rays / np.linalg.norm(rays, axis=-1, keepdims=True)
        self.ray_fwd = rays[..., 0] / np.linalg.norm(rays, axis=-1)  # cos to fwd axis
        self.uv = np.stack([u, v], axis=-1).astype(np.float64)

    def _trace(self, R: np.ndarray, t: np.ndarray):
        rays_w = self.rays @ R.T
        dist = np.full((self.H, self.W), _BIG)
        hit_id = np.full((self.H, self.W), -1, dtype=np.int32)
        for i, p in enumerate(self.prims):
            s = p.intersect(t, rays_w)
            take = s < dist
            dist = np.where(take, s, dist)
            hit_id = np.where(take, i, hit_id)
        pts_w = t[None, None] + rays_w * np.minimum(dist, 1e6)[..., None]
        return dist, pts_w, hit_id, rays_w

    def render(self, pose: np.ndarray):
        """pose (7,) -> (image HxWx3 f32, depth HxW f32, dist HxW, pts, ids)."""
        R = se3.rotmat(pose[None].astype(np.float64))[0]
        t = pose[:3].astype(np.float64)
        dist, pts_w, hit_id, rays_w = self._trace(R, t)
        img = np.zeros((self.H, self.W, 3), np.float64)
        fx = self.K[0, 0]
        for i, p in enumerate(self.prims):
            m = hit_id == i
            if not m.any():
                continue
            if isinstance(p, SkyDome):
                img[m] = p.shade(rays_w[m])
                continue
            # texture/shade only the hit pixels — full-grid eval per primitive
            # dominated render time (~15 prims x 3 generators x HW points)
            u, v, n = p.surface(pts_w[m])
            # per-pixel world footprint for analytic anti-aliasing: pixel
            # solid angle x distance, stretched by grazing incidence
            cosi = np.maximum(np.abs(np.sum(n * rays_w[m], axis=-1)), 0.2)
            if isinstance(p, SpherePrim) and p.inside:
                # sky coords are angular with r_eff cap (see surface())
                foot = np.full(u.shape, min(p.r, 60.0) / fx)
            else:
                foot = np.minimum(dist[m], 1e6) / fx / cosi
            rgb = p.texture(u, v, footprint=foot)
            cos = np.clip(-(n @ self.light), 0.0, 1.0)
            lam = self.ambient_rgb[None] + self.light_rgb[None] * cos[..., None]
            img[m] = np.clip(rgb * lam, 0.0, 1.0)
        # depth = forward (x) component of the camera-frame point
        depth = dist * self.ray_fwd
        return (img.astype(np.float32), depth.astype(np.float32),
                dist, pts_w, hit_id)

    def flow(self, pose_a: np.ndarray, pose_b: np.ndarray,
             pts_w_a: np.ndarray, ids_a: np.ndarray,
             dist_b_map: np.ndarray):
        """Exact flow a->b with occlusion mask via the target depth test."""
        Rb = se3.rotmat(pose_b[None].astype(np.float64))[0]
        tb = pose_b[:3].astype(np.float64)
        pts_b = (pts_w_a - tb[None, None]) @ Rb
        fx, fy, cx, cy = self.K[0, 0], self.K[1, 1], self.K[0, 2], self.K[1, 2]
        x = np.maximum(pts_b[..., 0], 1e-6)
        ub = fx * pts_b[..., 1] / x + cx
        vb = fy * pts_b[..., 2] / x + cy
        flow = np.stack([ub, vb], axis=-1) - self.uv
        inb = (pts_b[..., 0] > 0.1) & (ub >= 0) & (ub <= self.W - 1) & \
              (vb >= 0) & (vb <= self.H - 1) & (ids_a >= 0)
        # occlusion: the point must be the closest surface along frame-b's ray
        ui = np.clip(np.round(ub).astype(np.int64), 0, self.W - 1)
        vi = np.clip(np.round(vb).astype(np.int64), 0, self.H - 1)
        dist_b_pt = np.linalg.norm(pts_b, axis=-1)
        seen = dist_b_map[vi, ui] > dist_b_pt * (1 - 0.02) - 0.05
        return flow.astype(np.float32), inb & seen


class RandomizedStereo(SequenceBase[StereoFrame]):
    """Domain-randomized synthetic sequence (drop-in for SyntheticStereo).

    Config: n_frames, width, height, fx fy cx cy, baseline, seed
    (world + texture + trajectory all derive from ``seed``)."""

    def __init__(self, config) -> None:
        cfg = self.config_dict2ns(config)
        self.n_frames = int(getattr(cfg, "n_frames", 16))
        W, H = int(getattr(cfg, "width", 640)), int(getattr(cfg, "height", 640))
        fx = float(getattr(cfg, "fx", W / 2.0))
        fy = float(getattr(cfg, "fy", W / 2.0))
        cx = float(getattr(cfg, "cx", W / 2))
        cy = float(getattr(cfg, "cy", H / 2))
        self.K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float32)
        self.baseline = float(getattr(cfg, "baseline", 0.25))
        # supersample: render the image at s x resolution and box-filter down
        # — natural anti-aliased edges (GT depth/flow stay at pixel centers
        # via the native-resolution trace).
        self.ss = int(getattr(cfg, "supersample", 1))
        seed = int(getattr(cfg, "seed", 0))
        prims, light, shading = build_random_world(seed)
        self.renderer = WorldRenderer(prims, light, self.K.astype(np.float64), W, H,
                                      shading=shading)
        self._ss_renderer = None
        if self.ss > 1:
            # s high-res pixel centers must tile each native pixel:
            # fx' = s*fx, cx' = s*cx + (s-1)/2 (likewise fy/cy).
            Kss = self.K.astype(np.float64).copy()
            Kss[0, 0] *= self.ss
            Kss[1, 1] *= self.ss
            Kss[0, 2] = self.ss * Kss[0, 2] + (self.ss - 1) / 2.0
            Kss[1, 2] = self.ss * Kss[1, 2] + (self.ss - 1) / 2.0
            self._ss_renderer = WorldRenderer(prims, light, Kss, W * self.ss, H * self.ss,
                                              shading=shading)
        self.poses = random_trajectory(self.n_frames, seed + 999)
        self._rcache: dict[int, tuple] = {}
        self._cache: dict[int, StereoFrame] = {}
        super().__init__(self.n_frames)

    def _render(self, index: int):
        if index not in self._rcache:
            # keep the raw-render cache bounded: only neighbors are reused
            if len(self._rcache) > 3:
                self._rcache.pop(next(iter(self._rcache)))
            self._rcache[index] = self.renderer.render(self.poses[index])
        return self._rcache[index]

    def _image(self, pose: np.ndarray, native_img: np.ndarray | None) -> np.ndarray:
        """Anti-aliased image via the supersampled renderer (if enabled);
        ``native_img=None`` skips the (redundant) native render entirely."""
        if self._ss_renderer is None:
            if native_img is None:
                return self.renderer.render(pose)[0]
            return native_img
        img_hi = self._ss_renderer.render(pose)[0]
        s = self.ss
        H, W = self.renderer.H, self.renderer.W
        return img_hi.reshape(H, s, W, s, 3).mean(axis=(1, 3)).astype(np.float32)

    def _right_pose(self, pose: np.ndarray) -> np.ndarray:
        offset = se3.from_t_q(
            np.array([0.0, self.baseline, 0.0], np.float32),
            np.array([0.0, 0.0, 0.0, 1.0], np.float32))
        return se3.mul(pose.astype(np.float32), offset)

    def __getitem__(self, local_index: int) -> StereoFrame:
        index = self.get_index(local_index)
        if index not in self._cache:
            if len(self._cache) > 6:
                self._cache.pop(next(iter(self._cache)))
            pose = self.poses[index]
            imgL, depth, _, pts_w, ids = self._render(index)
            imgL = self._image(pose, imgL)
            imgR = self._image(self._right_pose(pose), None)
            flow = flow_mask = None
            if index + 1 < self.n_frames:
                _, _, dist_b, _, _ = self._render(index + 1)
                flow, valid = self.renderer.flow(
                    pose, self.poses[index + 1], pts_w, ids, dist_b)
                flow, flow_mask = flow[None], valid[None, ..., None]
            self._cache[index] = StereoFrame(
                idx=np.array([local_index]),
                gt_pose=pose[None],
                stereo=StereoData(
                    T_BS=se3.identity((1,)),
                    K=self.K[None],
                    baseline=np.array([self.baseline], np.float32),
                    time_ns=np.array([int(index * 1e8)], np.int64),
                    imageL=torch.from_numpy(imgL[None]),
                    imageR=torch.from_numpy(imgR[None]),
                    gt_flow=None if flow is None else torch.from_numpy(flow),
                    flow_mask=None if flow_mask is None else torch.from_numpy(flow_mask),
                    gt_depth=torch.from_numpy(depth[None, ..., None]),
                ),
            )
        frame = self._cache[index]
        return StereoFrame(idx=np.array([local_index]), gt_pose=frame.gt_pose,
                           stereo=frame.stereo)

    @classmethod
    def is_valid_config(cls, config) -> None:
        cls._enforce_config_spec(
            config, {"n_frames": lambda v: isinstance(v, int) and v > 1})
