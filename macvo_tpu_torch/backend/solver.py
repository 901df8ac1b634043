"""Levenberg-Marquardt solver for the two-frame pose-graph problems
(port of ``macvo_tpu/backend/solver.py``).

Same robust problem as the JAX solver: the pose is optimized in the se3
tangent space with the right retraction ``T(delta) = T0 Exp(delta)``,
per-observation covariances are whitened block-wise, Huber(0.1) IRLS weights,
damped normal equations with diagonal clamping, accept/reject trust-region
damping (<= 16 rejects a step) and <= 10 outer steps with a plateau stop.

The JAX ``lax.while_loop`` pair becomes a loop of exactly ``max_steps`` outer
steps with no host sync: a finished solve keeps its state through the
remaining steps by ``torch.where``. The inner accept/reject loop is evaluated
all at once — the damping of the k-th try is ``min(d * up^k, d_max)``, so the
17 candidate steps are one batched 6x6 solve and one batched loss, and the
first accepted candidate is the one the sequential loop would take.

dtype follows the inputs: float64 on the CPU (reference-grade), float32 on the
card together with the local re-anchoring of ``Local_TwoFrame_PGO``.

``reduce`` is the counterpart of the JAX solver's ``axis_name``: when each
process holds a shard of the observations (``parallel/sharded_ba.py``), it
sums the per-shard loss, normal matrix and gradient, and the candidate
losses, over the process group, after which every process runs the identical
6x6 update.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from ..geometry import se3


class TwoFrameData(NamedTuple):
    """Static-shape observation block for one two-frame solve (padded to N)."""

    pose0: torch.Tensor        # (7,) initial pose of the frame to optimize
    points_w: torch.Tensor     # (N,3) world points (frame-0 backprojections)
    points_c: torch.Tensor     # (N,3) camera-frame points of frame 1 (ICP target)
    kp2: torch.Tensor          # (N,2) observed pixels on frame 1
    disp2: torch.Tensor        # (N,) observed disparity on frame 1
    cov_obs_c: torch.Tensor    # (N,3,3) frame-1 observation cov (camera frame)
    cov_pts_w: torch.Tensor    # (N,3,3) world point cov
    cov_kp2: torch.Tensor      # (N,2,2) pixel cov of kp2
    disp2_cov: torch.Tensor    # (N,) disparity variance
    K: torch.Tensor            # (3,3)
    baseline: torch.Tensor     # () scalar
    mask: torch.Tensor         # (N,) bool validity


def _safe_x(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Sign-preserving clamp away from zero (a degenerate landmark gives a
    large finite residual, never a NaN)."""
    sign_eps = torch.where(x < 0, torch.full_like(x, -eps), torch.full_like(x, eps))
    return torch.where(x.abs() < eps, sign_eps, x)


def _project_ned(points: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    x = _safe_x(points[..., 0])
    u = K[0, 0] * points[..., 1] / x + K[0, 2]
    v = K[1, 1] * points[..., 2] / x + K[1, 2]
    return torch.stack([u, v], dim=-1)


def _pinhole_jacobian(q: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """d(pi)/dq for the NED pinhole, (..., 2, 3)."""
    fx, fy = K[0, 0], K[1, 1]
    x, y, z = _safe_x(q[..., 0]), q[..., 1], q[..., 2]
    x2 = x * x
    zero = torch.zeros_like(x)
    row_u = torch.stack([-fx * y / x2, fx / x, zero], dim=-1)
    row_v = torch.stack([-fy * z / x2, zero, fy / x], dim=-1)
    return torch.stack([row_u, row_v], dim=-2)


# -- residual + Jacobian per graph type -----------------------------------------
# pose (C,7) -> residual (C,N,D), jacobian (C,N,D,6), cov (C|1,N,D,D).

def _icp_terms(pose, data: TwoFrameData):
    """r = T p_c - p_w; Sigma = R Sigma_obs R^T + Sigma_pt; J = [R | -R skew(p_c)]."""
    R = se3.rotmat(pose)[:, None]                                   # (C,1,3,3)
    r = se3.act(pose[:, None, :], data.points_c) - data.points_w
    J_rho = R.expand(r.shape[:-1] + (3, 3))
    J_phi = -(R @ se3.skew(data.points_c))
    cov = R @ data.cov_obs_c @ R.transpose(-1, -2) + data.cov_pts_w.to(R.dtype)
    return r, torch.cat([J_rho, J_phi], dim=-1), cov


def _reproj_q_jacobian(pose, points_w):
    """q = T^-1 p_w and dq/ddelta = [-I | skew(q)] for the right retraction."""
    q = se3.act(se3.inv(pose)[:, None, :], points_w)
    eye = torch.eye(3, dtype=q.dtype, device=q.device).expand(q.shape[:-1] + (3, 3))
    return q, torch.cat([-eye, se3.skew(q)], dim=-1)


def _reproj_terms(pose, data: TwoFrameData):
    """r = pi(T^-1 p_w) - kp2."""
    q, J_q = _reproj_q_jacobian(pose, data.points_w)
    r = _project_ned(q, data.K) - data.kp2
    return r, _pinhole_jacobian(q, data.K) @ J_q, data.cov_kp2[None]


def _reproj_disp_terms(pose, data: TwoFrameData):
    """r = [reproj_u, reproj_v, fx*bl/x - disp2] — the shipping ``disp`` graph."""
    q, J_q = _reproj_q_jacobian(pose, data.points_w)
    fx = data.K[0, 0]
    x = _safe_x(q[..., 0])
    reproj = _project_ned(q, data.K) - data.kp2
    disp_r = fx * data.baseline / x - data.disp2
    r = torch.cat([reproj, disp_r[..., None]], dim=-1)
    J_reproj = _pinhole_jacobian(q, data.K) @ J_q
    J_disp = (-(fx * data.baseline) / (x * x))[..., None, None] * J_q[..., 0:1, :]
    J = torch.cat([J_reproj, J_disp], dim=-2)
    n = data.kp2.shape[0]
    cov = torch.zeros((1, n, 3, 3), dtype=data.cov_kp2.dtype, device=data.cov_kp2.device)
    cov[0, :, :2, :2] = data.cov_kp2
    cov[0, :, 2, 2] = data.disp2_cov
    return r, J, cov


GRAPH_TERMS = {"icp": _icp_terms, "reproj": _reproj_terms, "disp": _reproj_disp_terms}


def _inverse_small(m: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of (...,2,2) or (...,3,3) matrices (adjugate / det)."""
    if m.shape[-1] == 2:
        a, b, c, d = m[..., 0, 0], m[..., 0, 1], m[..., 1, 0], m[..., 1, 1]
        inv = torch.stack([torch.stack([d, -b], -1), torch.stack([-c, a], -1)], -2)
        return inv / (a * d - b * c)[..., None, None]
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    A, B, C = e * i - f * h, -(d * i - f * g), d * h - e * g
    det = a * A + b * B + c * C
    adj = torch.stack([
        torch.stack([A, -(b * i - c * h), b * f - c * e], -1),
        torch.stack([B, a * i - c * g, -(a * f - c * d)], -1),
        torch.stack([C, -(a * h - b * g), a * e - b * d], -1),
    ], -2)
    return adj / det[..., None, None]


def _block_whiten(cov: torch.Tensor, mask: torch.Tensor, ridge: float = 1e-12) -> torch.Tensor:
    """Per-observation inverse covariance; masked rows get zero weight."""
    d = cov.shape[-1]
    eye = torch.eye(d, dtype=cov.dtype, device=cov.device)
    m = mask[:, None, None]
    safe = torch.where(m, cov, eye) + ridge * eye
    return torch.where(m, _inverse_small(safe), torch.zeros_like(safe))


def solve_two_frame(data: TwoFrameData, graph_type: str = "icp", huber_delta: float = 0.1,
                    damping_init: float = 1e-3, damping_up: float = 4.0, damping_down: float = 0.5,
                    damping_min: float = 1e-9, damping_max: float = 1e10, diag_min: float = 1e-6,
                    diag_max: float = 1e32, plateau_decreasing: float = 1e-5,
                    plateau_patience: int = 2, max_steps: int = 10, max_rejects: int = 16,
                    reduce: Optional[Callable[[torch.Tensor], torch.Tensor]] = None) -> torch.Tensor:
    """Run the damped LM solve; returns the optimized (7,) SE3 pose.

    ``reduce``: None for a solve over all of ``data``; else a function that
    sums a tensor over the processes that hold the other observation shards
    (one call a system, one a set of candidates)."""
    terms_fn = GRAPH_TERMS[graph_type]
    dtype, dev = data.points_w.dtype, data.points_w.device
    mask_f = data.mask.to(dtype)

    def whitened(pose):
        r, J, cov = terms_fn(pose, data)
        W = _block_whiten(cov, data.mask)
        sq = torch.einsum("cni,cnij,cnj->cn", r, W.expand(r.shape[:-1] + W.shape[-2:]), r).clamp(min=0.0)
        e = torch.sqrt(sq + 1e-24)
        rho = torch.where(e <= huber_delta, sq, 2.0 * huber_delta * e - huber_delta**2)
        return r, J, W, e, torch.sum(rho * mask_f, dim=-1)

    def loss_only(twists):                              # (C,6) -> (C,)
        loss = whitened(se3.mul(data.pose0, se3.exp(twists)))[-1]
        return loss if reduce is None else reduce(loss)

    def system(twist):                                  # (6,) -> loss, A (6,6), b (6,)
        r, J, W, e, loss = whitened(se3.mul(data.pose0, se3.exp(twist))[None])
        w = torch.where(e <= huber_delta, torch.ones_like(e), huber_delta / e) * mask_f
        Weff = W.expand(r.shape[:-1] + W.shape[-2:]) * w[..., None, None]
        A = torch.einsum("cndi,cndk,cnkj->ij", J, Weff, J)
        b = -torch.einsum("cndi,cndk,cnk->i", J, Weff, r)
        if reduce is None:
            return loss[0], A, b
        summed = reduce(torch.cat([loss[:1], A.reshape(36), b]))
        return summed[0], summed[1:37].reshape(6, 6), summed[37:]

    ks = torch.arange(max_rejects + 1, device=dev, dtype=dtype)
    idx6 = torch.arange(6, device=dev)
    twist = torch.zeros(6, dtype=dtype, device=dev)
    damping = torch.tensor(damping_init, dtype=dtype, device=dev)
    plateau = torch.zeros((), dtype=torch.int64, device=dev)
    done = torch.zeros((), dtype=torch.bool, device=dev)
    for _ in range(max_steps):
        last_loss, A, b = system(twist)
        diag = torch.clamp(torch.diagonal(A), diag_min, diag_max)
        A = A.clone()
        A[idx6, idx6] = diag
        damp_k = torch.clamp(damping * damping_up ** ks, max=damping_max)          # (17,)
        A_k = A + torch.diag_embed(diag[None] * damp_k[:, None])
        delta_k = torch.linalg.solve_ex(A_k, b.expand(ks.shape[0], 6))[0]
        cand_k = se3.log(se3.mul(se3.exp(twist), se3.exp(delta_k)))
        cand_loss = loss_only(cand_k)
        acc_k = cand_loss < last_loss
        accepted = acc_k.any()
        first = torch.argmax(acc_k.to(torch.int64))
        new_twist = torch.where(accepted, cand_k[first], twist)
        new_damping = torch.where(accepted, torch.clamp(damp_k[first] * damping_down, min=damping_min),
                                  torch.clamp(damping * damping_up ** (max_rejects + 1), max=damping_max))
        new_loss = torch.where(accepted, cand_loss[first], last_loss)
        improved = (last_loss - new_loss) > plateau_decreasing
        new_plateau = torch.where(improved, torch.zeros_like(plateau), plateau + 1)
        new_done = (new_plateau >= plateau_patience) | ~accepted
        active = ~done
        twist = torch.where(active, new_twist, twist)
        damping = torch.where(active, new_damping, damping)
        plateau = torch.where(active, new_plateau, plateau)
        done = done | new_done
    return se3.normalize(se3.mul(data.pose0, se3.exp(twist)))


# -- packed transport ------------------------------------------------------------
# (cap+1, 33): points_w 0:3 | points_c 3:6 | kp2 6:8 | disp2 8 | cov_obs_c 9:18 |
# cov_pts_w 18:27 | cov_kp2 27:31 | disp2_cov 31 | mask 32; last row: pose0 0:7 |
# fx fy cx cy 7:11 | baseline 11.
PACKED_WIDTH = 33


def intrinsics(fx, fy, cx, cy) -> torch.Tensor:
    zero, one = torch.zeros_like(fx), torch.ones_like(fx)
    return torch.stack([torch.stack([fx, zero, cx]), torch.stack([zero, fy, cy]),
                        torch.stack([zero, zero, one])])


def unpack_two_frame(packed: torch.Tensor) -> TwoFrameData:
    cap = packed.shape[0] - 1
    aux = packed[cap]
    mask = packed[:cap, 32] > 0.5
    # Padded rows get a benign point at unit depth: a zero point would project
    # through x = 0 and its NaN would defeat the mask.
    benign = packed.new_tensor([1.0, 0.0, 0.0])
    return TwoFrameData(
        pose0=aux[0:7],
        points_w=torch.where(mask[:, None], packed[:cap, 0:3], benign),
        points_c=torch.where(mask[:, None], packed[:cap, 3:6], benign),
        kp2=packed[:cap, 6:8],
        disp2=packed[:cap, 8],
        cov_obs_c=packed[:cap, 9:18].reshape(cap, 3, 3),
        cov_pts_w=packed[:cap, 18:27].reshape(cap, 3, 3),
        cov_kp2=packed[:cap, 27:31].reshape(cap, 2, 2),
        disp2_cov=packed[:cap, 31],
        K=intrinsics(aux[7], aux[8], aux[9], aux[10]),
        baseline=aux[11],
        mask=mask,
    )


def solve_two_frame_packed(packed: torch.Tensor, graph_type: str = "icp") -> torch.Tensor:
    return solve_two_frame(unpack_two_frame(packed), graph_type=graph_type)
