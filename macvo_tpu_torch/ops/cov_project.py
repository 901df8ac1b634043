"""2D->3D covariance projection (port of ``macvo_tpu/ops/cov_project.py``).

NED convention: index 0 of the 3x3 matrices is the forward (depth) axis,
``[[s_zz, s_xz, s_yz], [s_xz, s_xx, s_xy], [s_yz, s_xy, s_yy]]``. The patch
gathers, one-hot matmuls in the JAX version, are plain advanced indexing here.
"""

from __future__ import annotations

import torch

from ..geometry.gaussian import gaussian_full_kernels


def covariance_2to3_full(sigma_uu, sigma_uv, sigma_vv, sigma_dd, u, v, d, fx, fy, cx, cy) -> torch.Tensor:
    """Full-covariance pixel->camera projection, (N,) inputs -> (N,3,3)."""
    du, dv = u - cx, v - cy
    d2 = d * d
    s_xx = (du * du * sigma_dd + d2 * sigma_uu + sigma_uu * sigma_dd) / fx**2
    s_yy = (dv * dv * sigma_dd + d2 * sigma_vv + sigma_vv * sigma_dd) / fy**2
    s_zz = sigma_dd
    s_xy = (du * dv * sigma_dd + (d2 + sigma_dd) * sigma_uv) / (fx * fy)
    s_xz = sigma_dd * du / fx
    s_yz = sigma_dd * dv / fy
    row0 = torch.stack([s_zz, s_xz, s_yz], dim=-1)
    row1 = torch.stack([s_xz, s_xx, s_xy], dim=-1)
    row2 = torch.stack([s_yz, s_xy, s_yy], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


def gather_patches(dense: torch.Tensor, kp_uv: torch.Tensor, kernel_size: int) -> torch.Tensor:
    """(K,K) patches of an (H,W) map around N keypoints -> (N,K,K) with
    ``patches[n, i, j] = dense[v_n + off_j, u_n + off_i]``; taps clamp to the border."""
    h, w = dense.shape
    half = kernel_size // 2
    offsets = torch.arange(-half, half + 1, device=dense.device)
    u_idx = (kp_uv[:, 0].to(torch.int64)[:, None] + offsets).clamp(0, w - 1)
    v_idx = (kp_uv[:, 1].to(torch.int64)[:, None] + offsets).clamp(0, h - 1)
    return dense[v_idx[:, None, :], u_idx[:, :, None]]


def match_covariance(depth_map: torch.Tensor, kp_uv: torch.Tensor, depth_cov: torch.Tensor,
                     flow_cov: torch.Tensor, fx, fy, cx, cy, kernel_size: int,
                     match_cov_default: float, min_flow_cov: float, min_depth_cov: float,
                     has_flow_cov: bool, has_depth_cov: bool) -> torch.Tensor:
    """MAC-VO MatchCovariance: anisotropic Gaussian kernels from the 2x2 flow
    cov weigh the local depth patch; its weighted mean and variance project to
    an (N,3,3) camera-frame covariance (dtype of ``depth_map``)."""
    n = kp_uv.shape[0]
    if has_flow_cov:
        flow_cov = torch.cat([torch.clamp(flow_cov[..., :2], min=min_flow_cov**2), flow_cov[..., 2:3]], dim=-1)
    else:
        flow_cov = torch.full((n, 3), match_cov_default, dtype=depth_map.dtype, device=depth_map.device)
        flow_cov[:, 2] = 0.0
    var_u, var_v, var_uv = flow_cov[..., 0], flow_cov[..., 1], flow_cov[..., 2]
    cov_2x2 = torch.stack([torch.stack([var_u, var_uv], -1), torch.stack([var_uv, var_v], -1)], dim=-2)
    kernels = gaussian_full_kernels(cov_2x2, kernel_size)
    patches = gather_patches(depth_map, kp_uv, kernel_size)

    wavg_depth = torch.sum(kernels * patches, dim=(-1, -2))
    if has_flow_cov or not has_depth_cov:
        wvar_depth = torch.sum(kernels * (patches - wavg_depth[:, None, None]) ** 2, dim=(-1, -2))
    else:
        wvar_depth = depth_cov
    wvar_depth = torch.clamp(wvar_depth, min=min_depth_cov)
    return covariance_2to3_full(var_u, var_uv, var_v, wvar_depth, kp_uv[..., 0], kp_uv[..., 1],
                                wavg_depth, fx, fy, cx, cy)
