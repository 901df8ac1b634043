"""2D->3D covariance projection (port of ``macvo_tpu/ops/cov_project.py``).

NED convention: index 0 of the 3x3 matrices is the forward (depth) axis,
``[[s_zz, s_xz, s_yz], [s_xz, s_xx, s_xy], [s_yz, s_xy, s_yy]]``. The patch
gathers, one-hot matmuls in the JAX version, are plain advanced indexing here.
"""

from __future__ import annotations

import torch

from ..geometry.gaussian import gaussian_full_kernels, gaussian_mixture_mean_var


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


def covariance_2to3_diag(sigma_uu, sigma_vv, sigma_dd, u, v, d, fx, fy, cx, cy) -> torch.Tensor:
    """:func:`covariance_2to3_full` of a diagonal pixel covariance (sigma_uv = 0)."""
    return covariance_2to3_full(sigma_uu, torch.zeros_like(sigma_uu), sigma_vv, sigma_dd, u, v, d, fx, fy, cx, cy)


def gather_patches(dense: torch.Tensor, kp_uv: torch.Tensor, kernel_size: int) -> torch.Tensor:
    """(K,K) patches of an (H,W) map around N keypoints -> (N,K,K) with
    ``patches[n, i, j] = dense[v_n + off_j, u_n + off_i]``; taps clamp to the border."""
    h, w = dense.shape
    half = kernel_size // 2
    offsets = torch.arange(-half, half + 1, device=dense.device)
    u_idx = (kp_uv[:, 0].to(torch.int64)[:, None] + offsets).clamp(0, w - 1)
    v_idx = (kp_uv[:, 1].to(torch.int64)[:, None] + offsets).clamp(0, h - 1)
    return dense[v_idx[:, None, :], u_idx[:, :, None]]


def _flow_variances(flow_cov: torch.Tensor, n: int, like: torch.Tensor, match_cov_default: float,
                  min_flow_cov: float, has_flow_cov: bool):
    """Clamp the given (N,3) flow covariance to the quantization floor, or
    make the default isotropic one; returns (var_u, var_v, var_uv)."""
    if has_flow_cov:
        flow_cov = torch.cat([torch.clamp(flow_cov[..., :2], min=min_flow_cov**2), flow_cov[..., 2:3]], dim=-1)
    else:
        flow_cov = torch.full((n, 3), match_cov_default, dtype=like.dtype, device=like.device)
        flow_cov[:, 2] = 0.0
    return flow_cov[..., 0], flow_cov[..., 1], flow_cov[..., 2]


def _kernels_f64(var_u, var_v, var_uv, kernel_size: int) -> torch.Tensor:
    """(N,K,K) Gaussian kernels in float64. The kernel, its normalisation and
    the weighted moments built on it run in float64 and are cast back: fp32
    sums over K*K taps carry rounding that depends on the order of summation."""
    cov_2x2 = torch.stack([torch.stack([var_u, var_uv], -1), torch.stack([var_uv, var_v], -1)], dim=-2)
    return gaussian_full_kernels(cov_2x2.double(), kernel_size)


def match_covariance(depth_map: torch.Tensor, kp_uv: torch.Tensor, depth_cov: torch.Tensor,
                     flow_cov: torch.Tensor, fx, fy, cx, cy, kernel_size: int,
                     match_cov_default: float, min_flow_cov: float, min_depth_cov: float,
                     has_flow_cov: bool, has_depth_cov: bool) -> torch.Tensor:
    """MAC-VO MatchCovariance: anisotropic Gaussian kernels from the 2x2 flow
    cov weigh the local depth patch; its weighted mean and variance project to
    an (N,3,3) camera-frame covariance (dtype of ``depth_map``)."""
    var_u, var_v, var_uv = _flow_variances(flow_cov, kp_uv.shape[0], depth_map, match_cov_default,
                                         min_flow_cov, has_flow_cov)
    kernels = _kernels_f64(var_u, var_v, var_uv, kernel_size)
    patches = gather_patches(depth_map, kp_uv, kernel_size).double()
    wavg_depth = torch.sum(kernels * patches, dim=(-1, -2))
    if has_flow_cov or not has_depth_cov:
        wvar_depth = torch.sum(kernels * (patches - wavg_depth[:, None, None]) ** 2, dim=(-1, -2))
        wvar_depth = wvar_depth.to(depth_map.dtype)
    else:
        wvar_depth = depth_cov
    wvar_depth = torch.clamp(wvar_depth, min=min_depth_cov)
    return covariance_2to3_full(var_u, var_uv, var_v, wvar_depth, kp_uv[..., 0], kp_uv[..., 1],
                                wavg_depth.to(depth_map.dtype), fx, fy, cx, cy)


def gaussian_mixture_covariance(depth_map: torch.Tensor, depth_cov_map: torch.Tensor, kp_uv: torch.Tensor,
                                depth_cov: torch.Tensor, flow_cov: torch.Tensor, fx, fy, cx, cy,
                                kernel_size: int, match_cov_default: float, min_flow_cov: float,
                                min_depth_cov: float, has_flow_cov: bool, has_depth_cov: bool) -> torch.Tensor:
    """Gaussian-mixture variant of :func:`match_covariance`: the depth patch is
    a mixture of per-pixel Gaussians (depth, depth variance) weighted by the
    flow kernel."""
    n = kp_uv.shape[0]
    var_u, var_v, var_uv = _flow_variances(flow_cov, n, depth_map, match_cov_default, min_flow_cov, has_flow_cov)
    kernels = _kernels_f64(var_u, var_v, var_uv, kernel_size).reshape(n, -1)
    patches = gather_patches(depth_map, kp_uv, kernel_size).double().reshape(n, -1)
    cov_patches = gather_patches(depth_cov_map, kp_uv, kernel_size).double().reshape(n, -1)
    wavg_depth, wvar_depth = gaussian_mixture_mean_var(patches, cov_patches, kernels)
    wvar_depth = depth_cov if (has_depth_cov and not has_flow_cov) else wvar_depth.to(depth_map.dtype)
    wvar_depth = torch.clamp(wvar_depth, min=min_depth_cov)
    return covariance_2to3_full(var_u, var_uv, var_v, wvar_depth, kp_uv[..., 0], kp_uv[..., 1],
                                wavg_depth.to(depth_map.dtype), fx, fy, cx, cy)


def depth_only_covariance(kp_uv: torch.Tensor, depth_cov: torch.Tensor, fx, fy, cx, cy,
                          regularization: float) -> torch.Tensor:
    """The (N,3,3) projection of the depth variance alone along each pixel's
    ray, plus ``regularization`` x I (it keeps the LM problem full rank)."""
    factor_x = (kp_uv[..., 0] - cx) / fx
    factor_y = (kp_uv[..., 1] - cy) / fy
    var_z = depth_cov
    var_x, var_y = factor_x * factor_x * var_z, factor_y * factor_y * var_z
    cov_xy, cov_xz, cov_yz = factor_x * factor_y * var_z, factor_x * var_z, factor_y * var_z
    cov = torch.stack([torch.stack([var_z, cov_xz, cov_yz], -1), torch.stack([cov_xz, var_x, cov_xy], -1),
                       torch.stack([cov_yz, cov_xy, var_y], -1)], dim=-2)
    return cov + regularization * torch.eye(3, dtype=cov.dtype, device=cov.device)
