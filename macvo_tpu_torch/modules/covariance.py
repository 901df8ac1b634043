"""ICovariance2to3 module family (port of ``macvo_tpu/modules/covariance.py``).

``estimate(frame, kp (N,2), depth_est, depth_cov (N,)|None, flow_cov (N,3)|None)
-> (N,3,3)`` camera-frame covariance per keypoint, in the dtype of the depth
map (fp32; the JAX package gives float64 where x64 is on).
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Optional

import torch

from ..data.frame import StereoData
from ..ops.cov_project import depth_only_covariance, gaussian_mixture_covariance, match_covariance
from ..utils.logging import Logger
from ..utils.registry import RegisteredConfigTestable
from .frontend import DepthOutput

_POS_NUM = lambda v: isinstance(v, (int, float)) and v > 0
_ODD = lambda v: isinstance(v, int) and v > 0 and v % 2 == 1


class ICovariance2to3(RegisteredConfigTestable, register=False):
    def __init__(self, config: SimpleNamespace) -> None:
        self.config = config

    def estimate(self, frame: StereoData, kp: torch.Tensor, depth_est: DepthOutput,
                 depth_cov: Optional[torch.Tensor], flow_cov: Optional[torch.Tensor]) -> torch.Tensor:
        raise NotImplementedError


class NoCovariance(ICovariance2to3):
    """Identity covariance for every observation."""

    def estimate(self, frame, kp, depth_est, depth_cov, flow_cov) -> torch.Tensor:
        return torch.eye(3, dtype=depth_est.depth.dtype, device=kp.device).repeat(kp.shape[0], 1, 1)

    @classmethod
    def is_valid_config(cls, config) -> None:
        return


class DepthCovariance(ICovariance2to3):
    """The per-keypoint depth variance alone, projected along each ray, plus
    ``regularization`` x I (default 1e-5)."""

    def __init__(self, config: SimpleNamespace) -> None:
        super().__init__(config)
        if getattr(config, "regularization", None) is None:
            config.regularization = 1e-5
            Logger.info("DepthCovariance: regularization defaulted to 1e-5")

    def estimate(self, frame, kp, depth_est, depth_cov, flow_cov) -> torch.Tensor:
        if depth_cov is None:
            raise ValueError("DepthCovariance needs the per-keypoint depth covariance")
        return depth_only_covariance(kp, depth_cov, frame.fx, frame.fy, frame.cx, frame.cy,
                                     float(self.config.regularization))

    @classmethod
    def is_valid_config(cls, config) -> None:
        cls._enforce_config_spec(config, {"regularization": lambda r: (r is None) or _POS_NUM(r)})


class _PatchCovariance(ICovariance2to3, register=False):
    """Shared host of the two patch models: the config keys and the optional
    per-keypoint inputs replaced by zeros."""

    def _inputs(self, kp, depth_est, depth_cov, flow_cov) -> tuple:
        depth_map = depth_est.depth[0, ..., 0]
        n = kp.shape[0]
        zeros = torch.zeros((n,), dtype=depth_map.dtype, device=depth_map.device)
        return (kp.to(depth_map.dtype), depth_cov if depth_cov is not None else zeros,
                flow_cov if flow_cov is not None else zeros[:, None].expand(n, 3))

    def _args(self, frame, depth_cov, flow_cov) -> tuple:
        return (frame.fx, frame.fy, frame.cx, frame.cy, int(self.config.kernel_size),
                float(self.config.match_cov_default), float(self.config.min_flow_cov),
                float(self.config.min_depth_cov), flow_cov is not None, depth_cov is not None)

    @classmethod
    def is_valid_config(cls, config) -> None:
        cls._enforce_config_spec(config, {
            "kernel_size": _ODD,
            "match_cov_default": _POS_NUM,
            "min_flow_cov": _POS_NUM,
            "min_depth_cov": _POS_NUM,
        })


class MatchCovariance(_PatchCovariance):
    """MAC-VO covariance model (paper III.C)."""

    def estimate(self, frame, kp, depth_est, depth_cov, flow_cov) -> torch.Tensor:
        return match_covariance(depth_est.depth[0, ..., 0], *self._inputs(kp, depth_est, depth_cov, flow_cov),
                                *self._args(frame, depth_cov, flow_cov))


class GaussianMixtureCovariance(_PatchCovariance):
    """The depth patch as a mixture of per-pixel Gaussians (depth, depth
    variance) weighted by the flow kernel; needs a dense depth covariance."""

    def estimate(self, frame, kp, depth_est, depth_cov, flow_cov) -> torch.Tensor:
        if depth_est.cov is None:
            raise ValueError("GaussianMixtureCovariance needs a dense depth covariance map")
        return gaussian_mixture_covariance(depth_est.depth[0, ..., 0], depth_est.cov[0, ..., 0],
                                           *self._inputs(kp, depth_est, depth_cov, flow_cov),
                                           *self._args(frame, depth_cov, flow_cov))


class Modifier_Diagonalize(ICovariance2to3):
    """Ablation modifier: the wrapped model's covariances with their
    off-diagonal terms zeroed."""

    def __init__(self, config: SimpleNamespace) -> None:
        super().__init__(config)
        self.submodule = ICovariance2to3.instantiate(config.type, config.args)

    def estimate(self, frame, kp, depth_est, depth_cov, flow_cov) -> torch.Tensor:
        covs = self.submodule.estimate(frame, kp, depth_est, depth_cov, flow_cov)
        return covs * torch.eye(3, dtype=covs.dtype, device=covs.device)

    @classmethod
    def is_valid_config(cls, config) -> None:
        ICovariance2to3.is_valid_config(config)


def det_3x3_f64(m: torch.Tensor) -> torch.Tensor:
    """Determinants of (N,3,3) matrices by cofactors, in float64: a covariance
    with entries near 1e-4 has a determinant near 1e-12."""
    m = m.double()
    return (m[:, 0, 0] * (m[:, 1, 1] * m[:, 2, 2] - m[:, 1, 2] * m[:, 2, 1])
            - m[:, 0, 1] * (m[:, 1, 0] * m[:, 2, 2] - m[:, 1, 2] * m[:, 2, 0])
            + m[:, 0, 2] * (m[:, 1, 0] * m[:, 2, 1] - m[:, 1, 1] * m[:, 2, 0]))


class Modifier_Normalize(ICovariance2to3):
    """Ablation modifier: the wrapped model's covariances divided by their
    determinant (float64, cast back)."""

    def __init__(self, config: SimpleNamespace) -> None:
        super().__init__(config)
        self.submodule = ICovariance2to3.instantiate(config.type, config.args)

    def estimate(self, frame, kp, depth_est, depth_cov, flow_cov) -> torch.Tensor:
        covs = self.submodule.estimate(frame, kp, depth_est, depth_cov, flow_cov)
        return (covs.double() / det_3x3_f64(covs)[:, None, None]).to(covs.dtype)

    @classmethod
    def is_valid_config(cls, config) -> None:
        ICovariance2to3.is_valid_config(config)
