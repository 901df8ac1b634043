"""Observation outlier filters — keep-mask producers (port of ``macvo_tpu/modules/outlier.py``).

Filters take a dict of ``(N, ...)`` observation tensors (the MATCH_FIELDS of
``worldmap/visual_map.py``) and return an ``(N,)`` bool mask, True = keep.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Mapping

import torch

from ..data.frame import StereoData
from ..utils.registry import RegisteredConfigTestable

Obs = Mapping[str, torch.Tensor]


class IObservationFilter(RegisteredConfigTestable, register=False):
    def __init__(self, config: SimpleNamespace) -> None:
        self.config = config

    @property
    def required_keys(self) -> set[str]:
        return set()

    def verify_shape(self, values: Obs) -> bool:
        return all(k in values for k in self.required_keys)

    def set_meta(self, meta: StereoData) -> None:
        """Receive first-frame meta (intrinsics) for dynamic thresholds."""

    def filter(self, values: Obs) -> torch.Tensor:
        raise NotImplementedError

    @staticmethod
    def _ones(values: Obs) -> torch.Tensor:
        first = next(iter(values.values()))
        return torch.ones((first.shape[0],), dtype=torch.bool, device=first.device)


class IdentityFilter(IObservationFilter):
    """Keep everything."""

    def filter(self, values: Obs) -> torch.Tensor:
        return self._ones(values)

    @classmethod
    def is_valid_config(cls, config) -> None:
        return


class FilterCompose(IObservationFilter):
    """AND-chain of child filters."""

    def __init__(self, config: SimpleNamespace) -> None:
        super().__init__(config)
        self.filters = [IObservationFilter.instantiate(a.type, a.args) for a in config.filter_args]

    @property
    def required_keys(self) -> set[str]:
        return {k for f in self.filters for k in f.required_keys}

    def set_meta(self, meta: StereoData) -> None:
        for f in self.filters:
            f.set_meta(meta)

    def filter(self, values: Obs) -> torch.Tensor:
        mask = self._ones(values)
        for f in self.filters:
            mask = mask & f.filter(values)
        return mask

    @classmethod
    def is_valid_config(cls, config) -> None:
        for arg in config.filter_args:
            IObservationFilter.is_valid_config(arg)


class CovarianceSanityFilter(IObservationFilter):
    """Reject observations whose 3x3 covariances carry NaN/Inf."""

    @property
    def required_keys(self) -> set[str]:
        return {"obs1_covTc", "obs2_covTc"}

    def filter(self, values: Obs) -> torch.Tensor:
        bad = ~self._ones(values)
        for key in ("obs1_covTc", "obs2_covTc"):
            bad = bad | (~torch.isfinite(values[key])).any(dim=-1).any(dim=-1)
        return ~bad

    @classmethod
    def is_valid_config(cls, config) -> None:
        return


class SimpleDepthFilter(IObservationFilter):
    """Keep observations with depth in [min_depth, max_depth]; ``auto`` max is fx * baseline."""

    @property
    def required_keys(self) -> set[str]:
        return {"pixel1_d", "pixel2_d"}

    def set_meta(self, meta: StereoData) -> None:
        if self.config.max_depth == "auto":
            self.config.max_depth = meta.fx * meta.frame_baseline

    def filter(self, values: Obs) -> torch.Tensor:
        d1, d2 = values["pixel1_d"][..., 0], values["pixel2_d"][..., 0]
        lo, hi = self.config.min_depth, self.config.max_depth
        return ~((d1 < lo) | (d1 > hi) | (d2 < lo) | (d2 > hi))

    @classmethod
    def is_valid_config(cls, config) -> None:
        cls._enforce_config_spec(config, {
            "min_depth": lambda d: isinstance(d, (int, float)) and d > 0.0,
            "max_depth": lambda d: (d == "auto") or (isinstance(d, (int, float)) and d > 0.0),
        })


class LikelyFrontOfCamFilter(IObservationFilter):
    """Keep observations likely in front of the camera, d - 2 sigma_d > 0 in
    both frames. When any depth covariance is the -1 placeholder (no depth
    covariance) it keeps everything; that test stays on the device."""

    @property
    def required_keys(self) -> set[str]:
        return {"pixel1_d", "pixel1_d_cov", "pixel2_d", "pixel2_d_cov"}

    def filter(self, values: Obs) -> torch.Tensor:
        c1, c2 = values["pixel1_d_cov"][..., 0], values["pixel2_d_cov"][..., 0]
        d1, d2 = values["pixel1_d"][..., 0], values["pixel2_d"][..., 0]
        keep = ((d1 - 2.0 * torch.sqrt(torch.clamp(c1, min=0.0))) > 0.0) & (
            (d2 - 2.0 * torch.sqrt(torch.clamp(c2, min=0.0))) > 0.0)
        return keep | (c1 == -1.0).any() | (c2 == -1.0).any()

    @classmethod
    def is_valid_config(cls, config) -> None:
        return
