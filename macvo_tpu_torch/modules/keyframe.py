"""Keyframe selectors (port of ``macvo_tpu/modules/keyframe.py``)."""

from __future__ import annotations

from types import SimpleNamespace

from ..utils.registry import RegisteredConfigTestable


class IKeyframeSelector(RegisteredConfigTestable, register=False):
    def __init__(self, config: SimpleNamespace) -> None:
        self.config = config

    def is_keyframe(self, frame) -> bool:
        raise NotImplementedError


class AllKeyframe(IKeyframeSelector):
    def is_keyframe(self, frame) -> bool:
        return True

    @classmethod
    def is_valid_config(cls, config) -> None:
        cls._enforce_config_spec(config, {})


class UniformKeyframe(IKeyframeSelector):
    """Every ``keyframe_freq``-th frame is a keyframe; the others are marked
    for interpolation at the end."""

    def is_keyframe(self, frame) -> bool:
        return (frame.frame_idx % self.config.keyframe_freq) == 0

    @classmethod
    def is_valid_config(cls, config) -> None:
        cls._enforce_config_spec(config, {"keyframe_freq": lambda f: isinstance(f, int) and f >= 1})
