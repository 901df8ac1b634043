from .frame import StereoData, StereoFrame
from .sequence import DevicePrefetcher, SequenceBase

# Import dataset modules so their classes register.
from .datasets import synthetic as _synthetic  # noqa: F401
from .datasets import tartanair as _tartanair  # noqa: F401

__all__ = ["DevicePrefetcher", "SequenceBase", "StereoData", "StereoFrame"]
