from .frame import AttitudeData, IMUData, StereoData, StereoFrame, StereoInertialFrame
from .sequence import DevicePrefetcher, PreloadedSequence, SequenceBase, TransformSequence, smart_transform
from .transform import IDataTransform

# Import dataset modules so their classes register.
from .datasets import euroc as _euroc  # noqa: F401
from .datasets import general as _general  # noqa: F401
from .datasets import kitti as _kitti  # noqa: F401
from .datasets import randomized as _randomized  # noqa: F401
from .datasets import synthetic as _synthetic  # noqa: F401
from .datasets import tartanair as _tartanair  # noqa: F401
from .datasets import vbr as _vbr  # noqa: F401

__all__ = [
    "AttitudeData",
    "DevicePrefetcher",
    "IDataTransform",
    "IMUData",
    "PreloadedSequence",
    "SequenceBase",
    "StereoData",
    "StereoFrame",
    "StereoInertialFrame",
    "TransformSequence",
    "smart_transform",
]
