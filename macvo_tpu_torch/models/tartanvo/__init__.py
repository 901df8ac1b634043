"""TartanVO network family (port of ``macvo_tpu/models/tartanvo``): the PWC
flow net, the hourglass stereo net with its covariance decoder and the
VOFlowRes pose head. ``RAFTFlowCovNet`` is not ported yet."""

from .network import (
    FLOW_NORM,
    IMAGENET_MEAN,
    IMAGENET_STD,
    POSE_DEPTH_NORM,
    POSE_NORM,
    POSENET_SIZE,
    STEREO_NORM,
    crop_to_multiple,
    make_intrinsics_layer,
    normalize_image,
    resize_bilinear,
)
from .posenet import VOFlowRes
from .pwc import PWCFlowNet, warp_features
from .stereonet import HourglassDecoder, StereoCovNet

__all__ = [
    "FLOW_NORM", "IMAGENET_MEAN", "IMAGENET_STD", "POSE_DEPTH_NORM", "POSE_NORM", "POSENET_SIZE",
    "STEREO_NORM", "HourglassDecoder", "PWCFlowNet", "StereoCovNet", "VOFlowRes", "crop_to_multiple",
    "make_intrinsics_layer", "normalize_image", "resize_bilinear", "warp_features",
]
