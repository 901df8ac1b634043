"""TartanVO network family (port of ``macvo_tpu/models/tartanvo``): the PWC
flow net, the hourglass stereo net with its covariance decoder and the
VOFlowRes pose head, and the RAFT-style flow-covariance net."""

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
from .pwc import PWCFlowNet, PyramidEncoder, warp_features
from .raftcov import GaussianGRU, GaussianHead, GaussianIteration, RAFTFlowCovNet
from .stereonet import HourglassDecoder, StereoCovNet

__all__ = [
    "FLOW_NORM", "IMAGENET_MEAN", "IMAGENET_STD", "POSE_DEPTH_NORM", "POSE_NORM", "POSENET_SIZE",
    "STEREO_NORM", "GaussianGRU", "GaussianHead", "GaussianIteration", "HourglassDecoder", "PWCFlowNet",
    "PyramidEncoder", "RAFTFlowCovNet", "StereoCovNet", "VOFlowRes", "crop_to_multiple",
    "make_intrinsics_layer", "normalize_image", "resize_bilinear", "warp_features",
]
