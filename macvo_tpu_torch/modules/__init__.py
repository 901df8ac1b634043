"""Pluggable pipeline modules; importing this package registers every implementation."""

from .covariance import ICovariance2to3, MatchCovariance
from .frontend import (
    DepthOutput,
    FrontendCompose,
    GTDepth,
    GTMatcher,
    IFrontend,
    IMatcher,
    IStereoDepth,
    MatchOutput,
    retrieve_pixels,
)
from .frontend_network import FlowFormerCovFrontend
from .frontend_tartanvo import TartanMotionNet, TartanVODepth, TartanVOMatcher
from .keyframe import AllKeyframe, IKeyframeSelector
from .keypoint import (
    CovAwareSelector_NoDepth,
    GridSelector,
    IKeypointSelector,
    MappingPointSelector,
    RandomSelector,
)
from .map_processor import IMapProcessor, MotionInterpolate
from .motion import IMotionModel, StaticMotionModel
from .outlier import CovarianceSanityFilter, FilterCompose, IObservationFilter, SimpleDepthFilter

__all__ = [
    "AllKeyframe", "CovAwareSelector_NoDepth", "CovarianceSanityFilter", "DepthOutput",
    "FilterCompose", "FlowFormerCovFrontend", "FrontendCompose", "GTDepth", "GTMatcher",
    "GridSelector", "ICovariance2to3", "IFrontend", "IKeyframeSelector", "IKeypointSelector",
    "IMapProcessor", "IMatcher", "IMotionModel", "IObservationFilter", "IStereoDepth",
    "MappingPointSelector", "MatchCovariance", "MatchOutput", "MotionInterpolate", "RandomSelector",
    "SimpleDepthFilter", "StaticMotionModel", "TartanMotionNet", "TartanVODepth", "TartanVOMatcher",
    "retrieve_pixels",
]
