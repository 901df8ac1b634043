"""Pluggable pipeline modules; importing this package registers every implementation."""

from .covariance import (
    DepthCovariance,
    GaussianMixtureCovariance,
    ICovariance2to3,
    MatchCovariance,
    Modifier_Diagonalize,
    Modifier_Normalize,
    NoCovariance,
)
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
from .keyframe import AllKeyframe, IKeyframeSelector, UniformKeyframe
from .keypoint import (
    CovAwareSelector,
    CovAwareSelector_NoDepth,
    GradientSelector,
    GridSelector,
    IKeypointSelector,
    MappingPointSelector,
    RandomSelector,
    SelectorCompose,
    SparseGradienSelector,
    SparseGradientSelector,
)
from .map_processor import IMapProcessor, MotionInterpolate, Naive, PoseInterpolate
from .motion import GTMotionwithNoise, IMotionModel, ReadPoseFile, StaticMotionModel
from .outlier import (
    CovarianceSanityFilter,
    FilterCompose,
    IdentityFilter,
    IObservationFilter,
    LikelyFrontOfCamFilter,
    SimpleDepthFilter,
)

__all__ = [
    "AllKeyframe", "CovAwareSelector", "CovAwareSelector_NoDepth", "CovarianceSanityFilter",
    "DepthCovariance", "DepthOutput", "FilterCompose", "FlowFormerCovFrontend", "FrontendCompose",
    "GTDepth", "GTMatcher", "GTMotionwithNoise", "GaussianMixtureCovariance", "GradientSelector",
    "GridSelector", "ICovariance2to3", "IFrontend", "IKeyframeSelector", "IKeypointSelector",
    "IMapProcessor", "IMatcher", "IMotionModel", "IObservationFilter", "IStereoDepth", "IdentityFilter",
    "LikelyFrontOfCamFilter", "MappingPointSelector", "MatchCovariance", "MatchOutput", "Modifier_Diagonalize",
    "Modifier_Normalize", "MotionInterpolate", "Naive", "NoCovariance", "PoseInterpolate", "RandomSelector",
    "ReadPoseFile", "SelectorCompose", "SimpleDepthFilter", "SparseGradienSelector", "SparseGradientSelector",
    "StaticMotionModel", "TartanMotionNet", "TartanVODepth", "TartanVOMatcher", "UniformKeyframe",
    "retrieve_pixels",
]
