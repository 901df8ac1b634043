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
    ApplyGTDepthCov,
    ApplyGTMatchCov,
    ApplyGTMatchMask,
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
from .frontend_network import (
    FlowFormerCovDepth,
    FlowFormerCovFrontend,
    FlowFormerCovMatcher,
    FlowFormerDepth,
    FlowFormerMatcher,
)
from .frontend_tartanvo import TartanMotionNet, TartanVOCovMatcher, TartanVODepth, TartanVOMatcher
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
    "AllKeyframe", "ApplyGTDepthCov", "ApplyGTMatchCov", "ApplyGTMatchMask", "CovAwareSelector", "CovAwareSelector_NoDepth", "CovarianceSanityFilter",
    "DepthCovariance", "DepthOutput", "FilterCompose", "FlowFormerCovDepth", "FlowFormerCovFrontend",
    "FlowFormerCovMatcher", "FlowFormerDepth", "FlowFormerMatcher", "FrontendCompose",
    "GTDepth", "GTMatcher", "GTMotionwithNoise", "GaussianMixtureCovariance", "GradientSelector",
    "GridSelector", "ICovariance2to3", "IFrontend", "IKeyframeSelector", "IKeypointSelector",
    "IMapProcessor", "IMatcher", "IMotionModel", "IObservationFilter", "IStereoDepth", "IdentityFilter",
    "LikelyFrontOfCamFilter", "MappingPointSelector", "MatchCovariance", "MatchOutput", "Modifier_Diagonalize",
    "Modifier_Normalize", "MotionInterpolate", "Naive", "NoCovariance", "PoseInterpolate", "RandomSelector",
    "ReadPoseFile", "SelectorCompose", "SimpleDepthFilter", "SparseGradienSelector", "SparseGradientSelector",
    "StaticMotionModel", "TartanMotionNet", "TartanVOCovMatcher", "TartanVODepth", "TartanVOMatcher", "UniformKeyframe",
    "retrieve_pixels",
]
