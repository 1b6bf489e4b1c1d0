"""Point-cloud pre-processing filters and their XML-name factory (the
registry of filter_factory.cc:43-52)."""
from .filters import FILTER_REGISTRY, Filter, FilterChain, create_filter
from .ground_removal2 import GroundRemoval2Filter
from .plane_detector import PlaneDetector, RandomSampleWithPlaneDetectFilter
from .range_image import RangeImageFilter

__all__ = ["FILTER_REGISTRY", "Filter", "FilterChain", "create_filter",
           "GroundRemoval2Filter", "RangeImageFilter", "PlaneDetector",
           "RandomSampleWithPlaneDetectFilter"]
