"""Registration matchers (reference: registrators/) — all four live types
plus the factory (interface.cc:139-173)."""
from .factory import (create_matcher, TYPE_ICP_PM, TYPE_NDT_GICP, TYPE_NDT,
                      TYPE_FAST_ICP)
from .gicp import Gicp, align_gicp, compute_point_normals
from .icp_fast import IcpFast, align_point_to_plane
from .icp_pm import IcpPointMatcher
from .ndt import Ndt, align_ndt, build_ndt_map
from .ndt_gicp import NdtWithGicp

__all__ = [
    "create_matcher", "TYPE_ICP_PM", "TYPE_NDT_GICP", "TYPE_NDT",
    "TYPE_FAST_ICP", "Gicp", "align_gicp", "compute_point_normals",
    "IcpFast", "align_point_to_plane", "IcpPointMatcher", "Ndt",
    "align_ndt", "build_ndt_map", "NdtWithGicp",
]
