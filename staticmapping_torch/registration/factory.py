"""Matcher factory — the PyTorch counterpart of
``staticmapping_tpu.registration.factory``: ``registrator::CreateMatcher``
(registrators/interface.cc:139-173) and the ``Type`` enum
(interface.h:41-50), {1: IcpPM, 3: NdtWithGicp, 5: Ndt, 6: FastIcp}.
Types 2 (libicp) and 4 (lego-loam) are deprecated and FATAL in the
reference; here they raise ``ValueError``."""
from __future__ import annotations

from typing import Any, Dict, Optional

from .icp_fast import IcpFast
from .icp_pm import IcpPointMatcher
from .ndt import Ndt
from .ndt_gicp import NdtWithGicp

# registrator::Type values (interface.h:41-50)
TYPE_ICP_PM = 1
TYPE_LIBICP = 2        # deprecated
TYPE_NDT_GICP = 3
TYPE_LEGO_LOAM = 4     # deprecated
TYPE_NDT = 5
TYPE_FAST_ICP = 6

_REGISTRY = {
    TYPE_ICP_PM: IcpPointMatcher,
    TYPE_NDT_GICP: NdtWithGicp,
    TYPE_NDT: Ndt,
    TYPE_FAST_ICP: IcpFast,
}

_BY_NAME = {
    "icp_pm": TYPE_ICP_PM,
    "ndt_gicp": TYPE_NDT_GICP,
    "ndt": TYPE_NDT,
    "icp_fast": TYPE_FAST_ICP,
    "fast_icp": TYPE_FAST_ICP,
}


def create_matcher(matcher_type, options: Optional[Dict[str, Any]] = None):
    """A matcher by reference type id (int) or name (str).

    ``options`` entries set the matcher's dataclass fields (the XML
    ``<registrator_options><param name=…>`` role, interface.cc:62-90);
    unknown keys raise, as the reference's typed option table does."""
    if isinstance(matcher_type, str):
        key = matcher_type.lower()
        if key not in _BY_NAME:
            raise ValueError(f"unknown matcher name {matcher_type!r}; "
                             f"one of {sorted(_BY_NAME)}")
        matcher_type = _BY_NAME[key]
    if matcher_type in (TYPE_LIBICP, TYPE_LEGO_LOAM):
        raise ValueError(
            f"matcher type {matcher_type} (libicp/lego-loam) is deprecated "
            "in the reference (interface.cc:155-160) and not provided")
    if matcher_type not in _REGISTRY:
        raise ValueError(f"unknown matcher type {matcher_type}; "
                         f"one of {sorted(_REGISTRY)}")
    cls = _REGISTRY[matcher_type]
    matcher = cls()
    for key, value in (options or {}).items():
        if not hasattr(matcher, key):
            raise ValueError(
                f"{cls.__name__} has no option {key!r} (the reference "
                "rejects unknown params too, interface.cc:76-88)")
        setattr(matcher, key, value)
    # NdtWithGicp builds its inner matchers from its options
    if isinstance(matcher, NdtWithGicp) and options:
        matcher.__post_init__()
    return matcher
