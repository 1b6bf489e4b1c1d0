"""Map-package options — the PyTorch counterpart of
``staticmapping_tpu.builder.map_package``.

Only ``MapPackageOptions`` is here, because ``config.py`` and
``MapBuilderOptions`` carry it.  Writing the package is not ported yet
(ROADMAP.md queue A item 17): ``save_map_package=True`` raises.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class MapPackageOptions:
    """builder/map_package.h:36-42, with the JAX package's names and
    defaults."""

    enable: bool = True
    border_offset: float = 100.0
    piece_width: float = 500.0
    cloud_file_prefix: str = "submap_"
    descript_filename: str = "map.xml"
