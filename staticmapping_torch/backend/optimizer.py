"""Back-end optimizer options — the PyTorch counterpart of
``staticmapping_tpu.backend.optimizer``.

Only ``OptimizerOptions`` is here, because ``config.py`` fills it from the
XML tree.  The incremental pose-graph optimizer itself is not ported yet
(ROADMAP.md queue A item 14): ``config.build_map_builder(with_backend=True)``
raises until it is.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class OptimizerOptions:
    """IsamOptimizerOptions (isam_optimizer.h:59-67), with the JAX
    package's names and defaults."""

    use_gps: bool = False
    use_odom: bool = False
    enable_extrinsic_calib: bool = False
    gps_factor_init_num: int = 20
    gps_factor_init_angle_rad: float = 0.5
    gps_factor_sample_step: int = 1
    gn_iterations: int = 8
    output_graph_pic: bool = False    # isam_optimizer.h:62 (ViewGraph png)
