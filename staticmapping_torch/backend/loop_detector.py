"""Loop-detector settings — the PyTorch counterpart of
``staticmapping_tpu.backend.loop_detector``.

Only ``LoopDetectorSettings`` is here, because ``config.py`` fills it from
the XML tree.  The loop detector itself is not ported yet (ROADMAP.md queue
A item 14).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class LoopDetectorSettings:
    """back_end/loop_detector_options.h:29-40, with the JAX package's names
    and defaults."""

    use_gps: bool = False
    use_descriptor: bool = False
    loop_ignore_threshold: int = 15
    trying_detect_loop_count: int = 1
    nearest_history_pos_num: int = 4
    max_close_loop_distance: float = 25.0
    max_close_loop_z_distance: float = 1.0
    m2dp_match_score: float = 0.99
    accept_scan_match_score: float = 0.75
    # shape knobs of the batched verifier
    normal_leaf_size: int = 8
    nn_tile: int = 1024
    # fixed ICP trip count of the batched loop verifier
    fixed_iterations: int = 40
    # density normalization anchor (icp_fast.target_spacing; 0 = raw)
    score_spacing_ref: float = 0.0
    # independent-family (GICP) acceptance gate; 0 disables
    independent_gate_min_score: float = 0.55
