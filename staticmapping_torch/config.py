"""XML config system — the PyTorch counterpart of
``staticmapping_tpu.config``.

The reference configures everything from one XML document
(config/static_mapping_default.xml) walked in ``MapBuilder::Initialise``
(builder/map_builder_options.cc:71-330): whole options, MRVM output
settings, the filter chain, front-end matcher + motion filter + IMU
options, back-end submap/optimizer/loop-detector options and map-package
options.  This module reads the same vocabulary (element and attribute
names, the ``<filter>``/``<param>`` scheme, matcher ``type`` integers) into
the port's option dataclasses with ``xml.etree``, exactly as the JAX
package does.

Entry points:
  * :func:`load_config` — XML file/string → :class:`PipelineConfig`
  * :func:`build_map_builder` — :class:`PipelineConfig` → wired
    :class:`~staticmapping_torch.builder.map_builder.MapBuilder`, with the
    pose-graph back end unless ``with_backend=False``.
"""
from __future__ import annotations

import dataclasses
import os
import xml.etree.ElementTree as ET
from typing import Any, Dict, List, Optional, Tuple

from .backend.loop_detector import LoopDetectorSettings
from .backend.optimizer import IncrementalOptimizer, OptimizerOptions
from .builder.frame import SubmapOptions
from .builder.frontend import FrontEndOptions, MotionFilterOptions
from .builder.map_builder import MapBuilder, MapBuilderOptions
from .builder.map_package import MapPackageOptions
from .builder.mrvm import MrvmSettings
from .filters.filters import FilterChain, create_filter


@dataclasses.dataclass
class MatcherConfig:
    """scan_matcher_options / submap_matcher_options
    (map_builder_options.cc:31-56 ``ReadMatcherOptions``)."""

    type: int = 6                       # registrator::Type (interface.h:41-50)
    accepted_min_score: float = 0.7
    params: Dict[str, Any] = dataclasses.field(default_factory=dict)
    inner_filters: List[Tuple[str, Dict[str, Any]]] = dataclasses.field(
        default_factory=list)


@dataclasses.dataclass
class PipelineConfig:
    """Everything ``MapBuilder::Initialise`` reads from the XML tree."""

    map_builder: MapBuilderOptions = dataclasses.field(
        default_factory=MapBuilderOptions)
    optimizer: OptimizerOptions = dataclasses.field(
        default_factory=OptimizerOptions)
    loop_detector: LoopDetectorSettings = dataclasses.field(
        default_factory=LoopDetectorSettings)
    scan_matcher: MatcherConfig = dataclasses.field(
        default_factory=MatcherConfig)
    submap_matcher: MatcherConfig = dataclasses.field(
        default_factory=lambda: MatcherConfig(accepted_min_score=0.75))
    filters: List[Tuple[str, Dict[str, Any]]] = dataclasses.field(
        default_factory=list)
    # imu_options (map_builder_options.cc:206-216)
    imu_enabled: bool = False
    imu_frequency: float = 100.0
    imu_gravity_constant: float = 9.8
    map_package_path: str = "pkgs/"


# ------------------------------------------------------------------ helpers

def _attr(node: Optional[ET.Element], name: str, cast, default):
    if node is None:
        return default
    raw = node.get(name)
    if raw is None:
        return default
    raw = raw.strip()
    if cast is bool:
        return raw.lower() in ("true", "1", "yes")
    return cast(raw)


def _parse_params(node: ET.Element) -> Dict[str, Any]:
    """``<param type="0|1" name="x"> v </param>`` children → dict
    (filter_interface.cc:46-56: type 0 = int, 1 = float)."""
    out: Dict[str, Any] = {}
    for p in node.findall("param"):
        name = p.get("name")
        if name is None:
            continue
        text = (p.text or "").strip()
        typ = p.get("type")
        if typ == "0":
            out[name] = int(float(text))
        else:
            try:
                out[name] = float(text)
            except ValueError:
                out[name] = text
    return out


def _parse_filters(node: Optional[ET.Element]
                   ) -> List[Tuple[str, Dict[str, Any]]]:
    if node is None:
        return []
    return [(f.get("name"), _parse_params(f))
            for f in node.findall("filter") if f.get("name")]


def _parse_matcher(parent: Optional[ET.Element], tag: str,
                   default: MatcherConfig) -> MatcherConfig:
    """ReadMatcherOptions parity (map_builder_options.cc:31-56)."""
    if parent is None:
        return default
    node = parent.find(tag)
    if node is None:
        return default
    cfg = MatcherConfig(
        type=_attr(node, "type", int, default.type),
        accepted_min_score=_attr(node, "accepted_min_score", float,
                                 default.accepted_min_score))
    reg = node.find("registrator_options")
    if reg is not None:
        cfg.params = _parse_params(reg)
    cfg.inner_filters = _parse_filters(node.find("inner_filters"))
    return cfg


# ------------------------------------------------------------------ loader

def load_config(source: Optional[str] = None) -> PipelineConfig:
    """Parse a reference-vocabulary XML config (path or XML string).

    Missing file / missing nodes fall back to defaults, like the
    reference's "using default config" path (map_builder_options.cc:72-100).
    """
    cfg = PipelineConfig()
    if not source:
        return cfg
    if os.path.isfile(source):
        root = ET.parse(source).getroot()
    else:
        try:
            root = ET.fromstring(source)
        except ET.ParseError:
            return cfg
    if root.tag == "edward_liu":
        sm = root.find("static_mapping")
    elif root.tag == "static_mapping":
        sm = root
    else:
        sm = root.find("edward_liu/static_mapping")
    if sm is None:
        return cfg

    mb = cfg.map_builder

    # whole_options (map_builder_options.cc:110-140)
    whole = sm.find("whole_options")
    mb.export_file_path = _attr(whole, "export_file_path", str,
                                mb.export_file_path)
    cfg.map_package_path = _attr(whole, "map_package_path", str,
                                 cfg.map_package_path)
    mb.output_direct_combined_map = _attr(
        whole, "output_direct_combined_map", bool,
        mb.output_direct_combined_map)
    mb.output_mrvm = _attr(whole, "output_mrvm", bool, mb.output_mrvm)
    mb.output_kitti_pose = _attr(whole, "output_kitti_pose", bool,
                                 mb.output_kitti_pose)
    mb.separate_output = _attr(whole, "separate_output", bool,
                               mb.separate_output)
    mb.separate_step = _attr(whole, "separate_step", int, mb.separate_step)

    # output_mrvm_settings (map_builder_options.cc:144-168)
    mrvm = sm.find("output_mrvm_settings")
    ms: MrvmSettings = mb.mrvm_settings
    ms.output_average = _attr(mrvm, "output_average", bool, ms.output_average)
    ms.output_rgb = _attr(mrvm, "output_rgb", bool, ms.output_rgb)
    ms.use_max_intensity = _attr(mrvm, "use_max_intensity", bool,
                                 ms.use_max_intensity)
    ms.prob_threshold = _attr(mrvm, "prob_threshold", float,
                              ms.prob_threshold)
    ms.high_resolution = _attr(mrvm, "high_resolution", float,
                               ms.high_resolution)
    ms.hit_prob = _attr(mrvm, "hit_prob", float, ms.hit_prob)
    ms.miss_prob = _attr(mrvm, "miss_prob", float, ms.miss_prob)
    ms.z_offset = _attr(mrvm, "z_offset", float, ms.z_offset)
    ms.max_point_num_in_cell = _attr(mrvm, "max_point_num_in_cell", int,
                                     ms.max_point_num_in_cell)
    ms.max_ray_steps = _attr(mrvm, "max_ray_steps", int, ms.max_ray_steps)

    # filters (map_builder_options.cc:170-177)
    cfg.filters = _parse_filters(sm.find("filters"))

    # front_end_options (map_builder_options.cc:179-217)
    fe_node = sm.find("front_end_options")
    fe: FrontEndOptions = mb.front_end
    cfg.scan_matcher = _parse_matcher(fe_node, "scan_matcher_options",
                                      cfg.scan_matcher)
    if fe_node is not None:
        mb.data_collector.accumulate_cloud_num = _attr(
            fe_node, "accumulate_cloud_num", int,
            mb.data_collector.accumulate_cloud_num)
        fe.accumulate_cloud_num = mb.data_collector.accumulate_cloud_num
        mf = fe_node.find("motion_filter")
        fe.motion_filter = MotionFilterOptions(
            translation_range=_attr(mf, "translation_range", float,
                                    fe.motion_filter.translation_range),
            angle_range=_attr(mf, "angle_range", float,
                              fe.motion_filter.angle_range),
            time_range=_attr(mf, "time_range", float,
                             fe.motion_filter.time_range))
        mc = fe_node.find("motion_compensation_options")
        fe.motion_compensation = _attr(mc, "enable", bool,
                                       fe.motion_compensation)
        fe.use_average = _attr(mc, "use_average", bool, fe.use_average)
        imu = fe_node.find("imu_options")
        cfg.imu_enabled = _attr(imu, "use_imu", bool, cfg.imu_enabled)
        cfg.imu_frequency = _attr(imu, "imu_frequency", float,
                                  cfg.imu_frequency)
        cfg.imu_gravity_constant = _attr(imu, "gravity_constant", float,
                                         cfg.imu_gravity_constant)
        mb.use_imu = cfg.imu_enabled
    # matcher params → front-end knobs (icp_fast.h:56-60 names)
    p = cfg.scan_matcher.params
    fe.max_iteration = int(p.get("max_iteration", fe.max_iteration))
    fe.dist_outlier_ratio = float(p.get("dist_outlier_ratio",
                                        fe.dist_outlier_ratio))
    fe.matcher_type = cfg.scan_matcher.type

    # back_end_options (map_builder_options.cc:219-299)
    be = sm.find("back_end_options")
    cfg.submap_matcher = _parse_matcher(be, "submap_matcher_options",
                                        cfg.submap_matcher)
    mb.submap_matcher_accepted_min_score = cfg.submap_matcher.accepted_min_score
    # density-normalization anchor for ALL acceptance scores (submap pair
    # matcher + loop verifier) — one knob, one place (VERDICT r04 #4)
    mb.score_spacing_ref = _attr(be, "score_spacing_ref", float,
                                 mb.score_spacing_ref)
    cfg.loop_detector.score_spacing_ref = mb.score_spacing_ref
    if be is not None:
        so = be.find("submap_options")
        sub: SubmapOptions = mb.submap
        sub.frame_count = _attr(so, "frame_count", int, sub.frame_count)
        sub.enable_inner_mrvm = _attr(so, "enable_inner_mrvm", bool,
                                      sub.enable_inner_mrvm)
        sub.enable_voxel_filter = _attr(so, "enable_voxel_filter", bool,
                                       sub.enable_voxel_filter)
        # (sic) reference spells it "enable_random_sampleing"
        sub.enable_random_sampling = _attr(
            so, "enable_random_sampleing", bool, sub.enable_random_sampling)
        sub.random_sampling_rate = _attr(so, "random_sampling_rate", float,
                                         sub.random_sampling_rate)
        sub.voxel_size = _attr(so, "voxel_size", float, sub.voxel_size)
        sub.enable_disk_saving = _attr(so, "enable_disk_saving", bool,
                                       getattr(sub, "enable_disk_saving",
                                               False))
        sub.disk_saving_delay = _attr(so, "disk_saving_delay", int,
                                      getattr(sub, "disk_saving_delay", 30))
        sub.saving_name_prefix = _attr(so, "saving_name_prefix", str,
                                       getattr(sub, "saving_name_prefix",
                                               "s_"))

        io = be.find("isam_optimizer_options")
        opt: OptimizerOptions = cfg.optimizer
        opt.use_odom = _attr(io, "use_odom", bool, opt.use_odom)
        opt.use_gps = _attr(io, "use_gps", bool, opt.use_gps)
        opt.enable_extrinsic_calib = _attr(io, "enable_extrinsic_calib",
                                           bool, opt.enable_extrinsic_calib)
        opt.output_graph_pic = _attr(io, "output_graph_pic", bool,
                                     opt.output_graph_pic)
        opt.gps_factor_init_num = _attr(io, "gps_factor_init_num", int,
                                        opt.gps_factor_init_num)
        opt.gps_factor_sample_step = _attr(io, "gps_factor_sample_step", int,
                                           opt.gps_factor_sample_step)
        opt.gps_factor_init_angle_rad = _attr(
            io, "gps_factor_init_angle_rad", float,
            opt.gps_factor_init_angle_rad)
        mb.use_odom = opt.use_odom
        mb.use_gps = opt.use_gps

        ld = be.find("loop_detector_setting")
        lds: LoopDetectorSettings = cfg.loop_detector
        lds.use_gps = _attr(ld, "use_gps", bool, lds.use_gps)
        lds.use_descriptor = _attr(ld, "use_descriptor", bool,
                                   lds.use_descriptor)
        lds.trying_detect_loop_count = _attr(ld, "trying_detect_loop_count",
                                             int,
                                             lds.trying_detect_loop_count)
        lds.loop_ignore_threshold = _attr(ld, "loop_ignore_threshold", int,
                                          lds.loop_ignore_threshold)
        lds.nearest_history_pos_num = _attr(ld, "nearest_history_pos_num",
                                            int, lds.nearest_history_pos_num)
        lds.max_close_loop_distance = _attr(ld, "max_close_loop_distance",
                                            float,
                                            lds.max_close_loop_distance)
        lds.max_close_loop_z_distance = _attr(
            ld, "max_close_loop_z_distance", float,
            lds.max_close_loop_z_distance)
        lds.m2dp_match_score = _attr(ld, "m2dp_match_score", float,
                                     lds.m2dp_match_score)
        lds.accept_scan_match_score = _attr(ld, "accept_scan_match_score",
                                            float,
                                            lds.accept_scan_match_score)

    # map_package_options (map_builder_options.cc:301-315)
    mp = sm.find("map_package_options")
    mpo: MapPackageOptions = mb.map_package
    mb.save_map_package = _attr(mp, "enable", bool, mb.save_map_package)
    mpo.enable = mb.save_map_package
    mpo.border_offset = _attr(mp, "border_offset", float, mpo.border_offset)
    mpo.piece_width = _attr(mp, "piece_width", float, mpo.piece_width)
    mpo.cloud_file_prefix = _attr(mp, "cloud_file_prefix", str,
                                  mpo.cloud_file_prefix)
    mpo.descript_filename = _attr(mp, "descript_filename", str,
                                  mpo.descript_filename)

    check_options(cfg)
    return cfg


def check_options(cfg: PipelineConfig) -> None:
    """CheckOptions (map_builder_options.cc:59-68).  Raises
    ``AssertionError``, as the JAX package's asserts do, but explicitly, so
    that ``python -O`` keeps the checks."""
    ms = cfg.map_builder.mrvm_settings
    checks = [
        (cfg.map_builder.data_collector.accumulate_cloud_num >= 1,
         "front_end_options.accumulate_cloud_num must be >= 1"),
        (ms.hit_prob > 0.5, "output_mrvm_settings.hit_prob must be > 0.5"),
        (ms.miss_prob < 0.5, "output_mrvm_settings.miss_prob must be < 0.5"),
        (ms.max_point_num_in_cell >= 1,
         "output_mrvm_settings.max_point_num_in_cell must be >= 1"),
    ]
    for ok, what in checks:
        if not ok:
            raise AssertionError(what)


def build_filter_chain(cfg: PipelineConfig) -> Optional[FilterChain]:
    if not cfg.filters:
        return None
    return FilterChain([create_filter(name, params)
                        for name, params in cfg.filters])


def build_map_builder(cfg: PipelineConfig, with_backend: bool = True,
                      device=None) -> MapBuilder:
    """InitialiseInside (map_builder.cc:62-113): wire the filter chain, the
    front end and the back-end optimizer on ``device`` (the GPU unless
    named)."""
    backend = None
    if with_backend:
        backend = IncrementalOptimizer(cfg.optimizer,
                                       loop_settings=cfg.loop_detector,
                                       device=device)
    return MapBuilder(cfg.map_builder, filter_chain=build_filter_chain(cfg),
                      backend=backend, device=device)
