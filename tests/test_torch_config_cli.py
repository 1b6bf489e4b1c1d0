"""Parity of the port's config system (staticmapping_torch.config) with the
JAX package's: both shipped XML configs load into equal option values, the
same options are rejected, and the back end is wired by default.  The CLI
on KITTI files runs in tests/test_torch_kitti_cli.py."""
import dataclasses
import os

import numpy as np
import pytest
import torch

from staticmapping_tpu import config as jconfig
from staticmapping_torch import config as tconfig
from staticmapping_torch.__main__ import make_parser, run as cli_run
from staticmapping_torch.backend.optimizer import IncrementalOptimizer
from staticmapping_torch.io import kitti as tkitti
from staticmapping_torch.io import synthetic as tsynthetic

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = [None, os.path.join(ROOT, "config", "lidar_only_kitti.xml"),
           os.path.join(ROOT, "config", "synthetic.xml")]


@pytest.mark.parametrize("path", CONFIGS,
                         ids=["defaults", "lidar_only_kitti", "synthetic"])
def test_load_config_matches_jax(path):
    """Every option value of the two ``PipelineConfig``s is equal, field by
    field and nested (the port's dataclasses carry the JAX package's names
    and defaults)."""
    cj, ct = jconfig.load_config(path), tconfig.load_config(path)
    assert dataclasses.asdict(ct) == dataclasses.asdict(cj)


def test_load_reference_vocabulary():
    """tests/test_config_cli.py::test_load_reference_vocabulary through the
    port."""
    cfg = tconfig.load_config(CONFIGS[1])
    mb = cfg.map_builder
    assert mb.front_end.motion_filter.translation_range == 0.5
    assert mb.front_end.matcher_type == 6
    assert mb.submap.frame_count == 2 and mb.submap.enable_voxel_filter
    assert mb.output_mrvm and not mb.output_direct_combined_map
    assert mb.mrvm_settings.prob_threshold == 0.57
    assert mb.mrvm_settings.z_offset == 1.2
    assert cfg.loop_detector.m2dp_match_score == 0.98
    assert [n for n, _ in cfg.filters] == ["Range", "AxisRange",
                                           "RandomSampler"]


def test_xml_string_and_missing_nodes():
    xml = ('<edward_liu><static_mapping><whole_options output_mrvm="false"'
           ' separate_output="true" separate_step="7"/>'
           '</static_mapping></edward_liu>')
    cj, ct = jconfig.load_config(xml), tconfig.load_config(xml)
    assert dataclasses.asdict(ct) == dataclasses.asdict(cj)
    assert not ct.map_builder.output_mrvm
    assert ct.map_builder.separate_output and ct.map_builder.separate_step == 7


@pytest.mark.parametrize("field,value", [
    ("hit_prob", 0.4), ("miss_prob", 0.6), ("max_point_num_in_cell", 0),
    ("accumulate_cloud_num", 0)])
def test_check_options_rejects_what_jax_rejects(field, value):
    for lib in (jconfig, tconfig):
        cfg = lib.load_config(None)
        if field == "accumulate_cloud_num":
            cfg.map_builder.data_collector.accumulate_cloud_num = value
        else:
            setattr(cfg.map_builder.mrvm_settings, field, value)
        with pytest.raises(AssertionError):
            lib.check_options(cfg)


def test_build_map_builder_wires_the_chain():
    mb = tconfig.build_map_builder(tconfig.load_config(CONFIGS[1]),
                                   with_backend=False, device="cpu")
    assert len(mb.front_end.filter_chain.filters) == 3
    assert not mb.options.pipelined
    assert mb.front_end.device.type == "cpu"


def test_build_map_builder_wires_the_backend():
    """``build_map_builder`` attaches the pose-graph back end unless told
    not to, with the config's optimizer options and loop-detector
    settings, on the named device."""
    cfg = tconfig.load_config(CONFIGS[2])
    be = tconfig.build_map_builder(cfg, device="cpu").backend
    assert isinstance(be, IncrementalOptimizer)
    assert be.options == cfg.optimizer
    assert be.loop_detector.settings == cfg.loop_detector
    assert be.graph.device.type == be.loop_detector.device.type == "cpu"
    assert tconfig.build_map_builder(cfg, with_backend=False,
                                     device="cpu").backend is None


def test_cli_runs_the_backend_on_the_synthetic_square(tmp_path, monkeypatch):
    """Without ``--no-backend`` the CLI hands every full submap to the back
    end (M2DP descriptors on, as config/synthetic.xml asks), runs the final
    optimization and writes its outputs.  The world is cut to 4000 points
    a scan and the widths to 4096-slot scans to keep the run short on the
    CPU."""
    load, make_sequence = tconfig.load_config, tsynthetic.make_sequence

    def narrow(path):
        cfg = load(path)
        cfg.map_builder.front_end.scan_capacity = 4096
        cfg.map_builder.front_end.nn_tile = 512
        cfg.map_builder.submap_capacity = 8192
        return cfg
    monkeypatch.setattr(tconfig, "load_config", narrow)
    monkeypatch.setattr(tsynthetic, "make_sequence", lambda **kw:
                        make_sequence(max_points=4000, **kw))
    mb = cli_run(make_parser().parse_args(
        ["--synthetic", "square", "--scans", "6", "--out", str(tmp_path),
         "--device", "cpu", "--quiet"]))
    full = [s for s in mb.trajectory if s.full]
    assert mb.backend.graph.num_nodes == len(full) >= 2
    assert len(mb.backend.graph.factors) == len(full) - 1
    assert all(s.descriptor is not None for s in full)
    written = tkitti.read_poses(str(tmp_path / "kitti_pose.txt"))
    assert written.shape == (len(mb.trajectory), 4, 4)
    assert np.isfinite(written).all()


def test_chain_of_all_ten_filters_builds():
    """A config whose chain names all ten filters of the registry builds a
    chain of the JAX package's classes in its order, which runs on a
    cloud."""
    from staticmapping_tpu.filters import FILTER_REGISTRY
    from staticmapping_torch.data import cloud as tcloud
    names = sorted(FILTER_REGISTRY)
    xml = ('<edward_liu><static_mapping><filters>'
           + "".join(f'<filter name="{n}"/>' for n in names)
           + '</filters></static_mapping></edward_liu>')
    cj, ct = jconfig.load_config(xml), tconfig.load_config(xml)
    assert [n for n, _ in ct.filters] == [n for n, _ in cj.filters] == names
    chain_t, chain_j = (tconfig.build_filter_chain(ct),
                        jconfig.build_filter_chain(cj))
    assert ([type(f).__name__ for f in chain_t.filters]
            == [type(f).__name__ for f in chain_j.filters])
    rng = np.random.default_rng(0)
    pts = rng.uniform(-20, 20, (3000, 3)).astype(np.float32)
    out = chain_t(tcloud.from_numpy(pts, capacity=4096, device="cpu"))
    assert out.xyz.shape == (4096, 3)
    assert torch.isfinite(out.xyz[out.mask]).all()


@pytest.mark.parametrize("matcher_type", [1, 3, 5])
def test_matcher_types_flow_through_the_config(matcher_type):
    """``scan_matcher_options type`` 1, 3 and 5, with the registrator
    params every type takes, load into equal option values in both
    packages, pass ``check_options`` and build a front end whose matcher
    is the JAX package's class; types 3 and 5 build the chunked front end
    too."""
    xml = ('<edward_liu><static_mapping><front_end_options>'
           f'<scan_matcher_options type="{matcher_type}">'
           f'<registrator_options type="{matcher_type}">'
           '<param name="max_iteration"> 20 </param>'
           '<param name="dist_outlier_ratio"> 0.6 </param>'
           '</registrator_options></scan_matcher_options>'
           '</front_end_options></static_mapping></edward_liu>')
    cj, ct = jconfig.load_config(xml), tconfig.load_config(xml)
    assert dataclasses.asdict(ct) == dataclasses.asdict(cj)
    fe = ct.map_builder.front_end
    assert (fe.matcher_type, fe.max_iteration, fe.dist_outlier_ratio) == (
        matcher_type, 20, 0.6)
    tconfig.check_options(ct)
    mb_t = tconfig.build_map_builder(ct, with_backend=False, device="cpu")
    mb_j = jconfig.build_map_builder(cj, with_backend=False)
    assert (type(mb_t.front_end.matcher).__name__
            == type(mb_j.front_end.matcher).__name__)
    if matcher_type != 1:
        ct.map_builder.pipelined = True
        mb = tconfig.build_map_builder(ct, with_backend=False, device="cpu")
        assert mb.front_end.options.matcher_type == matcher_type
        mb.front_end.close()


def test_urdf_extrinsics_lookup():
    """tests/test_config_cli.py::test_urdf_extrinsics_lookup through the
    port's copy."""
    import numpy as np
    from staticmapping_torch.common import np_se3
    from staticmapping_torch.io.urdf import (lookup_transform,
                                             read_fixed_transforms)
    urdf = """<robot name="car">
      <joint name="j1" type="fixed">
        <parent link="base_link"/><child link="velodyne"/>
        <origin xyz="1.2 0 1.8" rpy="0 0 0.1"/>
      </joint>
      <joint name="j2" type="fixed">
        <parent link="velodyne"/><child link="imu"/>
        <origin xyz="0 0 -0.5" rpy="0 0 0"/>
      </joint>
      <joint name="jr" type="revolute">
        <parent link="base_link"/><child link="wheel"/>
        <origin xyz="9 9 9"/>
      </joint>
    </robot>"""
    tfs = read_fixed_transforms(urdf)
    assert ("base_link", "wheel") not in tfs
    expected = tfs[("base_link", "velodyne")] @ tfs[("velodyne", "imu")]
    np.testing.assert_allclose(lookup_transform(tfs, "base_link", "imu"),
                               expected, atol=1e-12)
    np.testing.assert_allclose(lookup_transform(tfs, "imu", "base_link"),
                               np_se3.inverse(expected), atol=1e-9)
    assert lookup_transform(tfs, "base_link", "nonexistent") is None


def test_process_profiler_writes_samples(tmp_path):
    from staticmapping_torch.common.process_info import ProcessProfiler
    log = tmp_path / "resources.log"
    prof = ProcessProfiler(log_path=str(log), period=0.05).start()
    sum(i * i for i in range(300000))
    import time
    time.sleep(0.2)
    prof.stop()
    lines = log.read_text().splitlines()
    assert lines[0].startswith("# time_s") and len(lines) >= 2
