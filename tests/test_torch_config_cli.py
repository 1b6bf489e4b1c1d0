"""Parity of the port's config system (staticmapping_torch.config) with the
JAX package's: both shipped XML configs load into equal option values, the
same options are rejected, and the back end is refused until it is ported.
The CLI itself runs in tests/test_torch_kitti_cli.py."""
import dataclasses
import os

import pytest

from staticmapping_tpu import config as jconfig
from staticmapping_torch import config as tconfig
from staticmapping_torch.__main__ import main as cli_main

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


def test_backend_is_refused():
    """The back end is ROADMAP item 14: ``build_map_builder`` refuses it,
    and the CLI without ``--no-backend`` exits 2 naming the flag."""
    with pytest.raises(NotImplementedError, match="item 14"):
        tconfig.build_map_builder(tconfig.load_config(None), device="cpu")


def test_cli_without_no_backend_names_the_flag(tmp_path, capsys):
    rc = cli_main(["--synthetic", "straight", "--scans", "2", "--out",
                   str(tmp_path), "--device", "cpu", "--quiet"])
    assert rc == 2
    assert "--no-backend" in capsys.readouterr().err


def test_unported_filter_names_raise():
    cfg = tconfig.load_config(None)
    cfg.filters = [("GroundRemoval2", {})]
    with pytest.raises(KeyError, match="item 16"):
        tconfig.build_filter_chain(cfg)


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
