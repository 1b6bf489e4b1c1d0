"""The port's map package (staticmapping_torch.builder.map_package) against
the JAX package's on the CPU: a round trip, packages written by either
package loading in the other, the map pieces built from one trajectory
carried across, and ``MapBuilder(save_map_package=True)``."""
import os
import xml.etree.ElementTree as ET

import numpy as np
import pytest
import torch

from staticmapping_tpu.builder import frame as jframe
from staticmapping_tpu.builder import map_package as jpkg
from staticmapping_tpu.builder import mrvm as jmrvm
from staticmapping_tpu.common import np_se3
from staticmapping_tpu.data import cloud as jcloud
from staticmapping_tpu.io import synthetic
from staticmapping_torch import interop
from staticmapping_torch import tools as ttools
from staticmapping_torch.builder import frame as tframe
from staticmapping_torch.builder import map_builder as tmb
from staticmapping_torch.builder import map_package as tpkg
from staticmapping_torch.builder import mrvm as tmrvm
from staticmapping_torch.builder.frontend import FrontEndOptions
from staticmapping_torch.data import cloud as tcloud
from staticmapping_torch.io import pcd as tpcd

CPU = "cpu"
# small pieces, so that the 20 m trajectory spans a grid of them
PIECES = dict(border_offset=10.0, piece_width=20.0)
# a short MRVM keeps the CPU run brief; one hit keeps a voxel, so these
# sparse scans leave thousands of points in the pieces
MRVM = dict(max_ray_steps=32, prob_threshold=0.5)


@pytest.fixture(scope="module")
def jax_trajectory():
    """Six 2-frame submaps of 6000-point renders along a 20 m line, with
    transforms to next and M2DP-sized descriptors (JAX package)."""
    world = synthetic.make_world(seed=2)
    rng = np.random.default_rng(3)
    traj = jframe.Trajectory(0)
    for k in range(6):
        s = jframe.Submap(k, jframe.SubmapOptions(frame_count=2),
                          capacity=16384)
        for j in range(2):
            T = np_se3.from_rt(np_se3.euler_to_matrix([0, 0, 0.02 * k]),
                               [4.0 * k + 1.5 * j, 0.3 * j, 0.0])
            pts = synthetic.render_scan(world, T, max_range=40.0,
                                        max_points=6000, seed=10 * k + j)
            s.insert_frame(jframe.Frame(
                stamp=0.1 * (2 * k + j), global_pose=T,
                cloud=jcloud.from_numpy(pts, capacity=8192),
                match_score=0.9 - 0.01 * j))
        s.descriptor = rng.normal(size=192).astype(np.float32)
        if k:
            traj[k - 1].match_transform_to_next = (
                np_se3.inverse(traj[k - 1].global_pose) @ s.global_pose)
        traj.append(s)
    return traj


def _assert_same_trajectory(a, b, exact: bool) -> None:
    """Ids, stamps, poses (bit for bit, or to the 9 digits the XML keeps),
    transforms, frame skeletons, descriptors and cloud points."""
    cmp = (np.testing.assert_array_equal if exact else
           lambda x, y: np.testing.assert_allclose(x, y, rtol=1e-8,
                                                   atol=1e-8))
    assert a.id == b.id and len(a) == len(b)
    for sa, sb in zip(a, b):
        assert sa.id == sb.id and sa.stamp == pytest.approx(sb.stamp,
                                                            abs=1e-9)
        cmp(sa.global_pose, sb.global_pose)
        assert ((sa.match_transform_to_next is None)
                == (sb.match_transform_to_next is None))
        if sa.match_transform_to_next is not None:
            cmp(sa.match_transform_to_next, sb.match_transform_to_next)
        assert len(sa.frames) == len(sb.frames)
        for fa, fb in zip(sa.frames, sb.frames):
            assert fa.stamp == pytest.approx(fb.stamp, abs=1e-9)
            assert fa.match_score == pytest.approx(fb.match_score, abs=1e-6)
            cmp(fa.local_pose, fb.local_pose)
            cmp(fa.global_pose, fb.global_pose)
        np.testing.assert_array_equal(np.asarray(sa.descriptor),
                                      np.asarray(sb.descriptor))
        np.testing.assert_array_equal(_points(sa.cloud), _points(sb.cloud))


def _points(cloud) -> np.ndarray:
    if isinstance(cloud, tcloud.PointCloud):
        return tcloud.to_numpy(cloud)
    return jcloud.to_numpy(cloud)


def test_port_round_trip(jax_trajectory, tmp_path):
    traj = interop.trajectory(jax_trajectory, CPU)
    tpkg.save_trajectory(traj, str(tmp_path / "pkg"))
    back = tpkg.load_trajectory(str(tmp_path / "pkg"), capacity=16384,
                                device=CPU)
    _assert_same_trajectory(traj, back, exact=False)
    assert all(s.capacity == 16384 and s.cloud.capacity == 16384
               for s in back)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_package_loads_in_the_other_package(writer, jax_trajectory,
                                            tmp_path):
    """A package written by either package loads in both to the same
    state: poses equal exactly, points bit for bit; both write the same
    descriptor XML."""
    d = {k: str(tmp_path / k) for k in ("jax", "torch")}
    jpkg.save_trajectory(jax_trajectory, d["jax"])
    tpkg.save_trajectory(interop.trajectory(jax_trajectory, CPU),
                         d["torch"])
    with open(os.path.join(d["jax"], "map.xml"), "rb") as fj, \
            open(os.path.join(d["torch"], "map.xml"), "rb") as ft:
        assert fj.read() == ft.read()
    in_jax = jpkg.load_trajectory(d[writer])
    in_torch = tpkg.load_trajectory(d[writer], device=CPU)
    _assert_same_trajectory(in_jax, in_torch, exact=True)


def _pieces(path: str):
    root = ET.parse(os.path.join(path, "map.xml")).getroot()
    return [(p.get("file"), p.get("x"), p.get("y"))
            for p in root.findall("Piece")]


def test_map_pieces_match_jax(jax_trajectory, tmp_path):
    """The same piece files and centers; each piece's point count within
    1e-3 of the JAX package's, the voxel tolerance of
    tests/test_torch_mrvm.py (the MRVM's event sort is unstable), and its
    points inside the piece's half-width box around its center."""
    opts_j = jpkg.MapPackageOptions(**PIECES)
    opts_t = tpkg.MapPackageOptions(**PIECES)
    jpkg.save_map_pieces(jax_trajectory, str(tmp_path / "jax"), opts_j,
                         jmrvm.MrvmSettings(**MRVM))
    tpkg.save_map_pieces(interop.trajectory(jax_trajectory, CPU),
                         str(tmp_path / "torch"), opts_t,
                         tmrvm.MrvmSettings(**MRVM))
    pieces = _pieces(str(tmp_path / "jax"))
    assert len(pieces) >= 4
    assert _pieces(str(tmp_path / "torch")) == pieces
    half = PIECES["piece_width"] / 2
    total = 0
    for name, _, _ in pieces:
        n_j = len(tpcd.read_pcd(str(tmp_path / "jax" / name)))
        got = tpcd.read_pcd(str(tmp_path / "torch" / name))
        assert abs(len(got) - n_j) <= 1e-3 * n_j, (name, len(got), n_j)
        assert np.all(np.abs(got[:, :2]) <= half + 1e-3)
        total += len(got)
    assert total > 1000


def test_map_builder_writes_the_package(tmp_path):
    """``save_map_package=True``: ``finish()`` writes the package of the
    run's submaps and its pieces, and ``join_pieces`` rebuilds as many
    points as the pieces hold."""
    scans, _ = synthetic.make_sequence(n_scans=6, seed=5,
                                       trajectory="straight", step=1.0,
                                       max_points=6000, max_range=70.0)
    opts = tmb.MapBuilderOptions(
        front_end=FrontEndOptions(scan_capacity=8192, nn_tile=512,
                                  max_iteration=40,
                                  motion_compensation=False,
                                  use_average=False, target_leaf_size=4),
        submap=tframe.SubmapOptions(frame_count=2), submap_capacity=16384,
        export_file_path=str(tmp_path), output_mrvm=False,
        output_direct_combined_map=False, save_map_package=True,
        map_package=tpkg.MapPackageOptions(**PIECES),
        mrvm_settings=tmrvm.MrvmSettings(**MRVM))
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        mb = tmb.MapBuilder(opts, device=CPU)
        for i, pts in enumerate(scans):
            mb.insert_pointcloud(i * 0.1, pts)
        mb.finish()
    finally:
        torch.set_num_threads(saved)
    pkg = str(tmp_path / "map_package")
    back = tpkg.load_trajectory(pkg, device=CPU)
    assert len(back) == len(mb.trajectory) >= 3
    for s, b in zip(mb.trajectory, back):
        np.testing.assert_allclose(b.global_pose, s.global_pose, atol=1e-6)
        np.testing.assert_array_equal(_points(b.cloud), _points(s.cloud))
    pieces = _pieces(os.path.join(pkg, "pieces"))
    assert pieces
    out = str(tmp_path / "joined.pcd")
    assert ttools.main(["join_pieces", os.path.join(pkg, "pieces"), out]) == 0
    n_pieces = sum(len(tpcd.read_pcd(os.path.join(pkg, "pieces", f)))
                   for f, _, _ in pieces)
    assert len(tpcd.read_pcd(out)) == n_pieces > 1000
