"""The port's offline tools (``python -m staticmapping_torch.tools``) against
the JAX package's on the same input files: each subcommand writes the same
bytes, and ``path_statistic`` prints the same text.  Then the cases of
tests/test_octree.py through the port's ``Octree``."""
import os
import xml.etree.ElementTree as ET

import numpy as np
import pytest

from staticmapping_tpu import tools as jtools
from staticmapping_torch import tools as ttools
from staticmapping_torch.common.octree import Octree
from staticmapping_torch.io import las as tlas
from staticmapping_torch.io import pcd as tpcd


def _cloud(seed: int, n: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-50, 50, (n, 4)).astype(np.float32)
    pts[:, 3] = rng.uniform(0, 1, n)
    return pts


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """A pcd, a KITTI .bin, a pieces dir of two center-relative pcds with
    their descriptor, a path.csv and a KITTI pose file."""
    d = tmp_path_factory.mktemp("tool_inputs")
    tpcd.write_pcd(str(d / "cloud.pcd"), _cloud(0, 5000))
    _cloud(1, 3000).tofile(str(d / "scan.bin"))
    pieces = d / "pieces"
    pieces.mkdir()
    root = ET.Element("MapPackage")
    for k, (cx, cy) in enumerate([(250.0, -250.0), (500.0, 0.0)]):
        name = f"part_{k}_0.pcd"
        tpcd.write_pcd(str(pieces / name), _cloud(2 + k, 1000))
        ET.SubElement(root, "Piece", x=f"{cx:.6f}", y=f"{cy:.6f}", file=name)
    ET.ElementTree(root).write(str(pieces / "map_package.xml"))
    rng = np.random.default_rng(4)
    xyz = np.cumsum(rng.normal(0, 0.5, (40, 3)), axis=0)
    stamps = 0.1 * np.arange(40)
    np.savetxt(str(d / "path.csv"),
               np.column_stack([stamps, xyz, np.tile([1, 0, 0, 0], (40, 1))]),
               header="stamp x y z qw qx qy qz", comments="# ")
    poses = np.tile(np.eye(4)[:3].reshape(1, 12), (40, 1))
    poses[:, [3, 7, 11]] = xyz
    np.savetxt(str(d / "poses.txt"), poses)
    return d


def _run_both(d, out_name, argv_of):
    """Run one subcommand in each package; returns their two output
    paths."""
    outs = []
    for tag, mod in (("jax", jtools), ("torch", ttools)):
        out = str(d / f"{tag}_{out_name}")
        assert mod.main(argv_of(out)) == 0
        outs.append(out)
    return outs


def _same_bytes(a: str, b: str) -> None:
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()


@pytest.mark.parametrize("cmd", ["join_pieces", "bin_to_pcd", "pcd_sampler",
                                 "pcd_to_las"])
def test_tool_writes_the_jax_tools_bytes(cmd, inputs, tmp_path):
    d = inputs
    argv_of = {
        "join_pieces": lambda out: ["join_pieces", str(d / "pieces"), out],
        "bin_to_pcd": lambda out: ["bin_to_pcd", str(d / "scan.bin"), out],
        "pcd_sampler": lambda out: ["pcd_sampler", str(d / "cloud.pcd"), out,
                                    "--rate", "0.3", "--seed", "7"],
        "pcd_to_las": lambda out: ["pcd_to_las", str(d / "cloud.pcd"), out],
    }[cmd]
    ext = "las" if cmd == "pcd_to_las" else "pcd"
    a, b = _run_both(tmp_path, f"{cmd}.{ext}", argv_of)
    _same_bytes(a, b)
    assert os.path.getsize(b) > 1000


def test_join_pieces_restores_global_coordinates(inputs, tmp_path):
    out = str(tmp_path / "joined.pcd")
    assert ttools.main(["join_pieces", str(inputs / "pieces"), out]) == 0
    got = tpcd.read_pcd(out)
    want = np.vstack([_cloud(2, 1000) + [250.0, -250.0, 0, 0],
                      _cloud(3, 1000) + [500.0, 0.0, 0, 0]])
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_pcd_to_las_round_trip(inputs, tmp_path):
    out = str(tmp_path / "cloud.las")
    assert ttools.main(["pcd_to_las", str(inputs / "cloud.pcd"), out]) == 0
    got = tlas.read_las(out)
    want = tpcd.read_pcd(str(inputs / "cloud.pcd"))
    # 1 mm quantization of x, y, z; intensity in 1/65535 steps
    np.testing.assert_allclose(got[:, :3], want[:, :3], atol=6e-4)
    np.testing.assert_allclose(got[:, 3], want[:, 3], atol=2e-5)


@pytest.mark.parametrize("name", ["path.csv", "poses.txt"])
def test_path_statistic_prints_the_jax_tools_text(name, inputs, capsys):
    path = str(inputs / name)
    assert jtools.main(["path_statistic", path]) == 0
    want = capsys.readouterr().out
    assert ttools.main(["path_statistic", path]) == 0
    got = capsys.readouterr().out
    assert got == want
    assert "length:" in got


# --------------------------------------------------------------- octree --
# the cases of tests/test_octree.py, through the port's copy

def test_octree_build_and_contains():
    rng = np.random.default_rng(0)
    pts = rng.uniform(-10, 10, (2000, 3))
    tree = Octree(pts, max_depth=4)
    assert len(tree) == 2000
    assert tree.num_leaves > 50
    assert tree.contains(pts[0])
    assert not tree.contains([100.0, 0.0, 0.0])


def test_octree_radius_search_exact():
    rng = np.random.default_rng(1)
    pts = rng.uniform(-5, 5, (3000, 3))
    tree = Octree(pts, max_depth=5)
    for q in rng.uniform(-4, 4, (10, 3)):
        for r in (0.3, 1.0):
            got = np.sort(tree.radius_search(q, r))
            want = np.flatnonzero(np.linalg.norm(pts - q, axis=1) <= r)
            np.testing.assert_array_equal(got, want)


def test_octree_nearest_matches_bruteforce():
    rng = np.random.default_rng(2)
    pts = rng.uniform(-5, 5, (1000, 3))
    tree = Octree(pts, max_depth=4)
    for q in rng.uniform(-6, 6, (20, 3)):
        idx, d = tree.nearest(q)
        brute = np.linalg.norm(pts - q, axis=1)
        assert idx == int(np.argmin(brute))
        assert abs(d - brute.min()) < 1e-9


def test_octree_leaf_of():
    pts = np.array([[0.0, 0.0, 0.0], [0.01, 0.0, 0.0], [3.0, 3.0, 3.0]])
    tree = Octree(pts, max_depth=6)
    leaf = tree.leaf_of([0.0, 0.0, 0.0])
    assert leaf is not None and set(leaf) == {0, 1}
    assert tree.leaf_of([50.0, 0.0, 0.0]) is None
