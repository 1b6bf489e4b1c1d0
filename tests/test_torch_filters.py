"""Parity of the PyTorch port's filter chain (staticmapping_torch.filters)
with the JAX package on the CPU: the three filters of
config/lidar_only_kitti.xml, the other seven names of the registry on one
synthetic scan, and the factory over every name."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import staticmapping_tpu.filters as jfilter_pkg
import staticmapping_torch.filters as tfilter_pkg
from staticmapping_tpu.data import cloud as jcloud
from staticmapping_tpu.filters import filters as jfilters
from staticmapping_tpu.io import synthetic
from staticmapping_torch import interop
from staticmapping_torch.filters import filters as tfilters

CPU = "cpu"
# config/lidar_only_kitti.xml
KITTI_CHAIN = [("Range", {"min_range": 5.0}), ("AxisRange", {"min": -2.0}),
               ("RandomSampler", {"sampling_rate": 0.5})]


def _cloud(seed=0, n=3000, capacity=4096):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-30, 30, (n, 4)).astype(np.float32)
    pts[:, 2] = rng.uniform(-4, 4, n)
    return jcloud.from_numpy(pts, capacity=capacity)


@pytest.mark.parametrize("name,params", [
    ("Range", {"min_range": 5.0}), ("Range", {"min_range": 2.0,
                                              "max_range": 20.0}),
    ("AxisRange", {"min": -2.0}),
    ("AxisRange", {"min": -10.0, "max": 10.0, "axis_index": 0})])
def test_deterministic_filters_match_jax(name, params):
    jc = _cloud()
    want = jfilters.create_filter(name, params)(jc)
    got = tfilters.create_filter(name, params)(interop.point_cloud(jc, CPU))
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
    np.testing.assert_array_equal(got.xyz.numpy(), np.asarray(want.xyz))


def test_random_sampler_keeps_its_rate_and_seed():
    """Another RNG than jax.random draws the uniforms, so the kept set
    differs from the JAX package's; the kept fraction and the determinism
    per seed hold."""
    jc = _cloud(1, n=4000)
    pc = interop.point_cloud(jc, CPU)
    sampler = tfilters.create_filter("RandomSampler", {"sampling_rate": 0.5})
    a, b = sampler(pc), sampler(pc)
    np.testing.assert_array_equal(a.mask.numpy(), b.mask.numpy())
    n_in = int(pc.mask.sum())
    kept_t = int(a.mask.sum()) / n_in
    kept_j = int(np.asarray(jfilters.create_filter(
        "RandomSampler", {"sampling_rate": 0.5})(jc).mask).sum()) / n_in
    # three binomial standard deviations at n = 4000, p = 0.5
    assert abs(kept_t - 0.5) < 3 * np.sqrt(0.25 / n_in)
    assert abs(kept_j - 0.5) < 3 * np.sqrt(0.25 / n_in)
    assert not (a.mask & ~pc.mask).any()       # only clears mask bits
    other = tfilters.RandomSamplerFilter(sampling_rate=0.5, seed=1)(pc)
    assert not torch.equal(other.mask, a.mask)


def test_kitti_chain_matches_jax_before_sampling():
    jc = _cloud(2)
    chain_t = tfilters.FilterChain([tfilters.create_filter(n, p)
                                    for n, p in KITTI_CHAIN])
    chain_j = jfilters.FilterChain([jfilters.create_filter(n, p)
                                    for n, p in KITTI_CHAIN[:2]])
    got = chain_t(interop.point_cloud(jc, CPU)).mask.numpy()
    want = np.asarray(chain_j(jc).mask)
    assert not (got & ~want).any()             # the sampler only removes
    assert 0.4 < got.sum() / want.sum() < 0.6


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """The filters are chains of small ops: a wide CPU pool shared with
    other test processes only slows them down."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", sorted(jfilter_pkg.FILTER_REGISTRY))
def test_every_registry_name_builds_like_jax(name):
    """Every name the JAX package registers builds in the port, with the
    same parameter table and equal option values."""
    assert sorted(tfilter_pkg.FILTER_REGISTRY) == sorted(
        jfilter_pkg.FILTER_REGISTRY)
    j = jfilter_pkg.create_filter(name, {})
    t = tfilter_pkg.create_filter(name, {})
    assert type(t).__name__ == type(j).__name__
    assert type(t).PARAMS == type(j).PARAMS
    assert vars(t) == vars(j)


@pytest.fixture(scope="module")
def scan():
    """One synthetic scan at 16384 slots: 14732 points within 30 m, dense
    enough for the voxel filters' per-voxel counts."""
    scans, _ = synthetic.make_sequence(n_scans=1, seed=3,
                                       trajectory="straight",
                                       max_points=16000, max_range=30.0)
    jc = jcloud.from_numpy(scans[0], capacity=16384)
    return jc, interop.point_cloud(jc, CPU)


@pytest.mark.parametrize("name,params", [
    ("BoundingBoxRemoval", {"min_x": -3.0, "max_x": 3.0, "min_y": -2.0,
                            "max_y": 2.0, "min_z": -3.0, "max_z": 1.0}),
    ("VoxelGrid", {"voxel_size": 0.5}),
    ("StatisticRemoval", {}),
    ("GroundRemoval", {"min_point_num_in_voxel": 3}),
    ("GroundRemoval2", {"start_ground_height": -1.8}),
    ("RangeImage", {})])
def test_new_filters_match_jax(scan, name, params):
    """The same scan through both packages' filter: the same kept points
    (VoxelGrid: the same voxel centroids, to f32 rounding).  The ground
    lies 1.8 m below the sensor in this world, so GroundRemoval2 starts
    its lines there."""
    jc, tc = scan
    want = jfilter_pkg.create_filter(name, params)(jc)
    got = tfilter_pkg.create_filter(name, params)(tc)
    mask = np.asarray(want.mask)
    np.testing.assert_array_equal(got.mask.numpy(), mask)
    assert 0 < mask.sum() < np.asarray(jc.mask).sum() or name == "VoxelGrid"
    np.testing.assert_allclose(got.xyz.numpy()[mask],
                               np.asarray(want.xyz)[mask], atol=1e-5)


def test_plane_detector_matches_jax(scan):
    """The plane masks of both packages agree exactly (the batched
    eigenvectors' signs are free; the residuals they give are not)."""
    jc, tc = scan
    kw = dict(leaf_size=2.0, min_point_num_in_voxel=5,
              distance_threshold=0.5)
    want = np.asarray(jfilter_pkg.PlaneDetector(**kw).plane_mask(jc))
    got = tfilter_pkg.PlaneDetector(**kw).plane_mask(tc).numpy()
    np.testing.assert_array_equal(got, want)
    assert 1000 < want.sum() < np.asarray(jc.mask).sum()


def test_plane_sampler_keeps_planes_and_its_rate(scan):
    """RandomSamplerWithPlaneDetect keeps the plane set of both packages
    exactly and samples the other points at its rate: another RNG draws
    the uniforms, so the sampled points differ from the JAX package's,
    while the kept fraction holds to three binomial standard deviations
    and the draw is fixed by the seed."""
    jc, tc = scan
    params = {"sampling_rate": 0.5, "leaf_size": 2.0,
              "min_point_num_in_voxel": 5, "ground_height_threshold": 0.5}
    plane = tfilter_pkg.PlaneDetector(
        leaf_size=2.0, min_point_num_in_voxel=5,
        distance_threshold=0.5).plane_mask(tc).numpy()
    sampler = tfilter_pkg.create_filter("RandomSamplerWithPlaneDetect",
                                        params)
    a, b = sampler(tc).mask.numpy(), sampler(tc).mask.numpy()
    np.testing.assert_array_equal(a, b)
    want = np.asarray(jfilter_pkg.create_filter(
        "RandomSamplerWithPlaneDetect", params)(jc).mask)
    valid = np.asarray(jc.mask)
    assert (a[plane]).all() and (want[plane]).all()
    rest = valid & ~plane
    n = rest.sum()
    for kept in (a[rest].mean(), want[rest].mean()):
        assert abs(kept - 0.5) < 3 * np.sqrt(0.25 / n)
    assert not (a & ~valid).any()


@pytest.mark.parametrize("rows,cols", [(40, 1800), (16, 360)])
def test_depth_cluster_matches_jax(scan, rows, cols):
    """RangeImage's depth clustering: the per-point labels of both
    packages agree exactly, and so do the labels of ``_depth_cluster`` on
    one range image carried across.  The images hold the same pixels; a
    range, sqrt(x² + y² + z²) in f32, may round to its neighbouring
    float."""
    from staticmapping_tpu.filters import range_image as jri
    from staticmapping_torch.filters import range_image as tri
    jc, tc = scan
    kw = dict(vertical_line_num=rows, horizontal_line_num=cols)
    fj, ft = jri.RangeImageFilter(**kw), tri.RangeImageFilter(**kw)
    want = np.asarray(fj.depth_cluster(jc))
    np.testing.assert_array_equal(ft.depth_cluster(tc).numpy(), want)
    assert len(np.unique(want)) > 3
    img = fj.to_image(jc)
    got = ft.to_image(tc)
    np.testing.assert_array_equal(got > 0, img > 0)
    np.testing.assert_allclose(got, img, rtol=2.4e-7, atol=0)
    v_res = (30.0 + 15.0) / rows / 180.0 * np.pi
    lab_j = np.asarray(jri._depth_cluster(jnp.asarray(img),
                                          jnp.float32(v_res), rows, cols))
    lab_t = tri._depth_cluster(torch.from_numpy(np.array(img)),
                               torch.tensor(v_res, dtype=torch.float32),
                               rows, cols).numpy()
    np.testing.assert_array_equal(lab_t, lab_j)


def test_filter_params_are_checked():
    with pytest.raises(KeyError, match="no param"):
        tfilters.create_filter("Range", {"radius": 3.0})
    with pytest.raises(ValueError, match="invalid config"):
        tfilters.create_filter("Range", {"min_range": 5.0, "max_range": 1.0})
    with pytest.raises(KeyError, match="unknown filter"):
        tfilters.create_filter("NoSuchFilter", {})
