"""The port's random bits (``staticmapping_torch.common.random``) against
``jax.random`` on the CPU: the uniforms bit for bit, the two random
samplers' masks, and a sequential builder run with
config/lidar_only_kitti.xml's whole filter chain, RandomSampler included,
held to the JAX package's run of the same scans."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import staticmapping_tpu.filters as jfilter_pkg
import staticmapping_torch.filters as tfilter_pkg
from staticmapping_tpu import config as jconfig
from staticmapping_tpu.data import cloud as jcloud
from staticmapping_tpu.io import synthetic
from staticmapping_torch import config as tconfig
from staticmapping_torch import interop
from staticmapping_torch.common import random as trandom
from staticmapping_torch.io import pcd as tpcd
from test_torch_kitti_cli import run_builder, write_sequence

CPU = "cpu"

# 2**32 + 5 and -1: jax.random.key keeps only the seed's low 32 bits
SEEDS = [0, 1, 7, 2**32 + 5, -1]
SHAPES = [(1,), (5,), (4096,), (32768,), (2, 4096), (65536,)]


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("seed", SEEDS)
def test_uniform_is_jax_bit_for_bit(seed, shape):
    want = np.asarray(jax.random.uniform(jax.random.key(seed), shape))
    got = trandom.uniform(seed, shape, CPU)
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  want.view(np.uint32))


def test_random_bits_are_jax_bits():
    want = np.asarray(jax.random.bits(jax.random.key(123456), (3, 1000)))
    got = trandom.random_bits(123456, (3, 1000), CPU)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


def _scan_cloud(capacity=32768):
    """One full-width scan of the main path's world (30000 points within
    70 m) in ``capacity`` slots, as both packages hold it."""
    scans, _ = synthetic.make_sequence(n_scans=1, seed=3,
                                       trajectory="straight",
                                       max_points=30000, max_range=70.0)
    jc = jcloud.from_numpy(scans[0], capacity=capacity)
    return jc, interop.point_cloud(jc, CPU)


@pytest.mark.parametrize("name,params", [
    ("RandomSampler", {"sampling_rate": 0.5}),
    ("RandomSampler", {"sampling_rate": 0.3}),
    ("RandomSamplerWithPlaneDetect", {"sampling_rate": 0.5}),
])
def test_samplers_keep_the_jax_mask(name, params):
    """On one full-width scan, the port's sampler keeps exactly the points
    the JAX package's keeps, for two seeds."""
    jc, tc = _scan_cloud()
    for seed in (0, 9):
        jf = jfilter_pkg.create_filter(name, params)
        tf = tfilter_pkg.create_filter(name, params)
        jf.seed = tf.seed = seed
        want = np.asarray(jf(jc).mask)
        got = tf(tc).mask.numpy()
        np.testing.assert_array_equal(got, want)
        assert 0 < want.sum() < np.asarray(jc.mask).sum()


def test_sampled_builder_run_matches_jax(tmp_path):
    """Both packages' sequential builders on tests/test_kitti_cli.py's 10
    scans with config/lidar_only_kitti.xml's whole chain (Range, AxisRange,
    RandomSampler at 0.5): every scan's filtered cloud is the same bit for
    bit, the keyframe counts are equal and the static maps within 10% of
    each other (the bound of
    tests/test_torch_kitti_cli.py::test_builder_matches_jax)."""
    d = tmp_path / "velodyne"
    d.mkdir()
    scans, _ = write_sequence(str(d))
    clouds_j, clouds_t = [], []
    mb_j = run_builder(jconfig, str(d), tmp_path / "jax", False,
                       sampler=True, clouds=clouds_j)
    mb_t = run_builder(tconfig, str(d), tmp_path / "torch", False,
                       sampler=True, clouds=clouds_t, device=CPU)
    assert len(clouds_t) == len(clouds_j) == len(scans)
    for pc_t, pc_j in zip(clouds_t, clouds_j):
        np.testing.assert_array_equal(pc_t.mask.numpy(), np.asarray(pc_j.mask))
        np.testing.assert_array_equal(pc_t.xyz.numpy(), np.asarray(pc_j.xyz))
        n_in = int(jnp.sum(pc_j.xyz[:, 0] < 1e5))
        assert 0.4 * n_in < int(pc_t.mask.sum()) < 0.6 * n_in
    assert len(mb_t.frame_poses()) == len(mb_j.frame_poses())
    n_j, n_t = (len(tpcd.read_pcd(str(tmp_path / k / "static_map.pcd")))
                for k in ("jax", "torch"))
    assert n_t > 500
    assert abs(n_t - n_j) <= 0.10 * n_j, (n_t, n_j)
