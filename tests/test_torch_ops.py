"""Parity of the PyTorch port's voxel filter and normal estimators (kd-split
and Morton; staticmapping_torch.ops.voxel, .ops.normals) with the JAX
package, on the CPU."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from staticmapping_tpu.data import cloud as jcloud
from staticmapping_tpu.io import synthetic
from staticmapping_tpu.ops import normals as jnormals
from staticmapping_tpu.ops import voxel as jvoxel
from staticmapping_torch import interop
from staticmapping_torch.data import cloud as tcloud
from staticmapping_torch.ops import normals as tnormals
from staticmapping_torch.ops import voxel as tvoxel

CPU = "cpu"


def _jax_cloud(pts, capacity):
    return jcloud.from_numpy(pts, capacity=capacity)


def _scan(seed, n, capacity):
    """A synthetic LiDAR scan (walls, poles, ground) of ``n`` points."""
    world = synthetic.make_world(seed=seed)
    pose = synthetic.straight_trajectory(1)[0]
    pts = synthetic.render_scan(world, pose, max_points=n, seed=seed)
    return pts, _jax_cloud(pts, capacity)


@pytest.mark.parametrize("voxel_size", [0.1, 0.5])
def test_voxel_downsample_matches_jax(voxel_size):
    _, jc = _scan(1, 3000, 4096)
    want = jvoxel.voxel_downsample(jc, np.float32(voxel_size), mode="round")
    got = tvoxel.voxel_downsample(interop.point_cloud(jc, CPU), voxel_size)
    g, w = interop.to_numpy(got), {k: np.asarray(getattr(want, k))
                                   for k in ("xyz", "intensity", "factor",
                                             "mask")}
    # counts and mask exact: the same voxels, in the same key order
    np.testing.assert_array_equal(g["mask"], w["mask"])
    assert int(g["mask"].sum()) == int(w["mask"].sum())
    m = w["mask"]
    for k in ("xyz", "intensity", "factor"):
        np.testing.assert_allclose(g[k][m], w[k][m], rtol=1e-5, atol=1e-6)


def test_voxel_downsample_batched_rows():
    """A batch of clouds equals each cloud filtered on its own."""
    clouds = [interop.point_cloud(_scan(s, 1500, 2048)[1], CPU)
              for s in (2, 3)]
    got = tvoxel.voxel_downsample(tcloud.stack(clouds), 0.2)
    for b, c in enumerate(clouds):
        one = tvoxel.voxel_downsample(c, 0.2)
        np.testing.assert_array_equal(got.mask[b].numpy(), one.mask.numpy())
        np.testing.assert_allclose(got.xyz[b].numpy(), one.xyz.numpy(),
                                   rtol=1e-6)


def test_voxel_sort_puts_invalid_last():
    keys = torch.tensor([[1, 2, 3], [0, 0, 0], [1, 2, 2], [-5, 9, 9]],
                        dtype=torch.int32)
    mask = torch.tensor([True, False, True, True])
    skeys, smask, (pay,), seg = tvoxel._sort_by_voxel(
        keys, mask, (torch.arange(4, dtype=torch.float32),))
    assert pay.tolist() == [3.0, 2.0, 0.0, 1.0]
    assert smask.tolist() == [True, True, True, False]
    assert seg.tolist() == [0, 1, 2, 3]


@pytest.mark.parametrize("lead", [(), (3,)])
def test_segment_sum_adds_in_point_order(lead):
    """Each segment of the valid rows is summed from 0 in point order,
    exactly as a float32 loop adds it; the masked rows (last, one shared
    id, as ``_sort_by_voxel`` leaves them) add nothing, and every other
    slot holds 0.  Values span 12 decades so that any other order would
    round differently."""
    rng = np.random.default_rng(9)
    n, c = 257, 4
    n_valid = rng.integers(100, 200, lead or (1,))
    seg = np.sort(rng.integers(0, 40, lead + (n,)), axis=-1)
    mask = np.arange(n) < n_valid.reshape(lead + (1,))
    seg = np.where(mask, seg, 40)
    data = (rng.standard_normal(lead + (n, c))
            * 10.0 ** rng.integers(-6, 6, lead + (n, 1))).astype(np.float32)
    got = tvoxel._segment_sum(torch.from_numpy(data), torch.from_numpy(seg),
                              n, torch.from_numpy(mask)).numpy()
    want = np.zeros(lead + (n, c), np.float32)
    for row in np.ndindex(*lead):
        for i in range(n):
            if mask[row + (i,)]:
                want[row + (seg[row + (i,)],)] += data[row + (i,)]
    np.testing.assert_array_equal(got, want)


def test_kdsplit_normals_match_jax():
    _, jc = _scan(4, 3500, 4096)
    want = jnormals.estimate_normals(jc.compact(), leaf_size=8)
    pc = interop.point_cloud(jc, CPU).compact()
    got = interop.to_numpy(tnormals.estimate_normals(pc, leaf_size=8))
    m = np.asarray(want.mask)
    np.testing.assert_array_equal(got["mask"], m)
    assert m.sum() > 100
    np.testing.assert_allclose(got["xyz"][m], np.asarray(want.xyz)[m],
                               atol=1e-4)
    # sign included: the unconstrained LS normal fixes the orientation.
    # The raw (uncentred) leaf moment is ill-conditioned for a few leaves,
    # where any f32 evaluation strays from the exact normal by up to ~5e-3
    # and the two packages' f32 roundings stray apart: on this scan 15 of
    # 438 leaves differ from JAX by more than 1e-3 (up to 1.0e-2), while the
    # float64 solution puts the port's largest stray at 5.4e-3 and the JAX
    # package's at 5.2e-3.  So 1e-3 holds for 95% of leaves, not all (see
    # PERF.md, Open questions), and the port's stray from the float64
    # solution may be no larger than twice the JAX package's own.
    exact = tnormals.estimate_normals(
        dataclasses.replace(pc, xyz=pc.xyz.double()), leaf_size=8)
    n_t, n_j = got["normals"][m], np.asarray(want.normals)[m]
    n_64 = exact.normals.numpy()[m]
    assert np.mean(np.abs(n_t - n_j).max(1) <= 1e-3) >= 0.95
    port_stray = np.abs(n_t - n_64).max(1)
    jax_stray = np.abs(n_j - n_64).max(1)
    assert port_stray.max() <= 2.0 * jax_stray.max()
    assert (np.quantile(port_stray, 0.99)
            <= 2.0 * np.quantile(jax_stray, 0.99) + 1e-4)


def test_kdsplit_normals_batched_rows():
    clouds = [interop.point_cloud(_scan(s, 1800, 2048)[1], CPU)
              for s in (5, 6)]
    got = tnormals.estimate_normals(tcloud.stack(clouds), leaf_size=4)
    for b, c in enumerate(clouds):
        one = tnormals.estimate_normals(c, leaf_size=4)
        np.testing.assert_array_equal(got.mask[b].numpy(), one.mask.numpy())
        np.testing.assert_allclose(got.normals[b].numpy(),
                                   one.normals.numpy(), atol=1e-5)


def test_smallest_eigvec_and_solve3_match_jax():
    rng = np.random.default_rng(8)
    a = rng.normal(size=(64, 3, 3)).astype(np.float32)
    A = a @ np.swapaxes(a, 1, 2) + 0.1 * np.eye(3, dtype=np.float32)
    b = rng.normal(size=(64, 3)).astype(np.float32)
    x_j, det_j = jnormals._solve3(jnp.asarray(A), jnp.asarray(b))
    x_t, det_t = tnormals._solve3(torch.from_numpy(A), torch.from_numpy(b))
    np.testing.assert_allclose(x_t.numpy(), np.asarray(x_j), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(det_t.numpy(), np.asarray(det_j), rtol=1e-5)
    np.testing.assert_allclose(
        tnormals._sym3_eigvals(torch.from_numpy(A)).numpy(),
        np.asarray(jnormals._sym3_eigvals(jnp.asarray(A))), rtol=1e-4,
        atol=1e-5)
    v_t = tnormals.smallest_eigvec3(torch.from_numpy(A)).numpy()
    v_j = np.asarray(jnormals.smallest_eigvec3(jnp.asarray(A)))
    # an eigenvector's sign is arbitrary: compare up to it
    np.testing.assert_allclose(np.abs(np.sum(v_t * v_j, -1)), 1.0, atol=1e-4)


def _jax_morton_keys(jc):
    """The keys ``staticmapping_tpu.ops.normals.estimate_normals`` sorts by
    with ``method='morton'`` (normals.py:212-225), in one jit as there."""
    @jax.jit
    def keys(xyz, mask):
        lo = jnp.where(jnp.isfinite(
            lo := jnp.min(jnp.where(mask[:, None], xyz, jnp.inf), axis=0)),
            lo, 0.0)
        hi = jnp.where(jnp.isfinite(
            hi := jnp.max(jnp.where(mask[:, None], xyz, -jnp.inf), axis=0)),
            hi, 1.0)
        top = (1 << jnormals._MORTON_BITS) - 1
        scale = top / jnp.maximum(hi - lo, 1e-6)
        q = jnp.clip(((xyz - lo) * scale).astype(jnp.int32), 0, top)
        return jnp.where(mask, jnormals._morton_interleave(q),
                         jnp.int32(0x7FFFFFFF))
    return np.asarray(keys(jc.xyz, jc.mask))


def _morton_cloud(seed: int, invalid: float):
    """A 3500-point scan in 4096 slots, ``invalid`` of its slots then
    masked at random (scattered among the valid ones)."""
    _, jc = _scan(seed, 3500, 4096)
    rng = np.random.default_rng(seed)
    mask = np.asarray(jc.mask) & (rng.random(4096) >= invalid)
    return dataclasses.replace(jc, mask=jnp.asarray(mask))


@pytest.mark.parametrize("seed,invalid", [(4, 0.0), (7, 0.1)])
def test_morton_keys_and_leaf_mask_match_jax(seed, invalid):
    """The Morton keys and the leaf mask are exact, and the leaf means
    agree to 1e-4 m."""
    jc = _morton_cloud(seed, invalid)
    pc = interop.point_cloud(jc, CPU)
    np.testing.assert_array_equal(tnormals.morton_keys(pc).numpy(),
                                  _jax_morton_keys(jc))
    want = jnormals.estimate_normals(jc, leaf_size=8, method="morton")
    got = interop.to_numpy(tnormals.estimate_normals(pc, leaf_size=8,
                                                     method="morton"))
    m = np.asarray(want.mask)
    np.testing.assert_array_equal(got["mask"], m)
    assert m.sum() > 100
    np.testing.assert_allclose(got["xyz"][m], np.asarray(want.xyz)[m],
                               atol=1e-4)


def test_morton_normals_match_jax():
    """The leaf normals on test_kdsplit_normals_match_jax's scan, to its
    tolerance: 1e-3 for 95% of leaves, and the port's stray from a float64
    solve of the same leaves at most twice the JAX package's (largest and
    99th percentile).  The raw f32 leaf moment strays by up to ~1e-2 on a
    few leaves in either package (ROADMAP.md queue C)."""
    jc = _morton_cloud(4, 0.0)
    pc = interop.point_cloud(jc, CPU)
    want = jnormals.estimate_normals(jc, leaf_size=8, method="morton")
    got = tnormals.estimate_normals(pc, leaf_size=8, method="morton")
    m = np.asarray(want.mask)
    perm = torch.sort(tnormals.morton_keys(pc), stable=True).indices
    xyz64 = pc.xyz[perm].double()
    exact = tnormals._leaf_normals(xyz64[:, 0], xyz64[:, 1], xyz64[:, 2],
                                   pc.mask[perm], 8)
    n_t, n_j = got.normals.numpy()[m], np.asarray(want.normals)[m]
    n_64 = exact.normals.numpy()[m]
    assert np.mean(np.abs(n_t - n_j).max(1) <= 1e-3) >= 0.95
    port_stray = np.abs(n_t - n_64).max(1)
    jax_stray = np.abs(n_j - n_64).max(1)
    assert port_stray.max() <= 2.0 * jax_stray.max()
    assert (np.quantile(port_stray, 0.99)
            <= 2.0 * np.quantile(jax_stray, 0.99) + 1e-4)


def test_morton_normals_batched_rows():
    clouds = [interop.point_cloud(_scan(s, 1800, 2048)[1], CPU)
              for s in (8, 9)]
    got = tnormals.estimate_normals(tcloud.stack(clouds), leaf_size=4,
                                    method="morton")
    for b, c in enumerate(clouds):
        one = tnormals.estimate_normals(c, leaf_size=4, method="morton")
        np.testing.assert_array_equal(got.mask[b].numpy(), one.mask.numpy())
        np.testing.assert_allclose(got.normals[b].numpy(),
                                   one.normals.numpy(), atol=1e-5)
