"""Parity of the port's MRVM static map (staticmapping_torch.builder.mrvm
and builder/mrvm_store.py) with the JAX package on the CPU: the per-scan
device reduction, the packed read-back, whole maps over several scans, the
cases of tests/test_mrvm.py, and the native store against the numpy one."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from staticmapping_tpu.builder import mrvm as jmrvm
from staticmapping_tpu.data import cloud as jcloud
from staticmapping_torch.builder import mrvm as tmrvm
from staticmapping_torch.builder import mrvm_store as tstore
from staticmapping_torch.data import cloud as tcloud

CPU = "cpu"
RES, STEPS = 0.1, 32


def _scene(seed, n=1500):
    """A wall, a floor and a post around an origin, with intensities."""
    rng = np.random.default_rng(seed)
    wall = np.column_stack([np.full(n // 2, 8.0) + rng.normal(0, 0.02, n // 2),
                            rng.uniform(-4, 4, n // 2),
                            rng.uniform(-1, 2, n // 2)])
    floor = np.column_stack([rng.uniform(1, 8, n // 3),
                             rng.uniform(-4, 4, n // 3),
                             np.full(n // 3, -1.2)])
    k = n - len(wall) - len(floor)
    post = np.column_stack([rng.normal(4.0, 0.05, k), rng.normal(1.0, 0.05, k),
                            rng.uniform(-1.2, 1.0, k)])
    xyz = np.vstack([wall, floor, post]).astype(np.float32)
    inten = rng.uniform(0, 100, len(xyz)).astype(np.float32)
    return np.column_stack([xyz, inten]).astype(np.float32)


def _events(pts, origin, capacity=2048):
    """(JAX, port) ``_scan_events`` outputs as numpy, valid slots only,
    keyed by voxel."""
    jc = jcloud.from_numpy(pts, capacity=capacity)
    tc = tcloud.from_numpy(pts, capacity=capacity, device=CPU)
    out_j = jmrvm._scan_events(jc.xyz, jc.mask, jc.intensity,
                               jnp.asarray(origin, dtype=jnp.float32),
                               RES, STEPS)
    out_t = tmrvm._scan_events(tc.xyz, tc.mask, tc.intensity,
                               torch.as_tensor(origin, dtype=torch.float32),
                               RES, STEPS)
    res = []
    for out in (out_j, [x.numpy() for x in out_t]):
        keys, hit, miss, sxyz, mint, sint, valid = (np.asarray(x)
                                                    for x in out)
        res.append({tuple(k): (h, m, s, mi, si) for k, h, m, s, mi, si in
                    zip(keys[valid], hit[valid], miss[valid], sxyz[valid],
                        mint[valid], sint[valid])})
    return res


def test_scan_events_match_jax():
    """The same scan from the same origin: equal valid key sets, equal hit
    and miss counts for ≥ 99.9% of keys (a sample on a floor boundary may
    land in the neighbouring voxel when the two packages round the ray
    position differently in f32), and per-voxel sums to f32 tolerance (the
    JAX sort is unstable, so its sums add in another order)."""
    pts = _scene(0)
    ev_j, ev_t = _events(pts, np.array([0.3, -0.2, 0.5]))
    keys = set(ev_j) | set(ev_t)
    same_keys = set(ev_j) & set(ev_t)
    assert len(same_keys) >= 0.999 * len(keys)
    counts_equal = [k for k in same_keys
                    if ev_j[k][0] == ev_t[k][0] and ev_j[k][1] == ev_t[k][1]]
    assert len(counts_equal) >= 0.999 * len(keys)
    for k in same_keys:
        if ev_j[k][0] == ev_t[k][0]:
            np.testing.assert_allclose(ev_t[k][2], ev_j[k][2], rtol=1e-5,
                                       atol=1e-4)
            np.testing.assert_allclose(ev_t[k][4], ev_j[k][4], rtol=1e-5,
                                       atol=1e-3)
            assert ev_t[k][3] == ev_j[k][3]          # max intensity: exact


@pytest.mark.parametrize("with_avg", [False, True])
def test_packed_read_back_matches_jax(with_avg):
    """The int16 packing of both packages on the same scan: the valid
    prefix holds the same keys and counts row for row (both sorted by key);
    the f32 halves decode to the same values within f32 tolerance."""
    pts = _scene(1)
    origin = np.array([0.0, 0.0, 1.0], dtype=np.float32)
    jc = jcloud.from_numpy(pts, capacity=2048)
    tc = tcloud.from_numpy(pts, capacity=2048, device=CPU)
    pj, nj = jmrvm._scan_events_packed(jc.xyz, jc.mask, jc.intensity,
                                       jnp.asarray(origin), RES, STEPS,
                                       with_avg)
    pt, nt = tmrvm._scan_events_packed(tc.xyz, tc.mask, tc.intensity,
                                       torch.from_numpy(origin), RES, STEPS,
                                       with_avg)
    assert pt.dtype == torch.int16 and pt.shape == tuple(pj.shape)
    assert int(nt) == int(nj)
    pj, pt = np.asarray(pj)[:int(nj)], pt.numpy()[:int(nt)]
    same = (pt[:, :5] == pj[:, :5]).all(1)         # keys, hits, misses
    assert same.mean() >= 0.999
    np.testing.assert_array_equal(pt[same, 5:7], pj[same, 5:7])
    if with_avg:
        np.testing.assert_allclose(
            tmrvm._2xi16_to_f32(pt[same, 7:15].reshape(-1, 4, 2)),
            jmrvm._2xi16_to_f32(pj[same, 7:15].reshape(-1, 4, 2)),
            rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("settings", [
    dict(), dict(output_average=True), dict(use_max_intensity=False),
    dict(output_average=True, max_point_num_in_cell=2)])
def test_map_over_three_scans_matches_jax(settings):
    """``output_to_numpy`` of both maps after the same three scans from
    three origins: the same voxels (≥ 99.9%), their points and intensities
    to f32 tolerance."""
    kw = dict(max_ray_steps=STEPS, prob_threshold=0.55, **settings)
    mj = jmrvm.MultiResolutionVoxelMap(jmrvm.MrvmSettings(**kw))
    mt = tmrvm.MultiResolutionVoxelMap(tmrvm.MrvmSettings(**kw))
    for k, origin in enumerate(([0, 0, 0.5], [0.5, 0.2, 0.5],
                                [1.0, -0.3, 0.6])):
        pts = _scene(10 + k)
        mj.insert_point_cloud(jcloud.from_numpy(pts, capacity=2048),
                              np.array(origin))
        mt.insert_point_cloud(tcloud.from_numpy(pts, capacity=2048,
                                                device=CPU),
                              np.array(origin))
    assert abs(mt.num_voxels - mj.num_voxels) <= 1e-3 * mj.num_voxels
    out_j, out_t = mj.output_to_numpy(), mt.output_to_numpy()
    assert len(out_t) > 100
    assert abs(len(out_t) - len(out_j)) <= 1e-3 * len(out_j)
    # rows keyed by voxel (an averaged point lies inside its voxel)
    kj, kt = ({tuple(np.floor(p / RES).astype(int)): r
               for p, r in zip(o[:, :3], o)} for o in (out_j, out_t))
    common = set(kj) & set(kt)
    assert len(common) >= 0.999 * len(set(kj) | set(kt))
    for k in common:
        np.testing.assert_allclose(kt[k], kj[k], rtol=1e-5, atol=1e-4)


# ---- the cases of tests/test_mrvm.py, through the port ----

def _scan(points, capacity=2048):
    return tcloud.from_numpy(np.asarray(points, dtype=np.float32),
                             capacity=capacity, device=CPU)


def test_static_surface_survives():
    rng = np.random.default_rng(0)
    m = tmrvm.MultiResolutionVoxelMap(tmrvm.MrvmSettings(max_ray_steps=64))
    wall = np.column_stack([np.full(300, 10.0), rng.uniform(-3, 3, 300),
                            rng.uniform(0, 2, 300)])
    for _ in range(4):
        m.insert_point_cloud(_scan(wall + rng.normal(0, 0.01, wall.shape)),
                             origin=np.array([0.0, 0, 1.0]))
    out = m.output_to_numpy()
    assert out.shape[0] > 50
    assert np.all(np.abs(out[:, 0] - 10.0) < 0.5)


def test_dynamic_object_removed():
    rng = np.random.default_rng(1)
    m = tmrvm.MultiResolutionVoxelMap(tmrvm.MrvmSettings(max_ray_steps=256))
    wall = np.column_stack([np.full(1500, 12.0), rng.uniform(-3, 3, 1500),
                            rng.uniform(-1.5, 3, 1500)])
    car = np.column_stack([np.full(150, 5.0), rng.uniform(-1, 1, 150),
                           rng.uniform(0, 1, 150)])
    m.insert_point_cloud(_scan(np.vstack([wall, car])),
                         origin=np.array([0.0, 0, 1.0]))
    for _ in range(5):
        m.insert_point_cloud(_scan(wall + rng.normal(0, 0.01, wall.shape)),
                             origin=np.array([0.0, 0, 1.0]))
    out = m.output_to_numpy()
    assert out.shape[0] > 50
    near_car = np.abs(out[:, 0] - 5.0) < 0.5
    keys, hits, _, _, _, _, _ = m._export()
    initially_occupied = (hits[np.abs(keys[:, 0] * 0.1 - 5.0) < 0.5] > 0).sum()
    assert near_car.sum() < 0.05 * initially_occupied
    assert (np.abs(out[:, 0] - 12.0) < 0.5).sum() > 50


def test_output_average_positions():
    m = tmrvm.MultiResolutionVoxelMap(tmrvm.MrvmSettings(
        output_average=True, max_ray_steps=32))
    pts = np.array([[5.02, 0.03, 0.51], [5.04, 0.01, 0.52]])
    for _ in range(3):
        m.insert_point_cloud(_scan(pts), origin=np.array([0.0, 0, 0.5]))
    out = m.output_to_numpy(threshold=0.5)
    assert out.shape[0] >= 1
    d = np.linalg.norm(out[:, :3] - np.array([5.03, 0.02, 0.515]), axis=1)
    assert d.min() < 0.02


def test_intensity_max():
    m = tmrvm.MultiResolutionVoxelMap(tmrvm.MrvmSettings(max_ray_steps=32))
    pc = _scan(np.array([[3.0, 0, 0, 10.0], [3.01, 0, 0, 99.0]]), capacity=64)
    for _ in range(3):
        m.insert_point_cloud(pc, origin=np.array([0.0, 0, 0]))
    out = m.output_to_numpy(threshold=0.5)
    assert out.shape[0] >= 1
    assert np.max(out[:, 3]) == 99.0


def test_empty_map():
    m = tmrvm.MultiResolutionVoxelMap()
    assert m.output_to_numpy().shape == (0, 4)
    assert m.num_voxels == 0


def test_submap_inner_mrvm_removes_transient():
    """enable_inner_mrvm: a blob present in only one frame and crossed by
    the other frame's rays is attenuated in the submap cloud; the port's
    submap cloud matches the JAX package's in size."""
    from staticmapping_tpu.builder import frame as jframe
    from staticmapping_torch.builder import frame as tframe
    rng = np.random.default_rng(0)
    n_w = 2000
    wall = np.column_stack([np.full(n_w, 10.0) + rng.normal(0, 0.01, n_w),
                            rng.uniform(-4, 4, n_w),
                            rng.uniform(-1, 2, n_w)]).astype(np.float32)
    n_b = 400
    blob = np.column_stack([np.full(n_b, 5.0) + rng.normal(0, 0.05, n_b),
                            rng.uniform(-1, 1, n_b),
                            rng.uniform(-0.5, 0.5, n_b)]).astype(np.float32)
    s = tframe.Submap(0, tframe.SubmapOptions(frame_count=2,
                                              enable_inner_mrvm=True),
                      capacity=8192, device=CPU)
    sj = jframe.Submap(0, jframe.SubmapOptions(frame_count=2,
                                               enable_inner_mrvm=True),
                       capacity=8192)
    for k, pts in enumerate((np.vstack([wall, blob]), wall)):
        s.insert_frame(tframe.Frame(stamp=0.1 * k, cloud=tcloud.from_numpy(
            pts, capacity=4096, device=CPU), global_pose=np.eye(4)))
        sj.insert_frame(jframe.Frame(stamp=0.1 * k, cloud=jcloud.from_numpy(
            pts, capacity=4096), global_pose=np.eye(4)))
    out = tcloud.to_numpy(s.cloud)
    near_blob = (np.abs(out[:, 0] - 5.0) < 0.5).sum()
    near_wall = (np.abs(out[:, 0] - 10.0) < 0.5).sum()
    assert near_wall > 100
    assert near_blob < 0.3 * near_wall
    n_j = len(jcloud.to_numpy(sj.cloud))
    assert abs(len(out) - n_j) <= 0.01 * n_j


def test_native_store_matches_numpy_store():
    """The C++ hash map and the numpy store merge the same per-scan
    aggregates, with the per-cell cap straddled, into the same table."""
    rng = np.random.default_rng(3)
    native, plain = tstore.make_store(), tstore.make_store(False)
    assert isinstance(native, tstore._NativeStore)
    assert isinstance(plain, tstore._NumpyStore)
    for _ in range(4):
        n = 3000
        keys = rng.integers(-40, 40, (n, 3)).astype(np.int32)
        keys = np.unique(keys, axis=0)
        n = len(keys)
        hits = rng.integers(0, 6, n).astype(np.float32)
        misses = rng.integers(0, 4, n).astype(np.float32)
        sxyz = (rng.normal(size=(n, 3)) * hits[:, None]).astype(np.float32)
        mint = np.where(hits > 0, rng.uniform(0, 99, n), -1.0) \
            .astype(np.float32)
        sint = (rng.uniform(0, 50, n) * hits).astype(np.float32)
        for st in (native, plain):
            st.merge(keys, hits, misses, sxyz, mint, sint, cap=7.0)
    assert native.size == plain.size
    a, b = native.export(), plain.export()
    order_a = np.lexsort(a[0].T[::-1])
    order_b = np.lexsort(b[0].T[::-1])
    for xa, xb in zip(a, b):
        np.testing.assert_allclose(xa[order_a], xb[order_b], rtol=1e-9,
                                   atol=1e-9)
