"""Parity of the PyTorch port's SE(3) math, point-cloud ops and state
carry-over (staticmapping_torch.common.se3, .data.cloud, .interop) with the
JAX package, on the CPU."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from staticmapping_tpu.builder import pipeline as jpipe
from staticmapping_tpu.common import se3 as jse3
from staticmapping_tpu.data import cloud as jcloud
from staticmapping_torch import interop
from staticmapping_torch.common import se3 as tse3
from staticmapping_torch.data import cloud as tcloud

CPU = "cpu"


def _poses(rng, n):
    eul = rng.uniform(-np.pi, np.pi, (n, 3)).astype(np.float32)
    t = rng.uniform(-20, 20, (n, 3)).astype(np.float32)
    R = np.asarray(jse3.euler_to_matrix(jnp.asarray(eul)))
    return np.array(jse3.from_rt(jnp.asarray(R), jnp.asarray(t)))


def _quats(rng, n):
    q = rng.normal(size=(n, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return q


def _inputs(name, rng):
    """Inputs (numpy, float32) for one se3 function."""
    T = _poses(rng, 6)
    if name in ("inverse", "rotation", "translation", "normalize_rotation"):
        return (T,)
    if name == "from_rt":
        return (T[:, :3, :3], T[:, :3, 3])
    if name == "apply":
        return (T[:2], rng.uniform(-30, 30, (2, 50, 3)).astype(np.float32))
    if name in ("quat_to_matrix", "quat_normalize"):
        return (_quats(rng, 8) * 1.7,)
    if name == "matrix_to_quat":
        return (T[:, :3, :3],)
    if name in ("quat_mul", "quat_angular_distance"):
        return (_quats(rng, 8), _quats(rng, 8))
    if name == "quat_rotate":
        return (_quats(rng, 8), rng.normal(size=(8, 3)).astype(np.float32))
    if name == "slerp":
        t = rng.uniform(0, 1, (8, 1)).astype(np.float32)
        return (_quats(rng, 8), _quats(rng, 8), t)
    if name == "axis_angle_to_matrix":
        w = rng.normal(size=(8, 3)).astype(np.float32)
        w[:3] *= 1e-3                       # the small-angle series branch
        return (w,)
    if name in ("euler_to_matrix", "euler_to_quat"):
        return (rng.uniform(-np.pi, np.pi, (8, 3)).astype(np.float32),)
    if name == "matrix_to_euler":
        R = T[:, :3, :3].copy()
        R[0] = np.array([[0, 0, 1], [0, 1, 0], [-1, 0, 0]])  # singular
        return (R,)
    if name == "average_transforms":
        return (T[:3],)
    if name in ("quat_conj", "quat_to_euler"):
        return (_quats(rng, 8),)
    if name == "compose":
        return (T[:2], T[2:4], T[4:6])
    if name == "transform_to_vector6":
        return (T,)
    if name == "vector6_to_transform":
        return (np.concatenate(
            [rng.uniform(-20, 20, (8, 3)),
             rng.uniform(-np.pi, np.pi, (8, 3))], axis=1).astype(np.float32),)
    if name == "interpolate":
        return (T[:3], T[3:6], rng.uniform(0, 1, 3).astype(np.float32))
    raise KeyError(name)


SE3_FUNCTIONS = [
    "from_rt", "inverse", "apply", "rotation", "translation",
    "quat_normalize", "quat_mul", "quat_rotate", "quat_to_matrix",
    "matrix_to_quat", "slerp", "quat_angular_distance",
    "axis_angle_to_matrix", "euler_to_quat", "euler_to_matrix",
    "matrix_to_euler", "average_transforms", "normalize_rotation",
    "quat_conj", "quat_to_euler", "compose", "transform_to_vector6",
    "vector6_to_transform", "interpolate",
]


@pytest.mark.parametrize("name", SE3_FUNCTIONS)
def test_se3_matches_jax(name):
    rng = np.random.default_rng(SE3_FUNCTIONS.index(name))
    args = _inputs(name, rng)
    want = np.asarray(getattr(jse3, name)(*map(jnp.asarray, args)))
    got = getattr(tse3, name)(*map(torch.from_numpy, args)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_identity_matches_jax():
    np.testing.assert_array_equal(tse3.identity().numpy(),
                                  np.asarray(jse3.identity()))
    assert tse3.identity(torch.float64).dtype == torch.float64


def _rand_quat(rng):
    q = rng.normal(size=4).astype(np.float32)
    return q / np.linalg.norm(q)


@pytest.mark.parametrize("factor", [0.0, 1.0])
def test_interpolate_endpoints_match_jax(factor):
    """tests/test_se3.py::test_interpolate_endpoints through both
    packages."""
    rng = np.random.default_rng(4)
    qa, qb = _rand_quat(rng), _rand_quat(rng)
    Ta, Tb = (np.array(jse3.from_rt(jse3.quat_to_matrix(jnp.asarray(q)),
                                      jnp.asarray(t, jnp.float32)))
              for q, t in ((qa, [0.0, 0, 0]), (qb, [1.0, 2, 3])))
    want = np.asarray(jse3.interpolate(jnp.asarray(Ta), jnp.asarray(Tb),
                                       factor))
    got = tse3.interpolate(torch.from_numpy(Ta), torch.from_numpy(Tb),
                           factor).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)
    np.testing.assert_allclose(got, Ta if factor == 0.0 else Tb, atol=1e-5)


def test_interpolate_half_translation_matches_jax():
    """tests/test_se3.py::test_interpolate_half_translation through both
    packages."""
    Tb = np.array(jse3.from_rt(jnp.eye(3), jnp.array([2.0, 0.0, 0.0])))
    want = jse3.interpolate(jse3.identity(), jnp.asarray(Tb), 0.5)
    got = tse3.interpolate(tse3.identity(), torch.from_numpy(Tb), 0.5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    np.testing.assert_allclose(tse3.translation(got).numpy(),
                               [1.0, 0.0, 0.0], atol=1e-6)


def test_vector6_roundtrip_matches_jax():
    """tests/test_se3.py::test_vector6_roundtrip through both packages."""
    rng = np.random.default_rng(7)
    v = np.concatenate([rng.normal(size=3),
                        rng.uniform(-1, 1, size=3)]).astype(np.float32)
    T_j = jse3.vector6_to_transform(jnp.asarray(v))
    T_t = tse3.vector6_to_transform(torch.from_numpy(v))
    np.testing.assert_allclose(T_t.numpy(), np.asarray(T_j), atol=1e-6)
    v_t = tse3.transform_to_vector6(T_t).numpy()
    np.testing.assert_allclose(v_t, np.asarray(jse3.transform_to_vector6(T_j)),
                               atol=1e-6)
    np.testing.assert_allclose(v_t, v, atol=1e-5)


def test_cloud_helpers_match_jax():
    """``centroid`` (tests/test_cloud.py::test_centroid_ignores_padding),
    ``masked_xyz`` of both cloud types, ``NormalCloud.transform`` and
    ``empty`` through both packages."""
    pts = np.array([[1.0, 0, 0], [3.0, 0, 0]])
    pc_t = tcloud.from_numpy(pts, capacity=16, device=CPU)
    pc_j = jcloud.from_numpy(pts, capacity=16)
    np.testing.assert_array_equal(pc_t.centroid().numpy(),
                                  np.asarray(pc_j.centroid()))
    np.testing.assert_allclose(pc_t.centroid().numpy(), [2.0, 0, 0],
                               atol=1e-5)
    rng = np.random.default_rng(5)
    a = _cloud_arrays(rng, (2, 300))
    pc_t = interop.point_cloud(a, CPU)
    pc_j = jcloud.PointCloud(**{k: jnp.asarray(v) for k, v in a.items()})
    # 180 coordinates of up to 30 m summed in another order: f32 rounding
    np.testing.assert_allclose(pc_t.centroid().numpy(),
                               np.asarray(pc_j.centroid()), atol=1e-5)
    for fill in (tcloud.PAD_COORD, -7.5):
        np.testing.assert_array_equal(pc_t.masked_xyz(fill).numpy(),
                                      np.asarray(pc_j.masked_xyz(fill)))
    nc_j = jcloud.NormalCloud(xyz=jnp.asarray(a["xyz"][0, :128]),
                              normals=jnp.asarray(a["xyz"][1, :128] / 30.0),
                              mask=jnp.asarray(a["mask"][0, :128]))
    nc_t = interop.normal_cloud(nc_j, CPU)
    np.testing.assert_array_equal(nc_t.masked_xyz().numpy(),
                                  np.asarray(nc_j.masked_xyz()))
    T = _poses(rng, 1)[0]
    got, want = nc_t.transform(torch.from_numpy(T)), nc_j.transform(
        jnp.asarray(T))
    np.testing.assert_allclose(got.xyz.numpy(), np.asarray(want.xyz),
                               atol=1e-4)
    np.testing.assert_allclose(got.normals.numpy(), np.asarray(want.normals),
                               atol=1e-6)
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
    for k, v in interop.to_numpy(tcloud.empty(256, device=CPU)).items():
        np.testing.assert_array_equal(v, np.asarray(getattr(
            jcloud.empty(256), k)))


def test_empty_cloud_has_no_normals():
    """tests/test_normals.py::test_empty_cloud through both packages."""
    from staticmapping_torch.ops.normals import estimate_normals
    from staticmapping_tpu.ops.normals import estimate_normals as j_normals
    nc_t = estimate_normals(tcloud.empty(256, device=CPU), leaf_size=8)
    nc_j = j_normals(jcloud.empty(256), leaf_size=8)
    assert int(nc_t.num_valid()) == int(nc_j.num_valid()) == 0


def test_frame_transform_cloud_to_global_matches_jax():
    from staticmapping_torch.builder.frame import Frame as TFrame
    from staticmapping_tpu.builder.frame import Frame as JFrame
    rng = np.random.default_rng(6)
    a = _cloud_arrays(rng, (400,))
    pose = _poses(rng, 1)[0].astype(np.float64)
    jf = JFrame(stamp=0.5, cloud=jcloud.PointCloud(
        **{k: jnp.asarray(v) for k, v in a.items()}), global_pose=pose)
    tf = TFrame(stamp=0.5, cloud=interop.point_cloud(a, CPU),
                global_pose=pose)
    assert tf.descriptor is None and jf.descriptor is None
    got, want = tf.transform_cloud_to_global(), jf.transform_cloud_to_global()
    np.testing.assert_allclose(got.xyz.numpy(), np.asarray(want.xyz),
                               atol=1e-4)
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))


def _cloud_arrays(rng, shape, n_valid_frac=0.6):
    cap = shape[-1]
    return {
        "xyz": rng.uniform(-30, 30, shape + (3,)).astype(np.float32),
        "intensity": rng.uniform(0, 1, shape).astype(np.float32),
        "factor": np.broadcast_to(np.arange(cap, dtype=np.float32) / cap,
                                  shape).copy(),
        "mask": rng.uniform(0, 1, shape) < n_valid_frac,
    }


@pytest.mark.parametrize("shape", [(1000,), (3, 512)])
def test_compact_exact(shape):
    rng = np.random.default_rng(1)
    a = _cloud_arrays(rng, shape)
    got = interop.to_numpy(interop.point_cloud(a, CPU).compact())
    jc = jcloud.PointCloud(**{k: jnp.asarray(v) for k, v in a.items()})
    rows = [jc] if len(shape) == 1 else [
        jcloud.PointCloud(**{k: jnp.asarray(v[b]) for k, v in a.items()})
        for b in range(shape[0])]
    want = [interop.to_numpy(interop.point_cloud(r.compact(), CPU))
            for r in rows]
    for k in got:
        ref = want[0][k] if len(shape) == 1 else np.stack([w[k]
                                                           for w in want])
        np.testing.assert_array_equal(got[k], ref)


def test_motion_compensate_matches_jax():
    rng = np.random.default_rng(2)
    a = _cloud_arrays(rng, (800,))
    # one scan's motion: a few degrees and decimetres
    eul = rng.uniform(-0.05, 0.05, 3).astype(np.float32)
    T = np.array(jse3.from_rt(jse3.euler_to_matrix(jnp.asarray(eul)),
                              jnp.asarray([0.8, -0.3, 0.05], jnp.float32)))
    want = jcloud.PointCloud(**{k: jnp.asarray(v) for k, v in a.items()}
                             ).motion_compensate(jnp.asarray(T))
    got = interop.point_cloud(a, CPU).motion_compensate(torch.from_numpy(T))
    np.testing.assert_allclose(got.xyz.numpy(), np.asarray(want.xyz),
                               atol=1e-5)


def test_from_numpy_and_concat_match_jax():
    rng = np.random.default_rng(3)
    pts = rng.uniform(-10, 10, (300, 4)).astype(np.float32)
    a_t = tcloud.from_numpy(pts, capacity=512, device=CPU)
    a_j = jcloud.from_numpy(pts, capacity=512)
    for k, v in interop.to_numpy(a_t).items():
        np.testing.assert_array_equal(v, np.asarray(getattr(a_j, k)))
    b = rng.uniform(-10, 10, (200, 3)).astype(np.float32)
    got = tcloud.concat(a_t, tcloud.from_numpy(b, capacity=256, device=CPU),
                        capacity=640)
    want = jcloud.concat(a_j, jcloud.from_numpy(b, capacity=256),
                         capacity=640)
    np.testing.assert_array_equal(tcloud.to_numpy(got),
                                  jcloud.to_numpy(want))


def test_interop_round_trip_exact():
    rng = np.random.default_rng(4)
    a = _cloud_arrays(rng, (256,))
    jpc = jcloud.PointCloud(**{k: jnp.asarray(v) for k, v in a.items()})
    for k, v in interop.to_numpy(interop.point_cloud(jpc, CPU)).items():
        np.testing.assert_array_equal(v, a[k])
    jnc = jcloud.NormalCloud(xyz=jnp.asarray(a["xyz"][:64]),
                             normals=jnp.asarray(a["xyz"][64:128]),
                             mask=jnp.asarray(a["mask"][:64]))
    T = _poses(rng, 2)
    jstate = jpipe._FeState(
        target=jnc, pose_target=jnp.asarray(T[0]),
        prev_pose=jnp.asarray(T[1]), prev_stamp=jnp.float32(1.25),
        vel_lin=jnp.asarray([1.0, 2.0, 3.0], dtype=jnp.float32),
        vel_ang=jnp.asarray([0.1, 0.2, 0.3], dtype=jnp.float32),
        has_velocity=jnp.asarray(True))
    got = interop.to_numpy(interop.fe_state(jstate, CPU))
    for k in ("pose_target", "prev_pose", "prev_stamp", "vel_lin", "vel_ang",
              "has_velocity"):
        want = np.asarray(getattr(jstate, k))
        assert got[k].dtype == want.dtype, k
        np.testing.assert_array_equal(got[k], want)
    for k in ("xyz", "normals", "mask"):
        np.testing.assert_array_equal(got["target"][k],
                                      np.asarray(getattr(jnc, k)))
