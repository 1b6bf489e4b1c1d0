"""Parity of the port's NDT (staticmapping_torch.registration.ndt and the
voxel Gaussians of ops/voxel.py) with the JAX package on the CPU: the
voxel statistics, the Gaussian field, ``align_ndt`` on one field carried
across by ``interop.ndt_map``, and the three cases of tests/test_ndt.py
through both packages."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from staticmapping_tpu.common import np_se3
from staticmapping_tpu.data import cloud as jcloud
from staticmapping_tpu.ops import voxel as jvoxel
from staticmapping_tpu.registration import ndt as jndt
from staticmapping_torch import interop
from staticmapping_torch.ops import voxel as tvoxel
from staticmapping_torch.registration import ndt as tndt

CPU = "cpu"


def make_structured_cloud(n=4096, seed=0):
    """tests/test_ndt.py's scene: floor + two walls + sloped roof, full
    6-DoF constraint, within 11 m of the origin."""
    rng = np.random.default_rng(seed)
    per = n // 4
    floor = np.column_stack([rng.uniform(-10, 10, per),
                             rng.uniform(-10, 10, per),
                             0.02 * rng.standard_normal(per)])
    w1 = np.column_stack([np.full(per, 5.0) + 0.02 * rng.standard_normal(per),
                          rng.uniform(-10, 10, per),
                          rng.uniform(0, 4, per)])
    w2 = np.column_stack([rng.uniform(-10, 10, per),
                          np.full(per, -4.0) + 0.02 * rng.standard_normal(per),
                          rng.uniform(0, 4, per)])
    x = rng.uniform(-10, 10, per)
    roof = np.column_stack([x, rng.uniform(-10, 10, per),
                            4.0 + 0.15 * x + 0.02 * rng.standard_normal(per)])
    return np.vstack([floor, w1, w2, roof]).astype(np.float32)


TRUE_T = np_se3.from_rt(np_se3.euler_to_matrix(np.array([0.0, 0.0, 0.03])),
                        np.array([0.3, -0.2, 0.05]))


def _moved(pts, T=TRUE_T):
    """``inverse(T)``·pts: aligning them onto ``pts`` recovers ``T``."""
    return ((pts - T[:3, 3].astype(np.float32))
            @ T[:3, :3].astype(np.float32))


def _pair(pts, capacity=4096):
    jc = jcloud.from_numpy(pts, capacity=capacity)
    return jc, interop.point_cloud(jc, CPU)


def _pose_err(T, want):
    """(translation m, rotation rad) of ``T·want⁻¹``."""
    E = np.asarray(T, dtype=np.float64) @ np_se3.inverse(
        np.asarray(want, dtype=np.float64))
    ang = np.arccos(np.clip((np.trace(E[:3, :3]) - 1.0) / 2.0, -1.0, 1.0))
    return float(np.linalg.norm(E[:3, 3])), float(ang)


@pytest.mark.parametrize("mode,origin", [("round", None),
                                         ("floor", (-10.5, -10.2, -0.3))])
def test_voxel_stats_match_jax(mode, origin):
    """Counts, keys and validity match exactly (integer keys, f32 counts of
    whole points).  Means match to f32 rounding, 1e-5 m within 11 m of the
    origin; the raw-moment covariance to 1e-5 m² there (away from the
    origin its f32 cancellation error grows with the coordinates²)."""
    rng = np.random.default_rng(1)
    pts = make_structured_cloud(seed=1)[:3000]
    pts = pts[rng.permutation(len(pts))]
    jc, tc = _pair(pts)
    if origin is None:
        want = jvoxel.voxel_stats(jc, 1.0, mode=mode)
        got = tvoxel.voxel_stats(tc, 1.0, mode=mode)
    else:
        want = jvoxel.voxel_stats_floor(jc, 1.0, jnp.asarray(origin,
                                                              jnp.float32))
        got = tvoxel.voxel_stats_floor(tc, 1.0, torch.tensor(origin))
    for k in ("count", "valid", "voxel_key"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    valid = np.asarray(want["valid"])
    assert valid.sum() > 100
    np.testing.assert_allclose(got["mean"].numpy()[valid],
                               np.asarray(want["mean"])[valid], atol=1e-5)
    np.testing.assert_allclose(got["cov"].numpy()[valid],
                               np.asarray(want["cov"])[valid], atol=1e-5)


def test_build_ndt_map_matches_jax():
    """The sorted keys and validity match exactly.  On the scene shrunk to
    within 5 m of the origin the valid voxels' means match to 1e-5 m and
    their regularized inverse covariances to 2e-3 of each inverse's
    largest entry (6e-4 measured): the raw second moment's f32 rounding,
    summed in another order, grows with the coordinates², and a 2 cm thin
    voxel's inverse amplifies it by its condition number (at 10 m the gap
    reaches 9e-3)."""
    jc, tc = _pair(0.5 * make_structured_cloud())
    want = jndt.build_ndt_map(jc, 1.0)
    got = tndt.build_ndt_map(tc, 1.0)
    np.testing.assert_array_equal(got.key.numpy(), np.asarray(want.key))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_array_equal(got.origin.numpy(), np.asarray(want.origin))
    valid = np.asarray(want.valid)
    assert valid.sum() > 50
    np.testing.assert_allclose(got.mean.numpy()[valid],
                               np.asarray(want.mean)[valid], atol=1e-5)
    inv_w = np.asarray(want.inv_cov)[valid]
    scale = np.abs(inv_w).max(axis=(1, 2), keepdims=True)
    np.testing.assert_allclose(got.inv_cov.numpy()[valid] / scale,
                               inv_w / scale, atol=2e-3)


@pytest.mark.parametrize("direct7", [True, False])
def test_align_ndt_on_one_field_matches_jax(direct7):
    """Both packages align the moved cloud on the JAX package's field,
    carried across by ``interop.ndt_map``: T to 1e-3 m / 1e-3 rad, the
    score to 1e-4."""
    pts = make_structured_cloud(seed=3)
    jt, _ = _pair(pts)
    js, ts = _pair(_moved(pts))
    field = jndt.build_ndt_map(jt, 1.0)
    guess = np_se3.from_rt(np.eye(3), np.array([0.05, 0.0, 0.0]))
    T_j, s_j = jndt.align_ndt(js, field, jnp.asarray(guess, jnp.float32),
                              direct7=direct7)
    T_t, s_t = tndt.align_ndt(ts, interop.ndt_map(field, CPU),
                              torch.tensor(guess, dtype=torch.float32),
                              direct7=direct7)
    dt, dr = _pose_err(T_t.numpy(), np.asarray(T_j))
    assert dt < 1e-3 and dr < 1e-3, (dt, dr)
    assert abs(float(s_t) - float(s_j)) < 1e-4


def test_frozen_trips_keep_the_best_pose():
    """Checking ``converged`` every trip or only after the trip budget
    gives the same pose and score: a converged state passes through the
    frozen body unchanged, its best-seen pose too."""
    pts = make_structured_cloud(seed=4)
    _, tt = _pair(pts)
    _, ts = _pair(_moved(pts))
    field = tndt.build_ndt_map(tt, 1.0)
    eye = torch.eye(4)
    every = tndt.align_ndt(ts, field, eye, check_every=1)
    once = tndt.align_ndt(ts, field, eye, check_every=35)
    torch.testing.assert_close(every[0], once[0], rtol=0, atol=0)
    torch.testing.assert_close(every[1], once[1], rtol=0, atol=0)


def test_build_ndt_map_runs_in_both():
    """tests/test_ndt.py::test_build_ndt_map_runs through both packages."""
    for pkg_cloud, pkg_ndt in ((jcloud, jndt), (None, tndt)):
        pts = make_structured_cloud()
        jc = jcloud.from_numpy(pts, capacity=4096)
        c = jc if pkg_cloud else interop.point_cloud(jc, CPU)
        m = pkg_ndt.build_ndt_map(c, 1.0)
        valid = np.asarray(m.valid)
        assert valid.sum() > 50
        means = np.asarray(m.mean)[valid]
        assert means[:, 0].min() > -11 and means[:, 0].max() < 11
        keys = np.asarray(m.key).astype(np.int64)
        assert (np.diff(keys) >= 0).all()


@pytest.mark.parametrize("case", ["recovers_transform", "identity_noop"])
def test_ndt_cases_in_both(case):
    """tests/test_ndt.py's transform recovery (through the ``Ndt`` class)
    and identity cases, through both packages under that file's bounds."""
    seed = 0 if case == "recovers_transform" else 2
    pts = make_structured_cloud(seed=seed)
    src = _moved(pts) if case == "recovers_transform" else pts
    want = TRUE_T if case == "recovers_transform" else np.eye(4)
    jt, tt = _pair(pts)
    js, ts = _pair(src)
    results = {}
    for name, matcher, t, s, eye in (
            ("jax", jndt.Ndt(resolution=1.0), jt, js,
             jnp.eye(4, dtype=jnp.float32)),
            ("torch", tndt.Ndt(resolution=1.0), tt, ts, torch.eye(4))):
        matcher.set_input_target(t)
        matcher.set_input_source(s)
        T, score = matcher.align(eye)
        err = np.asarray(T, dtype=np.float64) @ np_se3.inverse(want) \
            - np.eye(4)
        tol, floor = (3e-2, 0.4) if case == "recovers_transform" \
            else (1e-2, 0.5)
        assert np.abs(err[:3, :]).max() < tol, (name, np.asarray(T))
        assert float(score) > floor, name
        results[name] = np.asarray(T)
    dt, dr = _pose_err(results["torch"], results["jax"])
    assert dt < 1e-3 and dr < 1e-3, (dt, dr)


def test_ndt_class_needs_both_clouds():
    with pytest.raises(ValueError, match="source and the target"):
        tndt.Ndt().align(torch.eye(4))
