"""Parity of the port's matcher types 1, 3 and 5 (staticmapping_torch.
registration: the factory, NdtWithGicp, IcpFast's in-loop compensation and
exact trim) and of the front ends that run them with the JAX package, on
the CPU: the factory cases of tests/test_registrators.py, the chained and
ICP matchers on one pair, one step of the sequential front end a type, and
one chunk of the chunked front end for types 5 and 3, step by step from one
state carried across.  The whole-sequence runs of tests/test_matcher_e2e.py
are tests/test_torch_matcher_e2e_*.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from staticmapping_tpu.builder import frontend as jfrontend
from staticmapping_tpu.builder import pipeline as jpipe
from staticmapping_tpu.common import np_se3
from staticmapping_tpu.data import cloud as jcloud
from staticmapping_tpu.io import synthetic
from staticmapping_tpu.ops import normals as jnormals
from staticmapping_tpu import registration as jreg
from staticmapping_torch import interop
from staticmapping_torch import registration as treg
from staticmapping_torch.builder import frontend as tfrontend
from staticmapping_torch.builder import map_builder as tmb
from staticmapping_torch.builder import pipeline as tpipe
from staticmapping_torch.data import cloud as tcloud
from staticmapping_torch.registration import icp_fast as ticp

CPU = "cpu"


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Chains of small ops beside a few 1-NN passes: a wide CPU pool
    shared with other test processes only slows them down."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def make_scene(n=4096, seed=0):
    """tests/test_registrators.py's scene: floor, two walls, sloped roof."""
    rng = np.random.default_rng(seed)
    per = n // 4
    floor = np.column_stack([rng.uniform(-10, 10, per),
                             rng.uniform(-10, 10, per),
                             0.02 * rng.standard_normal(per)])
    w1 = np.column_stack([np.full(per, 5.0) + 0.02 * rng.standard_normal(per),
                          rng.uniform(-10, 10, per), rng.uniform(0, 4, per)])
    w2 = np.column_stack([rng.uniform(-10, 10, per),
                          np.full(per, -4.0) + 0.02 * rng.standard_normal(per),
                          rng.uniform(0, 4, per)])
    x = rng.uniform(-10, 10, per)
    roof = np.column_stack([x, rng.uniform(-10, 10, per),
                            4.0 + 0.15 * x + 0.02 * rng.standard_normal(per)])
    return np.vstack([floor, w1, w2, roof]).astype(np.float32)


TRUE_T = np_se3.from_rt(np_se3.euler_to_matrix(np.array([0.0, 0.01, 0.03])),
                        np.array([0.25, -0.15, 0.05]))


def shifted_pair(seed=0):
    """``(source, target)`` of both packages: aligning the source onto the
    target recovers TRUE_T."""
    pts = make_scene(seed=seed)
    src = ((pts - TRUE_T[:3, 3].astype(np.float32))
           @ TRUE_T[:3, :3].astype(np.float32))
    js = jcloud.from_numpy(src, capacity=4096)
    jt = jcloud.from_numpy(pts, capacity=4096)
    return ((js, jt), (interop.point_cloud(js, CPU),
                       interop.point_cloud(jt, CPU)))


def _pose_err(T, want):
    """(translation m, rotation rad) of ``T·want⁻¹``."""
    E = np.asarray(T, dtype=np.float64) @ np_se3.inverse(
        np.asarray(want, dtype=np.float64))
    ang = np.arccos(np.clip((np.trace(E[:3, :3]) - 1.0) / 2.0, -1.0, 1.0))
    return float(np.linalg.norm(E[:3, 3])), float(ang)


def _public(m):
    """A matcher's option values (its dataclass fields, not its state)."""
    return {k: v for k, v in vars(m).items() if not k.startswith("_")
            and k != "final_score"}


@pytest.mark.parametrize("key", [1, 3, 5, 6, "icp_fast", "fast_icp", "ndt",
                                 "ndt_gicp", "icp_pm"])
def test_factory_types_match_jax(key):
    """tests/test_registrators.py::test_factory_types: every type id and
    name gives the same class with the same option values."""
    j, t = jreg.create_matcher(key), treg.create_matcher(key)
    assert type(t).__name__ == type(j).__name__
    assert t.TYPE == j.TYPE
    assert _public(t) == _public(j)


@pytest.mark.parametrize("key,options", [
    (2, None), (4, None), (99, None), ("libicp", None),
    (6, {"no_such_option": 1})])
def test_factory_rejects_what_jax_rejects(key, options):
    """Deprecated types 2 (libicp) and 4 (lego-loam), unknown types and
    names, and unknown options raise ValueError in both packages."""
    with pytest.raises(ValueError):
        jreg.create_matcher(key, options)
    with pytest.raises(ValueError):
        treg.create_matcher(key, options)


def test_factory_applies_options():
    """tests/test_registrators.py::test_factory_applies_options, and the
    chained matcher rebuilds its stages from its options."""
    m = treg.create_matcher(6, {"max_iteration": 42,
                                "dist_outlier_ratio": 0.8})
    assert m.max_iteration == 42 and m.dist_outlier_ratio == 0.8
    assert treg.create_matcher(5, {"resolution": 2.0}).resolution == 2.0
    c = treg.create_matcher(3, {"max_iteration": 12, "ndt_resolution": 2.0})
    assert c._ndt.max_iteration == 12 and c._gicp.max_iteration == 12
    assert c._ndt.resolution == 2.0


@pytest.mark.parametrize("name,seed,kw", [
    ("NdtWithGicp", 3, {"voxel_resolution": 0.3}),
    ("IcpPointMatcher", 5, {})])
def test_matcher_recovers_transform_in_both(name, seed, kw):
    """tests/test_registrators.py's chained-matcher and IcpPM cases through
    both packages under that file's 5e-2 bound; the two results agree to
    1e-3 m / 1e-3 rad and their scores to 1e-3."""
    (js, jt), (ts, tt) = shifted_pair(seed)
    out = {}
    for pkg, s, t, eye in (("jax", js, jt, jnp.eye(4, dtype=jnp.float32)),
                           ("torch", ts, tt, torch.eye(4))):
        m = getattr(jreg if pkg == "jax" else treg, name)(**kw)
        m.set_input_target(t)
        m.set_input_source(s)
        T, score = m.align(eye)
        err = np.asarray(T, dtype=np.float64) @ np_se3.inverse(TRUE_T) \
            - np.eye(4)
        assert np.abs(err[:3, :]).max() < 5e-2, (pkg, np.asarray(T))
        assert float(score) > 0.3, pkg
        out[pkg] = (np.asarray(T), float(score))
    dt, dr = _pose_err(out["torch"][0], out["jax"][0])
    assert dt < 1e-3 and dr < 1e-3, (dt, dr)
    assert abs(out["torch"][1] - out["jax"][1]) < 1e-3


def test_ndt_with_gicp_keeps_the_guess_when_ndt_fails():
    """An NDT score under ``ndt_min_score`` returns the caller's guess
    with score 0 (ndt_gicp.cc:106-109), in both packages."""
    (js, jt), (ts, tt) = shifted_pair(1)
    guess = np_se3.from_rt(np.eye(3), np.array([0.1, 0.0, 0.0]))
    for pkg, s, t, g in (("jax", js, jt, jnp.asarray(guess, jnp.float32)),
                         ("torch", ts, tt, torch.tensor(guess,
                                                        dtype=torch.float32))):
        m = getattr(jreg if pkg == "jax" else treg, "NdtWithGicp")(
            ndt_min_score=1.1)
        m.set_input_target(t)
        m.set_input_source(s)
        T, score = m.align(g)
        np.testing.assert_allclose(np.asarray(T), guess, atol=1e-7)
        assert float(score) == 0.0 and m.final_score == 0.0


@pytest.mark.parametrize("compensation,exact", [(True, False),
                                                (False, True), (True, True)])
def test_icp_fast_options_match_jax(compensation, exact):
    """``IcpFast`` with ``inner_compensation`` (each point moved by its
    ``factor`` share of the iterate) and ``exact_quantile`` (the sorted
    trim) through both packages on one target normal cloud carried
    across: T to 1e-3 m / 1e-3 rad, the score to 1e-3."""
    (js, jt), (ts, _) = shifted_pair(2)
    tgt_j = jnormals.estimate_normals(jt.compact(), leaf_size=8)
    tgt_t = interop.normal_cloud(tgt_j, CPU)
    out = {}
    for pkg, s, t, eye in (("jax", js, tgt_j, jnp.eye(4, dtype=jnp.float32)),
                           ("torch", ts, tgt_t, torch.eye(4))):
        m = (jreg if pkg == "jax" else treg).IcpFast(
            inner_compensation=compensation, exact_quantile=exact,
            max_iteration=40)
        m.set_input_source(s)
        m.set_input_target(t)
        T, score = m.align(eye)
        out[pkg] = (np.asarray(T), float(score))
    dt, dr = _pose_err(out["torch"][0], out["jax"][0])
    assert dt < 1e-3 and dr < 1e-3, (dt, dr)
    assert abs(out["torch"][1] - out["jax"][1]) < 1e-3
    if not compensation:       # the plain model recovers the true motion
        assert _pose_err(out["torch"][0], TRUE_T)[0] < 5e-2


def test_batched_options_match_each_pair():
    """The batched form with both options: every pair of a batch of two
    gets the pose and score of its own unbatched call, to f32 rounding."""
    (js, jt), (ts, tt) = shifted_pair(2)
    _, (ts2, _) = shifted_pair(4)
    tgt = interop.normal_cloud(
        jnormals.estimate_normals(jt.compact(), leaf_size=8), CPU)
    guesses = torch.stack([torch.eye(4), torch.eye(4)])
    guesses[1, 0, 3] = 0.1
    kw = dict(max_iteration=30, compensation=True, exact_quantile=True,
              fixed_iterations=30)
    sources = [ts, ts2]
    T_b, s_b = ticp.align_point_to_plane(
        tcloud.stack(sources), tcloud.stack_normals([tgt, tgt]), guesses,
        **kw)
    for k in range(2):
        T_1, s_1 = ticp.align_point_to_plane(sources[k], tgt, guesses[k],
                                             **kw)
        torch.testing.assert_close(T_b[k], T_1, rtol=0, atol=1e-5)
        torch.testing.assert_close(s_b[k], s_1, rtol=0, atol=1e-5)


@pytest.fixture(scope="module")
def near_scans():
    """Four dense short-range scans, 0.5 m apart: 4000 points within 20 m,
    dense enough for NDT's 1 m voxels of at least 4 points (at 30 m NDT
    reads no motion)."""
    return synthetic.make_sequence(n_scans=4, seed=4, trajectory="straight",
                                   step=0.5, max_points=4000, max_range=20.0)


FE = dict(scan_capacity=4096, nn_tile=512, max_iteration=40,
          motion_compensation=True, use_average=True)


@pytest.mark.parametrize("matcher_type", [1, 3, 5])
def test_sequential_matcher_types_step_like_jax(near_scans, matcher_type):
    """The sequential front end takes matcher types 1, 3 and 5 from the
    factory.  Each scan after the first starts the port from the JAX
    package's front-end state (``interop.load_frontend``: the compacted
    target scan handed to the port's matcher), with motion compensation and
    guess averaging on: the motion since the keyframe agrees to 1e-3 m and
    the keyframe decision exactly; the scans 0.5 m apart make keyframes.
    Type 1 builds its target's leaf-8 normals itself in each package, from
    the raw f32 second moment (ROADMAP.md queue C): its poses agree to
    5e-3 m, the bound of the type-6 chunk in test_torch_pipeline.py."""
    scans, _ = near_scans
    fe_j = jfrontend.FrontEnd(jfrontend.FrontEndOptions(
        **FE, matcher_type=matcher_type))
    fe_t = tfrontend.FrontEnd(tfrontend.FrontEndOptions(
        **FE, matcher_type=matcher_type), device=CPU)
    assert type(fe_t.matcher).__name__ == type(fe_j.matcher).__name__
    fe_j.process(0.0, scans[0])
    tol = 5e-3 if matcher_type == 1 else 1e-3
    n_kf = 0
    for i in range(1, 4):
        interop.load_frontend(fe_t, fe_j)
        ft = fe_t.process(0.1 * i, scans[i])
        fj = fe_j.process(0.1 * i, scans[i])
        assert (fj is None) == (ft is None)
        n_kf += ft is not None
        np.testing.assert_allclose(fe_t.pose_target, fe_j.pose_target,
                                   atol=tol)
        if ft is None:
            np.testing.assert_allclose(fe_t.accumulative,
                                       fe_j.accumulative, atol=tol)
        else:
            assert np.isfinite(ft.global_pose).all()
        assert abs(fe_t.last_score - fe_j.last_score) < 1e-3
    assert n_kf >= 2


@pytest.mark.parametrize("matcher_type", [2, 4])
def test_deprecated_matcher_types_raise(matcher_type):
    """Types 2 and 4 raise ValueError, as in the JAX package, in both
    front ends."""
    for make in (lambda o: tfrontend.FrontEnd(o, device=CPU),
                 lambda o: tpipe.DeviceFrontEnd(o, device=CPU)):
        with pytest.raises(ValueError, match="deprecated|3/5/6"):
            make(tfrontend.FrontEndOptions(matcher_type=matcher_type))
    with pytest.raises(ValueError):
        jfrontend.FrontEnd(jfrontend.FrontEndOptions(
            matcher_type=matcher_type))


def test_pipelined_rejects_type1(tmp_path):
    """tests/test_matcher_e2e.py::test_pipelined_rejects_type1."""
    opts = tmb.MapBuilderOptions(
        front_end=tfrontend.FrontEndOptions(matcher_type=1),
        pipelined=True, export_file_path=str(tmp_path))
    with pytest.raises(ValueError, match="matcher_type"):
        tmb.MapBuilder(opts, device=CPU)


@pytest.mark.parametrize("matcher_type,cap,max_points", [(5, 8192, 8000),
                                                         (3, 4096, 4000)])
def test_chunk_steps_match_jax(matcher_type, cap, max_points):
    """One chunk of the chunked front end for types 5 and 3, each scan
    started from the JAX package's state carried across by
    ``interop.fe_state`` (the target an NDT map, or an NDT map and a GICP
    cloud): the pose to 1e-3 m, the score to 1e-4 and the keyframe flag
    agree."""
    scans, _ = synthetic.make_sequence(
        n_scans=5, seed=4, trajectory="straight", step=0.5,
        max_points=max_points, max_range=30.0)
    fe_opts = dict(scan_capacity=cap, nn_tile=512, max_iteration=40,
                   matcher_type=matcher_type, motion_compensation=False)
    fe_j = jpipe.DeviceFrontEnd(jfrontend.FrontEndOptions(**fe_opts),
                                chunk_size=4)
    fe_j.process(0.0, scans[0])
    fe_t = tpipe.DeviceFrontEnd(tfrontend.FrontEndOptions(**fe_opts),
                                chunk_size=4, device=CPU)
    fe_t.close()
    buf = [(0.1 * i, scans[i]) for i in range(1, 5)]
    q, meta, imu = jpipe._pack_chunk(buf, 0.0, 4, cap, None)
    stamps, xyz, inten, mask, valid = jpipe._unpack_chunk(
        jnp.asarray(q), jnp.asarray(meta))
    st, xt, it, mt, _ = tpipe._unpack_chunk(torch.from_numpy(q),
                                            torch.from_numpy(meta))
    step_j = jax.jit(fe_j._step)
    state = fe_j.state
    n_kf = 0
    for k in range(4):
        state_t = interop.fe_state(state, CPU)
        new_t, (pose_t, score_t, kf_t, _) = fe_t._step(
            state_t, (st[k], xt[k], it[k], mt[k], torch.from_numpy(imu[k])))
        state, (pose_j, score_j, kf_j, _) = step_j(
            state, (stamps[k], xyz[k], inten[k], mask[k], valid[k],
                    jnp.asarray(imu[k])))
        np.testing.assert_allclose(pose_t.numpy(), np.asarray(pose_j),
                                   atol=1e-3)
        assert abs(float(score_t) - float(score_j)) < 1e-4
        assert kf_t == bool(kf_j)
        n_kf += kf_t
        if kf_t:     # the new target, built from the scan, is the same kind
            assert type(new_t.target) is type(state_t.target)
    assert n_kf >= 1
