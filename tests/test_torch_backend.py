"""Parity of the PyTorch port's pose-graph back end with the JAX package on
the CPU: the SE(3) exp/log and the autodiff factor Jacobians, the M2DP
descriptor, and the dense and PCG Gauss-Newton solves on the same graphs
(those of tests/test_pose_graph.py, and one with GPS, odometry and
special-node priors)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from staticmapping_tpu.backend import pose_graph as jpg
from staticmapping_tpu.backend import pose_graph_sparse as jpgs
from staticmapping_tpu.backend import view_graph as jvg
from staticmapping_tpu.common import np_se3
from staticmapping_tpu.common import se3 as jse3
from staticmapping_tpu.data import cloud as jcloud
from staticmapping_tpu.descriptor import m2dp as jm2dp
from staticmapping_torch import interop
from staticmapping_torch.backend import pose_graph as tpg
from staticmapping_torch.backend import pose_graph_sparse as tpgs
from staticmapping_torch.backend import view_graph as tvg
from staticmapping_torch.common import se3 as tse3
from staticmapping_torch.data import cloud as tcloud
from staticmapping_torch.descriptor import m2dp as tm2dp
from test_m2dp import make_structured
from test_pose_graph import _build_graph, _square_circuit, make_noisy_circle

CPU = "cpu"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The solves are chains of small ops, which a many-thread CPU pool
    only slows down."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# se3
# ---------------------------------------------------------------------------

def _xi(regime, n=64, seed=0):
    """Random ξ ∈ R⁶ whose rotation angle lies in ``regime``."""
    rng = np.random.default_rng(seed)
    axis = rng.normal(size=(n, 3))
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    lo, hi = {"zero": (0.0, 1e-6), "small": (1e-4, 0.05),
              "switch": (0.0995, 0.1005), "large": (0.2, 2.5),
              "near_pi": (np.pi - 1e-2, np.pi - 1e-4)}[regime]
    theta = rng.uniform(lo, hi, size=(n, 1))
    rho = rng.uniform(-5, 5, size=(n, 3))
    return np.concatenate([rho, axis * theta], 1).astype(np.float32)


@pytest.mark.parametrize("regime",
                         ["zero", "small", "switch", "large", "near_pi"])
def test_exp_log_match_jax(regime):
    """exp, log and matrix_to_axis_angle within 1e-5 (relative for the
    metre-scale translations, whose f32 ulp alone is ~5e-7)."""
    xi = _xi(regime)
    T_j = np.array(jse3.exp_se3(jnp.asarray(xi)))
    T_t = tse3.exp_se3(torch.from_numpy(xi)).numpy()
    np.testing.assert_allclose(T_t, T_j, rtol=1e-5, atol=1e-5)
    log_j = np.asarray(jse3.log_se3(jnp.asarray(T_j)))
    log_t = tse3.log_se3(torch.from_numpy(T_j)).numpy()
    aa_j = np.asarray(jse3.matrix_to_axis_angle(jnp.asarray(T_j[:, :3, :3])))
    aa_t = tse3.matrix_to_axis_angle(torch.from_numpy(T_j[:, :3, :3])).numpy()
    if regime == "near_pi":
        # at θ → π the rotation vector's sign flips with the last ulp of the
        # quaternion's w: compare the rotations the vectors stand for
        R_t = tse3.axis_angle_to_matrix(torch.from_numpy(aa_t)).numpy()
        np.testing.assert_allclose(R_t, T_j[:, :3, :3], atol=1e-5)
        np.testing.assert_allclose(np.linalg.norm(aa_t, axis=1),
                                   np.linalg.norm(aa_j, axis=1), atol=1e-5)
        return
    np.testing.assert_allclose(aa_t, aa_j, atol=1e-5)
    if regime == "switch":
        # just past θ = 0.1 the quotient form of V⁻¹ cancels in f32 (both
        # packages' logs are ~2.6e-5 m off the exact value there, in
        # different ulps): hold each to the float64 evaluation, at 1e-5 of
        # the translation's norm
        log_64 = tse3.log_se3(torch.from_numpy(T_j).double()).numpy()
        scale = np.maximum(np.linalg.norm(T_j[:, :3, 3], axis=1), 1.0)
        for log in (log_t, log_j):
            assert (np.abs(log - log_64).max(axis=1) <= 1e-5 * scale).all()
        return
    np.testing.assert_allclose(log_t, log_j, rtol=1e-5, atol=1e-5)


def _factor_inputs(seed=1):
    rng = np.random.default_rng(seed)

    def pose():
        return np_se3.from_rt(np_se3.euler_to_matrix(rng.uniform(-1, 1, 3)),
                              rng.uniform(-10, 10, 3)).astype(np.float32)
    return {
        "prior": (6, (pose(), pose())),
        "odom": (12, (pose(), pose(), pose())),
        "gps": (18, (pose(), pose(), pose(),
                     rng.uniform(-1, 1, 3).astype(np.float32),
                     rng.uniform(-50, 50, 3).astype(np.float32),
                     np.float32(1.0))),
    }


@pytest.mark.parametrize("factor", ["prior", "odom", "gps"])
def test_autodiff_jacobians_match_jax(factor):
    """``torch.func.jacfwd`` of each autodiff-linearized residual at ξ = 0
    equals ``jax.jacfwd``'s, and is finite."""
    dim, args = _factor_inputs()[factor]
    j_fn = getattr(jpg, f"_{factor}_residual")
    t_fn = getattr(tpg, f"_{factor}_residual")
    J_j = np.asarray(jax.jit(jax.jacfwd(j_fn))(jnp.zeros(dim, jnp.float32),
                                              *map(jnp.asarray, args)))
    J_t = torch.func.jacfwd(t_fn)(
        torch.zeros(dim), *(torch.as_tensor(a) for a in args)).numpy()
    assert np.isfinite(J_t).all()
    np.testing.assert_allclose(J_t, J_j, atol=1e-4)


# ---------------------------------------------------------------------------
# M2DP
# ---------------------------------------------------------------------------

def _jax_signature_and_descriptor(pc):
    """JAX's PCA-aligned points, signature matrix A and descriptor from one
    jitted program: the traced ``compute_descriptor`` re-evaluated with its
    intermediate values returned beside the result."""
    closed = jax.make_jaxpr(jm2dp.compute_descriptor.__wrapped__)(pc)
    jaxpr = closed.jaxpr
    scatter = [e for e in jaxpr.eqns if e.primitive.name == "scatter-add"]
    assert len(scatter) == 1
    hist = scatter[0].outvars[0]
    # pts = centered @ E: the last [N, 3] matrix product
    n = pc.xyz.shape[0]
    aligned = [e.outvars[0] for e in jaxpr.eqns
               if e.primitive.name == "dot_general"
               and e.outvars[0].aval.shape == (n, 3)][-1]

    def run(*leaves):
        env = dict(zip(jaxpr.constvars, closed.consts))
        env.update(zip(jaxpr.invars, leaves))

        def read(v):
            return v.val if type(v).__name__ == "Literal" else env[v]
        for eqn in jaxpr.eqns:
            outs = eqn.primitive.bind(*map(read, eqn.invars), **eqn.params)
            if not eqn.primitive.multiple_results:
                outs = [outs]
            env.update(zip(eqn.outvars, outs))
        return read(aligned), read(hist), read(jaxpr.outvars[0])

    P, A, d = jax.jit(run)(*jax.tree_util.tree_leaves(pc))
    return (np.array(P),
            np.asarray(A).reshape(jm2dp.P_VIEWS * jm2dp.Q_VIEWS, -1),
            np.array(d))


def _clouds(pts, cap=2048):
    return (jcloud.from_numpy(pts, capacity=cap),
            tcloud.from_numpy(pts, capacity=cap, device=CPU))


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_m2dp_matches_jax(seed):
    """The histogram of the same aligned points is JAX's A exactly; end to
    end (each package's own PCA) the descriptor agrees to 1e-4."""
    pts = make_structured(seed=seed)
    jpc, tpc = _clouds(pts)
    P_j, A_j, d_j = _jax_signature_and_descriptor(jpc)
    np.testing.assert_allclose(d_j, np.asarray(jm2dp.compute_descriptor(jpc)),
                               atol=1e-6)
    A_t = tm2dp.histogram(torch.from_numpy(P_j), tpc.mask).numpy()
    assert np.array_equal(A_t, A_j)
    # the two PCA alignments differ in their last bits, which can move a
    # point lying on a bin edge into the neighbouring bin: at most 0.01% of
    # the (view, point) counts move
    moved = np.abs(tm2dp.signature(tpc).numpy() - A_j).sum() / 2
    assert moved <= 1e-4 * A_j.sum()
    d_t = tm2dp.compute_descriptor(tpc)
    np.testing.assert_allclose(d_t.numpy(), d_j, atol=1e-4)
    assert float(tm2dp.match_descriptors(d_t, torch.from_numpy(d_j))) \
        >= 0.9999


def _tdesc(pts):
    return tm2dp.compute_descriptor(tcloud.from_numpy(pts, capacity=2048,
                                                      device=CPU))


def test_m2dp_rotation_invariance():
    """tests/test_m2dp.py::test_rotation_invariance through the port."""
    pts = make_structured(seed=1)
    T = np_se3.from_rt(np_se3.euler_to_matrix(np.array([0.0, 0.0, 1.3])),
                       np.array([25.0, -14.0, 0.4]))
    pts2 = (pts @ T[:3, :3].T + T[:3, 3]).astype(np.float32)
    assert float(tm2dp.match_descriptors(_tdesc(pts), _tdesc(pts2))) > 0.95


def test_m2dp_self_and_different_scenes():
    """tests/test_m2dp.py's self-match and different-scene cases."""
    d0 = _tdesc(make_structured(seed=3))
    rng = np.random.default_rng(4)
    d1 = _tdesc(rng.uniform(-3, 3, size=(2000, 3)).astype(np.float32))
    same = float(tm2dp.match_descriptors(d0, d0))
    assert same > 0.999
    assert float(tm2dp.match_descriptors(d0, d1)) < same - 0.05


def test_m2dp_match_many():
    d = _tdesc(make_structured(seed=5))
    bank = torch.stack([d, d * 0.5 + 0.01, _tdesc(make_structured(seed=6))])
    scores = tm2dp.match_many(d, bank).numpy()
    assert scores.shape == (3,)
    assert scores[0] > 0.999
    jscores = np.asarray(jm2dp.match_many(jnp.asarray(d.numpy()),
                                          jnp.asarray(bank.numpy())))
    np.testing.assert_allclose(scores, jscores, atol=1e-6)


# ---------------------------------------------------------------------------
# pose graph
# ---------------------------------------------------------------------------

def _circle_graph(lib, n, drift, seed, loop):
    gt, odom, _, noisy = make_noisy_circle(n=n, drift=drift, seed=seed)
    g = lib.PoseGraph()
    for _ in odom:
        g.add_node()
    for k, nr in enumerate(noisy):
        g.add_between(k, k + 1, nr)
    if loop:
        g.add_between(len(odom) - 1, 0, np_se3.inverse(gt[-1]) @ gt[0])
    return g, odom, gt


def _aux_graph(lib):
    """A circle with a loop, GPS factors on the calibration error, odometry
    factors and priors on all three special nodes."""
    g, odom, gt = _circle_graph(lib, 16, 0.05, 1, True)
    offset = np.array([100.0, 50.0, 3.0])
    for k in range(0, 16, 3):
        g.add_gps(k, gt[k][:3, 3] + offset, p_tracking_gps=(0.1, 0.0, 0.2),
                  use_calib_error=True)
        g.add_odom(k, gt[k])
    g.add_special_prior(jpg.SPECIAL_ODOM_CALIB, np.eye(4),
                        (0.1, 0.1, 0.1, 0.5, 0.5, 1.5))
    g.add_special_prior(jpg.SPECIAL_GPS_CALIB, np.eye(4),
                        (1.0, 1.0, 0.2, 1e-4, 1e-4, 1e-4))
    coord = np_se3.from_rt(np.eye(3), offset)
    g.add_special_prior(jpg.SPECIAL_GPS_COORD, coord,
                        (1.0, 1.0, 1.0, 0.1, 0.1, 0.2))
    g.set_special_value(jpg.SPECIAL_GPS_COORD,
                        np_se3.from_rt(np.eye(3), offset + [-1.0, 0.5, 0.0]))
    return g, odom, gt


def _square_graph(n=1500, seed=3, drift=0.03):
    gt, odom, noisy, loops = _square_circuit(n, drift=drift, seed=seed)
    return _build_graph(n, odom, noisy, loops), odom, gt


GRAPHS = {
    "chain": lambda: _circle_graph(jpg, 12, 0.02, 0, False),
    "loop": lambda: _circle_graph(jpg, 16, 0.05, 1, True),
    "chi2": lambda: _circle_graph(jpg, 10, 0.08, 2, True),
    "aux": lambda: _aux_graph(jpg),
}


def _assert_poses_close(out_t, out_j, tol=1e-4):
    out_t, out_j = np.asarray(out_t, np.float64), np.asarray(out_j,
                                                             np.float64)
    assert np.abs(out_t[:, :3, 3] - out_j[:, :3, 3]).max() <= tol
    # the relative rotation's angle as atan2(|sin|, cos), which keeps its
    # digits near 0 (an arccos of the trace would be ~3e-4 rad of noise)
    rel = np.swapaxes(out_t[:, :3, :3], 1, 2) @ out_j[:, :3, :3]
    skew = rel - np.swapaxes(rel, 1, 2)
    sin = 0.5 * np.linalg.norm(skew[:, [2, 0, 1], [1, 2, 0]], axis=1)
    cos = 0.5 * (np.trace(rel, axis1=1, axis2=2) - 1.0)
    assert np.arctan2(sin, cos).max() <= tol


# Trips run before the solves reach their f32 noise floor.  From the fourth
# trip on, every graph here changes its cost by under 2e-6 relative a trip:
# the accept/reject then turns on rounding, and two f32 solvers' poses
# part by up to 2.2e-4 m.  Parity of the poses is held over the trips before
# that, and of the χ² over the optimizer's default count of 8 too.
PARITY_TRIPS = 3


def _assert_above_noise(trace):
    """Every trip of JAX's ``trace`` either moved the cost by more than
    5e-6 of it, or ran at a cost within f32 rounding of 0."""
    c_cur, c_cand = np.asarray(trace)[:2]
    assert ((np.abs(c_cur - c_cand) > 5e-6 * c_cur) | (c_cur < 1e-6)).all()


def _solve_both(graph, solver, num_iters):
    g, odom, _ = GRAPHS[graph]()
    args, _, _ = g.solver_args(np.stack(odom))
    j_fn, t_fn = {"dense": (jpg.gauss_newton, tpg.gauss_newton),
                  "pcg": (jpgs.gauss_newton_pcg,
                          tpgs.gauss_newton_pcg)}[solver]
    out_j, chi_j, trace_j = j_fn(*args, num_iters=num_iters)
    out_t, chi_t, _ = t_fn(*interop.solver_args(args, CPU),
                           num_iters=num_iters)
    return out_t.numpy(), float(chi_t), np.asarray(out_j), float(chi_j), \
        trace_j


@pytest.mark.parametrize("solver", ["dense", "pcg"])
@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_solver_matches_jax(graph, solver):
    """The port's solver on JAX's ``solver_args`` of the same graph: the
    same poses (1e-4 m, 1e-4 rad) and χ² (1e-3 relative) over the trips
    above the noise floor."""
    out_t, chi_t, out_j, chi_j, trace_j = _solve_both(graph, solver,
                                                      PARITY_TRIPS)
    _assert_above_noise(trace_j)
    _assert_poses_close(out_t, out_j)
    assert abs(chi_t - chi_j) <= 1e-3 * max(chi_j, 1.0)


def test_default_trip_count_chi2_matches_jax():
    """Past the noise floor, at ``IncrementalOptimizer``'s 8 trips, the
    χ² of the graph with every factor type still agrees (1e-3 relative)."""
    _, chi_t, _, chi_j, _ = _solve_both("aux", "dense", 8)
    assert abs(chi_t - chi_j) <= 1e-3 * max(chi_j, 1.0)


@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_pose_graph_optimize_matches_jax(graph):
    """``PoseGraph.optimize`` end to end on a graph carried over by
    ``interop.pose_graph``, special-node estimates included."""
    g, odom, _ = GRAPHS[graph]()
    tg = interop.pose_graph(g, CPU)
    out_t = tg.optimize(np.stack(odom), num_iters=PARITY_TRIPS)
    out_j = g.optimize(np.stack(odom), num_iters=PARITY_TRIPS)
    _assert_poses_close(out_t, out_j)
    for a, b in zip(tg.special_values, g.special_values):
        assert np.abs(a[:3, 3] - b[:3, 3]).max() <= 1e-4
        assert np.abs(a[:3, :3] - b[:3, :3]).max() <= 1e-4
    assert abs(tg.last_chi2 - g.last_chi2) <= 1e-3 * max(g.last_chi2, 1.0)


def _tgraph(builder):
    g, odom, gt = builder()
    return interop.pose_graph(g, CPU), odom, gt


def test_chain_without_loops_unchanged():
    g, odom, _ = _tgraph(GRAPHS["chain"])
    out = g.optimize(np.stack(odom), num_iters=5)
    for a, b in zip(out, odom):
        assert np.abs(a - b).max() < 1e-3


def test_loop_closure_reduces_error():
    g, odom, gt = _tgraph(GRAPHS["loop"])
    err_before = np.linalg.norm(odom[-1][:3, 3] - gt[-1][:3, 3])
    out = g.optimize(np.stack(odom), num_iters=10)
    assert np.linalg.norm(out[-1][:3, 3] - gt[-1][:3, 3]) < err_before * 0.5
    assert np.abs(out[0] - odom[0]).max() < 1e-3       # gauge
    for T in out:
        assert np.abs(T[:3, :3] @ T[:3, :3].T - np.eye(3)).max() < 1e-4


def test_chi2_decreases():
    g, odom, _ = _tgraph(GRAPHS["chi2"])
    g.optimize(np.stack(odom), num_iters=1)
    chi_1 = g.last_chi2
    g.optimize(np.stack(odom), num_iters=10)
    assert g.last_chi2 <= chi_1 + 1e-3


def test_pcg_past_the_dense_limit_matches_jax():
    """tests/test_pose_graph.py::test_pcg_scales_past_dense_limit through
    the port (1500 nodes, auto-routed to PCG), held to the JAX package's
    solve of the same graph."""
    jg, odom, gt = _square_graph()
    g = interop.pose_graph(jg, CPU)
    before = np.linalg.norm(
        np.stack(odom)[:, :3, 3] - np.stack(gt)[:, :3, 3], axis=1).mean()
    out = g.optimize(np.stack(odom), num_iters=6, solver="auto")
    after = np.linalg.norm(out[:, :3, 3] - np.stack(gt)[:, :3, 3],
                           axis=1).mean()
    assert after < before, (before, after)
    assert g.last_chi2 < 50.0
    out_j = jg.optimize(np.stack(odom), num_iters=6, solver="auto")
    _assert_poses_close(out, out_j)
    assert abs(g.last_chi2 - jg.last_chi2) <= 1e-3 * max(jg.last_chi2, 1.0)


@pytest.mark.parametrize("trail", [(), (6,), (6, 6)], ids=str)
def test_ordered_sum_is_the_jax_scatter_order(trail):
    """The solvers' sums into H, b and the nodes: two JAX ``.at[].add``
    scatters one after the other, with repeated indices and values of
    mixed magnitude, equal the port's one ordered sum over both bit for
    bit; a slot nothing adds to stays 0."""
    rng = np.random.default_rng(9)
    n = 40
    idx = [rng.integers(0, n - 3, 300), rng.integers(0, n - 3, 200)]
    vals = [(rng.normal(size=(len(i),) + trail)
             * 10.0 ** rng.uniform(-3, 3, (len(i),) + (1,) * len(trail))
             ).astype(np.float32) for i in idx]

    @jax.jit
    def scatter(i1, v1, i2, v2):
        return jnp.zeros((n,) + trail, jnp.float32).at[i1].add(v1).at[
            i2].add(v2)
    want = np.asarray(scatter(idx[0], vals[0], idx[1], vals[1]))
    got = tpg._OrderedSum(torch.from_numpy(np.concatenate(idx)), n)(
        torch.from_numpy(np.concatenate(vals))).numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    assert not got[n - 3:].any()
    empty = tpg._OrderedSum(torch.zeros(0, dtype=torch.int64), n)(
        torch.zeros((0,) + trail))
    assert tuple(empty.shape) == (n,) + trail and not empty.any()


def test_sharded_solve_is_refused():
    """The sharded PCG solve takes only the port's mesh (a JAX mesh or any
    other object is refused); tests/test_torch_multidevice.py runs it."""
    g, odom, _ = _tgraph(GRAPHS["loop"])
    with pytest.raises(TypeError, match="multihost.Mesh"):
        g.optimize(np.stack(odom), solver="pcg", mesh=object())


def test_view_graph_matches_jax(tmp_path):
    """The port's copy writes the JAX package's text dump and image."""
    rng = np.random.default_rng(0)
    graphs = (jvg.ViewGraph(), tvg.ViewGraph())
    for k in range(6):
        pose = np_se3.from_rt(np.eye(3), rng.uniform(-5, 5, 3))
        for vg in graphs:
            vg.add_vertex(k, pose)
            if k:
                vg.add_edge(k - 1, k, pose)
    for vg, name in zip(graphs, ("jax", "torch")):
        vg.save_text_file(str(tmp_path / f"{name}.txt"))
        vg.save_image(str(tmp_path / f"{name}.png"))
    for ext in ("txt", "png"):
        assert (tmp_path / f"jax.{ext}").read_bytes() == \
            (tmp_path / f"torch.{ext}").read_bytes()
