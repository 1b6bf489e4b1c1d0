"""Parity of the PyTorch port's point-to-plane ICP
(staticmapping_torch.registration.icp_fast) with the JAX package, on the
CPU: both trip forms on one pair, and the batched fixed-trip form against
the JAX package's vmapped one; and the trips run over a block's static
buffers against a fresh call."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from staticmapping_tpu.common import np_se3
from staticmapping_tpu.data import cloud as jcloud
from staticmapping_tpu.io import synthetic
from staticmapping_tpu.ops.normals import estimate_normals
from staticmapping_tpu.registration import icp_fast as jicp
from staticmapping_torch import interop
from staticmapping_torch.common import prof
from staticmapping_torch.data import cloud as tcloud
from staticmapping_torch.registration import icp_fast as ticp
from torch_icp_pairs import plane_pair

CPU = "cpu"
CAP = 4096


def _pair(seed, motion):
    """A synthetic scan as target (with normals) and the same scene seen
    from a pose moved by ``motion`` as source.  A 25 m range keeps the
    4096-slot scans dense enough for ICP to recover the motion to cm."""
    world = synthetic.make_world(seed=seed)
    pose0 = synthetic.straight_trajectory(1)[0]
    pose1 = pose0 @ motion
    tgt_pts = synthetic.render_scan(world, pose0, max_points=3500, seed=seed,
                                    max_range=25.0)
    src_pts = synthetic.render_scan(world, pose1, max_points=3500,
                                    seed=seed + 1, max_range=25.0)
    target = estimate_normals(jcloud.from_numpy(tgt_pts, capacity=CAP)
                              .compact(), leaf_size=4)
    return jcloud.from_numpy(src_pts, capacity=CAP), target


def _motion(yaw, tx, ty):
    return np_se3.from_rt(np_se3.euler_to_matrix(np.array([0.0, 0.0, yaw])),
                          np.array([tx, ty, 0.0]))


def _rot_angle(R):
    return float(np.arccos(np.clip((np.trace(R) - 1) / 2, -1, 1)))


def _assert_close(T_t, T_j, s_t, s_j):
    T_t, T_j = np.asarray(T_t, np.float64), np.asarray(T_j, np.float64)
    assert np.linalg.norm(T_t[:3, 3] - T_j[:3, 3]) <= 1e-3
    assert _rot_angle(T_t[:3, :3].T @ T_j[:3, :3]) <= 1e-3
    assert abs(float(s_t) - float(s_j)) <= 1e-3


@pytest.mark.parametrize("form", ["while", "fixed"])
def test_align_matches_jax(form):
    motion = _motion(0.03, 0.6, 0.1)
    src, tgt = _pair(3, motion)
    guess = np.eye(4, dtype=np.float32)
    kw = dict(max_iteration=40, tile=512, return_aux=True,
              fixed_iterations=12 if form == "fixed" else 0)
    T_j, s_j, it_j = jicp.align_point_to_plane(src, tgt, jnp.asarray(guess),
                                               **kw)
    T_t, s_t, it_t = ticp.align_point_to_plane(
        interop.point_cloud(src, CPU), interop.normal_cloud(tgt, CPU),
        torch.from_numpy(guess), **kw)
    _assert_close(T_t.numpy(), T_j, s_t, s_j)
    assert int(it_t) == int(it_j)
    # and both recover the motion (T maps source into the target frame)
    assert np.linalg.norm(np.asarray(T_t)[:3, 3] - motion[:3, 3]) < 0.05


def test_trip_counts_record_run_and_needed_trips():
    src, tgt = _pair(3, _motion(0.03, 0.6, 0.1))
    src_t, tgt_t = interop.point_cloud(src, CPU), interop.normal_cloud(tgt, CPU)
    guess = torch.eye(4)
    ticp.reset_trips()
    _, _, it_w = ticp.align_point_to_plane(src_t, tgt_t, guess, tile=512,
                                           max_iteration=40, return_aux=True)
    _, _, it_f = ticp.align_point_to_plane(src_t, tgt_t, guess, tile=512,
                                           fixed_iterations=30,
                                           return_aux=True)
    counts = ticp.trip_counts()
    # the while form runs whole blocks of trips past convergence
    assert counts["while"]["needed"] == int(it_w) < 40
    assert counts["while"]["run"] == -(-int(it_w) // ticp._WHILE_CHECK_EVERY
                                       ) * ticp._WHILE_CHECK_EVERY
    assert counts["fixed"] == {"run": 30, "needed": int(it_f)}
    assert int(it_f) == int(it_w)
    ticp.reset_trips()
    assert ticp.trip_counts()["while"] == {"run": 0, "needed": 0}


def test_align_spacing_normalized_score_matches_jax():
    src, tgt = _pair(4, _motion(-0.02, 0.4, -0.2))
    guess = np.eye(4, dtype=np.float32)
    T_j, s_j = jicp.align_point_to_plane(src, tgt, jnp.asarray(guess),
                                         fixed_iterations=10, tile=512,
                                         score_spacing_ref=0.35)
    T_t, s_t = ticp.align_point_to_plane(
        interop.point_cloud(src, CPU), interop.normal_cloud(tgt, CPU),
        torch.from_numpy(guess), fixed_iterations=10, tile=512,
        score_spacing_ref=0.35)
    _assert_close(T_t.numpy(), T_j, s_t, s_j)
    np.testing.assert_allclose(
        float(ticp.target_spacing(interop.normal_cloud(tgt, CPU), 512)),
        float(jicp.target_spacing(tgt, 512)), rtol=1e-5)


def test_batched_fixed_trip_matches_jax_vmap():
    motions = [_motion(0.02, 0.5, 0.0), _motion(-0.04, 0.8, 0.2),
               _motion(0.0, 0.3, -0.1)]
    pairs = [_pair(5 + k, m) for k, m in enumerate(motions)]
    srcs = jax.tree.map(lambda *x: jnp.stack(x), *[p[0] for p in pairs])
    tgts = jax.tree.map(lambda *x: jnp.stack(x), *[p[1] for p in pairs])
    guesses = np.tile(np.eye(4, dtype=np.float32), (3, 1, 1))
    guesses[1, :3, 3] = [0.7, 0.1, 0.0]           # per-pair guesses
    T_j, s_j = jax.vmap(lambda s, t, g: jicp.align_point_to_plane(
        s, t, g, tile=512, fixed_iterations=10))(srcs, tgts,
                                                  jnp.asarray(guesses))
    T_t, s_t = ticp.align_point_to_plane(
        tcloud.stack([interop.point_cloud(p[0], CPU) for p in pairs]),
        tcloud.stack_normals([interop.normal_cloud(p[1], CPU)
                              for p in pairs]),
        torch.from_numpy(guesses), tile=512, fixed_iterations=10)
    assert tuple(T_t.shape) == (3, 4, 4) and tuple(s_t.shape) == (3,)
    for k in range(3):
        _assert_close(T_t[k].numpy(), T_j[k], s_t[k], s_j[k])


def test_solve6_zeroes_nonfinite_systems():
    rng = np.random.default_rng(0)
    a = rng.normal(size=(2, 6, 6)).astype(np.float32)
    A = a @ np.swapaxes(a, 1, 2)
    A[1, 2, 2] = np.nan                          # non-finite: zero solution
    b = rng.normal(size=(2, 6)).astype(np.float32)
    x_t = ticp._solve6(torch.from_numpy(A), torch.from_numpy(b)).numpy()
    for k in range(2):
        x_j = np.asarray(jicp._solve6(jnp.asarray(A[k]), jnp.asarray(b[k])))
        np.testing.assert_allclose(x_t[k], x_j, rtol=1e-3, atol=1e-4)
    assert np.all(x_t[1] == 0.0)


@pytest.mark.parametrize("nb,kw", [
    (None, dict(max_iteration=6)),                  # a block, then a tail
    (3, dict(fixed_iterations=6, score_spacing_ref=0.35)),
    (None, dict(max_iteration=8, compensation=True, exact_quantile=True)),
], ids=["while", "fixed_batched", "while_compensated"])
def test_block_over_static_buffers_matches_fresh_calls(monkeypatch, nb, kw):
    """The CUDA graph's block run on the CPU, one operation at a time: two
    calls loaded into the same buffers each return what a fresh call
    returns, bit for bit, and neither path counts a replayed trip."""
    pairs = [plane_pair(seed, nb, 1500, 700) for seed in (21, 22)]
    prof.reset()
    prof.enable(report_at_exit=False)
    try:
        fresh = [ticp.align_point_to_plane(*p, tile=256, return_aux=True,
                                           **kw) for p in pairs]
        made = []

        def cpu_block(x, o, init, trips):
            if not made:
                made.append(ticp._TripBlock(x, o, init, trips))
            made[0].load(x, init)
            return made[0]

        monkeypatch.setattr(ticp, "_block_for", cpu_block)
        buffers = None
        for p, want in zip(pairs, fresh):
            got = ticp.align_point_to_plane(*p, tile=256, return_aux=True,
                                            **kw)
            for a, b in zip(got, want):
                assert torch.equal(a, b)
            ptrs = [t.data_ptr() for t in made[0].x + made[0].state
                    if t is not None]
            assert buffers in (None, ptrs)
            buffers = ptrs
        counters = prof.counters()
    finally:
        prof.disable()
        prof.reset()
    assert made[0].graph is None
    assert counters.get("icp_graph_trips", 0) == 0
    assert counters.get("icp_graph_captures", 0) == 0
