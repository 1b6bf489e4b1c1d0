"""Multi-device execution of the PyTorch port against the JAX package, on
the CPU.

One module-scoped fixture starts one gloo group of two ranks
(tests/torch_multidevice_worker.py, one process a rank, as
tests/test_multihost.py starts its workers) and hands them inputs made
from seeds with numpy and the JAX package, through an npz.  While they
run, this process computes the JAX references on the 8 virtual CPU
devices of tests/conftest.py with the JAX package's own sharded
functions.  The tests below then hold each stage of the ranks' results:
the sharded pair registration (tests/multihost_worker.py stage A,
tests/test_parallel.py), the sharded PCG solves (stage B,
tests/test_pose_graph.py::test_pcg_sharded_matches_single_device) and
the MapBuilder-level slice (stage C).  The last tests need no group.
"""
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from __graft_entry__ import _example_pair
from staticmapping_tpu import parallel as jap
from staticmapping_tpu.backend import pose_graph as jpg
from staticmapping_tpu.backend import pose_graph_sparse as jpgs
from staticmapping_tpu.common import np_se3
from staticmapping_torch import interop
from staticmapping_torch import parallel as tap
from staticmapping_torch.backend import pose_graph as tpg
from staticmapping_torch.parallel import multihost
from test_pose_graph import _build_graph, _square_circuit

HERE = os.path.dirname(os.path.abspath(__file__))
WORKER = os.path.join(HERE, "torch_multidevice_worker.py")
RANKS = 2
# the whole group's wall-clock limit; each collective times out sooner
RANK_TIMEOUT_S = 120
CLOUD = ("xyz", "intensity", "factor", "mask")
NORMALS = ("xyz", "normals", "mask")


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _pairs():
    """tests/multihost_worker.py's 8 pairs: source capacity 1024, target
    256, each source moved by the inverse of a small known transform."""
    rng = np.random.default_rng(3)
    srcs, tgts = [], []
    for i in range(8):
        s, t = _example_pair(capacity=1024, target_capacity=256, seed=i)
        T = np_se3.from_rt(np_se3.euler_to_matrix(
            rng.uniform(-0.02, 0.02, 3)), rng.uniform(-0.2, 0.2, 3))
        srcs.append(s.transform(jnp.asarray(np_se3.inverse(T),
                                            dtype=jnp.float32)))
        tgts.append(t)
    return jap.stack_pairs(srcs, tgts, [np.eye(4)] * 8)


def _chain_graph():
    """tests/multihost_worker.py stage B's 64-node graph and its poses."""
    n = 64
    g = jpg.PoseGraph()
    gt = [np.eye(4)]
    step = np.eye(4)
    step[0, 3] = 1.0
    for _ in range(n - 1):
        gt.append(np_se3.normalize_rotation(gt[-1] @ step))
    for _ in range(n):
        g.add_node()
    odom = [gt[0]]
    rng = np.random.default_rng(5)
    for k in range(n - 1):
        nr = np_se3.inverse(gt[k]) @ gt[k + 1]
        nr[:3, 3] += rng.normal(0, 0.02, 3)
        g.add_between(k, k + 1, nr)
        odom.append(np_se3.normalize_rotation(odom[-1] @ nr))
    for k in range(16, n, 8):
        g.add_between(k, k - 16, np_se3.inverse(gt[k]) @ gt[k - 16],
                      sigmas=(0.05,) * 3 + (0.02,) * 3)
    return g.solver_args(np.stack(odom))[0]


@pytest.fixture(scope="module")
def group_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("multidevice")
    bs, bt, gs = _pairs()
    chain_args = _chain_graph()
    _, odom, noisy, loops = _square_circuit(400, drift=0.02, seed=4)
    inp = {f"a_src_{f}": np.asarray(getattr(bs, f)) for f in CLOUD}
    inp.update({f"a_tgt_{f}": np.asarray(getattr(bt, f)) for f in NORMALS})
    inp["a_guess"] = np.asarray(gs)
    inp["b_nargs"] = np.int64(len(chain_args))
    inp.update({f"b_arg{k:02d}": np.asarray(a)
                for k, a in enumerate(chain_args)})
    inp.update(b2_odom=np.stack(odom), b2_noisy=np.stack(noisy),
               b2_loop_ij=np.array([(i, j) for i, j, _ in loops]),
               b2_loop_T=np.stack([T for _, _, T in loops]))
    np.savez(tmp / "inputs.npz", **inp)

    port = _free_port()
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    procs = [subprocess.Popen(
        [sys.executable, WORKER, str(r), str(RANKS), str(port),
         str(tmp / "inputs.npz"), str(tmp)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env,
        cwd=os.path.dirname(HERE)) for r in range(RANKS)]
    try:
        # the JAX references, on this process's 8 virtual devices, while
        # the ranks run
        mesh8 = jap.make_submap_mesh(8)
        Ts, scores, mean = jap.align_pairs_sharded(bs, bt, gs, mesh8,
                                                   max_iteration=15)
        ref = {"a_Ts": np.asarray(Ts), "a_scores": np.asarray(scores),
               "a_mean": float(mean)}
        p, c, _ = jpgs.gauss_newton_pcg(*chain_args, num_iters=4)
        ref.update(b_poses=np.asarray(p), b_chi2=float(c))
        g = _build_graph(400, odom, noisy, loops)
        ref["b2_poses"] = g.optimize(
            np.stack(odom), num_iters=5, solver="pcg",
            mesh=JaxMesh(np.array(jax.devices()), axis_names=("graph",)))
        ref["b2_chi2"] = g.last_chi2
        outs = [p.communicate(timeout=RANK_TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, (
            f"rank {r} failed (rc={p.returncode}):\n"
            f"{out.decode(errors='replace')[-3000:]}")
    ranks = [dict(np.load(tmp / f"rank{r}.npz")) for r in range(RANKS)]
    return ref, ranks


def test_pairs_sharded_match_jax(group_run):
    """``align_pairs_sharded`` over two ranks gives every rank the JAX
    package's sharded result on its 8-device mesh."""
    ref, ranks = group_run
    for out in ranks:
        np.testing.assert_allclose(out["a_Ts"], ref["a_Ts"], atol=1e-3)
        np.testing.assert_allclose(out["a_scores"], ref["a_scores"],
                                   atol=1e-3)
        assert abs(float(out["a_mean"]) - ref["a_mean"]) < 1e-3


def test_pairs_multihost_match_jax(group_run):
    """``align_pairs_multihost`` with each rank's own half returns that
    half of the JAX result and the global mean."""
    ref, ranks = group_run
    for r, out in enumerate(ranks):
        half = slice(4 * r, 4 * (r + 1))
        np.testing.assert_allclose(out["a_local_Ts"], ref["a_Ts"][half],
                                   atol=1e-3)
        np.testing.assert_allclose(out["a_local_scores"],
                                   ref["a_scores"][half], atol=1e-3)
        assert abs(float(out["a_local_mean"]) - ref["a_mean"]) < 1e-3


def test_pair_list_uneven_batch_matches_unsharded(group_run):
    """Five pairs over two ranks are padded to six and cut back: the
    sharded ``align_pair_list`` equals the port's unsharded call."""
    _, ranks = group_run
    for out in ranks:
        assert out["a_list_Ts"].shape == (5, 4, 4)
        np.testing.assert_allclose(out["a_list_Ts"], out["a_list_ref_Ts"],
                                   atol=1e-5)
        np.testing.assert_allclose(out["a_list_scores"],
                                   out["a_list_ref_scores"], atol=1e-5)


def test_make_submap_mesh_takes_the_first_ranks(group_run):
    """``make_submap_mesh(1)`` spans rank 0 alone; rank 1 gets None."""
    _, ranks = group_run
    assert [int(out["a_first_mesh"]) for out in ranks] == [10, -1]


def test_chain_graph_multihost_matches_jax(group_run):
    """The 64-node graph with each rank holding half of the between
    factors: poses within 1e-3 of the JAX ``gauss_newton_pcg``, χ² within
    1e-2 relative (tests/multihost_worker.py's bounds)."""
    ref, ranks = group_run
    for out in ranks:
        assert np.abs(out["b_poses"] - ref["b_poses"]).max() < 1e-3
        assert abs(float(out["b_chi2"]) - ref["b_chi2"]) < 1e-2 * max(
            1.0, ref["b_chi2"])


def test_circuit_sharded_optimize_matches_jax(group_run):
    """The 400-node square circuit through ``PoseGraph.optimize(
    solver="pcg", mesh=)`` over two ranks against the JAX package's
    ``solve_sharded`` on 8 devices: poses within 2e-3, χ² within 10%."""
    ref, ranks = group_run
    for out in ranks:
        assert np.abs(out["b2_poses"] - ref["b2_poses"]).max() < 2e-3
        assert abs(float(out["b2_chi2"]) - ref["b2_chi2"]) < 0.1 * max(
            1.0, ref["b2_chi2"])


def test_mapbuilder_slice_matches_single_process(group_run):
    """Two halves of a straight drive mapped on two ranks, joined at the
    boundary and solved sharded: within 1e-3 of one process's solve of
    the same merged graph, spanning the drive's ~21 m."""
    _, ranks = group_run
    for out in ranks:
        assert np.abs(out["c_poses"] - out["c_ref_poses"]).max() < 1e-3
        last = int(out["c_nodes"]) - 1
        span = float(np.linalg.norm(out["c_ref_poses"][last][:3, 3]
                                    - out["c_ref_poses"][0][:3, 3]))
        assert 15.0 < span < 27.0, span


def test_ranks_agree(group_run):
    """What the mesh replicates is the same on both ranks, bit for bit."""
    _, (a, b) = group_run
    for key in ("a_Ts", "a_scores", "a_mean", "b_poses", "b_chi2",
                "b2_poses", "c_poses", "c_chi2"):
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)


def test_make_submap_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError, match="multihost.initialize"):
        tap.make_submap_mesh()
    with pytest.raises(RuntimeError, match="process group"):
        multihost.global_mesh(device="cpu")


def test_dense_solve_ignores_mesh():
    """As in the JAX package, the dense solver runs alone whatever mesh it
    is given."""
    _, odom, noisy, loops = _square_circuit(64, laps=2, seed=3)

    def graph():
        g = tpg.PoseGraph(device="cpu")
        for _ in odom:
            g.add_node()
        for k, nr in enumerate(noisy):
            g.add_between(k, k + 1, nr)
        for i, j, T in loops:
            g.add_between(i, j, T)
        return g

    mesh = multihost.Mesh(group=None, size=2, rank=0,
                          device=torch.device("cpu"))
    g1, g2 = graph(), graph()
    out1 = g1.optimize(np.stack(odom), num_iters=3, solver="dense")
    out2 = g2.optimize(np.stack(odom), num_iters=3, solver="dense",
                       mesh=mesh)
    np.testing.assert_array_equal(out1, out2)
    assert g1.last_chi2 == g2.last_chi2


def test_exact_quantile_matches_jax():
    """``align_pairs(exact_quantile=True)`` (the sorted-quantile trim)
    against the JAX package's, on four of stage A's pairs."""
    bs, bt, gs = _pairs()
    four = slice(0, 4)
    Ts_j, sc_j = jap.align_pairs(
        jax.tree.map(lambda x: x[four], bs), jax.tree.map(lambda x: x[four],
                                                          bt),
        gs[four], max_iteration=15, exact_quantile=True)
    src = interop.point_cloud({f: np.asarray(getattr(bs, f))[four]
                               for f in CLOUD}, "cpu")
    tgt = interop.normal_cloud({f: np.asarray(getattr(bt, f))[four]
                                for f in NORMALS}, "cpu")
    Ts_t, sc_t = tap.align_pairs(src, tgt, torch.from_numpy(
        np.array(gs)[four]), max_iteration=15, exact_quantile=True)
    np.testing.assert_allclose(Ts_t.numpy(), np.asarray(Ts_j), atol=1e-3)
    np.testing.assert_allclose(sc_t.numpy(), np.asarray(sc_j), atol=1e-3)
