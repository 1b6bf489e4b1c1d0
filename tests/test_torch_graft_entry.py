"""The port's driver entry points (``staticmapping_torch/graft_entry.py``)
against the repository's ``__graft_entry__.py`` on the CPU: ``entry()``'s
ICP forward step on the same drawn pair, and ``dryrun_multichip(2)`` over
two gloo ranks against the JAX package's dry run on two of the virtual
devices of tests/conftest.py."""
import importlib

import jax
import numpy as np
import pytest

import __graft_entry__ as jentry
from staticmapping_tpu.backend import pose_graph as jpg
from staticmapping_torch import graft_entry

from scripts.main_path import transform_gap

# the module, not the function of the same name that the package exports
jalign = importlib.import_module("staticmapping_tpu.parallel.align_pairs")

CPU = "cpu"
RANKS = 2
# the port against the JAX package: entry()'s T (m, rad) and score; the
# dry run's largest error to the known transforms (m), each pair's
# translation (m: 30 f32 ICP trips from the identity part the packages by
# 1.3 mm on this CPU) and χ² (relative)
ENTRY_T_TOL = (1e-3, 1e-3)
ENTRY_SCORE_TOL = 1e-3
DRYRUN_T_TOL_M = 1e-3
DRYRUN_PAIR_TOL_M = 2e-3
DRYRUN_CHI2_REL = 0.1


def test_entry_matches_jax():
    fn_j, args_j = jentry.entry()
    T_j, s_j = jax.jit(fn_j)(*args_j)
    fn_t, args_t = graft_entry.entry(device=CPU)
    T_t, s_t = fn_t(*args_t)
    dt, dr = transform_gap(T_t.double().numpy(), np.asarray(T_j))
    assert dt <= ENTRY_T_TOL[0] and dr <= ENTRY_T_TOL[1], (dt, dr)
    assert abs(float(s_t) - float(s_j)) <= ENTRY_SCORE_TOL


def test_example_pair_matches_jax():
    """The port draws ``_example_pair``'s points and builds its normals as
    the JAX package does."""
    src_j, tgt_j = jentry._example_pair(seed=3)
    src_t, tgt_t = graft_entry.example_pair(seed=3, device=CPU)
    np.testing.assert_array_equal(src_t.xyz.numpy(), np.asarray(src_j.xyz))
    np.testing.assert_array_equal(tgt_t.mask.numpy(), np.asarray(tgt_j.mask))
    np.testing.assert_allclose(tgt_t.xyz.numpy(), np.asarray(tgt_j.xyz),
                               atol=1e-5)


@pytest.fixture(scope="module")
def dryruns():
    """Both dry runs at two devices; the JAX run's sharded transforms and
    final χ² are recorded on the way."""
    port = graft_entry.dryrun_multichip(RANKS, device=CPU)
    rec = {}
    sharded, optimize = jalign.align_pairs_sharded, jpg.PoseGraph.optimize

    def recorded_align(*args, **kwargs):
        out = sharded(*args, **kwargs)
        rec["Ts"] = np.asarray(out[0], dtype=np.float64)
        return out

    def recorded_optimize(self, *args, **kwargs):
        out = optimize(self, *args, **kwargs)
        rec["chi2"] = float(self.last_chi2)
        return out
    jalign.align_pairs_sharded = recorded_align
    jpg.PoseGraph.optimize = recorded_optimize
    try:
        jentry.dryrun_multichip(RANKS)
    finally:
        jalign.align_pairs_sharded = sharded
        jpg.PoseGraph.optimize = optimize
    return port, rec


def test_dryrun_transforms_match_jax(dryruns):
    """The largest error to the known transforms within DRYRUN_T_TOL_M of
    the JAX run's, each sharded registration's translation within
    DRYRUN_PAIR_TOL_M."""
    port, jax_run = dryruns
    (_, _, _), gt_T, _ = graft_entry.registration_inputs(RANKS, CPU)
    assert port["pairs"] == len(jax_run["Ts"]) == 2 * RANKS
    gap = np.abs(port["Ts"][:, :3, 3] - jax_run["Ts"][:, :3, 3]).max()
    assert gap <= DRYRUN_PAIR_TOL_M, gap
    jax_err = np.linalg.norm(jax_run["Ts"][:, :3, 3] - gt_T[:, :3, 3],
                             axis=1).max()
    assert abs(port["max_t_err_m"] - jax_err) <= DRYRUN_T_TOL_M


def test_dryrun_chi2_matches_jax(dryruns):
    port, jax_run = dryruns
    assert abs(port["chi2"] - jax_run["chi2"]) <= (DRYRUN_CHI2_REL
                                                   * jax_run["chi2"])


def test_dryrun_holds_the_jax_asserts(dryruns):
    port, _ = dryruns
    assert port["ranks"] == RANKS and port["backend"] == "gloo"
    assert port["max_t_err_m"] < graft_entry.MAX_T_ERR_M
    assert port["mean_score"] >= graft_entry.MIN_MEAN_SCORE
    assert port["sharded_t_gap"] < graft_entry.MAX_SHARDED_GAP
    assert port["chi2"] < graft_entry.MAX_CHI2
