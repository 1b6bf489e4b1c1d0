"""The launch plan of the 1-NN CUDA kernel (``staticmapping_torch.ops.
nn_search.plan``) and a torch emulation of the kernel's walk over it, on
the CPU.

The plan must cover the targets with its splits, in order, without gap or
overlap, fit CUDA's grid, and size the scratch as the kernel indexes it.
The emulation follows ``csrc/nn_search.cu`` step for step: per split a
running minimum over groups of ``GROUP`` targets of d' = d² − |q|², a strict
``<`` between groups, recovery of the first index in the best group, then
the merge of the splits in order with a strict ``<``.  On integer-grid
points every d' is exact, so ties are exact, and the emulation must give
``_nearest_plain``'s and the JAX package's ``_nearest_scan``'s index for
every query.  The kernel itself is held against the plain version on the
card by tests/test_torch_cuda.py.
"""
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from staticmapping_tpu.ops import nn_search as jnn
from staticmapping_torch.ops import nn_search as tnn

# (batch, queries, targets): the six shapes of bench.py:101-107, the main
# path's two (chip_smoke.MAIN_SHAPES), the variant bench's, ragged ones
SHAPES = [(1, 512, 4096), (1, 128, 128), (1, 1920, 2176),
          (1, 32768, 65536), (2, 2048, 4096), (2, 65536, 65536),
          (1, 32768, 4096), (16, 16384, 8192), (1, 16384, 2048),
          (1, 1, 1), (1, 3, 5), (3, 1001, 3003), (1, 100003, 777),
          (7, 999, 12345), (65535, 10, 10), (1, 700, 257)]
CUDA_GRID = (2**31 - 1, 65535, 65535)


def _splits(p, n):
    return [(s * p.split_len, min(n, (s + 1) * p.split_len))
            for s in range(p.splits)]


def _check_plan(p, b, m, n):
    assert (p.r, p.block) in tnn.INSTANCES
    assert p.block <= 1024 and p.block * tnn.PREFETCH % tnn.GROUP == 0
    assert p.split_len % tnn.GROUP == 0
    cuts = _splits(p, n)
    assert cuts[0][0] == 0 and cuts[-1][1] == n
    for (lo, hi), (lo2, _) in zip(cuts, cuts[1:]):
        assert hi == lo2                     # in order, no gap, no overlap
    assert all(hi > lo for lo, hi in cuts) or n == 0
    assert p.grid == (-(-m // (p.r * p.block)), p.splits, b)
    assert all(0 < g <= lim for g, lim in zip(p.grid, CUDA_GRID))
    # the queries a block covers reach M, and no block lies wholly past it
    assert p.grid[0] * p.r * p.block >= m > (p.grid[0] - 1) * p.r * p.block
    assert p.scratch == (p.splits * b * m if p.splits > 1 else 0)


@pytest.mark.parametrize("b,m,n", SHAPES)
def test_plan_covers_the_targets(b, m, n):
    p = tnn.plan(b, m, n)
    _check_plan(p, b, m, n)
    if p.splits > 1:
        assert all(hi - lo >= tnn.MIN_SPLIT for lo, hi in _splits(p, n))
        # splitting stops near WARPS_PER_SM warps per SM
        warps = p.grid[0] * b * p.block // 32
        assert warps * (p.splits - 1) < tnn.WARPS_PER_SM * tnn.H100_SMS


@pytest.mark.parametrize("b,m,n", SHAPES[:9])
@pytest.mark.parametrize("r,block", sorted(tnn.INSTANCES))
def test_every_instance_plans_the_sweep_shapes(b, m, n, r, block):
    _check_plan(tnn.plan(b, m, n, r, block), b, m, n)


def test_main_shapes_split_only_where_the_queries_do_not_fill_the_card():
    """Front-end ICP (32768 × 4096): 64 query tiles, so the targets split.
    Pair ICP (16 × 16384 × 8192): 512 query tiles, S = 1."""
    single = tnn.plan(1, 32768, 4096)
    batched = tnn.plan(16, 16384, 8192)
    assert single.splits > 1 and batched.splits == 1
    # fewer SMs ask for fewer splits
    assert tnn.plan(1, 32768, 4096, sms=66).splits < single.splits


@pytest.mark.parametrize("n,splits", [(12, 2), (20, 3), (33, 4), (100, 13),
                                      (5, 9)])
def test_forced_splits_leave_none_empty(n, splits):
    p = tnn.plan(1, 10, n, splits=splits)
    _check_plan(p, 1, 10, n)
    assert p.splits <= splits


def test_plan_refuses_what_has_no_instance():
    with pytest.raises(ValueError, match="instance"):
        tnn.plan(1, 8, 8, r=3)
    with pytest.raises(ValueError, match="splits"):
        tnn.plan(1, 8, 8, splits=0)


def test_constants_match_the_kernel_source():
    """GROUP, PREFETCH and the (R, block) instances are compile-time
    constants of csrc/nn_search.cu."""
    src = open(os.path.join(os.path.dirname(tnn.__file__), os.pardir,
                            "csrc", "nn_search.cu")).read()
    assert int(re.search(r"kGroup = (\d+);", src).group(1)) == tnn.GROUP
    assert (int(re.search(r"kPrefetch = (\d+);", src).group(1))
            == tnn.PREFETCH)
    cases = {(int(r), int(b)) for r, b in
             re.findall(r"NN_CASE\((\d+), (\d+)\)", src)}
    assert cases == tnn.INSTANCES


# ---------------------------------------------------------------------------
# the kernel's walk, emulated
# ---------------------------------------------------------------------------

def emulate(query, tgt, p):
    """``csrc/nn_search.cu`` under plan ``p`` in torch: ``query [B, M, 3]``,
    ``tgt [B, N, 3]`` (invalid rows already far away) → ``(d2, idx)``."""
    a = torch.cat([-2.0 * tgt, (tgt * tgt).sum(-1, keepdim=True)], -1)
    dp = (query[:, :, None, :] * a[:, None, :, :3]).sum(-1) + a[:, None, :, 3]
    b, m, n = dp.shape
    best_d = best_i = None
    for lo, hi in _splits(p, n):
        seg = dp[..., lo:hi]
        pad = -(hi - lo) % tnn.GROUP
        groups = torch.cat([seg, torch.full((b, m, pad), float("inf"))],
                           -1).reshape(b, m, -1, tnn.GROUP)
        gmin = groups.min(-1).values
        s_d = torch.full((b, m), float("inf"))
        s_g = torch.zeros((b, m), dtype=torch.long)
        for g in range(gmin.shape[-1]):          # strict '<' between groups
            take = gmin[..., g] < s_d
            s_d = torch.where(take, gmin[..., g], s_d)
            s_g = torch.where(take, g, s_g)
        # recovery: the first target of the best group whose d' is the best
        grp = torch.gather(groups, 2, s_g[..., None, None].expand(
            b, m, 1, tnn.GROUP))[..., 0, :]
        first = (grp == s_d[..., None]).int().argmax(-1)
        s_i = lo + s_g * tnn.GROUP + first
        if best_d is None:
            best_d, best_i = s_d, s_i
        else:                                    # the merge, split order
            take = s_d < best_d
            best_d = torch.where(take, s_d, best_d)
            best_i = torch.where(take, s_i, best_i)
    picked = torch.gather(tgt, 1, best_i[..., None].expand(b, m, 3))
    return ((query - picked) ** 2).sum(-1), best_i.to(torch.int32)


def _grid_problem(seed, b, m, n, span):
    """Integer-grid points with exact ties, duplicates straddling every
    group boundary, and some invalid targets."""
    rng = np.random.default_rng(seed)
    q = rng.integers(-span, span + 1, (b, m, 3)).astype(np.float32)
    t = rng.integers(-span, span + 1, (b, n, 3)).astype(np.float32)
    t[:, tnn.GROUP::tnn.GROUP] = t[:, tnn.GROUP - 1:-1:tnn.GROUP]
    mask = rng.uniform(size=(b, n)) > 0.1
    return q, t, mask


@pytest.mark.parametrize("b,m,n,plan_kw,tile", [
    (1, 300, 1000, {}, 200),                     # automatic: S > 1
    (2, 257, 777, {"splits": 1}, 111),
    (1, 129, 1000, {"splits": 3, "r": 2, "block": 256}, 125),
    (3, 64, 96, {"splits": 5}, 32),              # splits of a few groups
    (1, 3, 13, {"splits": 2, "r": 8, "block": 64}, 13),
    (1, 200, 2048, {"splits": 7}, 256),
])
def test_emulated_walk_equals_nearest_scan(b, m, n, plan_kw, tile):
    q, t, mask = _grid_problem(b * 1000 + n, b, m, n, span=4)
    p = tnn.plan(b, m, n, **plan_kw)
    if not plan_kw:
        assert p.splits > 1
    # ties across split boundaries too
    for lo, _ in _splits(p, n)[1:]:
        t[:, lo] = t[:, lo - 1]
        mask[:, lo] = mask[:, lo - 1] = True
    qt, tt, mt = (torch.from_numpy(x) for x in (q, t, mask))
    tgt = torch.where(mt[..., None], tt, torch.full_like(tt, tnn._FAR))
    d_e, i_e = emulate(qt, tgt, p)
    d_p, i_p = tnn._nearest_plain(qt, tgt, mt, tile=tile)
    np.testing.assert_array_equal(i_e.numpy(), i_p.numpy())
    np.testing.assert_array_equal(d_e.numpy(), d_p.numpy())
    for k in range(b):
        d_j, i_j = jnn._nearest_scan(jnp.asarray(q[k]), jnp.asarray(
            np.where(mask[k][:, None], t[k], tnn._FAR)), jnp.asarray(mask[k]),
            tile=tile)
        np.testing.assert_array_equal(i_e[k].numpy(), np.asarray(i_j))
        np.testing.assert_array_equal(d_e[k].numpy(), np.asarray(d_j))
