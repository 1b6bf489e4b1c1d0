"""The launch plan of the NN-variant CUDA kernel (``staticmapping_torch.
ops.nn_variants.plan``) and a torch emulation of the kernel's walk over it,
on the CPU.

The plan must cover the targets with at most MAX_SPLITS splits, in order,
without gap, overlap or an empty split, and fit CUDA's grid.  The emulation
follows ``csrc/nn_variants.cu`` step for step: each warp's row loop (the
fewest leading rows, 3, 5 or 8, outside which its queries are zero), per
split a running minimum over groups of ``GROUP`` targets of the reduced
value (K3: d² − |q|²; K4: d²), the group's rank value (K3 adds |q|² once
per group; the packed forms clamp at 0 and clear the low ``idx_bits``
bits), a strict ``<`` between groups, recovery of the first column of the
best group whose own rank value equals the best, then the splits merged in
order with a strict ``<``.  Whether the best group is re-read from shared
or device memory does not change a value, so it is not emulated.  On
integer-grid operands every sum is exact in f32, so the emulation must give
``_plain``'s d and index bit for bit, for all three forms, through exact
ties of the truncated value across group and split boundaries and d² ≤ 0
clamped to 0.  The kernel itself is held against the plain version on the
card by tests/test_torch_cuda.py.
"""
import os
import re

import numpy as np
import pytest
import torch

from staticmapping_torch.ops import nn_search as tnn
from staticmapping_torch.ops import nn_variants as tnv

VARIANTS = ["packed", "aug_packed", "aug"]
# (queries, targets): the bench's, ragged and tiny ones
SHAPES = [(16384, 2048), (1, 1), (3, 5), (1001, 3003), (100003, 777),
          (700, 257), (64, 16), (4096, 2048), (2, 2**20)]
CUDA_GRID = (2**31 - 1, 65535)


def _splits(p, n):
    return [(s * p.split_len, min(n, (s + 1) * p.split_len))
            for s in range(p.splits)]


def _check_plan(p, m, n):
    assert (p.r, p.block) in tnv.INSTANCES
    assert p.block % 32 == 0 and p.block * tnv.PREFETCH % tnv.GROUP == 0
    assert 1 <= p.splits <= tnv.MAX_SPLITS
    assert p.split_len % tnv.GROUP == 0
    cuts = _splits(p, n)
    assert cuts[0][0] == 0 and cuts[-1][1] == n
    for (lo, hi), (lo2, _) in zip(cuts, cuts[1:]):
        assert hi == lo2                     # in order, no gap, no overlap
    assert all(hi > lo for lo, hi in cuts)   # no empty split
    assert p.grid == (-(-m // (p.r * p.block)), p.splits)
    assert all(0 < g <= lim for g, lim in zip(p.grid, CUDA_GRID))
    assert p.grid[0] * p.r * p.block >= m > (p.grid[0] - 1) * p.r * p.block


@pytest.mark.parametrize("m,n", SHAPES)
@pytest.mark.parametrize("r,block", sorted(tnv.INSTANCES))
def test_plan_covers_the_targets(m, n, r, block):
    p = tnv.plan(m, n, r, block)
    _check_plan(p, m, n)
    if p.splits > 1:
        assert all(hi - lo >= tnn.MIN_SPLIT for lo, hi in _splits(p, n))


def test_bench_shape_splits_up_to_the_cap():
    """16384 × 2048 at R = 2, block 256: 32 query tiles want about 8 splits
    for 16 warps an SM, and 2048 targets allow 8 of 256."""
    p = tnv.plan(16384, 2048)
    assert p == tnv.VariantPlan(2, 256, 8, 256, (32, 8))
    # the cap holds where the card would want more splits
    assert tnv.plan(1024, 2**20).splits == tnv.MAX_SPLITS
    assert tnv.plan(16384, 2048, sms=66).splits < p.splits


def test_k1_and_k2_plans_are_unchanged():
    """The split rule shared with the K1 kernel's plan still gives K1 and
    K2 their measured plans at the main path's shapes."""
    assert tnn.plan(1, 32768, 4096) == tnn.NNPlan(
        2, 256, 4, 1024, (64, 4, 1), 4 * 32768)
    assert tnn.plan(16, 16384, 8192) == tnn.NNPlan(
        2, 256, 1, 8192, (32, 1, 16), 0)


@pytest.mark.parametrize("n,splits", [(12, 2), (20, 3), (33, 4), (100, 7),
                                      (5, 8), (2048, 1), (2048, 8)])
def test_forced_splits_leave_none_empty(n, splits):
    p = tnv.plan(10, n, splits=splits)
    _check_plan(p, 10, n)
    assert p.splits <= splits


def test_plan_refuses_what_has_no_instance_or_merge():
    with pytest.raises(ValueError, match="instance"):
        tnv.plan(8, 8, r=3)
    with pytest.raises(ValueError, match="merge"):
        tnv.plan(8, 4096, splits=tnv.MAX_SPLITS + 1)
    with pytest.raises(ValueError, match="splits"):
        tnv.plan(8, 8, splits=0)


def test_constants_match_the_kernel_source():
    """GROUP, PREFETCH, MAX_SPLITS and the (R, block) instances are
    compile-time constants of csrc/nn_variants.cu."""
    src = open(os.path.join(os.path.dirname(tnv.__file__), os.pardir,
                            "csrc", "nn_variants.cu")).read()
    assert int(re.search(r"kGroup = (\d+);", src).group(1)) == tnv.GROUP
    assert (int(re.search(r"kPrefetch = (\d+);", src).group(1))
            == tnv.PREFETCH)
    assert (int(re.search(r"kMaxSplits = (\d+);", src).group(1))
            == tnv.MAX_SPLITS)
    cases = {(int(r), int(b)) for r, b in
             re.findall(r"NV_CASE\((\d+), (\d+)\)", src)}
    assert cases == tnv.INSTANCES
    assert tnv.GROUP == tnn.GROUP            # the split rule's granule


# ---------------------------------------------------------------------------
# the kernel's walk, emulated
# ---------------------------------------------------------------------------

def _warp_rows(q, p):
    """The row loop of each query's warp: 8 if a query of the warp has a
    nonzero row past 5, else 5 if one has a nonzero row 3 or 4, else 3."""
    m = q.shape[0]
    need = torch.full((m,), 3)
    need[(q[:, 3:5] != 0).any(1)] = 5
    need[(q[:, 5:] != 0).any(1)] = 8
    qi = torch.arange(m)
    per_tile = p.r * p.block
    # thread tx of tile k holds queries k * R * block + r * block + tx
    warp = (qi // per_tile) * (p.block // 32) + (qi % p.block) // 32
    rows = torch.zeros(int(warp.max()) + 1, dtype=torch.long)
    rows = rows.scatter_reduce(0, warp, need, "amax")
    return rows[warp]


def _rank(variant, x, q2, low):
    """The rank value of reduced values ``x``: K3 adds |q|²; the packed
    forms clamp at 0 and clear the low bits (as ints, so −0 becomes +0)."""
    if variant == "packed":
        x = x + q2
    if variant != "aug":
        bits = torch.clamp_min(x.contiguous().view(torch.int32), 0) & ~low
        x = bits.view(torch.float32)
    return x


def emulate(variant, q8t, t8t, idx_bits, p):
    """``csrc/nn_variants.cu`` under plan ``p`` in torch, on ``[8, M]`` /
    ``[8, N]`` f32 operands whose every sum is exact in f32."""
    q, t = q8t.T.double(), t8t.T.double()                 # [M, 8], [N, 8]
    m, n = q.shape[0], t.shape[0]
    low = (1 << idx_bits) - 1
    rows = _warp_rows(q, p)
    tv = -2.0 * t if variant == "packed" else t
    vals = torch.empty((m, n), dtype=torch.float64)
    for k in (3, 5, 8):                  # each warp's loop: its rows only
        sel = rows == k
        vals[sel] = q[sel, :k] @ tv[:, :k].T
    if variant == "packed":
        vals += (t * t).sum(1)[None]                      # |t|² over 8 rows
    vals = vals.float()
    q2 = (q * q).sum(1).float()[:, None]
    best_v = best_i = None
    for lo, hi in _splits(p, n):
        seg = vals[:, lo:hi]
        pad = -(hi - lo) % tnv.GROUP
        groups = torch.cat([seg, torch.full((m, pad), float("inf"))],
                           1).reshape(m, -1, tnv.GROUP)
        g_rank = _rank(variant, groups.min(-1).values, q2, low)
        s_v = torch.full((m,), float("inf"))
        s_g = torch.zeros((m,), dtype=torch.long)
        for g in range(g_rank.shape[1]):             # strict '<' in order
            take = g_rank[:, g] < s_v
            s_v = torch.where(take, g_rank[:, g], s_v)
            s_g = torch.where(take, g, s_g)
        # recovery: the first column of the best group whose own rank
        # value is the best (the padding never is: it is past the split)
        grp = torch.gather(groups, 1, s_g[:, None, None].expand(
            m, 1, tnv.GROUP))[:, 0, :]
        col = lo + s_g[:, None] * tnv.GROUP + torch.arange(tnv.GROUP)
        hit = (_rank(variant, grp, q2, low) == s_v[:, None]) & (col < hi)
        s_i = lo + s_g * tnv.GROUP + hit.int().argmax(1)
        if best_v is None:
            best_v, best_i = s_v, s_i
        else:                                   # the merge, split order
            take = s_v < best_v
            best_v = torch.where(take, s_v, best_v)
            best_i = torch.where(take, s_i, best_i)
    if variant == "aug":
        best_v = torch.clamp_min(best_v, 0.0)
    return best_v, best_i.to(torch.int32)


def _grid_operands(variant, layout, seed, m, n, span, cuts):
    """Integer-grid ``[8, M]`` / ``[8, N]`` operands.  ``points``: the
    variant's own layout (pad8 for K3, aug_q / aug_t for K4) of points in
    ±span; ``rows8``: every row an integer in ±span (the 8-row loop, and
    for K4 many d² < 0); ``mixed``: rows8 with rows 3-7 of a third of the
    queries and rows 5-7 of another third zeroed, so that warps take all
    three loops.  At every cut c, targets c − 1 and c are equal and query k
    (one per cut) has its least d² there: an exact tie across the
    boundary."""
    rng = np.random.default_rng(seed)
    if layout == "points":
        q = rng.integers(-span, span + 1, (m, 3)).astype(np.float32)
        t = rng.integers(-span, span + 1, (n, 3)).astype(np.float32)
        for k, c in enumerate(cuts[:m]):
            t[c] = q[k] = t[c - 1]                       # d² = 0 at both
        q, t = torch.from_numpy(q), torch.from_numpy(t)
        if variant == "packed":
            return tnv.pad8(q), tnv.pad8(t)
        return tnv.aug_q(q), tnv.aug_t(t)
    q8 = rng.integers(-span, span + 1, (8, m)).astype(np.float32)
    t8 = rng.integers(-span, span + 1, (8, n)).astype(np.float32)
    if layout == "mixed":
        q8[3:, :m // 3] = 0                   # the 3-row loop
        q8[5:, m // 3:2 * m // 3] = 0         # the 5-row loop
    for k, c in enumerate(cuts[:m]):
        # K3: d² = |q − t|² = 0; K4: d² = q·t = −10 |q|², far below the rest
        t8[:, c - 1] = t8[:, c] = q8[:, k] * (1 if variant == "packed"
                                              else -10)
    return torch.from_numpy(q8), torch.from_numpy(t8)


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("layout,m,n,idx_bits,plan_kw,span", [
    ("points", 300, 2048, 11, {}, 60),            # N = 2^11: S = 8
    ("points", 200, 3000, 20, {"splits": 3, "r": 4, "block": 64}, 60),
    ("points", 129, 1000, 11, {"splits": 1, "r": 2, "block": 128}, 8),
    ("points", 70, 16, 4, {"splits": 1}, 3),      # N = 2^4
    ("rows8", 300, 1500, 20, {}, 6),
    ("rows8", 257, 777, 11, {"splits": 5, "r": 4, "block": 128}, 6),
    ("mixed", 700, 2048, 11, {"splits": 8, "r": 2, "block": 128}, 5),
    ("mixed", 600, 600, 20, {"splits": 2, "r": 4, "block": 64}, 40),
])
def test_emulated_walk_equals_plain(variant, layout, m, n, idx_bits,
                                    plan_kw, span):
    p = tnv.plan(m, n, **plan_kw)
    if not plan_kw:
        assert p.splits > 1
    cuts = sorted({lo for lo, _ in _splits(p, n)[1:]}
                  | set(range(tnv.GROUP, n, tnv.GROUP * 9))) or [n // 2]
    q8t, t8t = _grid_operands(variant, layout, m * 7 + n, m, n, span, cuts)
    d_e, i_e = emulate(variant, q8t, t8t, idx_bits, p)
    d_p, i_p = tnv._plain(variant, q8t, t8t, idx_bits)
    np.testing.assert_array_equal(i_e.numpy(), i_p.numpy())
    np.testing.assert_array_equal(d_e.numpy().view(np.int32),
                                  d_p.numpy().view(np.int32))
    # the inputs carry what the rule must get right: ties of the rank value
    # (at 0 where d² ≤ 0 clamps) between distinct columns
    q, t = q8t.T.double(), t8t.T.double()
    if variant == "packed":
        d2 = ((q * q).sum(1)[:, None] + (t * t).sum(1)[None]
              - 2 * q @ t.T).float()
    else:
        d2 = (q @ t.T).float()
    low = (1 << idx_bits) - 1
    key = (torch.clamp_min(d2, 0.0).view(torch.int32) & ~low
           if variant != "aug" else d2.view(torch.int32))
    best = key.gather(1, i_p.long()[:, None])
    assert ((key == best).sum(1) > 1).any()
    if variant == "aug_packed" and layout != "points":
        assert (d_p == 0).float().mean() > 0.5       # d² ≤ 0 clamps to 0


@pytest.mark.parametrize("variant", VARIANTS)
def test_every_plan_and_row_loop_gives_one_answer(variant):
    """The value of a pair does not depend on the plan, nor (for finite
    operands) on which row loop its warp takes: every plan's emulation is
    the same, bit for bit, on mixed-row operands."""
    m, n = 1000, 2048
    q8t, t8t = _grid_operands(variant, "mixed", 5, m, n, 7, [16, 1024])
    ref = None
    for r, block in sorted(tnv.INSTANCES):
        for splits in (1, 3, 8):
            d, i = emulate(variant, q8t, t8t, 11,
                           tnv.plan(m, n, r, block, splits))
            if ref is None:
                ref = d, i
            np.testing.assert_array_equal(d.numpy(), ref[0].numpy())
            np.testing.assert_array_equal(i.numpy(), ref[1].numpy())
