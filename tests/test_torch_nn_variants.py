"""Parity of the port's NN-kernel variants (staticmapping_torch.ops.
nn_variants: K3 ``nearest_packed`` and K4 ``nearest_aug``, both modes) with
the Pallas kernel bodies of ``tools/bench_nn_variants.py`` run in interpret
mode on the CPU.  The CUDA kernel is held against the plain version in
tests/test_torch_cuda.py."""
import importlib.util
import os
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from staticmapping_torch.ops import nn_variants as tnv

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
M, N = 1024, 2048          # about the bench's width: 2048 targets, 11 bits
IDX_BITS = 11


@pytest.fixture(scope="module")
def bench():
    """``tools/bench_nn_variants.py`` (``tools/`` is not a package)."""
    spec = importlib.util.spec_from_file_location(
        "bench_nn_variants", os.path.join(ROOT, "tools",
                                          "bench_nn_variants.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def points():
    rng = np.random.default_rng(21)
    q = rng.uniform(-30, 30, (M, 3)).astype(np.float32)
    t = rng.uniform(-30, 30, (N, 3)).astype(np.float32)
    return q, t


def _interpret(body, q8t, t8t):
    """A bench kernel body through ``pl.pallas_call(interpret=True)`` with
    the bench's output layout."""
    m = q8t.shape[1]
    d, i = pl.pallas_call(
        body,
        out_shape=[jax.ShapeDtypeStruct((m // 128, 128), jnp.float32),
                   jax.ShapeDtypeStruct((m // 128, 128), jnp.int32)],
        interpret=True,
    )(jnp.asarray(q8t), jnp.asarray(t8t))
    return np.asarray(d).reshape(m), np.asarray(i).reshape(m)


def _operands(variant, q, t):
    """(numpy [8, M], numpy [8, N]) operands of the variant, built by the
    port's layout helpers (checked against the bench's below)."""
    qt, tt = torch.from_numpy(q), torch.from_numpy(t)
    if variant == "packed":
        return tnv.pad8(qt).numpy(), tnv.pad8(tt).numpy()
    return tnv.aug_q(qt).numpy(), tnv.aug_t(tt).numpy()


def _cancel_floor(q, t):
    """Absolute d² tolerance between two f32 evaluations of |q|² + |t|² −
    2 q·t in different orders: a few ulps of the largest |q|² + |t|²
    (4 ulps, as tests/test_torch_nn_search.py measured for the same
    expansion)."""
    mag = float((q.astype(np.float64) ** 2).sum(-1).max()
                + (t.astype(np.float64) ** 2).sum(-1).max())
    return 4 * np.finfo(np.float32).eps * mag


def _near_tie_ok(q, t, d, idx):
    """bench.py:45-77: at most 0.1% of picks more than 5 cm beyond the
    true nearest target, and d within rtol 2e-2 / atol 5e-2 of the picked
    target's exact d²."""
    q64, t64 = q.astype(np.float64), t.astype(np.float64)
    full = ((q64[:, None, :] - t64[None]) ** 2).sum(-1)
    d_picked = full[np.arange(len(q)), idx]
    excess = np.sqrt(d_picked) - np.sqrt(full.min(1))
    assert np.mean(excess > 0.05) <= 1e-3
    np.testing.assert_allclose(d, d_picked, rtol=2e-2, atol=5e-2)


def test_layouts_match_the_bench(bench, points):
    q, t = points
    np.testing.assert_array_equal(
        tnv.aug_q(torch.from_numpy(q)).numpy(), np.asarray(bench._aug_q(q)))
    np.testing.assert_array_equal(
        tnv.aug_t(torch.from_numpy(t)).numpy(), np.asarray(bench._aug_t(t)))
    np.testing.assert_array_equal(
        tnv.pad8(torch.from_numpy(q)).numpy(),
        np.asarray(bench.nn_search._pad8(jnp.asarray(q))))


@pytest.mark.parametrize("variant", ["packed", "aug_packed", "aug"])
def test_plain_matches_tpu_kernel_interpreted(bench, points, variant):
    """The plain version and the TPU kernel body on the same operands:
    indices agree for ≥ 99.9% of queries and both meet the near-tie
    contract.  d is held to the expansion's f32 cancellation floor plus, for
    the packed forms, one step of the 11-bit truncation (2^-12 of d²
    relative): two roundings of d² one ulp apart can truncate to
    neighbouring steps."""
    q, t = points
    q8t, t8t = _operands(variant, q, t)
    if variant == "packed":
        body = partial(bench._nn_kernel_packed, 512, N, IDX_BITS)
        d_t, i_t = tnv.nearest_packed(torch.from_numpy(q8t),
                                      torch.from_numpy(t8t), IDX_BITS)
    else:
        packed = variant == "aug_packed"
        body = partial(bench._nn_kernel_aug, 512, N, packed)
        d_t, i_t = tnv.nearest_aug(torch.from_numpy(q8t),
                                   torch.from_numpy(t8t), packed)
    d_k, i_k = _interpret(body, q8t, t8t)
    d_t, i_t = d_t.numpy(), i_t.numpy()
    assert d_t.dtype == np.float32 and i_t.dtype == np.int32
    assert np.mean(i_t == i_k) >= 0.999
    _near_tie_ok(q, t, d_t, i_t)
    _near_tie_ok(q, t, d_k, i_k)
    trunc = 2.0 ** -(23 - IDX_BITS) if variant != "aug" else 0.0
    same = i_t == i_k
    np.testing.assert_allclose(d_t[same], d_k[same], rtol=trunc,
                               atol=_cancel_floor(q, t))
    if variant != "aug":
        # the packed d is the truncated d²: its low bits are clear
        bits = d_t.view(np.int32)
        assert not (bits & ((1 << IDX_BITS) - 1)).any()


def test_packed_ties_go_to_the_lowest_index():
    """Duplicated targets give equal d², hence equal truncated keys: the
    lowest column wins, in the plain version as in the TPU kernel."""
    rng = np.random.default_rng(22)
    base = rng.uniform(-5, 5, (16, 3)).astype(np.float32)
    t = np.concatenate([base] * 8)                   # 128 targets
    q = base[rng.integers(0, 16, 256)]
    qt, tt = torch.from_numpy(q), torch.from_numpy(t)
    want = np.array([np.flatnonzero((base == p).all(1))[0] for p in q])
    for d, i in (tnv.nearest_packed(tnv.pad8(qt), tnv.pad8(tt)),
                 tnv.nearest_aug(tnv.aug_q(qt), tnv.aug_t(tt), True),
                 tnv.nearest_aug(tnv.aug_q(qt), tnv.aug_t(tt), False)):
        np.testing.assert_array_equal(i.numpy(), want)


@pytest.mark.parametrize("variant", ["packed", "aug_packed"])
def test_packed_forms_refuse_targets_beyond_the_index_bits(variant):
    """The packed key holds ``idx_bits`` index bits: 2^idx_bits targets
    fit, one more would wrap the index, and the wrapper refuses it (the TPU
    kernels say nothing there).  The two-reduction form has no limit."""
    q = torch.zeros((8, 128))
    fits, wraps = torch.zeros((8, 2048)), torch.zeros((8, 2049))
    if variant == "packed":
        tnv.nearest_packed(q, fits, 11)
        tnv.nearest_packed(q, torch.zeros((8, 16)), 4)
        with pytest.raises(ValueError, match="index bits"):
            tnv.nearest_packed(q, wraps, 11)
        with pytest.raises(ValueError, match="index bits"):
            tnv.nearest_packed(q, torch.zeros((8, 17)), 4)
    else:
        tnv.nearest_aug(q, fits, True)
        with pytest.raises(ValueError, match="index bits"):
            tnv.nearest_aug(q, wraps, True)
    d, i = tnv.nearest_aug(q, wraps, False)
    assert d.shape == (128,) and i.dtype == torch.int32


@pytest.mark.parametrize("variant", ["packed", "aug_packed", "aug"])
def test_plain_matches_tpu_kernel_on_general_rows(bench, variant):
    """Operands whose rows 3-7 are not zero (the kernel's 8-row loop): the
    plain version and the TPU kernel body, interpreted, on the same
    operands.  Indices agree for ≥ 99.9% of queries; d to the f32 error of
    the contraction at these magnitudes plus one truncation step."""
    rng = np.random.default_rng(23)
    m, n = 256, 512
    q8t = rng.uniform(-3, 3, (8, m)).astype(np.float32)
    t8t = rng.uniform(-3, 3, (8, n)).astype(np.float32)
    qt, tt = torch.from_numpy(q8t), torch.from_numpy(t8t)
    if variant == "packed":
        body = partial(bench._nn_kernel_packed, 256, n, IDX_BITS)
        d_t, i_t = tnv.nearest_packed(qt, tt, IDX_BITS)
    else:
        packed = variant == "aug_packed"
        body = partial(bench._nn_kernel_aug, 256, n, packed)
        d_t, i_t = tnv.nearest_aug(qt, tt, packed)
    d_k, i_k = _interpret(body, q8t, t8t)
    d_t, i_t = d_t.numpy(), i_t.numpy()
    assert np.mean(i_t == i_k) >= 0.999
    if variant == "aug":
        assert (d_t == 0).mean() > 0.5          # d² < 0 clamped, as the TPU
    trunc = 2.0 ** -(23 - IDX_BITS) if variant != "aug" else 0.0
    same = i_t == i_k
    np.testing.assert_allclose(d_t[same], d_k[same], rtol=trunc, atol=1e-4)


def test_cuda_wrapper_refuses_host_tensors():
    q = torch.zeros((8, 128))
    with pytest.raises(ValueError, match="CUDA"):
        tnv._cuda("packed", q, q, 11)
    with pytest.raises(ValueError, match="CUDA"):
        tnv._cuda("aug", q, q, 11, tnv.plan(128, 128))
