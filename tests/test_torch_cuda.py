"""The port's CUDA kernels, the MRVM's device reduction and the port's
paths on a GPU.

Every test here needs a CUDA device and skips without one.  The file
imports neither JAX nor the JAX package, so it also runs where only the
port's dependencies are installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""
import os

import numpy as np
import pytest
import torch

from staticmapping_torch.ops import nn_search as tnn

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    """The first CUDA device; skips the test where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the CUDA kernel runs only on a GPU")
    return torch.device("cuda")


def _problem(rng, lead, m, n, n_invalid):
    q = rng.uniform(-20, 20, lead + (m, 3)).astype(np.float32)
    t = rng.uniform(-20, 20, lead + (n, 3)).astype(np.float32)
    mask = np.ones(lead + (n,), dtype=bool)
    mask[..., n - n_invalid:] = False
    return q, t, mask


def _both(q, t, mask, device):
    """(kernel, plain) results of ``nearest_1`` on the same inputs."""
    d_k, i_k = tnn.nearest_1(*(torch.from_numpy(x).to(device)
                               for x in (q, t, mask)))
    torch.cuda.synchronize()
    d_p, i_p = tnn.nearest_1(*(torch.from_numpy(x) for x in (q, t, mask)))
    return d_k.cpu().numpy(), i_k.cpu().numpy(), d_p.numpy(), i_p.numpy()


@pytest.mark.parametrize("lead", [(), (3,)])
def test_kernel_matches_plain(cuda_device, lead):
    """Ragged M and N (no multiple of 128) with invalid targets: the
    kernel's FP32 difference form and the plain expansion pick the same
    target for nearly every query; d² agrees to the expansion's f32 error at
    20 m coordinates."""
    rng = np.random.default_rng(16)
    q, t, mask = _problem(rng, lead, 1000, 3001, 77)
    entry = "batched" if lead else "single"
    before = tnn.launches[entry]
    d_k, i_k, d_p, i_p = _both(q, t, mask, cuda_device)
    assert tnn.launches[entry] == before + 1
    assert d_k.shape == d_p.shape and i_k.dtype == np.int32
    assert np.mean(i_k == i_p) >= 0.999
    np.testing.assert_allclose(d_k, d_p, atol=5e-2)
    assert (i_k < 3001 - 77).all()                   # a valid target


@pytest.mark.parametrize("broadcast", ["query", "target"])
def test_kernel_broadcasts_an_unbatched_operand(cuda_device, broadcast):
    rng = np.random.default_rng(17)
    q, t, mask = _problem(rng, (3,), 300, 700, 50)
    if broadcast == "query":
        q = q[0]
    else:
        t, mask = t[0], mask[0]
    d_k, i_k, d_p, i_p = _both(q, t, mask, cuda_device)
    assert d_k.shape == (3, 300)
    assert np.mean(i_k == i_p) >= 0.999
    np.testing.assert_allclose(d_k, d_p, atol=5e-2)


def test_kernel_ties_go_to_the_lowest_index(cuda_device):
    """Duplicated targets across tiles and column groups: the lowest index
    wins, as in the JAX package's ``_nearest_scan``."""
    rng = np.random.default_rng(18)
    base = rng.uniform(-5, 5, (50, 3)).astype(np.float32)
    t = np.concatenate([base] * 100)                 # 5000 targets
    mask = np.ones(len(t), dtype=bool)
    mask[:50] = False                                # first copy invalid
    q = base[rng.integers(0, 50, 400)]
    d_k, i_k, _, i_p = _both(q, t, mask, cuda_device)
    want = np.array([50 + np.flatnonzero((base == p).all(1))[0] for p in q])
    np.testing.assert_array_equal(i_k, want)
    np.testing.assert_array_equal(i_p, want)
    np.testing.assert_array_equal(d_k, 0.0)


def test_kernel_single_query_and_target(cuda_device):
    q = np.array([[1.0, 2.0, 3.0]], np.float32)
    t = np.array([[1.0, 2.0, 5.0]], np.float32)
    d_k, i_k, _, _ = _both(q, t, np.ones(1, bool), cuda_device)
    assert i_k.tolist() == [0]
    np.testing.assert_allclose(d_k, [4.0])


def _grid_problem(rng, lead, m, n, span=3):
    """Integer-grid points in [-span, span]: every d² is exact in f32, so
    ties are exact and the kernel must pick the plain version's index."""
    q = rng.integers(-span, span + 1, lead + (m, 3)).astype(np.float32)
    t = rng.integers(-span, span + 1, lead + (n, 3)).astype(np.float32)
    return q, t, np.ones(lead + (n,), dtype=bool)


def _kernel_with(q, t, mask, device, launch):
    """``nearest_1``'s masking, then ``_nearest_cuda`` under ``launch``."""
    qd, td, md = (torch.from_numpy(x).to(device) for x in (q, t, mask))
    tgt = torch.where(md[..., None], td, torch.full_like(td, tnn._FAR))
    d, i = tnn._nearest_cuda(qd.contiguous(), tgt.contiguous(), launch)
    torch.cuda.synchronize()
    return d.cpu().numpy(), i.cpu().numpy()


def _plain(q, t, mask):
    d, i = tnn.nearest_1(*(torch.from_numpy(x) for x in (q, t, mask)))
    return d.numpy(), i.numpy()


@pytest.mark.parametrize("r,block,splits", [
    (4, 128, 1), (4, 128, 3), (2, 256, 5), (8, 64, 7), (8, 256, 2)])
def test_kernel_ties_straddle_groups_and_splits(cuda_device, r, block,
                                                splits):
    """Exact ties placed on both sides of every group boundary and every
    split boundary: the lowest index wins, as in ``_nearest_scan``."""
    rng = np.random.default_rng(23)
    m, n = 700, 2000
    q, t, mask = _grid_problem(rng, (), m, n, span=6)
    launch = tnn.plan(1, m, n, r, block, splits)
    assert launch.splits == splits
    cuts = sorted({s * launch.split_len for s in range(1, splits)}
                  | set(range(tnn.GROUP, n, tnn.GROUP * 25)))
    for k, c in enumerate(cuts):    # t[c - 1] == t[c], off the grid, unique
        t[c - 1] = t[c] = (7 + k, 7, 7)
    q[:len(cuts)] = t[cuts]         # a query on each duplicate
    mask[:3] = False
    d_k, i_k = _kernel_with(q, t, mask, cuda_device, launch)
    d_p, i_p = _plain(q, t, mask)
    np.testing.assert_array_equal(i_k, i_p)
    np.testing.assert_array_equal(d_k, d_p)
    np.testing.assert_array_equal(i_k[:len(cuts)], np.array(cuts) - 1)
    np.testing.assert_array_equal(d_k[:len(cuts)], 0.0)


@pytest.mark.parametrize("lead,m,n,want_split", [
    ((), 4096, 8192, True),            # 8 query tiles: the targets split
    ((), 300, 3000, True),
    ((64,), 4096, 600, False),         # 512 blocks already fill the card
    ((2,), 1000, 500, False),          # too few targets to split
])
def test_kernel_plan_splits_or_not(cuda_device, lead, m, n, want_split):
    """The automatic plan at shapes that split the targets and at shapes
    that do not, against the plain version."""
    rng = np.random.default_rng(24)
    q, t, mask = _problem(rng, lead, m, n, n // 10)
    launch = tnn.plan(lead[0] if lead else 1, m, n,
                      sms=tnn._sm_count(cuda_device))
    assert (launch.splits > 1) == want_split
    d_k, i_k, d_p, i_p = _both(q, t, mask, cuda_device)
    assert np.mean(i_k == i_p) >= 0.999
    np.testing.assert_allclose(d_k, d_p, atol=5e-2)


@pytest.mark.parametrize("m,n,splits", [
    (1, 1, None), (3, 5, None), (2, 7, 1), (3, 12, 2), (1, 20, 3),
    (5, 33, 4)])
def test_kernel_fewer_queries_than_r_and_targets_than_groups(
        cuda_device, m, n, splits):
    """M below one thread's R, and N below S × GROUP (ragged last group,
    splits of one group), on integer-grid points: exactly the plain
    version's picks."""
    rng = np.random.default_rng(25)
    q, t, mask = _grid_problem(rng, (), m, n, span=2)
    launch = tnn.plan(1, m, n, 8, 128, splits)
    d_k, i_k = _kernel_with(q, t, mask, cuda_device, launch)
    d_p, i_p = _plain(q, t, mask)
    np.testing.assert_array_equal(i_k, i_p)
    np.testing.assert_array_equal(d_k, d_p)


@pytest.mark.parametrize("broadcast", ["none", "query", "target"])
@pytest.mark.parametrize("splits", [1, 4])
def test_kernel_ragged_batches_with_broadcast(cuda_device, broadcast,
                                              splits):
    """Ragged M and N on the batched entry, with and without a broadcast
    operand, and on the single entry per pair, at S = 1 and S > 1:
    exactly the plain version's picks on integer-grid points."""
    rng = np.random.default_rng(26)
    b, m, n = 3, 1001, 3003
    q, t, mask = _grid_problem(rng, (b,), m, n, span=9)
    mask[1, 100:200] = False
    if broadcast == "query":
        q = q[0]
    elif broadcast == "target":
        t, mask = t[0], mask[0]
    launch = tnn.plan(b, m, n, splits=splits)
    before = tnn.launches["batched"]
    d_k, i_k = _kernel_with(q, t, mask, cuda_device, launch)
    assert tnn.launches["batched"] == before + 1
    d_p, i_p = _plain(q, t, mask)
    np.testing.assert_array_equal(i_k, i_p)
    np.testing.assert_array_equal(d_k, d_p)
    for k in range(b):                       # the single entry, pair k
        qk = q if q.ndim == 2 else q[k]
        tk, mk = (t, mask) if t.ndim == 2 else (t[k], mask[k])
        d_s, i_s = _kernel_with(qk, tk, mk, cuda_device,
                                tnn.plan(1, m, n, splits=splits))
        np.testing.assert_array_equal(i_s, i_p[k])
        np.testing.assert_array_equal(d_s, d_p[k])


def test_wrapper_refuses_a_plan_it_has_no_kernel_for(cuda_device):
    q = torch.zeros((8, 3), device=cuda_device)
    with pytest.raises(ValueError, match="does not fit"):
        tnn._nearest_cuda(q, q, tnn.plan(2, 8, 8))
    with pytest.raises(ValueError, match="does not fit"):
        tnn._nearest_cuda(q, q, tnn.plan(1, 8, 8)._replace(split_len=0))
    with pytest.raises(RuntimeError, match="launch failed"):
        tnn._nearest_cuda(q, q, tnn.NNPlan(3, 128, 1, 8, (1, 1, 1), 0))


def test_wrapper_refuses_what_the_kernel_does_not_take(cuda_device):
    q = torch.zeros((8, 3), device=cuda_device)
    with pytest.raises(TypeError, match="float32"):
        tnn._nearest_cuda(q.double(), q)
    with pytest.raises(ValueError, match="contiguous"):
        tnn._nearest_cuda(torch.zeros((3, 8), device=cuda_device).T, q)
    with pytest.raises(ValueError, match="batch sizes"):
        tnn._nearest_cuda(torch.zeros((2, 8, 3), device=cuda_device),
                          torch.zeros((3, 8, 3), device=cuda_device))
    with pytest.raises(ValueError, match="CUDA"):
        tnn._nearest_cuda(q, q.cpu())


def test_small_main_path_launches_both_entries(cuda_device, tmp_path):
    """The pipelined type-6 MapBuilder at a small size on the GPU goes
    through both kernel entries and writes finite poses."""
    from staticmapping_torch.builder.frame import SubmapOptions
    from staticmapping_torch.builder.frontend import FrontEndOptions
    from staticmapping_torch.builder.map_builder import (MapBuilder,
                                                         MapBuilderOptions)
    from staticmapping_torch.io import kitti, synthetic

    scans, _ = synthetic.make_sequence(n_scans=12, seed=5, step=1.0,
                                       max_points=8000, max_range=70.0)
    mb = MapBuilder(MapBuilderOptions(
        front_end=FrontEndOptions(scan_capacity=8192, target_leaf_size=4),
        submap=SubmapOptions(frame_count=2), submap_capacity=16384,
        submap_matcher_leaf_size=4, pipelined=True, pipeline_chunk=4,
        pair_match_batch=2, export_file_path=str(tmp_path),
        output_mrvm=False, output_direct_combined_map=False))
    tnn.reset_launches()
    for i, pts in enumerate(scans):
        mb.insert_pointcloud(0.1 * i, pts)
    mb.finish()
    assert tnn.launches["single"] > 0 and tnn.launches["batched"] > 0
    poses = kitti.read_poses(str(tmp_path / "kitti_pose.txt"))
    assert len(poses) == len(mb.trajectory) and np.isfinite(poses).all()


# ---------------------------------------------------------------------------
# the NN variants (K3, K4)
# ---------------------------------------------------------------------------

def _variant_operands(variant, q, t, device):
    from staticmapping_torch.ops import nn_variants as tnv
    qd, td = torch.from_numpy(q).to(device), torch.from_numpy(t).to(device)
    if variant == "packed":
        return tnv.pad8(qd), tnv.pad8(td)
    return tnv.aug_q(qd), tnv.aug_t(td)


def _variant(variant, a, b, launch=None, idx_bits=11):
    from staticmapping_torch.ops import nn_variants as tnv
    if variant == "packed":
        return tnv.nearest_packed(a, b, idx_bits, launch)
    return tnv.nearest_aug(a, b, variant == "aug_packed", launch)


# (r, block, splits) of the launches held against the plain version: every
# instance, S = 1 and S > 1 (None: the automatic plan)
VARIANT_PLANS = [(2, 256, None), (2, 128, 1), (4, 64, 3), (4, 128, 8),
                 (2, 256, 1), (4, 64, None)]


@pytest.mark.parametrize("variant", ["packed", "aug_packed", "aug"])
@pytest.mark.parametrize("r,block,splits", VARIANT_PLANS)
def test_variant_kernel_matches_plain(cuda_device, variant, r, block,
                                      splits):
    """Ragged M with N = 2048 (the packed key's 11 bits): every plan's
    kernel picks the plain version's target for ≥ 99.9% of queries; d
    agrees to the expansion's f32 error at 30 m plus one 11-bit truncation
    step, and the packed d has its low bits clear."""
    from staticmapping_torch.ops import nn_variants as tnv
    rng = np.random.default_rng(19)
    q = rng.uniform(-30, 30, (3000, 3)).astype(np.float32)
    t = rng.uniform(-30, 30, (2048, 3)).astype(np.float32)
    a, b = _variant_operands(variant, q, t, cuda_device)
    launch = tnv.plan(3000, 2048, r, block, splits,
                      sms=tnn._sm_count(cuda_device))
    assert splits is None or launch.splits == splits
    before = tnv.launches[variant]
    d_k, i_k = _variant(variant, a, b, launch)
    torch.cuda.synchronize()
    assert tnv.launches[variant] == before + 1
    d_p, i_p = _variant(variant, a.cpu(), b.cpu())
    d_k, i_k = d_k.cpu().numpy(), i_k.cpu().numpy()
    assert i_k.dtype == np.int32 and d_k.shape == (3000,)
    assert np.mean(i_k == i_p.numpy()) >= 0.999
    np.testing.assert_allclose(d_k, d_p.numpy(), rtol=2.0 ** -12, atol=5e-2)
    if variant != "aug":
        assert not (d_k.view(np.int32) & 2047).any()


@pytest.mark.parametrize("variant", ["packed", "aug_packed", "aug"])
def test_variant_kernel_ties_go_to_the_lowest_index(cuda_device, variant):
    rng = np.random.default_rng(20)
    base = rng.uniform(-5, 5, (16, 3)).astype(np.float32)
    t = np.concatenate([base] * 128)                 # 2048 targets
    q = base[rng.integers(0, 16, 500)]
    d_k, i_k = _variant(variant, *_variant_operands(variant, q, t,
                                                    cuda_device))
    want = np.array([np.flatnonzero((base == p).all(1))[0] for p in q])
    np.testing.assert_array_equal(i_k.cpu().numpy(), want)


def _variant_grid(variant, rows, m, n, span, cuts, rng):
    """Integer-grid operands (every sum exact in f32) whose queries are
    zero past ``rows`` (3: the pad8 loop, 5: the aug_q loop, 8: general),
    with targets c − 1 and c equal at every cut and query k's least d² on
    such a pair (K3: its own; K4: the one most aligned with it)."""
    q8 = rng.integers(-span, span + 1, (8, m)).astype(np.float32)
    t8 = rng.integers(-span, span + 1, (8, n)).astype(np.float32)
    q8[rows:] = 0
    for k, c in enumerate(cuts[:m]):
        # K3: d² = |q − t|² = 0; K4: d² = q·t = −10 |q|², below the rest
        t8[:, c - 1] = t8[:, c] = q8[:, k] * (1 if variant == "packed"
                                              else -10)
    return q8, t8


@pytest.mark.parametrize("variant", ["packed", "aug_packed", "aug"])
@pytest.mark.parametrize("rows", [3, 5, 8])
@pytest.mark.parametrize("r,block,splits,idx_bits", [
    (2, 256, 1, 11), (4, 128, 5, 11), (2, 128, 8, 20), (4, 64, 3, 20)])
def test_variant_kernel_ties_straddle_groups_and_splits(
        cuda_device, variant, rows, r, block, splits, idx_bits):
    """Each row loop on integer grids, with exact ties placed on both sides
    of every split boundary and of group boundaries, and (20 bits) many
    ties of the truncated value: exactly the plain version's d and index."""
    from staticmapping_torch.ops import nn_variants as tnv
    rng = np.random.default_rng(27 + rows)
    m, n = 700, 2048
    launch = tnv.plan(m, n, r, block, splits)
    assert launch.splits == splits
    cuts = sorted({s * launch.split_len for s in range(1, splits)}
                  | set(range(tnv.GROUP, n, tnv.GROUP * 25)))
    q8, t8 = _variant_grid(variant, rows, m, n, 6, cuts, rng)
    bits = idx_bits if variant == "packed" else tnv.AUG_IDX_BITS
    d_k, i_k = _variant(variant, torch.from_numpy(q8).to(cuda_device),
                        torch.from_numpy(t8).to(cuda_device), launch, bits)
    d_p, i_p = _variant(variant, torch.from_numpy(q8),
                        torch.from_numpy(t8), None, bits)
    np.testing.assert_array_equal(i_k.cpu().numpy(), i_p.numpy())
    np.testing.assert_array_equal(d_k.cpu().numpy().view(np.int32),
                                  d_p.numpy().view(np.int32))
    picked = i_k.cpu().numpy()[:len(cuts)]
    if variant == "packed":         # d² = 0 on its own pair only
        np.testing.assert_array_equal(picked, np.array(cuts) - 1)
    elif variant == "aug":          # the lower column of a planted pair
        assert np.isin(picked, np.array(cuts) - 1).all()


@pytest.mark.parametrize("variant", ["packed", "aug_packed", "aug"])
@pytest.mark.parametrize("m,n,splits", [
    (1, 1, None), (3, 5, None), (2, 7, 1), (3, 12, 2), (1, 20, 3),
    (5, 33, 4), (100, 127, 8)])
def test_variant_kernel_fewer_queries_than_r_and_targets_than_groups(
        cuda_device, variant, m, n, splits):
    """M below one block's R × block, and N below S × GROUP (ragged last
    group, splits of one group), on integer grids: exactly the plain
    version's picks."""
    from staticmapping_torch.ops import nn_variants as tnv
    rng = np.random.default_rng(28)
    q8, t8 = _variant_grid(variant, 5, m, n, 2, [], rng)
    launch = tnv.plan(m, n, 4, 128, splits)
    d_k, i_k = _variant(variant, torch.from_numpy(q8).to(cuda_device),
                        torch.from_numpy(t8).to(cuda_device), launch)
    d_p, i_p = _variant(variant, torch.from_numpy(q8), torch.from_numpy(t8))
    np.testing.assert_array_equal(i_k.cpu().numpy(), i_p.numpy())
    np.testing.assert_array_equal(d_k.cpu().numpy(), d_p.numpy())


@pytest.mark.parametrize("variant", ["packed", "aug_packed", "aug"])
def test_variant_kernel_general_rows(cuda_device, variant):
    """Real-valued operands with every row in use (the 8-row loop): the
    plain version's picks for ≥ 99.9% of queries, d to f32 error."""
    rng = np.random.default_rng(29)
    q8 = rng.uniform(-3, 3, (8, 2000)).astype(np.float32)
    t8 = rng.uniform(-3, 3, (8, 2048)).astype(np.float32)
    d_k, i_k = _variant(variant, torch.from_numpy(q8).to(cuda_device),
                        torch.from_numpy(t8).to(cuda_device))
    d_p, i_p = _variant(variant, torch.from_numpy(q8), torch.from_numpy(t8))
    assert np.mean(i_k.cpu().numpy() == i_p.numpy()) >= 0.999
    np.testing.assert_allclose(d_k.cpu().numpy(), d_p.numpy(),
                               rtol=2.0 ** -12, atol=1e-4)


def test_variant_wrapper_refuses_what_the_kernel_does_not_take(cuda_device):
    from staticmapping_torch.ops import nn_variants as tnv
    q = torch.zeros((8, 64), device=cuda_device)
    with pytest.raises(ValueError, match="index bits"):
        tnv.nearest_packed(q, torch.zeros((8, 2049), device=cuda_device))
    with pytest.raises(TypeError, match="float32"):
        tnv.nearest_aug(q.double(), q.double(), False)
    with pytest.raises(ValueError, match="contiguous"):
        tnv.nearest_aug(torch.zeros((64, 8), device=cuda_device).T, q, False)
    p = tnv.plan(64, 64)
    with pytest.raises(ValueError, match="instance"):
        tnv.nearest_aug(q, q, False, p._replace(r=3))
    with pytest.raises(ValueError, match="S must be"):
        tnv.nearest_aug(q, torch.zeros((8, 4096), device=cuda_device), False,
                        tnv.VariantPlan(2, 256, 9, 464, (1, 9)))
    with pytest.raises(ValueError, match="does not fit"):
        tnv.nearest_aug(q, q, False, tnv.plan(64, 4096))


# ---------------------------------------------------------------------------
# the MRVM
# ---------------------------------------------------------------------------

def test_scan_events_on_the_gpu_match_the_cpu(cuda_device):
    """The MRVM's per-scan reduction on the GPU and on the CPU: the same
    valid voxels with the same hit and miss counts (≥ 99.9%), and per-voxel
    sums to f32 tolerance (the GPU adds them with atomics)."""
    from staticmapping_torch.builder import mrvm
    rng = np.random.default_rng(21)
    n = 8192
    xyz = np.column_stack([rng.uniform(-40, 40, n), rng.uniform(-40, 40, n),
                           rng.uniform(-2, 3, n)]).astype(np.float32)
    inten = rng.uniform(0, 100, n).astype(np.float32)
    mask = rng.uniform(0, 1, n) < 0.9
    origin = np.array([0.5, -0.3, 1.7], dtype=np.float32)

    def run(dev):
        return [x.cpu().numpy() for x in mrvm._scan_events(
            torch.from_numpy(xyz).to(dev), torch.from_numpy(mask).to(dev),
            torch.from_numpy(inten).to(dev),
            torch.from_numpy(origin).to(dev), 0.1, 48)]

    g, c = run(cuda_device), run("cpu")

    def by_key(out):
        keys, valid = out[0], out[6]
        k = keys[valid].astype(np.int64) + (1 << 20)
        return ((k[:, 0] << 42) | (k[:, 1] << 21) | k[:, 2],
                *(x[valid] for x in out[1:6]))

    g, c = by_key(g), by_key(c)
    common, ig, ic = np.intersect1d(g[0], c[0], return_indices=True)
    same = (g[1][ig] == c[1][ic]) & (g[2][ig] == c[2][ic])
    union = len(g[0]) + len(c[0]) - len(common)
    assert same.sum() >= 0.999 * union
    ig, ic = ig[same], ic[same]
    np.testing.assert_allclose(g[3][ig], c[3][ic], rtol=1e-5, atol=1e-3)
    np.testing.assert_array_equal(g[4][ig], c[4][ic])     # max intensity
    np.testing.assert_allclose(g[5][ig], c[5][ic], rtol=1e-5, atol=1e-2)


def test_native_mrvm_store_builds_and_merges():
    """The host C++ store builds where the GPU tests run and agrees with
    the numpy store."""
    from staticmapping_torch.builder import mrvm_store
    rng = np.random.default_rng(22)
    native, plain = mrvm_store.make_store(), mrvm_store.make_store(False)
    keys = np.unique(rng.integers(-30, 30, (2000, 3)), axis=0).astype(
        np.int32)
    n = len(keys)
    hits = rng.integers(0, 5, n).astype(np.float32)
    for st in (native, plain):
        st.merge(keys, hits, rng.integers(0, 3, n).astype(np.float32) * 0,
                 np.zeros((n, 3), np.float32),
                 np.full(n, 7.0, np.float32), hits * 2.0, cap=3.0)
    assert native.size == plain.size == n
    a, b = native.export(), plain.export()
    oa, ob = np.lexsort(a[0].T[::-1]), np.lexsort(b[0].T[::-1])
    for xa, xb in zip(a, b):
        np.testing.assert_allclose(xa[oa], xb[ob])


def test_short_cli_run(cuda_device, tmp_path):
    """``python -m staticmapping_torch --device cuda`` on a short synthetic
    run: the sequential front end launches the single-pair kernel, and the
    outputs, static map included, are written."""
    import subprocess
    import sys
    from staticmapping_torch.io import kitti, pcd
    out = tmp_path / "out"
    proc = subprocess.run(
        [sys.executable, "-m", "staticmapping_torch", "--synthetic",
         "straight", "--scans", "8", "--out", str(out), "--no-backend",
         "--device", "cuda", "--gt", str(out / "gt_pose.txt")],
        capture_output=True, text=True, timeout=600,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert proc.returncode == 0, proc.stderr
    assert "ATE RMSE" in proc.stdout
    poses = kitti.read_poses(str(out / "kitti_pose.txt"))
    assert len(poses) >= 1 and np.isfinite(poses).all()
    assert len(pcd.read_pcd(str(out / "static_map.pcd"))) > 0


# ---------------------------------------------------------------------------
# the pose-graph back end
# ---------------------------------------------------------------------------

def _boxes(rng, n=6000):
    """Points on the faces of a few boxes: a cloud with structure for the
    M2DP descriptor and the GICP normals."""
    pts = []
    for _ in range(6):
        c = rng.uniform(-15, 15, 3) * [1, 1, 0.2]
        size = rng.uniform(2, 6, 3)
        face = rng.integers(0, 3, n // 6)
        p = rng.uniform(-0.5, 0.5, (n // 6, 3))
        p[np.arange(n // 6), face] = rng.choice([-0.5, 0.5], n // 6)
        pts.append(c + p * size)
    return np.concatenate(pts).astype(np.float32)


def test_m2dp_on_the_gpu_matches_the_cpu(cuda_device):
    """The histogram of the same aligned points equals the CPU's on at
    least 99.99% of the counts (a point on a bin edge may round to the
    neighbouring bin), and the descriptors match to 0.9999."""
    from staticmapping_torch.data import cloud as tcloud
    from staticmapping_torch.descriptor import m2dp
    pts = _boxes(np.random.default_rng(30))
    gpu = tcloud.from_numpy(pts, capacity=8192, device=cuda_device)
    cpu = tcloud.from_numpy(pts, capacity=8192, device="cpu")
    aligned = m2dp.pca_align(cpu)
    A_g = m2dp.histogram(aligned.to(cuda_device), gpu.mask).cpu().numpy()
    A_c = m2dp.histogram(aligned, cpu.mask).numpy()
    assert np.abs(A_g - A_c).sum() / 2 <= 1e-4 * A_c.sum()
    d_g, d_c = m2dp.compute_descriptor(gpu), m2dp.compute_descriptor(cpu)
    assert d_g.is_cuda
    assert float(m2dp.match_descriptors(d_g.cpu(), d_c)) >= 0.9999


def _circle_graph(device, n=24, drift=0.05, seed=31):
    """A noisy circle with a loop closure, GPS factors on the calibration
    error, odometry factors and priors on the special nodes."""
    from staticmapping_torch.backend import pose_graph as pg
    from staticmapping_torch.common import np_se3
    rng = np.random.default_rng(seed)
    step = np_se3.from_rt(np_se3.euler_to_matrix(
        np.array([0.0, 0.0, 2 * np.pi / n])), np.array([2.0, 0.0, 0.0]))
    gt = [np.eye(4)]
    for _ in range(n - 1):
        gt.append(gt[-1] @ step)
    g = pg.PoseGraph(device=device)
    odom = [gt[0]]
    for k in range(n):
        g.add_node()
    for k in range(n - 1):
        noise = np_se3.from_rt(np_se3.euler_to_matrix(
            rng.normal(0, drift / 4, 3)), rng.normal(0, drift, 3))
        meas = np_se3.inverse(gt[k]) @ gt[k + 1] @ noise
        g.add_between(k, k + 1, meas)
        odom.append(odom[-1] @ meas)
    g.add_between(n - 1, 0, np_se3.inverse(gt[-1]) @ gt[0])
    offset = np.array([100.0, 50.0, 3.0])
    for k in range(0, n, 4):
        g.add_gps(k, gt[k][:3, 3] + offset, p_tracking_gps=(0.1, 0.0, 0.2),
                  use_calib_error=True)
        g.add_odom(k, gt[k])
    g.add_special_prior(pg.SPECIAL_ODOM_CALIB, np.eye(4),
                        (0.1, 0.1, 0.1, 0.5, 0.5, 1.5))
    g.add_special_prior(pg.SPECIAL_GPS_CALIB, np.eye(4),
                        (1.0, 1.0, 0.2, 1e-4, 1e-4, 1e-4))
    g.add_special_prior(pg.SPECIAL_GPS_COORD,
                        np_se3.from_rt(np.eye(3), offset),
                        (1.0, 1.0, 1.0, 0.1, 0.1, 0.2))
    return g, np.stack(odom)


@pytest.mark.parametrize("solver", ["dense", "pcg"])
def test_pose_graph_solve_on_the_gpu_matches_the_cpu(cuda_device, solver):
    """Three trips, before the f32 noise floor: poses within 1e-4 m and
    the χ² within 1e-3 relative (the sums run in the CPU's order, but the
    card's matrix products and linear solves round otherwise)."""
    g_g, odom = _circle_graph(cuda_device)
    g_c, _ = _circle_graph("cpu")
    out_g = g_g.optimize(odom, num_iters=3, solver=solver)
    out_c = g_c.optimize(odom, num_iters=3, solver=solver)
    assert np.abs(out_g[:, :3, 3] - out_c[:, :3, 3]).max() <= 1e-4
    assert np.abs(out_g[:, :3, :3] - out_c[:, :3, :3]).max() <= 1e-4
    assert abs(g_g.last_chi2 - g_c.last_chi2) <= 1e-3 * max(g_c.last_chi2,
                                                            1.0)


@pytest.mark.parametrize("solver", ["dense", "pcg"])
def test_pose_graph_solve_on_the_gpu_is_the_same_every_run(cuda_device,
                                                           solver):
    """The solver's sums run in factor order on the card, so three solves
    of one graph at the optimizer's 8 trips (past the f32 noise floor,
    where the LM accept turns on rounding) give the same poses, χ² and
    trace bit for bit."""
    from staticmapping_torch.backend import pose_graph as pg
    from staticmapping_torch.backend import pose_graph_sparse as pgs
    g, odom = _circle_graph(cuda_device)
    args, _, _ = g.solver_args(odom)
    fn = pg.gauss_newton if solver == "dense" else pgs.gauss_newton_pcg
    first, *rest = (fn(*args, num_iters=8) for _ in range(3))
    assert first[0].is_cuda
    for out in rest:
        for a, b in zip(out, first):
            assert torch.equal(a, b)


def test_ordered_sum_on_the_gpu_equals_the_cpu(cuda_device):
    """The solvers' ordered sum walks each node's terms in one thread on
    the card, in the CPU's order: equal bit for bit."""
    from staticmapping_torch.backend.pose_graph import _OrderedSum
    rng = np.random.default_rng(47)
    idx = torch.from_numpy(rng.integers(0, 4000, 50000))
    vals = torch.from_numpy((rng.normal(size=(50000, 6, 6))
                             * 10.0 ** rng.uniform(-3, 3, (50000, 1, 1))
                             ).astype(np.float32))
    want = _OrderedSum(idx, 4096)(vals)
    got = _OrderedSum(idx.to(cuda_device), 4096)(vals.to(cuda_device))
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("shape", [(5,), (32768,), (2, 4096)], ids=str)
@pytest.mark.parametrize("seed", [0, 7, 2**32 + 5, -1])
def test_uniform_on_the_gpu_equals_the_cpu(cuda_device, seed, shape):
    """The JAX package's uniforms drawn on the card equal the CPU's bit for
    bit (tests/test_torch_random.py holds the CPU's to ``jax.random``)."""
    from staticmapping_torch.common import random as trandom
    got = trandom.uniform(seed, shape, cuda_device)
    assert got.is_cuda and tuple(got.shape) == shape
    want = trandom.uniform(seed, shape, "cpu")
    assert torch.equal(got.cpu().view(torch.int32), want.view(torch.int32))


def test_align_gicp_on_the_gpu_matches_the_cpu(cuda_device):
    """The GICP gate's align on the same normal cloud: T within 1e-3 m and
    1e-3 rad, the score within 1e-3, through the single-pair kernel."""
    from staticmapping_torch.common import np_se3
    from staticmapping_torch.data import cloud as tcloud
    from staticmapping_torch.registration import gicp
    pts = _boxes(np.random.default_rng(32), n=4096)
    gc = gicp.compute_point_normals(
        tcloud.from_numpy(pts, capacity=4096, device="cpu"), k=20)
    gg = gicp.GicpCloud(*(x.to(cuda_device) for x in gc))
    guess = torch.from_numpy(np_se3.from_rt(
        np_se3.euler_to_matrix(np.array([0.0, 0.0, 0.04])),
        np.array([0.3, -0.2, 0.05])).astype(np.float32))
    before = tnn.launches["single"]
    T_g, s_g = gicp.align_gicp(gg, gg, guess.to(cuda_device),
                               max_correspondence_dist=2.0, max_iteration=8)
    T_c, s_c = gicp.align_gicp(gc, gc, guess, max_correspondence_dist=2.0,
                               max_iteration=8)
    assert tnn.launches["single"] > before
    T_g, T_c = T_g.cpu().numpy(), T_c.numpy()
    assert np.abs(T_g[:3, 3] - T_c[:3, 3]).max() <= 1e-3
    assert np.abs(T_g[:3, :3] - T_c[:3, :3]).max() <= 1e-3
    assert abs(float(s_g) - float(s_c)) <= 1e-3


def test_kernel_at_the_loop_verifier_shape_matches_plain(cuda_device):
    """18 pairs (3 yaw guesses x 6 candidates) of a 65536-slot source
    against 8192 targets, the kernel against ``_nearest_plain`` on the same
    card."""
    rng = np.random.default_rng(33)
    q, t, mask = _problem(rng, (18,), 65536, 8192, 512)
    qd, td, md = (torch.from_numpy(x).to(cuda_device) for x in (q, t, mask))
    before = tnn.launches["batched"]
    d_k, i_k = tnn.nearest_1(qd, td, md)
    assert tnn.launches["batched"] == before + 1
    d_p, i_p = tnn._nearest_plain(
        qd, torch.where(md[..., None], td, tnn._FAR), md)
    assert float((i_k == i_p).float().mean()) >= 0.999
    assert float((d_k - d_p).abs().max()) <= 5e-2


def test_short_cli_run_with_the_backend(cuda_device, tmp_path):
    """``python -m staticmapping_torch --synthetic square`` without
    ``--no-backend`` on its first 40 scans: every full submap reaches the
    back end with its M2DP descriptor, past the loop detector's 15-submap
    threshold, and the outputs are finite."""
    from staticmapping_torch import __main__ as cli
    from staticmapping_torch.io import kitti
    mb = cli.run(cli.make_parser().parse_args(
        ["--synthetic", "square", "--scans", "40", "--out",
         str(tmp_path), "--device", "cuda", "--quiet"]))
    full = [s for s in mb.trajectory if s.full]
    assert mb.backend.graph.num_nodes == len(full) > 15
    assert all(s.descriptor is not None for s in full)
    assert len(mb.backend.loop_detector.frames) == len(full)
    poses = kitti.read_poses(str(tmp_path / "kitti_pose.txt"))
    assert len(poses) == len(mb.trajectory) and np.isfinite(poses).all()


def _scene(rng, n=4096):
    """A floor, two walls and a sloped roof within 11 m of the origin."""
    per = n // 4
    x = rng.uniform(-10, 10, per)
    parts = [
        np.column_stack([rng.uniform(-10, 10, per),
                         rng.uniform(-10, 10, per),
                         0.02 * rng.standard_normal(per)]),
        np.column_stack([5.0 + 0.02 * rng.standard_normal(per),
                         rng.uniform(-10, 10, per), rng.uniform(0, 4, per)]),
        np.column_stack([rng.uniform(-10, 10, per),
                         -4.0 + 0.02 * rng.standard_normal(per),
                         rng.uniform(0, 4, per)]),
        np.column_stack([x, rng.uniform(-10, 10, per),
                         4.0 + 0.15 * x + 0.02 * rng.standard_normal(per)])]
    return np.vstack(parts).astype(np.float32)


def _moved_pair(seed):
    """(source, target) point arrays: aligning the source onto the target
    recovers a 0.3 m, 0.03 rad motion."""
    from staticmapping_torch.common import np_se3
    pts = _scene(np.random.default_rng(seed))
    T = np_se3.from_rt(np_se3.euler_to_matrix(np.array([0.0, 0.0, 0.03])),
                       np.array([0.3, -0.2, 0.05]))
    src = (pts - T[:3, 3].astype(np.float32)) @ T[:3, :3].astype(np.float32)
    return src, pts


def _pose_close(T_g, T_c, tol=1e-3):
    T_g, T_c = T_g.cpu().numpy(), T_c.cpu().numpy()
    assert np.abs(T_g[:3, 3] - T_c[:3, 3]).max() <= tol
    assert np.abs(T_g[:3, :3] - T_c[:3, :3]).max() <= tol


def test_align_ndt_on_the_gpu_matches_the_cpu(cuda_device):
    """NDT on one field built on the CPU and moved to the card: T within
    1e-3 m and 1e-3 rad, the score within 1e-4; the field built on the
    card has the same keys."""
    from staticmapping_torch.data import cloud as tcloud
    from staticmapping_torch.registration import ndt
    src, tgt = _moved_pair(40)
    tc = tcloud.from_numpy(tgt, capacity=4096, device="cpu")
    sc = tcloud.from_numpy(src, capacity=4096, device="cpu")
    field = ndt.build_ndt_map(tc, 1.0)
    field_g = ndt.build_ndt_map(
        tcloud.from_numpy(tgt, capacity=4096, device=cuda_device), 1.0)
    assert torch.equal(field_g.key.cpu(), field.key)
    eye = torch.eye(4)
    T_c, s_c = ndt.align_ndt(sc, field, eye)
    T_g, s_g = ndt.align_ndt(
        tcloud.from_numpy(src, capacity=4096, device=cuda_device),
        ndt.NdtMap(*(x.to(cuda_device) for x in field)),
        eye.to(cuda_device))
    _pose_close(T_g, T_c)
    assert abs(float(s_g) - float(s_c)) <= 1e-4


def test_ndt_with_gicp_on_the_gpu_matches_the_cpu(cuda_device):
    """The type-3 chain (voxel filter, NDT, GICP on the single-pair
    kernel) on the same clouds: T within 1e-3 m and 1e-3 rad, the score
    within 1e-3."""
    from staticmapping_torch.data import cloud as tcloud
    from staticmapping_torch.registration import NdtWithGicp
    src, tgt = _moved_pair(41)
    out = {}
    for dev in ("cpu", cuda_device):
        m = NdtWithGicp(voxel_resolution=0.3)
        m.set_input_target(tcloud.from_numpy(tgt, capacity=4096, device=dev))
        m.set_input_source(tcloud.from_numpy(src, capacity=4096, device=dev))
        before = tnn.launches["single"]
        out[str(dev)] = m.align(torch.eye(4, device=dev))
        assert (tnn.launches["single"] > before) == (dev != "cpu")
    (T_c, s_c), (T_g, s_g) = out["cpu"], out[str(cuda_device)]
    _pose_close(T_g, T_c)
    assert abs(float(s_g) - float(s_c)) <= 1e-3


def test_type3_chunk_on_the_gpu_matches_the_cpu(cuda_device):
    """One chunk of the chunked type-3 front end from the same first scan
    on the card and on the CPU: the same keyframe flags, the poses within
    1e-3 m, the scores within 1e-3."""
    from staticmapping_torch.builder import frontend, pipeline
    from staticmapping_torch.io import synthetic
    scans, _ = synthetic.make_sequence(
        n_scans=5, seed=4, trajectory="straight", step=0.5,
        max_points=4000, max_range=30.0)
    buf = [(0.1 * i, scans[i]) for i in range(1, 5)]
    q, meta, imu = pipeline._pack_chunk(buf, 0.0, 4, 4096, None)
    out = {}
    for dev in ("cpu", cuda_device):
        fe = pipeline.DeviceFrontEnd(frontend.FrontEndOptions(
            scan_capacity=4096, nn_tile=512, max_iteration=40,
            matcher_type=3, motion_compensation=False), chunk_size=4,
            device=dev)
        fe.close()
        fe.process(0.0, scans[0])
        _, outputs = fe._run_chunk(
            fe.state, *(torch.from_numpy(a).to(dev) for a in (q, meta, imu)),
            np.ones(4, dtype=bool))
        out[str(dev)] = outputs
    for o_c, o_g in zip(out["cpu"], out[str(cuda_device)]):
        assert o_c[2] == o_g[2]
        _pose_close(o_g[0], o_c[0])
        assert abs(float(o_g[1]) - float(o_c[1])) <= 1e-3


def test_kernel_at_the_gicp_stage_shape_keeps_the_contract(cuda_device):
    """The single-pair kernel at the GICP stage of matcher type 3 (a
    0.2 m voxel-filtered 32768-slot scan against its keyframe's), held to
    chip_smoke.py's near-tie contract (``check_one``)."""
    import sys
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from chip_smoke import check_one
    rng = np.random.default_rng(42)
    q, t, mask = _problem(rng, (), 32768, 32768, 2048)
    before = tnn.launches["single"]
    d, i = tnn.nearest_1(*(torch.from_numpy(x).to(cuda_device)
                           for x in (q, t, mask)))
    assert tnn.launches["single"] == before + 1
    res = check_one(q, t, mask, d.cpu().numpy(), i.cpu().numpy())
    assert res["ok"], res


def test_plane_detector_on_the_gpu_matches_the_cpu(cuda_device):
    """The plane mask of a 32768-slot cloud (as many voxel slots, more
    than cuSOLVER's batched eigensolver takes in one call) on the card
    equals the CPU's on at least 99.9% of the points: the voxel moments
    are the CPU's bit for bit, but cuSOLVER's eigenvectors round otherwise
    than LAPACK's, which can move a residual across the 0.1 m inlier
    bound."""
    from staticmapping_torch.data import cloud as tcloud
    from staticmapping_torch.filters import PlaneDetector
    pts = _boxes(np.random.default_rng(43), n=30000)
    det = PlaneDetector(leaf_size=2.0, min_point_num_in_voxel=5,
                        distance_threshold=0.5)
    want = det.plane_mask(tcloud.from_numpy(pts, capacity=32768,
                                            device="cpu"))
    got = det.plane_mask(tcloud.from_numpy(pts, capacity=32768,
                                           device=cuda_device))
    assert int(want.sum()) > 1000
    assert float((got.cpu() == want).float().mean()) >= 0.999


def test_voxel_stats_on_the_gpu_equal_the_cpu(cuda_device):
    """Each voxel's sums run in point order on the card too, so NDT's voxel
    statistics and a voxel downsample equal the CPU's bit for bit, call
    after call."""
    from staticmapping_torch.data import cloud as tcloud
    from staticmapping_torch.ops import voxel
    pts = _boxes(np.random.default_rng(44), n=30000) + 40.0
    cpu = tcloud.from_numpy(pts, capacity=32768, device="cpu")
    gpu = tcloud.from_numpy(pts, capacity=32768, device=cuda_device)
    origin = torch.tensor([20.0, 20.0, 30.0])
    want = voxel.voxel_stats_floor(cpu, 1.0, origin)
    for _ in range(2):
        got = voxel.voxel_stats_floor(gpu, 1.0, origin.to(cuda_device))
        for k in ("count", "mean", "cov", "valid", "voxel_key"):
            assert torch.equal(got[k].cpu(), want[k]), k
    ds_c = voxel.voxel_downsample(cpu, 0.2)
    ds_g = voxel.voxel_downsample(gpu, 0.2)
    assert torch.equal(ds_g.xyz.cpu(), ds_c.xyz)
    assert torch.equal(ds_g.mask.cpu(), ds_c.mask)


def test_morton_normals_on_the_gpu_equal_the_cpu(cuda_device):
    """Morton normals of one full-width scan: the keys, their sorted order
    and the leaf mask on the card equal the CPU's.  The leaf normals come
    from the raw f32 leaf moment, whose sums the card rounds differently:
    the card's stray from a float64 solve of the same leaves is held to
    twice the CPU's (99th percentile, as the JAX parity test holds the
    CPU's)."""
    from staticmapping_torch.data import cloud as tcloud
    from staticmapping_torch.io import synthetic
    from staticmapping_torch.ops import normals
    world = synthetic.make_world(seed=3)
    pts = synthetic.render_scan(world, synthetic.straight_trajectory(1)[0],
                                max_points=30000, max_range=70.0, seed=3)
    cpu = tcloud.from_numpy(pts, capacity=32768, device="cpu")
    gpu = tcloud.from_numpy(pts, capacity=32768, device=cuda_device)
    k_c, k_g = normals.morton_keys(cpu), normals.morton_keys(gpu)
    assert torch.equal(k_g.cpu(), k_c)
    perm = torch.sort(k_c, stable=True).indices
    assert torch.equal(torch.sort(k_g, stable=True).indices.cpu(), perm)
    want = normals.estimate_normals(cpu, leaf_size=8, method="morton")
    got = normals.estimate_normals(gpu, leaf_size=8, method="morton")
    assert int(want.mask.sum()) > 1000
    assert torch.equal(got.mask.cpu(), want.mask)
    xyz = cpu.xyz[perm].double()
    exact = normals._leaf_normals(xyz[:, 0], xyz[:, 1], xyz[:, 2],
                                  cpu.mask[perm], 8)
    m = want.mask
    gpu_stray = (got.normals.cpu()[m].double()
                 - exact.normals[m]).abs().amax(-1)
    cpu_stray = (want.normals[m].double() - exact.normals[m]).abs().amax(-1)
    q_g, q_c = (float(torch.quantile(s, 0.99))
                for s in (gpu_stray, cpu_stray))
    assert q_g <= 2.0 * q_c + 1e-4, (q_g, q_c, float(gpu_stray.max()),
                                     float(cpu_stray.max()))


def test_kernel_at_the_merge_ratio_matches_plain(cuda_device):
    """K2 as the multi-trajectory merge runs it, scaled down: 8 pairs of a
    4096-slot source against 512 leaf-8 targets (the merge's 8:1 ratio of
    65536 to 8192), the kernel against ``_nearest_plain`` on the same
    card."""
    rng = np.random.default_rng(45)
    q, t, mask = _problem(rng, (8,), 4096, 512, 32)
    qd, td, md = (torch.from_numpy(x).to(cuda_device) for x in (q, t, mask))
    before = tnn.launches["batched"]
    d_k, i_k = tnn.nearest_1(qd, td, md)
    assert tnn.launches["batched"] == before + 1
    d_p, i_p = tnn._nearest_plain(
        qd, torch.where(md[..., None], td, tnn._FAR), md)
    assert float((i_k == i_p).float().mean()) >= 0.999
    assert float((d_k - d_p).abs().max()) <= 5e-2
