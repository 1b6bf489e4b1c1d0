"""1-NN kernel variants and their microbench — the PyTorch/CUDA counterpart
of ``tools/bench_nn_variants.py``.

Two functions of the variant bench, each in two implementations:

* :func:`nearest_packed` (K3, the bench's ``nearest_packed`` →
  ``_nn_kernel_packed``): d² by the f32 expansion |q|² + |t|² − 2 q·t,
  clamped at 0, min over the packed key ``(bits(d²) & ~low) | (col & low)``
  with ``low = 2^idx_bits − 1``;
* :func:`nearest_aug` (K4, ``nearest_aug`` → ``_nn_kernel_aug``): one f32
  contraction of augmented rows *is* d²; ``packed=True`` reduces by the same
  key with 11 bits, ``packed=False`` by min and first-index argmin, then
  clamps at 0.

A CUDA tensor goes to the hand-written kernel ``csrc/nn_variants.cu`` (see
its header note) under a launch plan (:func:`plan`); a CPU tensor takes the
plain PyTorch version.  Neither falls back to the other.  Operands keep the
TPU kernels' transposed ``[8, M]`` / ``[8, N]`` f32 layout (:func:`pad8`,
:func:`aug_q`, :func:`aug_t` build it from ``[M, 3]`` points) and are
finite (padding is 1e6, as everywhere in the port).  What the packing loses
is kept: d is the truncated d², the index is ``col mod 2^idx_bits`` and
ties of truncated d² go to the lowest low bits.  The packed forms refuse
``N > 2^idx_bits``, where the index would wrap.

    python -m staticmapping_torch.ops.nn_variants

runs the bench on the GPU at its shape, 16384 × 2048: each variant under
every (R, block) instance's plan (the TPU kernels swept their query chunk
``qc``, which has no meaning here), timed over ``R`` carry-dependent calls
replayed from a CUDA graph (``ms``) and issued from Python (``eager_ms``),
then each variant's agreement with the K1 kernel.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import cuda_build
from . import nn_search

# rows of the transposed operand layout
ROWS = 8
# the K4 kernel's packed key holds 11 index bits (bench_nn_variants.py:123)
AUG_IDX_BITS = 11
_VARIANT_ID = {"packed": 0, "aug_packed": 1, "aug": 2}

# Compile-time constants and (R, block) instances of csrc/nn_variants.cu.
GROUP = nn_search.GROUP  # kGroup: targets per running-min group
PREFETCH = 2             # kPrefetch: targets per thread per shared tile
INSTANCES = frozenset({(2, 128), (2, 256), (4, 64), (4, 128)})
MAX_SPLITS = 8           # kMaxSplits: S at most (the merge's unrolled loads)
# The default (R, block), chosen by chip_smoke.py's nn_variant_plan_sweep.
DEFAULT_R, DEFAULT_BLOCK = 2, 256

# Launches of the CUDA kernel per variant since the last reset.
launches: Dict[str, int] = {k: 0 for k in _VARIANT_ID}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


# ---------------------------------------------------------------------------
# operand layouts (bench_nn_variants.py:100-115, nn_search._pad8)
# ---------------------------------------------------------------------------

def pad8(p: torch.Tensor) -> torch.Tensor:
    """``[M, 3]`` → ``[8, M]``: rows x, y, z, 0, 0, 0, 0, 0."""
    out = torch.zeros((ROWS, p.shape[0]), dtype=torch.float32,
                      device=p.device)
    out[0:3] = p.T
    return out


def aug_q(q: torch.Tensor) -> torch.Tensor:
    """``[M, 3]`` → ``[8, M]``: rows −2x, −2y, −2z, |q|², 1, 0, 0, 0."""
    out = torch.zeros((ROWS, q.shape[0]), dtype=torch.float32,
                      device=q.device)
    out[0:3] = -2.0 * q.T
    out[3] = torch.sum(q * q, dim=1)
    out[4] = 1.0
    return out


def aug_t(t: torch.Tensor) -> torch.Tensor:
    """``[N, 3]`` → ``[8, N]``: rows x, y, z, 1, |t|², 0, 0, 0."""
    out = torch.zeros((ROWS, t.shape[0]), dtype=torch.float32,
                      device=t.device)
    out[0:3] = t.T
    out[3] = 1.0
    out[4] = torch.sum(t * t, dim=1)
    return out


# ---------------------------------------------------------------------------
# plain PyTorch versions (CPU tensors)
# ---------------------------------------------------------------------------

def _packed_min(d2: torch.Tensor, idx_bits: int):
    """Min over the last axis of the packed key of ``max(d2, 0)`` and the
    column: ``(truncated d², col mod 2^idx_bits)``."""
    low = (1 << idx_bits) - 1
    col = torch.arange(d2.shape[-1], dtype=torch.int32,
                       device=d2.device) & low
    bits = torch.clamp_min(d2, 0.0).contiguous().view(torch.int32)
    best = torch.min((bits & ~low) | col, dim=-1).values
    return (best & ~low).contiguous().view(torch.float32), best & low


def _plain(variant: str, q8t: torch.Tensor, t8t: torch.Tensor,
           idx_bits: int, chunk: int = 2048):
    """The variant's function on ``[8, M]`` / ``[8, N]`` operands, in query
    chunks of ``chunk``."""
    q, t = q8t.T, t8t.T                                    # [M, 8], [N, 8]
    t2 = torch.sum(t * t, dim=1)
    ds, idxs = [], []
    for s in range(0, q.shape[0], chunk):
        qc = q[s:s + chunk]
        dot = qc @ t.T
        if variant == "packed":
            q2 = torch.sum(qc * qc, dim=1)
            d, i = _packed_min((q2[:, None] + t2[None, :]) - 2.0 * dot,
                               idx_bits)
        elif variant == "aug_packed":
            d, i = _packed_min(dot, idx_bits)
        else:
            d, i = torch.min(dot, dim=1)
            d, i = torch.clamp_min(d, 0.0), i.to(torch.int32)
        ds.append(d)
        idxs.append(i)
    return torch.cat(ds), torch.cat(idxs)


# ---------------------------------------------------------------------------
# the CUDA kernel (CUDA tensors)
# ---------------------------------------------------------------------------

class VariantPlan(NamedTuple):
    """A launch of ``csrc/nn_variants.cu``.  Split ``s`` covers targets
    ``[s * split_len, min(n, (s + 1) * split_len))``; with S > 1 a second
    kernel merges the splits."""
    r: int                      # queries a thread
    block: int                  # threads a block
    splits: int                 # S: target slices, each its own block
    split_len: int              # targets a slice, a multiple of GROUP
    grid: Tuple[int, int]       # (query tiles, S)


@functools.lru_cache(maxsize=1024)
def plan(m: int, n: int, r: Optional[int] = None,
         block: Optional[int] = None, splits: Optional[int] = None,
         sms: int = nn_search.H100_SMS) -> VariantPlan:
    """The launch for ``m`` queries and ``n`` targets on a card of ``sms``
    SMs, by the rule of :func:`nn_search.plan`: unless ``splits`` is given,
    the targets are split until the grid holds about
    ``nn_search.WARPS_PER_SM`` warps per SM, every split holding at least
    ``nn_search.MIN_SPLIT`` targets, and S is at most MAX_SPLITS.  ``r``
    and ``block`` default to the measured best."""
    r = DEFAULT_R if r is None else r
    block = DEFAULT_BLOCK if block is None else block
    if (r, block) not in INSTANCES:
        raise ValueError(f"no kernel instance for r={r}, block={block}; "
                         f"have {sorted(INSTANCES)}")
    if splits is not None and splits > MAX_SPLITS:
        raise ValueError(f"{splits} splits exceed the {MAX_SPLITS} that the "
                         "merge kernel reads")
    tiles = -(-m // (r * block))
    splits, length = nn_search.split_targets(n, tiles, block, sms, splits,
                                             MAX_SPLITS)
    return VariantPlan(r, block, splits, length, (tiles, splits))


@functools.lru_cache(maxsize=None)
def _kernel_fn():
    fn = cuda_build.load("nn_variants").nn_variant_forward
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 6 + [
        ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _cuda(variant: str, q8t: torch.Tensor, t8t: torch.Tensor,
          idx_bits: int, launch: Optional[VariantPlan] = None):
    """Launch ``csrc/nn_variants.cu`` for ``variant`` on ``[8, M]`` /
    ``[8, N]`` f32 CUDA tensors under ``launch`` (default :func:`plan` for
    the card's SM count); counts one call, which with S > 1 is two
    launches, the split kernel and the merge."""
    for name, x in (("query", q8t), ("target", t8t)):
        if not x.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor")
        if x.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q8t.device != t8t.device:
        raise ValueError("query and target lie on different devices")
    m, n = q8t.shape[1], t8t.shape[1]
    p = launch or plan(m, n, sms=nn_search._sm_count(q8t.device))
    if (p.r, p.block) not in INSTANCES:
        raise ValueError(f"no kernel instance for plan {p}")
    if not 0 < p.splits <= MAX_SPLITS:
        raise ValueError(f"plan {p}: S must be in 1..{MAX_SPLITS}, the "
                         "splits that the merge kernel reads")
    if (p.grid != (-(-m // (p.r * p.block)), p.splits)
            or p.split_len % GROUP
            or not (p.splits - 1) * p.split_len < n <= p.splits * p.split_len):
        raise ValueError(f"plan {p} does not fit M={m} N={n}")
    d = torch.empty((m,), dtype=torch.float32, device=q8t.device)
    i = torch.empty((m,), dtype=torch.int32, device=q8t.device)
    part_v = part_i = 0                   # the [S, M] value and idx partials
    if p.splits > 1:
        part = torch.empty(2 * p.splits * m, dtype=torch.int32,
                           device=q8t.device)
        part_v = part.data_ptr()
        part_i = part_v + 4 * p.splits * m
    rc = _kernel_fn()(
        _VARIANT_ID[variant], q8t.data_ptr(), t8t.data_ptr(), d.data_ptr(),
        i.data_ptr(), part_v, part_i, m, n, idx_bits, p.r, p.block,
        p.splits, p.split_len,
        torch.cuda.current_stream(q8t.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"nn_variants kernel launch failed: CUDA error "
                           f"{rc}")
    launches[variant] += 1
    return d, i


def _nearest(variant: str, q8t: torch.Tensor, t8t: torch.Tensor,
             idx_bits: int, launch: Optional[VariantPlan]):
    for name, x in (("query", q8t), ("target", t8t)):
        if x.dim() != 2 or x.shape[0] != ROWS:
            raise ValueError(f"{name} must be [{ROWS}, N], got "
                             f"{tuple(x.shape)}")
    n = t8t.shape[1]
    if n < 1 or q8t.shape[1] >= 2**31 or n >= 2**31:
        raise ValueError(f"shape out of range: M={q8t.shape[1]} N={n}")
    if not 0 < idx_bits <= 30:
        raise ValueError(f"idx_bits must be in 1..30, got {idx_bits}")
    if variant != "aug" and n > 2**idx_bits:
        raise ValueError(
            f"{n} targets do not fit the packed key's {idx_bits} index "
            f"bits: the index would wrap modulo {2**idx_bits}")
    if q8t.is_cuda:
        return _cuda(variant, q8t, t8t, idx_bits, launch)
    return _plain(variant, q8t, t8t, idx_bits)


def nearest_packed(q8t: torch.Tensor, t8t: torch.Tensor, idx_bits: int = 11,
                   launch: Optional[VariantPlan] = None):
    """K3: 1-NN of ``[8, M]`` queries in ``[8, N]`` targets (:func:`pad8`
    layout; finite) by the f32 expansion and the packed key.  Returns
    ``(d [M] f32, i [M] i32)``: d² with its low ``idx_bits`` bits cleared,
    and the index (``N ≤ 2^idx_bits``).  ``launch`` overrides the CUDA
    kernel's :func:`plan`."""
    return _nearest("packed", q8t, t8t, idx_bits, launch)


def nearest_aug(qa: torch.Tensor, ta: torch.Tensor, packed: bool,
                launch: Optional[VariantPlan] = None):
    """K4: 1-NN of augmented ``[8, M]`` queries (:func:`aug_q`) in augmented
    ``[8, N]`` targets (:func:`aug_t`; finite), whose contraction is d².
    ``packed=True``: the packed key with 11 index bits (``N ≤ 2048``);
    ``packed=False``: min and first-index argmin, then d clamped at 0."""
    return _nearest("aug_packed" if packed else "aug", qa, ta,
                    AUG_IDX_BITS, launch)


# ---------------------------------------------------------------------------
# the microbench (bench_nn_variants.py:184-225)
# ---------------------------------------------------------------------------

R = 50


def measure(fn, q: torch.Tensor, t: torch.Tensor, label: str,
            reps: int = R) -> Dict[str, float]:
    """Milliseconds per call of ``fn(q, t)`` over ``reps`` carry-dependent
    calls (each call's query is perturbed by the previous result, so none
    can be skipped), after a warm run: ``ms`` by CUDA events around the
    replay of a CUDA graph that holds the loop, ``eager_ms`` around the
    loop issued from Python, the host's dispatch included."""
    def loop():
        acc = torch.zeros((), dtype=torch.float32, device=q.device)
        for _ in range(reps):
            d, _ = fn(q + acc * 1e-12, t)
            acc = acc + d[0] * 0.0 + 1.0
        return acc

    def timed(run) -> float:
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop) / reps

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        loop()                               # warm: build, allocator
    torch.cuda.current_stream().wait_stream(side)
    eager = timed(loop)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        loop()
    graph.replay()
    torch.cuda.synchronize()
    ms = timed(graph.replay)
    print(f"{label:34s}: {ms * 1e3:8.1f} us/call graph, "
          f"{eager * 1e3:8.1f} eager", flush=True)
    return {"ms": ms, "eager_ms": eager}


def main() -> dict:
    """Run the bench on the first GPU; returns ``{label: {"ms", "eager_ms"}}``
    per call and the agreement of each variant with the K1 kernel."""
    if not torch.cuda.is_available():
        raise RuntimeError("the NN-variant bench needs a CUDA device")
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    m, n = 16384, 2048
    q = torch.as_tensor(rng.uniform(-30, 30, (m, 3)), dtype=torch.float32,
                        device=dev)
    t = torch.as_tensor(rng.uniform(-30, 30, (n, 3)), dtype=torch.float32,
                        device=dev)
    q8, t8 = pad8(q), pad8(t)
    qa, ta = aug_q(q), aug_t(t)
    sms = nn_search._sm_count(dev)
    times = {}

    times["current (nn_search.cu)"] = measure(
        lambda a, b: nn_search._nearest_cuda(a, b), q, t,
        "current (nn_search.cu)")
    for label, fn, qq, tt in (
            ("packed", lambda a, b, p: nearest_packed(a, b, 11, p), q8, t8),
            ("aug-matmul", lambda a, b, p: nearest_aug(a, b, False, p),
             qa, ta),
            ("aug-matmul packed",
             lambda a, b, p: nearest_aug(a, b, True, p), qa, ta)):
        for r, blk in sorted(INSTANCES):
            p = plan(m, n, r, blk, sms=sms)
            key = f"{label} r={r} block={blk} S={p.splits}"
            times[key] = measure(functools.partial(fn, p=p), qq, tt, key)
    mask = torch.ones((n,), dtype=torch.bool, device=dev)
    times["plain scan tile=1024"] = measure(
        lambda a, b: nn_search._nearest_plain(a, b, mask, tile=1024), q, t,
        "plain scan tile=1024")

    # agreement with the K1 kernel
    d0, i0 = nn_search._nearest_cuda(q, t)
    agreement = {}
    for name, (dv, iv) in (("packed", nearest_packed(q8, t8, 11)),
                           ("aug", nearest_aug(qa, ta, False)),
                           ("aug-packed", nearest_aug(qa, ta, True))):
        agree = float((i0 == iv).float().mean())
        derr = float((d0 - dv).abs().max())
        agreement[name] = {"idx_agree": agree, "max_d2_err": derr}
        print(f"{name} vs current: idx agree {agree:.5f}, max d2 err "
              f"{derr:.2e}", flush=True)
    return {"per_call": times, "agreement": agreement}


if __name__ == "__main__":
    main()
