"""Nearest-neighbour search — the PyTorch/CUDA counterpart of
``staticmapping_tpu.ops.nn_search``.

Brute-force 1-NN replaces the reference's libnabo kd-trees
(registrators/icp_fast.cc:466-468).  Two implementations of one function:

* the CUDA kernel ``csrc/nn_search.cu`` (see its header note), launched by
  :func:`_nearest_cuda` for tensors on the GPU — it replaces the Pallas
  kernels ``_nn_kernel`` (single pair) and ``_nn_kernel_batched`` (a batch
  of pairs);
* :func:`_nearest_plain`, a PyTorch rendition of the JAX package's
  ``_nearest_scan`` / ``_dist2_block``, taken only for CPU tensors.

:func:`nearest_1` picks by the tensors' device and never falls back: a CUDA
tensor goes to the kernel or raises.

Callers should demean clouds first (the reference demeans its target too,
icp_fast.cc:457-463) so f32 cancellation error stays small.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from .. import cuda_build
from ..common import prof

# Far-away coordinate used for invalid/padded points.
_FAR = 1.0e6

# Launches of the CUDA kernel per entry since the last reset: "single" for
# one (query set, target set) pair — the front-end ICP — and "batched" for
# a batch of pairs — the submap-pair registration batch.
launches: Dict[str, int] = {"single": 0, "batched": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _dist2_block(query: torch.Tensor, target_tile: torch.Tensor,
                 q2: Optional[torch.Tensor] = None,
                 t2: Optional[torch.Tensor] = None,
                 out: Optional[list] = None):
    """``[..., M, 3] × [..., T, 3] → [..., M, T]`` squared distances by
    the ``|q|² + |t|² − 2 q·t`` expansion.  ``q2 [..., M, 1]`` and
    ``t2 [..., 1, T]``, where given, are |q|² and |t|² computed once by
    the caller; a |t|² of +inf gives that target a d² of +inf.  The
    passes write into two [..., M, T] buffers kept in the list ``out``
    from call to call (on the CPU a fresh buffer a call costs page faults
    as long as the passes), so the result lives until the next call.
    ``sub_(cross, alpha=2)`` rounds as ``− 2.0 * cross`` does, since
    doubling is exact."""
    if q2 is None:
        q2 = torch.sum(query * query, dim=-1, keepdim=True)
    if t2 is None:
        t2 = torch.sum(target_tile * target_tile, dim=-1)[..., None, :]
    shape = (torch.broadcast_shapes(query.shape[:-2], target_tile.shape[:-2])
             + (query.shape[-2], target_tile.shape[-2]))
    if out is None:
        out = []
    if not out or out[0].shape != shape:
        out[:] = [torch.empty(shape, dtype=query.dtype, device=query.device)
                  for _ in range(2)]
    d2, cross = out
    torch.matmul(query, target_tile.transpose(-1, -2), out=cross)
    torch.add(q2, t2, out=d2)
    return d2.sub_(cross, alpha=2.0).clamp_min_(0.0)


def _nearest_plain(query: torch.Tensor, tgt: torch.Tensor,
                   target_mask: torch.Tensor, tile: int = 1024):
    """Tiled exact 1-NN: ``query [..., M, 3]``, ``tgt [..., N, 3]`` (invalid
    rows already far away), ``target_mask [..., N]`` → ``(d2 [..., M] f32,
    idx [..., M] int32)``.  Ties go to the lowest index, as in
    ``_nearest_scan``: ``min`` returns the first minimum of a tile and a
    later tile must be strictly better.  An invalid target's |t|² is +inf,
    so its d² is +inf."""
    n = tgt.shape[-2]
    batch = torch.broadcast_shapes(query.shape[:-2], tgt.shape[:-2])
    shape = batch + query.shape[-2:-1]
    best_d = torch.full(shape, float("inf"), dtype=torch.float32,
                        device=query.device)
    best_i = torch.zeros(shape, dtype=torch.int32, device=query.device)
    q2 = torch.sum(query * query, dim=-1, keepdim=True)              # [M, 1]
    t2 = torch.sum(tgt * tgt, dim=-1).masked_fill(
        ~target_mask, float("inf"))[..., None, :]                    # [1, N]
    bufs = []
    for start in range(0, n, tile):
        stop = min(start + tile, n)
        d2 = _dist2_block(query, tgt[..., start:stop, :], q2,
                          t2[..., start:stop], bufs)
        tile_best, tile_arg = torch.min(d2, dim=-1)
        take = tile_best < best_d
        best_d = torch.where(take, tile_best, best_d)
        best_i = torch.where(take, tile_arg.to(torch.int32) + start, best_i)
    return best_d, best_i


# Compile-time constants and (R, block) instances of csrc/nn_search.cu.
GROUP = 16               # kGroup: targets per running-min group
PREFETCH = 4             # kPrefetch: targets per thread per shared tile
INSTANCES = frozenset({(2, 128), (2, 256), (4, 64), (4, 128), (4, 256),
                       (8, 64), (8, 128), (8, 256)})
# The default (R, block), chosen by chip_smoke.py's nn_plan_sweep.
DEFAULT_R, DEFAULT_BLOCK = 2, 256
# Splitting the targets fills the card up to about this many warps per SM
# (4 blocks of 128 threads), and no split then holds fewer than MIN_SPLIT
# targets.
WARPS_PER_SM = 16
MIN_SPLIT = 256
H100_SMS = 132


class NNPlan(NamedTuple):
    """A launch of ``csrc/nn_search.cu``.  Split ``s`` covers targets
    ``[s * split_len, min(n, (s + 1) * split_len))``."""
    r: int                      # queries a thread
    block: int                  # threads a block
    splits: int                 # S: target slices, each its own block
    split_len: int              # targets a slice, a multiple of GROUP
    grid: Tuple[int, int, int]  # (query tiles, S, batch)
    scratch: int                # elements of each [S, B, M] partial buffer


def _cut(n: int, splits: int) -> Tuple[int, int]:
    """``(splits, split_len)`` with no empty split."""
    per_split = -(-n // splits)
    length = max(GROUP, -(-per_split // GROUP) * GROUP)
    return max(1, -(-n // length)), length


def split_targets(n: int, blocks: int, block: int, sms: int,
                  splits: Optional[int] = None,
                  cap: Optional[int] = None) -> Tuple[int, int]:
    """``(S, split_len)`` for ``n`` targets behind ``blocks`` blocks of
    ``block`` threads on ``sms`` SMs.  Unless ``splits`` is given, S grows
    until the grid holds about WARPS_PER_SM warps per SM, every split
    holding at least MIN_SPLIT targets and S at most ``cap``."""
    floor = 1
    if splits is None:
        want = WARPS_PER_SM * 32 * sms / (block * max(1, blocks))
        splits = max(1, min(int(want + 0.5), n // MIN_SPLIT,
                            n if cap is None else cap))
        floor = MIN_SPLIT
    if splits < 1:
        raise ValueError(f"splits must be >= 1, got {splits}")
    splits, length = _cut(n, splits)
    while splits > 1 and n - (splits - 1) * length < floor:
        splits, length = _cut(n, splits - 1)
    return splits, length


@functools.lru_cache(maxsize=1024)
def plan(b: int, m: int, n: int, r: Optional[int] = None,
         block: Optional[int] = None, splits: Optional[int] = None,
         sms: int = H100_SMS) -> NNPlan:
    """The launch for ``b`` pairs of ``m`` queries and ``n`` targets on a
    card of ``sms`` SMs.  Unless ``splits`` is given, the targets are split
    until the grid holds about WARPS_PER_SM warps per SM, with every split
    holding at least MIN_SPLIT targets; S is 1 where the query tiles alone
    fill the card.  ``r`` and ``block`` default to the measured best."""
    r = DEFAULT_R if r is None else r
    block = DEFAULT_BLOCK if block is None else block
    if (r, block) not in INSTANCES:
        raise ValueError(f"no kernel instance for r={r}, block={block}; "
                         f"have {sorted(INSTANCES)}")
    tiles = -(-m // (r * block))
    splits, length = split_targets(n, b * tiles, block, sms, splits)
    return NNPlan(r, block, splits, length, (tiles, splits, b),
                  splits * b * m if splits > 1 else 0)


@functools.lru_cache(maxsize=None)
def _kernel_fn():
    fn = cuda_build.load("nn_search").nn_search_forward
    fn.argtypes = [ctypes.c_void_p] * 6 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _nearest_cuda(query: torch.Tensor, tgt: torch.Tensor,
                  launch: Optional[NNPlan] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch ``csrc/nn_search.cu``: ``query [M, 3] | [B, M, 3]``, ``tgt
    [N, 3] | [B, N, 3]`` (f32, contiguous, on one CUDA device; invalid rows
    already far away).  A 2-D operand beside a 3-D one is broadcast over
    the batch.  ``launch`` overrides :func:`plan` for the card's SM count.
    Counts one call under ``single`` (both 2-D) or ``batched``; with S > 1
    the call is two launches, the split kernel and the merge.  Adds the
    call's ``b·m·n`` pairs to the ``prof`` counter ``nn_pairs`` and the
    bytes its operands and results need to ``nn_bytes``."""
    for name, x in (("query", query), ("target", tgt)):
        if not x.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor")
        if x.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {x.dtype}")
        if x.dim() not in (2, 3) or x.shape[-1] != 3:
            raise ValueError(f"{name} must be [N, 3] or [B, N, 3], got "
                             f"{tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if query.device != tgt.device:
        raise ValueError("query and target lie on different devices")
    batched = query.dim() == 3 or tgt.dim() == 3
    b_q = query.shape[0] if query.dim() == 3 else 1
    b_t = tgt.shape[0] if tgt.dim() == 3 else 1
    if b_q != b_t and 1 not in (b_q, b_t):
        raise ValueError(f"batch sizes differ: {b_q} vs {b_t}")
    b = max(b_q, b_t)
    m, n = query.shape[-2], tgt.shape[-2]
    if b > 65535 or m >= 2**31 or n >= 2**30:
        raise ValueError(f"shape out of the kernel's range: B={b} M={m} N={n}")
    p = launch or plan(b, m, n, sms=_sm_count(query.device))
    s = p.splits
    if (p.grid != (-(-m // (p.r * p.block)), s, b) or not 0 < s <= 65535
            or not (s - 1) * p.split_len < max(n, 1) <= s * p.split_len
            or p.scratch != (s * b * m if s > 1 else 0)):
        raise ValueError(f"plan {p} does not fit B={b} M={m} N={n}")
    dev = query.device
    d2 = torch.empty((b, m), dtype=torch.float32, device=dev)
    idx = torch.empty((b, m), dtype=torch.int32, device=dev)
    part_d = part_i = 0                   # the [S, B, M] d' and idx partials
    if p.scratch:
        part = torch.empty(2 * p.scratch, dtype=torch.int32, device=dev)
        part_d = part.data_ptr()
        part_i = part_d + 4 * p.scratch
    rc = _kernel_fn()(
        query.data_ptr(), tgt.data_ptr(), d2.data_ptr(), idx.data_ptr(),
        part_d, part_i, b, m, n,
        m * 3 if query.dim() == 3 and b_q > 1 else 0,
        n * 3 if tgt.dim() == 3 and b_t > 1 else 0,
        p.r, p.block, p.splits, p.split_len,
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"nn_search kernel launch failed: CUDA error {rc}")
    launches["batched" if batched else "single"] += 1
    prof.count("nn_pairs", b * m * n)
    # each query and target read once (12 B), d² and idx written (8 B)
    prof.count("nn_bytes", b * (12 * (m + n) + 8 * m))
    if batched:
        return d2, idx
    return d2[0], idx[0]


def nearest_1(query: torch.Tensor, target: torch.Tensor,
              target_mask: torch.Tensor, tile: int = 1024):
    """1-NN of every query point in target.

    Args:
      query: ``[M, 3]`` or ``[B, M, 3]`` (masked-out queries may hold
        garbage; their result is meaningless and masked by the caller).
      target: ``[N, 3]`` or ``[B, N, 3]``; ``target_mask``: ``[..., N]`` bool.
        An unbatched operand beside a batched one is broadcast.
      tile: target tile of the CPU path.
    Returns:
      ``(d2 [..., M] f32, idx [..., M] int32)``: squared distance and index
      of the nearest valid target point.
    """
    tgt = torch.where(target_mask[..., None], target,
                      torch.full_like(target, _FAR))
    if query.is_cuda:
        return _nearest_cuda(query.contiguous(), tgt.contiguous())
    return _nearest_plain(query, tgt, target_mask,
                          tile=min(tile, tgt.shape[-2]))


def gather_rows(payload: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``payload [..., N, P]`` rows picked by ``idx [..., M]`` → ``[..., M, P]``."""
    idx = idx.long()
    if payload.dim() == 2:
        return payload[idx]
    return torch.gather(payload, -2,
                        idx[..., None].expand(idx.shape + payload.shape[-1:]))


def nearest_select(query: torch.Tensor, target: torch.Tensor,
                   target_mask: torch.Tensor, payload: torch.Tensor):
    """1-NN + payload row gather: ``(d2 [..., M], idx [..., M], selected
    [..., M, P])``."""
    d2, idx = nearest_1(query, target, target_mask)
    return d2, idx, gather_rows(payload, idx)


def knn(query: torch.Tensor, target: torch.Tensor, target_mask: torch.Tensor,
        k: int, tile: int = 1024):
    """k-NN: returns ``(d2 [M, k], idx [M, k])`` sorted ascending by d2.
    The queries go ``tile`` at a time, each block's d² to every target
    in one pass and one ``topk``."""
    tgt = torch.where(target_mask[:, None], target,
                      torch.full_like(target, _FAR))
    t2 = torch.sum(tgt * tgt, dim=-1).masked_fill(
        ~target_mask, float("inf"))[None, :]
    out_d, out_i, bufs = [], [], []
    for start in range(0, query.shape[0], tile):
        d2 = _dist2_block(query[start:start + tile], tgt, t2=t2, out=bufs)
        d, i = torch.topk(d2, k, dim=1, largest=False, sorted=True)
        out_d.append(d)
        out_i.append(i.to(torch.int32))
    return torch.cat(out_d), torch.cat(out_i)


def masked_quantile(values: torch.Tensor, mask: torch.Tensor, q):
    """Quantile over the valid entries of the last axis, matching the
    reference's ``GetDistsQuantile``: sorted[floor(count * q)]
    (icp_fast.cc:65-90)."""
    big = torch.where(mask, values, float("inf"))
    s = torch.sort(big, dim=-1).values
    count = torch.sum(mask, dim=-1)
    idx = (count.to(torch.float32) * q).to(torch.int64)
    idx = idx.clamp(0, values.shape[-1] - 1)
    idx = torch.minimum(idx, (count - 1).clamp_min(0))
    return torch.gather(s, -1, idx[..., None])[..., 0]


def masked_quantile_fast(values: torch.Tensor, mask: torch.Tensor, q,
                         rounds: int = 16) -> torch.Tensor:
    """Approximate masked quantile of the last axis by threshold bisection —
    O(rounds·N), no sort.  Returns an upper bound on the exact quantile
    (keeps at least as many matches as the exact threshold would); it only
    feeds the ICP's robust trimming threshold, where a ≤ range/2^rounds
    overshoot is harmless."""
    v = torch.where(mask, values, 0.0)
    hi = torch.amax(v, dim=-1) + 1e-12
    lo = torch.zeros_like(hi)
    want = q * torch.sum(mask, dim=-1).to(torch.float32)
    for _ in range(rounds):
        mid = 0.5 * (lo + hi)
        c = torch.sum((v <= mid[..., None]) & mask, dim=-1).to(torch.float32)
        below = c < want
        lo = torch.where(below, mid, lo)
        hi = torch.where(below, hi, mid)
    return hi
