"""Fast point-to-plane ICP — the PyTorch counterpart of
``staticmapping_tpu.registration.icp_fast`` (the reference's ``IcpFast``,
registrators/icp_fast.{h,cc}; "type 6").

Iteration structure (icp_fast.cc:455-529): demean the target; move the
source by ``T_target_mean⁻¹·guess``; iterate {transform (or per-point
motion-compensate), 1-NN, quantile outlier trim at ``dist_outlier_ratio``,
weighted point-to-plane normal equations ``A = wF·Fᵀ``, ``b = −wF·(δ·n)``,
solve, left-multiply}; converge when the last-4 smoothed rotation /
translation deltas fall below (0.001 rad, 0.01 m) (cc:377-405).

A batch axis is written into every step (the JAX package vmaps instead):
``align_point_to_plane`` takes one pair or ``B`` pairs, and each pair
freezes on its own ``converged`` flag.  ``IcpFast`` is the stateful
matcher of the factory's type 6.

On a CUDA device the trips between two host checks of ``converged`` (all
of the fixed form's trips) replay as one CUDA graph from the second call
with the same shapes and options on (:class:`_TripBlock`,
:func:`_block_for`): the same kernels, the 1-NN kernel among them, with
one launch in place of a few hundred a trip.
"""
from __future__ import annotations

import dataclasses
import functools
from collections import OrderedDict
from typing import Dict, NamedTuple, Optional

import torch

from ..common import prof, se3
from ..common.trips import TripCounter
from ..data.cloud import PointCloud, NormalCloud
from ..ops import nn_search

_SMOOTH = 4              # kSmoothLength (icp_fast.cc:378)
_CONV_ROT = 1.0e-3       # kConvergeRotDist
_CONV_TRANS = 1.0e-2     # kConvergeTransDist
_RING = _SMOOTH + 2      # ring buffer holds last deltas
# trips between host checks of ``converged`` in the while form: the frozen
# body leaves a converged state unchanged, so checking every few trips
# returns the while loop's exact result with a fraction of its host syncs
_WHILE_CHECK_EVERY = 4

# ICP trips since the last reset_trips(), per trip form ("while", "fixed"),
# summed over pairs: "run" counts the trips executed, "needed" the trips
# each pair took to converge (its ``it``)
_trips: Dict[str, TripCounter] = {"while": TripCounter(),
                                  "fixed": TripCounter()}


def reset_trips() -> None:
    for counter in _trips.values():
        counter.reset()


def trip_counts() -> Dict[str, Dict[str, int]]:
    """``{form: {"run": trips executed, "needed": trips to convergence}}``
    since the last :func:`reset_trips`."""
    return {k: counter.counts() for k, counter in _trips.items()}


class _IcpState(NamedTuple):
    T_iter: torch.Tensor       # [B, 4, 4]
    quats: torch.Tensor        # [B, _RING, 4] recent T_iter rotations
    trans: torch.Tensor        # [B, _RING, 3] recent T_iter translations
    it: torch.Tensor           # [B] int32 iteration counter
    converged: torch.Tensor    # [B] bool
    score: torch.Tensor        # [B] f32 exp(-avg matched dist) of last iter


def _solve6(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched Jacobi-preconditioned 6×6 solve ``[B, 6, 6] × [B, 6]``,
    non-finite-guarded (the reference's LLT→QR→SVD fallback chain,
    icp_fast.cc:204-254, collapses to this in f32).  ``solve_ex`` neither
    raises nor syncs on a singular system; such a row is zeroed, like a
    non-finite one."""
    diag = torch.diagonal(A, dim1=-2, dim2=-1)
    s = 1.0 / torch.sqrt(torch.clamp_min(diag, 1e-10))
    As = (A * s[..., :, None] * s[..., None, :]
          + 1e-8 * torch.eye(6, dtype=A.dtype, device=A.device))
    x, info = torch.linalg.solve_ex(As, (b * s)[..., None])
    x = x[..., 0] * s
    ok = torch.isfinite(x).all(dim=-1) & (info == 0)
    return torch.where(ok[..., None], x, torch.zeros_like(x))


def target_spacing(target: NormalCloud, tile: int = 1024) -> torch.Tensor:
    """Median nearest-neighbour distance among the target's valid points —
    the density scale that makes ``exp(−avg_dist)`` fitness portable across
    sensor densities.  Unbatched ``[M]`` target → scalar."""
    d2, _ = nn_search.knn(target.xyz, target.xyz, target.mask, k=2,
                          tile=min(tile, target.xyz.shape[0]))
    second = torch.sqrt(torch.clamp_min(d2[:, 1], 0.0))   # 1st NN is self
    return nn_search.masked_quantile(second, target.mask, 0.5)


class _IcpInputs(NamedTuple):
    """What a trip reads besides its state."""
    src0: torch.Tensor              # [B, N, 3] source moved by T_init
    src_mask: torch.Tensor          # [B, N] bool
    factor: Optional[torch.Tensor]  # [B, N] compensation shares, or None
    # the demeaned target, _FAR where masked, ++ its normals: [B, M, 6],
    # [M, 6] for one pair
    payload_q: torch.Tensor
    tmask_q: torch.Tensor           # [B, M] | [M] bool
    spacing: Optional[torch.Tensor]  # [B] target spacing, or None

    @property
    def tgt_q(self) -> torch.Tensor:
        return self.payload_q[..., :3]


class _TripOptions(NamedTuple):
    batched: bool
    compensation: bool
    exact_quantile: bool
    dist_outlier_ratio: float
    score_spacing_ref: float


def _trip(x: _IcpInputs, o: _TripOptions, state: _IcpState) -> _IcpState:
    """One ICP trip from ``state``."""
    f32 = torch.float32
    dev = x.src0.device
    # step 0: move source by current iterate, or by each point's share of it
    if o.compensation:
        q_iter = se3.matrix_to_quat(se3.rotation(state.T_iter))
        qi = se3.quat_identity(f32, dev).expand(q_iter.shape)
        f = x.factor[..., None]                               # [B, N, 1]
        q_pp = se3.slerp(qi[:, None, :], q_iter[:, None, :], f)
        step_pts = (se3.quat_rotate(q_pp, x.src0)
                    + se3.translation(state.T_iter)[:, None, :] * f)
    else:
        step_pts = se3.apply(state.T_iter, x.src0)

    # step 1: correspondences (FindClosests, cc:169-180); the kernel's d² is
    # selection-grade, so recompute it exactly from the match
    query = step_pts if o.batched else step_pts[0]
    _, _, sel = nn_search.nearest_select(query, x.tgt_q, x.tmask_q,
                                         x.payload_q)
    if not o.batched:
        sel = sel[None]
    q_pts = sel[..., :3]            # matched target points (demeaned)
    nrm = sel[..., 3:6]
    diff = step_pts - q_pts
    d2 = torch.sum(diff * diff, dim=-1)
    d2 = torch.where(x.src_mask, d2, float("inf"))

    # step 2: trimmed outlier rejection (cc:496-498), by the sorted quantile
    # or the bisection's upper bound of it
    if o.exact_quantile:
        limit = nn_search.masked_quantile(d2, x.src_mask,
                                          o.dist_outlier_ratio)
    else:
        limit = nn_search.masked_quantile_fast(d2, x.src_mask,
                                               o.dist_outlier_ratio)
    w = ((d2 <= limit[:, None]) & x.src_mask).to(f32)

    # step 3: point-to-plane normal equations (ComputePointToPlane)
    cross = torch.linalg.cross(step_pts, nrm, dim=-1)
    F = torch.cat([cross, nrm], dim=-1)                       # [B, N, 6]
    if o.compensation:
        F = F * x.factor[..., None]
    wF = F * w[..., None]
    A = wF.transpose(-1, -2) @ F                              # [B, 6, 6]
    dot = torch.sum(diff * nrm, dim=-1)
    b = -(wF.transpose(-1, -2) @ dot[..., None])[..., 0]      # [B, 6]
    dx = _solve6(A, b)

    # rotation from angle-axis dx[:3], translation dx[3:] (cc:300-312)
    dT = se3.from_rt(se3.axis_angle_to_matrix(dx[:, :3]), dx[:, 3:])
    T_iter = dT @ state.T_iter

    # step 4: convergence bookkeeping (CheckConvergence, cc:377-405)
    qs = torch.cat([state.quats[:, 1:],
                    se3.matrix_to_quat(se3.rotation(T_iter))[:, None]], 1)
    ts = torch.cat([state.trans[:, 1:],
                    se3.translation(T_iter)[:, None]], 1)
    it = state.it + 1
    rot_d = torch.mean(se3.quat_angular_distance(
        qs[:, -_SMOOTH:], qs[:, -_SMOOTH - 1:-1]), dim=-1)
    trans_d = torch.mean(torch.linalg.vector_norm(
        ts[:, -_SMOOTH:] - ts[:, -_SMOOTH - 1:-1], dim=-1), dim=-1)
    # the reference needs > kSmoothLength history entries to check
    converged = ((it >= _SMOOTH + 1) & (rot_d < _CONV_ROT)
                 & (trans_d < _CONV_TRANS))

    # score over kept matches (cc:516-521); a select, not a product with w,
    # because masked slots hold d2 = inf and inf * 0 is NaN
    kept = torch.clamp_min(torch.sum(w, dim=-1), 1.0)
    dist = torch.sqrt(torch.clamp_min(d2, 0.0))
    avg_dist = torch.sum(torch.where(w > 0, dist, 0.0), dim=-1) / kept
    if x.spacing is not None:
        avg_dist = avg_dist * (o.score_spacing_ref / x.spacing)
    score = torch.exp(-avg_dist)
    return _IcpState(T_iter, qs, ts, it, converged, score)


def _frozen_trip(x: _IcpInputs, o: _TripOptions,
                 state: _IcpState) -> _IcpState:
    """A trip that leaves each converged pair's state as it was."""
    new = _trip(x, o, state)
    c = state.converged
    return _IcpState(*(
        torch.where(c.reshape(c.shape + (1,) * (old.dim() - 1)), old, nw)
        for old, nw in zip(state, new)))


class _TripBlock:
    """``trips`` frozen trips over static buffers.  :meth:`load` copies a
    call's inputs and initial state into the buffers, and each :meth:`run`
    advances :attr:`state` in place.  Once :meth:`capture` has recorded
    the trips as a CUDA graph, a run replays it: one launch in place of a
    few hundred a trip.  Before that, and off CUDA, a run issues the same
    operations one by one on the same buffers."""

    def __init__(self, x: _IcpInputs, o: _TripOptions, state: _IcpState,
                 trips: int):
        self.o, self.trips = o, trips
        self.x = _IcpInputs(*(None if t is None else torch.empty_like(t)
                              for t in x))
        self.state = _IcpState(*(torch.empty_like(t) for t in state))
        self.graph = None
        # what one run adds to the nn_search launches and prof counters
        self.launches: Dict[str, int] = {}
        self.counted: Dict[str, int] = {}

    def load(self, x: _IcpInputs, state: _IcpState) -> None:
        for buf, t in zip(self.x, x):
            if buf is not None:
                buf.copy_(t)
        self.set_state(state)

    def set_state(self, state: _IcpState) -> None:
        for buf, t in zip(self.state, state):
            buf.copy_(t)

    def _issue_trips(self) -> None:
        state = self.state
        for _ in range(self.trips):
            state = _frozen_trip(self.x, self.o, state)
        self.set_state(state)

    def run(self) -> _IcpState:
        if self.graph is None:
            self._issue_trips()
            return self.state
        self.graph.replay()
        for k, n in self.launches.items():
            nn_search.launches[k] += n
        for name, n in self.counted.items():
            prof.count(name, n)
        prof.count("icp_graph_trips", self.trips * self.state.it.shape[0])
        return self.state

    def capture(self) -> None:
        """Record the trips as a CUDA graph on a side stream.  Nothing runs
        at the capture, so the launches and counts its host code makes are
        held back and added at each replay instead.  The capture mode is
        thread-local: the front end's stage thread keeps copying while the
        trips are recorded."""
        dev = self.state.T_iter.device
        stream = _capture_stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        before = dict(nn_search.launches)
        graph = torch.cuda.CUDAGraph()
        # cuBLAS keeps a workspace for each stream it ran on.  Cleared
        # before, the capture stream's comes from the graph's own pool,
        # which keeps it for the replays; cleared after, no reference
        # holds it as allocated memory (as torch's cudagraph trees do)
        torch._C._cuda_clearCublasWorkspaces()
        with prof.tally() as held, torch.cuda.stream(stream):
            graph.capture_begin(capture_error_mode="thread_local")
            try:
                self._issue_trips()
            finally:
                graph.capture_end()
        torch._C._cuda_clearCublasWorkspaces()
        torch.cuda.current_stream(dev).wait_stream(stream)
        self.launches = {k: n - before[k]
                         for k, n in nn_search.launches.items()}
        nn_search.launches.update(before)
        self.counted = held
        self.graph = graph
        prof.count("icp_graph_captures")


# a key's block, once captured (most recently used last), and the keys
# seen once: a key is captured at its second call, so a shape that comes
# once never pays for a capture
_MAX_BLOCKS = 8
_blocks: "OrderedDict[tuple, _TripBlock]" = OrderedDict()
_seen: set = set()


@functools.lru_cache(maxsize=None)
def _capture_stream(device: torch.device) -> "torch.cuda.Stream":
    return torch.cuda.Stream(device)


def _block_for(x: _IcpInputs, o: _TripOptions, init: _IcpState,
               trips: int) -> Optional[_TripBlock]:
    """The graph-captured block of ``trips`` trips for these shapes, loaded
    with ``x`` and ``init``; None for CPU tensors and at a key's first
    call."""
    if not x.src0.is_cuda:
        return None
    key = (x.src0.device, x.src0.shape, x.payload_q.shape, o, trips)
    block = _blocks.pop(key, None)
    if block is None and key not in _seen:
        if len(_seen) > 1024:
            _seen.clear()
        _seen.add(key)
        return None
    if block is None:
        block = _TripBlock(x, o, init, trips)
        block.load(x, init)
        block.capture()
        if len(_blocks) >= _MAX_BLOCKS:
            _blocks.popitem(last=False)
    else:
        block.load(x, init)
    _blocks[key] = block
    return block


def align_point_to_plane(
    source: PointCloud,
    target: NormalCloud,
    guess: torch.Tensor,
    dist_outlier_ratio: float = 0.7,
    max_iteration: int = 100,
    tile: int = 1024,
    return_aux: bool = False,
    fixed_iterations: int = 0,
    score_spacing_ref: float = 0.0,
    compensation: bool = False,
    exact_quantile: bool = False,
):
    """Align ``source`` onto ``target``; returns ``(T [4,4], score)`` for one
    pair, or ``(T [B,4,4], score [B])`` when every argument carries a
    leading batch axis.

    ``T`` maps source-frame points into the target frame
    (``T = T_mean · T_iter · T_mean⁻¹ · guess``, icp_fast.cc:526-527).

    ``fixed_iterations > 0`` runs exactly that many trips with no host
    check, each pair frozen once converged (the batched submap-pair form).
    Otherwise the while form runs up to ``max_iteration`` trips, stopping
    once every pair converged; it checks on the host every few trips and
    returns the same result as checking every trip.

    On a CUDA device the trips replay as CUDA graphs from the second call
    with the same shapes and options on (module note); the first call, a
    block cut short by ``max_iteration`` and CPU tensors run them one
    operation at a time.

    ``score_spacing_ref > 0`` reports the density-normalized fitness
    ``exp(−avg_dist · ref / target_spacing)``; 0 keeps the raw
    ``exp(−avg_dist)`` (icp_fast.cc:518-521).

    ``compensation`` moves each source point by its own share (its
    ``factor``) of the current iterate, slerped rotation and lerped
    translation, and weighs its normal-equation row by that share.
    ``exact_quantile`` trims at the sorted quantile (``masked_quantile``)
    instead of the bisection's upper bound.
    """
    batched = source.xyz.dim() == 3
    if not batched:
        source = PointCloud(source.xyz[None], source.intensity[None],
                            source.factor[None], source.mask[None])
        target = NormalCloud(target.xyz[None], target.normals[None],
                             target.mask[None])
        guess = guess[None]
    f32 = torch.float32
    dev = source.xyz.device
    nb = source.xyz.shape[0]
    guess = guess.to(f32)

    # --- demean target (icp_fast.cc:457-463) ---
    tmask = target.mask
    tgt_mean = (torch.sum(torch.where(tmask[..., None], target.xyz, 0.0), -2)
                / target.num_valid().clamp_min(1)[..., None])     # [B, 3]
    tgt_pts = torch.where(tmask[..., None], target.xyz - tgt_mean[:, None],
                          torch.full_like(target.xyz, nn_search._FAR))
    # matched-point payload gathered by index: xyz ++ normal
    tgt_payload = torch.cat([tgt_pts, target.normals], dim=-1)

    eye3 = torch.eye(3, dtype=f32, device=dev).expand(nb, 3, 3)
    T_mean = se3.from_rt(eye3, tgt_mean)
    T_init = se3.inverse(T_mean) @ guess

    if score_spacing_ref > 0.0:
        spacing = torch.stack([
            target_spacing(target[k], tile) for k in range(nb)]).clamp_min(1e-3)
    else:
        spacing = None

    # unbatched pairs go through the kernel's single-pair entry
    x = _IcpInputs(
        se3.apply(T_init, source.xyz), source.mask,
        source.factor if compensation else None,
        tgt_payload if batched else tgt_payload[0],
        tmask if batched else tmask[0], spacing)
    o = _TripOptions(batched, compensation, exact_quantile,
                     float(dist_outlier_ratio), float(score_spacing_ref))

    init = _IcpState(
        torch.eye(4, dtype=f32, device=dev).expand(nb, 4, 4).clone(),
        se3.quat_identity(f32, dev).expand(nb, _RING, 4).clone(),
        torch.zeros((nb, _RING, 3), dtype=f32, device=dev),
        torch.zeros((nb,), dtype=torch.int32, device=dev),
        torch.zeros((nb,), dtype=torch.bool, device=dev),
        torch.zeros((nb,), dtype=f32, device=dev))
    if fixed_iterations > 0:
        form, per_block = "fixed", fixed_iterations
    else:
        form, per_block = "while", min(_WHILE_CHECK_EVERY, max_iteration)
    block = _block_for(x, o, init, per_block)

    def advance(state: _IcpState, n: int) -> _IcpState:
        if block is not None and n == block.trips:
            return block.run()
        for _ in range(n):
            state = _frozen_trip(x, o, state)
        return state

    state = init if block is None else block.state
    if fixed_iterations > 0:
        trips = fixed_iterations
        state = advance(state, trips)
    else:
        trips = 0
        while trips < max_iteration:
            n = min(_WHILE_CHECK_EVERY, max_iteration - trips)
            state = advance(state, n)
            trips += n
            with prof.block("Icp:converged_read"):
                prof.count("host_reads")
                done = bool(state.converged.all())
            if done:
                break
    _trips[form].add(trips * nb, state.it)

    result = T_mean @ state.T_iter @ T_init
    score, it = state.score, state.it
    if block is not None:
        # the block's buffers are the next call's
        score, it = score.clone(), it.clone()
    if not batched:
        result, score, it = result[0], score[0], it[0]
    if return_aux:
        return result, score, it
    return result, score


@dataclasses.dataclass
class IcpFast:
    """Stateful "type 6" matcher with the ``registrator::Interface`` API
    (registrators/interface.h:67-116): set_input_source / set_input_target
    / align.  Options: icp_fast.h:56-60."""

    knn_normal_estimate: int = 7   # kept for config parity (unused, as in
    #                                the reference)
    max_iteration: int = 100
    dist_outlier_ratio: float = 0.7
    tile: int = 1024
    inner_compensation: bool = False
    exact_quantile: bool = False

    TYPE = 6  # registrator::Type::kFastIcp (interface.h:41-50)

    _source: PointCloud = None
    _target: NormalCloud = None
    final_score: float = 0.0

    def set_input_source(self, cloud: PointCloud):
        self._source = cloud

    def set_input_target(self, target: NormalCloud):
        self._target = target

    def align(self, guess: torch.Tensor):
        if self._source is None or self._target is None:
            raise ValueError("set the source and the target before align")
        T, score = align_point_to_plane(
            self._source, self._target, guess,
            dist_outlier_ratio=self.dist_outlier_ratio,
            max_iteration=self.max_iteration, tile=self.tile,
            compensation=self.inner_compensation,
            exact_quantile=self.exact_quantile)
        self.final_score = score
        return T, score
