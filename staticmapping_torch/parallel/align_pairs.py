"""Batched and sharded pair registration — the PyTorch counterpart of
``staticmapping_tpu.parallel.align_pairs``.

The reference registers independent pairs on threads: submap-pair matches
on a 6-worker pool (builder/map_builder.cc:705-709), loop-closure candidates
on a ``tbb::task_group`` (back_end/loop_detector.cc:224-228).  Here the
independent problems are stacked along a leading batch axis and solved by
one call of the batched point-to-plane ICP (``icp_fast.align_point_to_plane``
takes a batch); with ``fixed_iterations > 0`` its correspondence search is
the batched nn_search kernel.

Over several processes (``parallel/multihost.py``: one rank per device)
:func:`align_pairs_sharded` gives each rank a contiguous slice of the
batch, registers it on the rank's own device, and gathers the results in
rank order; the mean score is reduced over the mesh.  No collective runs
inside the ICP: each rank stops on its own pairs' convergence.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..data import cloud as cloud_lib
from ..data.cloud import NormalCloud, PointCloud
from ..registration.icp_fast import align_point_to_plane
from . import multihost
from .multihost import Mesh, all_gather, all_reduce, check_mesh


def stack_pairs(sources: Sequence[PointCloud],
                targets: Sequence[NormalCloud],
                guesses: Sequence[np.ndarray]):
    """Stack per-pair problems along a new leading batch axis.  All sources
    share a capacity, all targets share a capacity.  Returns
    ``(batch_src, batch_tgt, guesses [B, 4, 4] f32)`` on the sources'
    device."""
    if not len(sources) == len(targets) == len(guesses) > 0:
        raise ValueError("need equally many sources, targets and guesses")
    gs = torch.as_tensor(np.stack([np.asarray(g) for g in guesses]),
                         dtype=torch.float32, device=sources[0].device)
    return cloud_lib.stack(sources), cloud_lib.stack_normals(targets), gs


def pad_pairs(batch_src: PointCloud, batch_tgt: NormalCloud,
              guesses: torch.Tensor, multiple: int):
    """Pad the batch axis up to a multiple of ``multiple`` by repeating the
    last pair; returns ``(src, tgt, guesses, real_count)``."""
    b = guesses.shape[0]
    pad = (-b) % multiple
    if pad == 0:
        return batch_src, batch_tgt, guesses, b

    def rep(x):
        return torch.cat([x, x[-1:].expand((pad,) + x.shape[1:])], dim=0)

    src = PointCloud(*(rep(getattr(batch_src, f))
                       for f in ("xyz", "intensity", "factor", "mask")))
    tgt = NormalCloud(*(rep(getattr(batch_tgt, f))
                        for f in ("xyz", "normals", "mask")))
    return src, tgt, rep(guesses), b


def align_pairs(batch_src: PointCloud, batch_tgt: NormalCloud,
                guesses: torch.Tensor, dist_outlier_ratio: float = 0.7,
                max_iteration: int = 100, exact_quantile: bool = False,
                fixed_iterations: int = 0, score_spacing_ref: float = 0.0):
    """Register B independent pairs in one batched call: ``batch_src``
    ``[B, N, ...]``, ``batch_tgt`` ``[B, M, ...]``, ``guesses [B, 4, 4]`` →
    ``(T [B, 4, 4], scores [B])`` on the device.  ``fixed_iterations > 0``
    runs that many trips with converged pairs frozen, instead of the while
    form that stops when every pair has converged.  ``exact_quantile``
    trims at the sorted quantile instead of the bisection's bound."""
    return align_point_to_plane(
        batch_src, batch_tgt, guesses, dist_outlier_ratio=dist_outlier_ratio,
        max_iteration=max_iteration, fixed_iterations=fixed_iterations,
        score_spacing_ref=score_spacing_ref, exact_quantile=exact_quantile)


def make_submap_mesh(n_devices: Optional[int] = None,
                     device=None) -> Optional[Mesh]:
    """The 1-D mesh over the first ``n_devices`` ranks of the process group
    (every rank when None), each computing on ``device`` (its current GPU
    unless named).  Every rank must call it; a rank outside the mesh gets
    None.  Raises when no process group exists
    (``multihost.initialize``)."""
    multihost.require_group()
    world = dist.get_world_size()
    n = world if n_devices is None else int(n_devices)
    if not 1 <= n <= world:
        raise ValueError(f"a mesh of {n} ranks in a group of {world}")
    if n == world:
        return multihost.global_mesh(device=device)
    group = dist.new_group(list(range(n)), timeout=multihost.DEFAULT_TIMEOUT)
    if dist.get_rank() >= n:
        return None
    return Mesh(group, n, dist.get_rank(), multihost.mesh_device(device))


def _align_shard(src: PointCloud, tgt: NormalCloud, guesses: torch.Tensor,
                 mesh: Mesh, **kw):
    """This rank's pairs registered on its own device: ``(T [b, 4, 4],
    scores [b], mean score over the mesh)``, the mean the average of the
    ranks' means (the JAX package's ``pmean``)."""
    if guesses.device != mesh.device:
        raise ValueError(f"the pairs lie on {guesses.device}, the mesh's "
                         f"rank computes on {mesh.device}")
    Ts, scores = align_pairs(src, tgt, guesses, **kw)
    mean = all_reduce(scores.mean().reshape(1), mesh)[0] / mesh.size
    return Ts, scores, mean


def align_pairs_sharded(batch_src: PointCloud, batch_tgt: NormalCloud,
                        guesses: torch.Tensor, mesh: Mesh,
                        dist_outlier_ratio: float = 0.7,
                        max_iteration: int = 100,
                        exact_quantile: bool = False,
                        already_sharded: bool = False,
                        fixed_iterations: int = 0,
                        score_spacing_ref: float = 0.0):
    """Register a batch of B pairs over ``mesh``: rank r takes the
    contiguous slice ``[r·B/D, (r+1)·B/D)`` (with ``already_sharded`` the
    inputs already are that slice, of one size on every rank).  B must be
    divisible by the mesh size D (:func:`pad_pairs`).  Returns the global
    ``(T [B, 4, 4], scores [B])`` in rank order and the mean score over
    the mesh, the same on every rank."""
    check_mesh(mesh)
    if not already_sharded:
        b = guesses.shape[0]
        if b % mesh.size:
            raise ValueError(f"batch {b} not divisible by mesh size "
                             f"{mesh.size}")
        per = b // mesh.size
        lo, hi = mesh.rank * per, (mesh.rank + 1) * per
        batch_src, batch_tgt = (
            dataclasses.replace(c, **{f.name: getattr(c, f.name)[lo:hi]
                                      for f in dataclasses.fields(c)})
            for c in (batch_src, batch_tgt))
        guesses = guesses[lo:hi]
    Ts, scores, mean = _align_shard(
        batch_src, batch_tgt, guesses, mesh,
        dist_outlier_ratio=dist_outlier_ratio, max_iteration=max_iteration,
        exact_quantile=exact_quantile, fixed_iterations=fixed_iterations,
        score_spacing_ref=score_spacing_ref)
    return all_gather(Ts, mesh), all_gather(scores, mesh), mean


def align_pair_list(sources: Sequence[PointCloud],
                    targets: Sequence[NormalCloud],
                    guesses: Sequence[np.ndarray],
                    mesh: Optional[Mesh] = None,
                    dist_outlier_ratio: float = 0.7,
                    max_iteration: int = 100,
                    exact_quantile: bool = False,
                    pad_to=None,
                    fixed_iterations: int = 0,
                    score_spacing_ref: float = 0.0
                    ) -> Tuple[List[np.ndarray], List[float]]:
    """Host API: a list of pairs in, host transforms and scores out (one
    read of the device results).  This is what the loop detector calls.

    ``pad_to`` rounds the batch up to a multiple of that value by repeating
    the last pair, so a varying pair count (loop candidates arrive 1..K at
    a time) always runs at one batch shape.  A ``mesh`` of more than one
    rank takes the sharded path (every rank passes the same pairs), the
    batch padded to a multiple of the mesh size as well."""
    sharded = mesh is not None and check_mesh(mesh).size > 1
    real = len(guesses)
    if sharded:
        d = mesh.size
        multiple = d if pad_to is None else -(-pad_to // d) * d
    else:
        multiple = pad_to
    if multiple is not None and multiple > 1:
        pad = (-real) % multiple
        if pad:
            sources = list(sources) + [sources[-1]] * pad
            targets = list(targets) + [targets[-1]] * pad
            guesses = list(guesses) + [guesses[-1]] * pad
    kw = dict(dist_outlier_ratio=dist_outlier_ratio,
              max_iteration=max_iteration, exact_quantile=exact_quantile,
              fixed_iterations=fixed_iterations,
              score_spacing_ref=score_spacing_ref)
    if sharded:
        # each rank stacks only its own slice
        per = len(guesses) // mesh.size
        mine = slice(mesh.rank * per, (mesh.rank + 1) * per)
        Ts, scores, _ = align_pairs_sharded(
            *stack_pairs(sources[mine], targets[mine], guesses[mine]), mesh,
            already_sharded=True, **kw)
    else:
        Ts, scores = align_pairs(*stack_pairs(sources, targets, guesses),
                                 **kw)
    # transforms and scores come back in one transfer
    out = torch.cat([Ts.reshape(-1, 16), scores[:, None]], dim=1)
    out = out[:real].cpu().double().numpy()
    return list(out[:, :16].reshape(-1, 4, 4)), [float(s) for s in out[:, 16]]
