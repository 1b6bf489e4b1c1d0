"""Batched pair registration — the PyTorch counterpart of
``staticmapping_tpu.parallel.align_pairs``.

The reference registers independent pairs on threads: submap-pair matches
on a 6-worker pool (builder/map_builder.cc:705-709), loop-closure candidates
on a ``tbb::task_group`` (back_end/loop_detector.cc:224-228).  Here the
independent problems are stacked along a leading batch axis and solved by
one call of the batched point-to-plane ICP (``icp_fast.align_point_to_plane``
takes a batch); with ``fixed_iterations > 0`` its correspondence search is
the batched nn_search kernel.

Everything here runs on one device.  The JAX package also shards the batch
over a device mesh (``make_submap_mesh``, ``align_pairs_sharded``); those
raise ``NotImplementedError`` until multi-device execution is ported.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..data import cloud as cloud_lib
from ..data.cloud import NormalCloud, PointCloud
from ..registration.icp_fast import align_point_to_plane

_MULTI_DEVICE = ("staticmapping_torch does not support sharding pair "
                 "registration over a device mesh: multi-device execution "
                 "is ROADMAP.md queue A item 18")


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
                max_iteration: int = 100, fixed_iterations: int = 0,
                score_spacing_ref: float = 0.0):
    """Register B independent pairs in one batched call: ``batch_src``
    ``[B, N, ...]``, ``batch_tgt`` ``[B, M, ...]``, ``guesses [B, 4, 4]`` →
    ``(T [B, 4, 4], scores [B])`` on the device.  ``fixed_iterations > 0``
    runs that many trips with converged pairs frozen, instead of the while
    form that stops when every pair has converged."""
    return align_point_to_plane(
        batch_src, batch_tgt, guesses, dist_outlier_ratio=dist_outlier_ratio,
        max_iteration=max_iteration, fixed_iterations=fixed_iterations,
        score_spacing_ref=score_spacing_ref)


def make_submap_mesh(n_devices=None):
    raise NotImplementedError(_MULTI_DEVICE)


def align_pairs_sharded(*args, **kwargs):
    raise NotImplementedError(_MULTI_DEVICE)


def align_pair_list(sources: Sequence[PointCloud],
                    targets: Sequence[NormalCloud],
                    guesses: Sequence[np.ndarray],
                    mesh=None,
                    dist_outlier_ratio: float = 0.7,
                    max_iteration: int = 100,
                    pad_to=None,
                    fixed_iterations: int = 0,
                    score_spacing_ref: float = 0.0
                    ) -> Tuple[List[np.ndarray], List[float]]:
    """Host API: a list of pairs in, host transforms and scores out (one
    read of the device results).  This is what the loop detector calls.

    ``pad_to`` rounds the batch up to a multiple of that value by repeating
    the last pair, so a varying pair count (loop candidates arrive 1..K at
    a time) always runs at one batch shape.  ``mesh`` must be None: the
    sharded path is not ported."""
    if mesh is not None:
        raise NotImplementedError(_MULTI_DEVICE)
    real = len(guesses)
    if pad_to is not None and pad_to > 1:
        pad = (-real) % pad_to
        if pad:
            sources = list(sources) + [sources[-1]] * pad
            targets = list(targets) + [targets[-1]] * pad
            guesses = list(guesses) + [guesses[-1]] * pad
    Ts, scores = align_pairs(
        *stack_pairs(sources, targets, guesses),
        dist_outlier_ratio=dist_outlier_ratio, max_iteration=max_iteration,
        fixed_iterations=fixed_iterations,
        score_spacing_ref=score_spacing_ref)
    # transforms and scores come back in one transfer
    out = torch.cat([Ts.reshape(-1, 16), scores[:, None]], dim=1)
    out = out[:real].cpu().double().numpy()
    return list(out[:, :16].reshape(-1, 4, 4)), [float(s) for s in out[:, 16]]
