"""Multi-trajectory map merging — the PyTorch counterpart of
``staticmapping_tpu.builder.multi_trajectory``: the capability the
reference designed but never finished building.

Reference: ``MultiTrajectoryMapBuilder`` (builder/multi_trajectory/
multi_trajectory_map_builder.h:44-86: LoadBaseMap / LoadIncrementalMap →
cross-trajectory loop detection → joint optimization → merged output) and
``MultiTrajectoryOptimizer`` (back_end/multi_trajectory/
multi_trajectory_optimizer.h:48-84, 64-bit key = trajectory≪32 | submap,
.cc:39-46), both excluded from the reference's build.

All submaps of all trajectories become nodes of one pose graph (node id =
offset(trajectory) + submap id, the flat form of the 64-bit key).  The
intra-trajectory between factors come from each package's
``match_transform_to_next``; cross-trajectory candidates pass a 2-D and z
distance gate and an optional M2DP gate, and all of them are registered in
one batched call (``parallel.align_pairs.align_pair_list``, whose
correspondence search is the batched 1-NN kernel, K2), accepted by score,
and added as loop factors.  One joint ``PoseGraph.optimize`` follows: the
dense solve, or PCG past 192 nodes.
"""
from __future__ import annotations

import dataclasses
import os
from typing import List, Optional, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..backend.pose_graph import PoseGraph
from ..common import np_se3
from ..descriptor import m2dp
from ..parallel.align_pairs import align_pair_list
from .frame import Trajectory
from .map_package import MapPackageOptions, load_trajectory, save_trajectory

# between-factor sigmas (trans xyz, rot xyz) of the JAX package's merge
CHAIN_SIGMAS = (0.1, 0.1, 0.1, 0.05, 0.05, 0.05)
CROSS_SIGMAS = (0.05, 0.05, 0.05, 0.02, 0.02, 0.02)


@dataclasses.dataclass
class MultiTrajectoryOptions:
    """Knobs as in LoopDetectorSettings where they apply
    (loop_detector_options.h:29-40), with the JAX package's defaults."""

    max_distance: float = 25.0        # 2-D candidate gate
    max_z_distance: float = 2.0
    use_descriptor: bool = True
    m2dp_match_score: float = 0.97
    accept_match_score: float = 0.75
    max_pairs: int = 64               # cap on cross edges per merge
    normal_leaf_size: int = 8
    nn_tile: int = 1024
    num_solver_iters: int = 10


class MultiTrajectoryMapBuilder:
    """Load base and incremental trajectories onto ``device`` (the GPU
    unless named), detect cross-trajectory overlaps, jointly optimize,
    export."""

    def __init__(self, options: MultiTrajectoryOptions = None, device=None):
        self.options = options or MultiTrajectoryOptions()
        self.device = resolve_device(device)
        self.trajectories: List[Trajectory] = []

    # ------------------------------------------------------------ load --
    def load_base_map(self, package_dir: str,
                      pkg_options: MapPackageOptions = None,
                      capacity: Optional[int] = None) -> Trajectory:
        """LoadBaseMap (multi_trajectory_map_builder.h:64).  ``capacity``
        gives every submap cloud that many slots (the batched merge stacks
        them, and the normals need a power of two); None sizes each to
        its points, as the JAX package does."""
        return self._load(package_dir, pkg_options, capacity)

    def load_incremental_map(self, package_dir: str,
                             pkg_options: MapPackageOptions = None,
                             capacity: Optional[int] = None) -> Trajectory:
        """LoadIncrementalMap (multi_trajectory_map_builder.h:65)."""
        return self._load(package_dir, pkg_options, capacity)

    def _load(self, package_dir, pkg_options, capacity):
        traj = load_trajectory(package_dir, pkg_options, capacity=capacity,
                               device=self.device)
        self.add_trajectory(traj)
        return traj

    def add_trajectory(self, traj: Trajectory) -> None:
        traj.id = len(self.trajectories)
        self.trajectories.append(traj)

    # ------------------------------------------------------- key layout --
    def _offsets(self) -> List[int]:
        offs, n = [], 0
        for t in self.trajectories:
            offs.append(n)
            n += len(t)
        return offs

    def node_id(self, traj_index: int, submap_id: int) -> int:
        """Flat form of SubmapIdToUint64 (multi_trajectory_optimizer.cc:
        39-46: (trajectory << 32) | submap)."""
        return self._offsets()[traj_index] + submap_id

    # -------------------------------------------------- loop candidates --
    def find_cross_candidates(self) -> List[Tuple[int, int, int, int]]:
        """(traj_a, submap_a, traj_b, submap_b) pairs passing the distance
        (and descriptor) gates, trajectory a before b; more than
        ``max_pairs`` are thinned evenly over the overlap."""
        opts = self.options
        gated = []
        for a in range(len(self.trajectories)):
            for b in range(a + 1, len(self.trajectories)):
                for sa in self.trajectories[a]:
                    pa = sa.global_pose[:3, 3]
                    for sb in self.trajectories[b]:
                        pb = sb.global_pose[:3, 3]
                        if (np.linalg.norm(pa[:2] - pb[:2]) > opts.max_distance
                                or abs(pa[2] - pb[2]) > opts.max_z_distance):
                            continue
                        gated.append((a, sa, b, sb))
        keep = np.ones(len(gated), dtype=bool)
        described = [k for k, (_, sa, _, sb) in enumerate(gated)
                     if sa.descriptor is not None and sb.descriptor is not None]
        if opts.use_descriptor and described:
            # every descriptor pair scored in one call and one host read
            def bank(side):
                return torch.as_tensor(
                    np.stack([np.asarray(gated[k][side].descriptor)
                              for k in described]),
                    dtype=torch.float32, device=self.device)
            scores = m2dp.match_descriptors(bank(1), bank(3)).cpu().numpy()
            keep[described] = scores >= opts.m2dp_match_score
        cands = [(a, sa.id, b, sb.id)
                 for (a, sa, b, sb), k in zip(gated, keep) if k]
        # spread the cap across the overlap instead of truncating the head
        if len(cands) > opts.max_pairs:
            step = len(cands) / opts.max_pairs
            cands = [cands[int(i * step)] for i in range(opts.max_pairs)]
        return cands

    # ---------------------------------------------------------- merge --
    def merge(self, num_candidates_out: Optional[list] = None) -> int:
        """Cross-register the candidates (one batched call), add the
        factors, solve jointly.  Returns the number of accepted cross
        edges."""
        opts = self.options
        if len(self.trajectories) < 2:
            raise ValueError("merge needs at least two trajectories")
        cands = self.find_cross_candidates()
        if num_candidates_out is not None:
            num_candidates_out.append(len(cands))

        accepted = []
        if cands:
            sources, targets, guesses = [], [], []
            for (a, ia, b, ib) in cands:
                sa = self.trajectories[a][ia]
                sb = self.trajectories[b][ib]
                # register b's submap onto a's (a = the target frame); the
                # target normals come from the submap's cache
                sources.append(sb.cloud)
                targets.append(sa.normal_cloud(opts.normal_leaf_size))
                guesses.append(np_se3.inverse(sa.global_pose)
                               @ sb.global_pose)
            Ts, scores = align_pair_list(sources, targets, guesses)
            for k, (a, ia, b, ib) in enumerate(cands):
                if scores[k] >= opts.accept_match_score:
                    accepted.append((a, ia, b, ib,
                                     np_se3.normalize_rotation(Ts[k])))

        offs = self._offsets()
        g = PoseGraph(device=self.device)
        poses = []
        for t in self.trajectories:
            for s in t:
                g.add_node()
                poses.append(s.global_pose)
        # intra-trajectory chains (match_transform_to_next)
        for ti, t in enumerate(self.trajectories):
            for s in t:
                if s.match_transform_to_next is None or s.id + 1 >= len(t):
                    continue
                g.add_between(offs[ti] + s.id, offs[ti] + s.id + 1,
                              s.match_transform_to_next, CHAIN_SIGMAS)
        for (a, ia, b, ib, T) in accepted:
            g.add_between(offs[a] + ia, offs[b] + ib, T, CROSS_SIGMAS)
        # the base trajectory is gauge-fixed by the solver's node-0 prior;
        # every other one is anchored through its cross edges only
        out = g.optimize(np.stack(poses), num_iters=opts.num_solver_iters)
        k = 0
        for t in self.trajectories:
            for s in t:
                s.global_pose = out[k]
                s.update_inner_frame_poses()
                k += 1
        return len(accepted)

    # ---------------------------------------------------------- export --
    def save(self, out_dir: str,
             pkg_options: MapPackageOptions = None) -> None:
        """One package per trajectory, in the merged frame."""
        for t in self.trajectories:
            save_trajectory(t, os.path.join(out_dir, f"trajectory_{t.id}"),
                            pkg_options or MapPackageOptions())
