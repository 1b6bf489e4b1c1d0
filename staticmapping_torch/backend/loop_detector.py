"""Loop detection over the submap history — the PyTorch counterpart of
``staticmapping_tpu.backend.loop_detector`` (reference: the
``LoopDetector`` of back_end/loop_detector.{h,cc}): distance and z gating
over the history (cc:85-100), the optional M2DP descriptor gate
(cc:110-121), the 5-state loop state machine (cc:155-206), candidate
re-registration (CloseLoop, cc:282-318) and the mutual-consistency check
(CheckResult, cc:320-345).

Candidate gating and descriptor scoring are batched over the whole history;
the candidate re-registrations are one batched ICP call (the reference runs
them on a ``tbb::task_group``), whose correspondence search is the batched
nn_search kernel.  Each accepted edge is then re-verified by GICP, a
different registration family; the scores of all edges come back to the
host in one read.
"""
from __future__ import annotations

import collections
import dataclasses
import enum
import math
from typing import List, Optional, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..common import np_se3, prof
from ..descriptor import m2dp
from ..parallel.align_pairs import align_pair_list


class LoopStatus(enum.Enum):
    NO_LOOP = 0
    TRYING_TO_CLOSE = 1
    ENTERING = 2
    CONTINOUS = 3
    LEAVING = 4


@dataclasses.dataclass
class LoopDetectorSettings:
    """back_end/loop_detector_options.h:29-40, with the JAX package's names
    and defaults."""

    use_gps: bool = False
    use_descriptor: bool = False
    loop_ignore_threshold: int = 15
    trying_detect_loop_count: int = 1
    nearest_history_pos_num: int = 4
    max_close_loop_distance: float = 25.0
    max_close_loop_z_distance: float = 1.0
    m2dp_match_score: float = 0.99
    accept_scan_match_score: float = 0.75
    # shape knobs of the batched verifier
    normal_leaf_size: int = 8
    nn_tile: int = 1024
    # fixed ICP trip count of the batched loop verifier: a while form would
    # run the whole candidate batch to the slowest candidate's count; 40
    # fixed trips cover every converging loop registration, and candidates
    # that have not converged fail the score gate
    fixed_iterations: int = 40
    # density normalization anchor (icp_fast.target_spacing; 0 = raw)
    score_spacing_ref: float = 0.0
    # independent-family acceptance gate: an edge that passes the
    # point-to-plane score must also pass a GICP re-verification at this
    # raw exp(−fitness) score (0 disables) — the reference likewise uses a
    # different library for loop verification (loop_detector.cc:304)
    independent_gate_min_score: float = 0.55


@dataclasses.dataclass
class LoopEdge:
    target_index: int
    source_index: int
    transform: np.ndarray     # T: source submap frame -> target submap frame
    score: float
    init_guess: np.ndarray = None


@dataclasses.dataclass
class DetectResult:
    current_frame_index: int
    status: LoopStatus
    edges: List[LoopEdge] = dataclasses.field(default_factory=list)
    close_succeed: bool = False


class LoopDetector:
    """Feed submaps with :meth:`add_frame`.  Submaps expose ``global_pose``
    (np [4,4]), ``cloud`` (PointCloud) and ``descriptor``.  Descriptor
    scores are computed on ``device`` (the GPU unless named); the clouds
    stay where the submaps hold them.  With a ``mesh``
    (``parallel.multihost``) the candidate re-registrations are sharded
    over its ranks, each of which runs the same detector on the same
    submaps."""

    def __init__(self, settings: LoopDetectorSettings = None, device=None,
                 mesh=None):
        self.settings = settings or LoopDetectorSettings()
        self.device = resolve_device(device)
        self.mesh = mesh
        self.frames = []                      # submap refs
        self.descriptors: List[np.ndarray] = []
        self.status = LoopStatus.NO_LOOP
        self.accumulate_count = 0
        self.search_window: Optional[Tuple[int, int]] = None
        self._target_cache = collections.OrderedDict()  # index → NormalCloud
        self._gicp_cache = collections.OrderedDict()    # index → GicpCloud

    # ------------------------------------------------------------------
    def add_frame(self, submap, do_loop_detect: bool = True) -> DetectResult:
        s = self.settings
        self.frames.append(submap)
        if s.use_descriptor:
            self.descriptors.append(np.asarray(submap.descriptor))
        current = len(self.frames) - 1
        result = DetectResult(current, self.status)
        if not do_loop_detect or len(self.frames) <= s.loop_ignore_threshold:
            return result

        # --- candidate gating (cc:70-100), batched ---
        trans = np.stack([f.global_pose[:3, 3] for f in self.frames])
        cur = trans[current]
        start, end = 0, current - s.loop_ignore_threshold
        if self.search_window is not None:
            start = int(np.clip(self.search_window[0], 0, current))
            end = int(np.clip(self.search_window[1], 0, current))
        cand = np.arange(start, max(end, start))
        in_dist = np.array([], dtype=int)
        xy_kept = np.array([])
        if cand.size:
            xy = np.linalg.norm(trans[cand, :2] - cur[:2], axis=1)
            z = np.abs(trans[cand, 2] - cur[2])
            keep = ((xy <= s.max_close_loop_distance)
                    & (z <= s.max_close_loop_z_distance))
            in_dist, xy_kept = cand[keep], xy[keep]
        closest_index = -1
        if in_dist.size:
            k = int(np.argmin(xy_kept))
            # closest only counts if well within range (cc:97-99)
            if xy_kept[k] < s.max_close_loop_distance * 0.4:
                closest_index = int(in_dist[k])

        # --- descriptor gate (cc:110-121), one batched pass ---
        if in_dist.size and s.use_descriptor:
            with prof.block("LoopM2dpMatch"):
                bank = torch.as_tensor(
                    np.stack([self.descriptors[i] for i in in_dist]),
                    device=self.device)
                scores = m2dp.match_many(
                    torch.as_tensor(self.descriptors[current],
                                    device=self.device), bank).cpu().numpy()
            well_matched = in_dist[scores > s.m2dp_match_score]
        else:
            well_matched = in_dist

        loop_detection = 1 if well_matched.size else 0

        # pick up to nearest_history_pos_num pairs (cc:124-150)
        maybe_pairs: List[Tuple[int, int]] = []
        if loop_detection:
            wm = np.sort(well_matched)
            k = s.nearest_history_pos_num
            if wm.size >= 2 * k:
                step = wm.size // k
                picks = [int(wm[i * step]) for i in range(k)]
            else:
                picks = [int(x) for x in wm[:k]]
            maybe_pairs = [(p, current) for p in picks]
            if (closest_index >= 0
                    and (closest_index, current) not in maybe_pairs):
                maybe_pairs.append((closest_index, current))

        self._advance_state_machine(loop_detection)
        result.status = self.status

        if self.status == LoopStatus.CONTINOUS and maybe_pairs:
            result.edges = self._close_loops(maybe_pairs)
            if result.edges:
                result.close_succeed = self._check_result(result)
        return result

    # ------------------------------------------------------------------
    def _advance_state_machine(self, loop_detection: int) -> None:
        """cc:155-206 — the exact transition table."""
        s = self.settings
        st = self.status
        if st == LoopStatus.NO_LOOP:
            self.accumulate_count = 0
            if loop_detection == 1:
                self.status = LoopStatus.TRYING_TO_CLOSE
                self.accumulate_count += 1
                if self.accumulate_count >= s.trying_detect_loop_count:
                    self.status = LoopStatus.ENTERING
        elif st == LoopStatus.TRYING_TO_CLOSE:
            if loop_detection == 1:
                self.accumulate_count += 1
                if self.accumulate_count >= s.trying_detect_loop_count:
                    self.status = LoopStatus.ENTERING
            else:
                self.status = LoopStatus.NO_LOOP
        elif st == LoopStatus.ENTERING:
            self.status = (LoopStatus.CONTINOUS if loop_detection == 1
                           else LoopStatus.TRYING_TO_CLOSE)
        elif st == LoopStatus.CONTINOUS:
            if loop_detection == 0:
                self.status = LoopStatus.LEAVING
                self.accumulate_count = 0
        elif st == LoopStatus.LEAVING:
            self.status = (LoopStatus.TRYING_TO_CLOSE if loop_detection == 1
                           else LoopStatus.NO_LOOP)

    # ------------------------------------------------------------------
    def _target_normals(self, index: int):
        """Per-target normals: the submap's own cached normal cloud when it
        has one (computed once at pair-match time, ``Submap.normal_cloud``),
        else a local LRU cache — LRU, not FIFO, because CONTINOUS-state
        loops revisit the same targets for many consecutive submaps."""
        frame = self.frames[index]
        if hasattr(frame, "normal_cloud"):
            return frame.normal_cloud(self.settings.normal_leaf_size)
        if index in self._target_cache:
            self._target_cache.move_to_end(index)
        else:
            from ..builder.frontend import _target_normals as fused_normals
            self._target_cache[index] = fused_normals(
                frame.cloud, leaf_size=self.settings.normal_leaf_size)
            while len(self._target_cache) > 32:
                self._target_cache.popitem(last=False)
        return self._target_cache[index]

    def _close_loops(self, pairs: List[Tuple[int, int]]) -> List[LoopEdge]:
        """CloseLoop (cc:282-318) for all candidate pairs at once:
        re-register each source submap onto its target submap from the
        current globals with z zeroed (the reference's trick, cc:290-291).
        The verifier is the IcpPointMatcher pipeline (registration/icp_pm.py:
        hash-thinned reading at the PM RandomSampling 0.9 probability), one
        ``align_pair_list`` call.

        Each candidate runs from three yaw-perturbed guesses in the same
        batch and keeps its best-fitness result: by the time a loop closes,
        yaw drift can put the odometry guess outside ICP's basin."""
        from ..registration.icp_pm import IcpPointMatcher, _hash_thin
        pm = IcpPointMatcher()
        s = self.settings
        yaw_offsets = (0.0, 0.06, -0.06)
        G = len(yaw_offsets)
        sources, targets, guesses = [], [], []
        for target_id, source_id in pairs:
            g0 = (np_se3.inverse(self.frames[target_id].global_pose)
                  @ self.frames[source_id].global_pose)
            g0[2, 3] = 0.0
            src = _hash_thin(self.frames[source_id].cloud,
                             pm.reading_sample_prob)
            tgt = self._target_normals(target_id)
            for dy in yaw_offsets:
                g = g0.copy()
                g[:3, :3] = g0[:3, :3] @ np_se3.euler_to_matrix(
                    np.array([0.0, 0.0, dy]))
                sources.append(src)
                targets.append(tgt)
                guesses.append(g)
        with prof.block("LoopVerifier"):
            Ts, scores = align_pair_list(
                sources, targets, guesses, mesh=self.mesh,
                dist_outlier_ratio=pm.dist_outlier_ratio,
                max_iteration=pm.max_iteration,
                # candidates arrive 1..nearest_history_pos_num+1 at a time:
                # pad to one batch shape
                pad_to=G * (s.nearest_history_pos_num + 1),
                fixed_iterations=s.fixed_iterations,
                score_spacing_ref=s.score_spacing_ref)
        edges = []
        for k, (target_id, source_id) in enumerate(pairs):
            best = int(np.argmax(scores[k * G:(k + 1) * G])) + k * G
            score = scores[best]
            if score > s.accept_scan_match_score:
                edges.append(LoopEdge(
                    target_id, source_id,
                    np_se3.normalize_rotation(Ts[best]),
                    score=-math.log(max(score, 1e-9)),
                    init_guess=guesses[k * G]))
        if edges and s.independent_gate_min_score > 0:
            edges = self._independent_gate(edges)
        return edges

    def _gicp_cloud(self, index: int):
        """Per-submap ``GicpCloud`` (k-NN disk normals), LRU-cached, on a 4×
        slot stride of the voxel-compacted submap cloud: the k-NN normal
        build is O(N²), and the gate is an accept/reject vote, not a fine
        registration.  Cached with the median NN spacing of the thinned
        cloud, which normalizes the gate's score."""
        from ..registration.gicp import compute_point_normals
        from ..registration.icp_fast import target_spacing
        if index in self._gicp_cache:
            self._gicp_cache.move_to_end(index)
        else:
            thin = self.frames[index].cloud.slots(slice(None, None, 4))
            gc = compute_point_normals(thin, k=20)
            self._gicp_cache[index] = (gc, target_spacing(gc))
            while len(self._gicp_cache) > 16:
                self._gicp_cache.popitem(last=False)
        return self._gicp_cache[index]

    def _independent_gate(self, edges: List[LoopEdge]) -> List[LoopEdge]:
        """Re-verify accepted edges with a different registration family
        (GICP disk-covariance ICP) and drop the edges it rejects.  The edge
        transform stays the point-to-plane result; GICP contributes an
        accept/reject vote from a short refinement at that pose, with a
        tight 2 m correspondence gate (what makes disjoint-area pairs score
        low).  Every align runs without a host read; the scores come back
        in one read."""
        from ..registration.gicp import align_gicp
        s = self.settings
        max_iteration = 8
        with prof.block("LoopGicpGate"):
            outs, spacings = [], []
            for e in edges:
                src_g, _ = self._gicp_cloud(e.source_index)
                tgt_g, sp = self._gicp_cloud(e.target_index)
                outs.append(align_gicp(
                    src_g, tgt_g,
                    torch.as_tensor(e.transform, dtype=torch.float32,
                                    device=src_g.xyz.device),
                    max_correspondence_dist=2.0, max_iteration=max_iteration,
                    check_every=max_iteration)[1])
                spacings.append(sp)
            scores = torch.stack(outs)
            if s.score_spacing_ref > 0:
                # exp(-avg_d)^(ref/spacing) == exp(-avg_d * ref/spacing):
                # the density-normalized fitness (icp_fast.target_spacing)
                scores = scores ** (s.score_spacing_ref
                                    / torch.stack(spacings).clamp_min(1e-3))
            scores = scores.cpu().numpy()
        return [e for e, g in zip(edges, scores)
                if float(g) > s.independent_gate_min_score]

    def _check_result(self, result: DetectResult) -> bool:
        """CheckResult (cc:320-345): every edge must agree on the source
        pose within 0.25 m / 0.02 rad."""
        if len(result.edges) <= 1:
            return False
        first = result.edges[0]
        first_pose = self.frames[first.target_index].global_pose @ \
            first.transform
        for edge in result.edges[1:]:
            pose = self.frames[edge.target_index].global_pose @ edge.transform
            diff = np_se3.inverse(first_pose) @ pose
            trans_diff = np.linalg.norm(diff[:3, 3])
            rot_diff = np.linalg.norm(np_se3.matrix_to_euler(diff[:3, :3]))
            if trans_diff > 0.25 or rot_diff > 0.02:
                return False
        return True
