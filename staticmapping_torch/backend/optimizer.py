"""Incremental pose-graph optimizer — the PyTorch counterpart of
``staticmapping_tpu.backend.optimizer``, in the role of the reference's
GTSAM-iSAM2 ``back_end::IsamOptimizer`` (back_end/isam_optimizer.{h,cc}):
``add_submap`` ≈ AddFrame (cc:196-293), ``run_final_optimization`` ≈
RunFinalOptimazation (cc:351-368), ``get_gps_coord_transform`` ≈ cc:370-383.

Instead of an incremental Bayes tree, the whole pose graph is re-solved by
the batched Gauss-Newton of :mod:`pose_graph` when loop closures, GPS or
odometry factors arrive; a chain of between factors alone is already
consistent, so a plain new submap only chains its pose.

Noise models (isam_optimizer.cc:78-94) in (trans, rot) order — gtsam
writes (rot, trans):
  frame match / loop closure: trans 0.15, rot 0.1
  gps: iso 0.15 m
  odom: Huber(1) over trans (1.5, 1.5, 2), rot (0.2, 0.2, 0.2)
  odom-calib prior: trans 0.1, rot (0.5, 0.5, 1.5) when calibrating,
  else iso 1e-6
"""
from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional

import numpy as np

from .. import resolve_device
from ..common import np_se3, prof
from ..descriptor import m2dp
from .loop_detector import LoopDetector, LoopDetectorSettings
from .pose_graph import (PoseGraph, SPECIAL_GPS_CALIB, SPECIAL_GPS_COORD,
                         SPECIAL_ODOM_CALIB)
from .view_graph import ViewGraph

# (trans, rot) sigma order — see the module docstring
FRAME_MATCH_SIGMAS = (0.15, 0.15, 0.15, 0.1, 0.1, 0.1)
LOOP_CLOSURE_SIGMAS = (0.15, 0.15, 0.15, 0.1, 0.1, 0.1)
ODOM_FACTOR_SIGMAS = (1.5, 1.5, 2.0, 0.2, 0.2, 0.2)
ODOM_CALIB_PRIOR_SIGMAS = (0.1, 0.1, 0.1, 0.5, 0.5, 1.5)
ODOM_CALIB_FIXED_SIGMAS = (1e-6,) * 6
GPS_SIGMA = 0.15
# gps coord prior after the standalone solve (isam_optimizer.cc:341-345):
# gtsam (0.1, 0.1, 0.2 | 1, 1, 1) → (trans 1,1,1 | rot 0.1,0.1,0.2)
GPS_COORD_PRIOR_SIGMAS = (1.0, 1.0, 1.0, 0.1, 0.1, 0.2)
# gps tf-error prior (cc:347-349): translation (1, 1, 0.2); rotation pinned
GPS_CALIB_PRIOR_SIGMAS = (1.0, 1.0, 0.2, 1e-4, 1e-4, 1e-4)


@dataclasses.dataclass
class OptimizerOptions:
    """IsamOptimizerOptions (isam_optimizer.h:59-67), with the JAX
    package's names and defaults."""

    use_gps: bool = False
    use_odom: bool = False
    enable_extrinsic_calib: bool = False
    gps_factor_init_num: int = 20
    gps_factor_init_angle_rad: float = 0.5
    gps_factor_sample_step: int = 1
    gn_iterations: int = 8
    output_graph_pic: bool = False    # isam_optimizer.h:62 (ViewGraph png)


class IncrementalOptimizer:
    """The back end: loop detection and pose-graph solves on ``device``
    (the GPU unless the caller names another)."""

    def __init__(self, options: OptimizerOptions = None,
                 loop_settings: LoopDetectorSettings = None,
                 tf_odom_lidar: Optional[np.ndarray] = None,
                 tf_tracking_gps: Optional[np.ndarray] = None,
                 device=None):
        self.device = resolve_device(device)
        self.options = options or OptimizerOptions()
        self.loop_detector = LoopDetector(loop_settings, device=self.device)
        self.graph = PoseGraph(device=self.device)
        self.view_graph = ViewGraph()
        self.loop_edge_count = 0
        self._dirty = False       # factors pending a solve
        self.tf_odom_lidar = (np.eye(4) if tf_odom_lidar is None
                              else np.asarray(tf_odom_lidar, np.float64))
        self.tf_tracking_gps = (np.eye(4) if tf_tracking_gps is None
                                else np.asarray(tf_tracking_gps, np.float64))
        # two-stage GPS init state (isam_optimizer.cc:264-288)
        self._calculated_first_gps_coord = False
        self._cached_enu: Dict[int, np.ndarray] = {}
        self._odom_calib_prior_added = False

    # ------------------------------------------------------------------
    def set_transform_odom_to_lidar(self, T: np.ndarray):
        self.tf_odom_lidar = np.asarray(T, dtype=np.float64)

    def set_transform_tracking_to_gps(self, T: np.ndarray):
        self.tf_tracking_gps = np.asarray(T, dtype=np.float64)

    # ------------------------------------------------------------------
    def add_submap(self, trajectory, submap) -> None:
        """AddFrame: descriptor, loop detection, factors, update."""
        opts = self.options
        # descriptor for the loop detector's M2DP gate
        if (self.loop_detector.settings.use_descriptor
                and submap.descriptor is None):
            with prof.block("M2dpDescriptor"):
                submap.descriptor = m2dp.compute_descriptor(
                    submap.cloud).cpu().numpy()

        idx = self.graph.add_node()
        if not idx == submap.id == len(self.loop_detector.frames):
            raise ValueError(f"submap {submap.id} arrived as node {idx}: "
                             "submaps must be added in order")
        self.view_graph.add_vertex(idx, submap.global_pose)

        if idx > 0:
            prev = trajectory[idx - 1]
            # the previous submap stores the matched transform to this one
            # (SetMatchedTransformedToNext, map_builder.cc:436-444)
            T_prev_cur = prev.match_transform_to_next
            if T_prev_cur is None:
                # fall back to odometry chaining
                T_prev_cur = (np_se3.inverse(prev.global_pose)
                              @ submap.global_pose)
            self.graph.add_between(idx - 1, idx, T_prev_cur,
                                   FRAME_MATCH_SIGMAS)
            self.view_graph.add_edge(idx - 1, idx, T_prev_cur)
            # chain the global pose from the matched transform
            # (ConnectAllSubmap, map_builder.cc:484-489)
            submap.global_pose = np_se3.normalize_rotation(
                prev.global_pose @ T_prev_cur)
            self.view_graph.add_vertex(idx, submap.global_pose)

        # odom extrinsic-calibration factor (isam_optimizer.cc:209-224)
        if opts.use_odom and getattr(submap, "related_odom", None) is not None:
            if not self._odom_calib_prior_added:
                calib_init = np_se3.inverse(self.tf_odom_lidar)
                self.graph.set_special_value(SPECIAL_ODOM_CALIB, calib_init)
                prior_sig = (ODOM_CALIB_PRIOR_SIGMAS
                             if opts.enable_extrinsic_calib
                             else ODOM_CALIB_FIXED_SIGMAS)
                self.graph.add_special_prior(SPECIAL_ODOM_CALIB, calib_init,
                                             prior_sig)
                self._odom_calib_prior_added = True
            self.graph.add_odom(idx, submap.related_odom, ODOM_FACTOR_SIGMAS)
            self._dirty = True

        result = self.loop_detector.add_frame(submap, do_loop_detect=True)

        if result.close_succeed:
            for edge in result.edges:
                self.graph.add_between(edge.target_index, edge.source_index,
                                       edge.transform, LOOP_CLOSURE_SIGMAS)
                self.view_graph.add_edge(edge.target_index,
                                         edge.source_index, edge.transform)
                self.loop_edge_count += 1
            self._dirty = True

        # GPS two-stage init + factors (isam_optimizer.cc:264-293)
        if opts.use_gps and getattr(submap, "related_gps_enu",
                                    None) is not None:
            enu = np.asarray(submap.related_gps_enu, dtype=np.float64)
            if not self._calculated_first_gps_coord:
                if (len(self._cached_enu) < opts.gps_factor_init_num
                        or self._max_heading_change()
                        < opts.gps_factor_init_angle_rad):
                    self._cached_enu[idx] = enu
                else:
                    self._solve_gps_coord_alone(trajectory)
                    for i, cached in sorted(self._cached_enu.items()):
                        self._add_enu_factor(i, cached)
                    self._calculated_first_gps_coord = True
                    self._dirty = True
            elif (opts.gps_factor_sample_step <= 1
                  or idx % opts.gps_factor_sample_step == 0):
                self._add_enu_factor(idx, enu)
                self._dirty = True

        if self._dirty:
            self._solve(trajectory)

    # ------------------------------------------------------------------
    def _add_enu_factor(self, idx: int, enu: np.ndarray) -> None:
        self.graph.add_gps(
            idx, enu, p_tracking_gps=self.tf_tracking_gps[:3, 3],
            sigma=GPS_SIGMA,
            use_calib_error=self.options.enable_extrinsic_calib)

    def _max_heading_change(self) -> float:
        """AnalyseAllFramePoseForMaxRotation (isam_optimizer.cc:176-194):
        the largest angle between the first frame's forward (x) axis and
        any later frame's."""
        frames = self.loop_detector.frames
        if len(frames) <= 1:
            return 0.0
        v0 = frames[0].global_pose[:3, 0]
        best = 0.0
        for f in frames:
            v = f.global_pose[:3, 0]
            d = np.clip(np.dot(v0, v) / (np.linalg.norm(v0)
                                         * np.linalg.norm(v)), -1.0, 1.0)
            best = max(best, abs(float(np.arccos(d))))
        return best

    def _solve_gps_coord_alone(self, trajectory) -> None:
        """SolveGpsCorrdAlone (isam_optimizer.cc:295-349): the map→ENU
        transform from the cached (pose, enu) pairs with the poses held.
        Closed form: Kabsch on the GPS-antenna positions (the reference
        solves the same least squares by GN; its weak prior permits a full
        3-DoF rotation at these sigmas)."""
        p_tg = self.tf_tracking_gps[:3, 3]
        xs, ys = [], []
        for i, enu in sorted(self._cached_enu.items()):
            T = trajectory[i].global_pose
            xs.append(T[:3, :3] @ p_tg + T[:3, 3])   # antenna in map frame
            ys.append(enu)
        X, Y = np.stack(xs), np.stack(ys)
        xc, yc = X.mean(0), Y.mean(0)
        U, _, Vt = np.linalg.svd((X - xc).T @ (Y - yc))
        d = np.sign(np.linalg.det(Vt.T @ U.T))
        R = Vt.T @ np.diag([1.0, 1.0, d]) @ U.T
        T_coord = np_se3.from_rt(R, yc - R @ xc)
        self.graph.set_special_value(SPECIAL_GPS_COORD, T_coord)
        self.graph.add_special_prior(SPECIAL_GPS_COORD, T_coord,
                                     GPS_COORD_PRIOR_SIGMAS)
        if self.options.enable_extrinsic_calib:
            self.graph.set_special_value(SPECIAL_GPS_CALIB, np.eye(4))
            self.graph.add_special_prior(SPECIAL_GPS_CALIB, np.eye(4),
                                         GPS_CALIB_PRIOR_SIGMAS)

    # ------------------------------------------------------------------
    def _solve(self, trajectory) -> None:
        poses = np.stack([s.global_pose for s in trajectory
                          if s.id < self.graph.num_nodes])
        with prof.block("PoseGraphSolve"):
            out = self.graph.optimize(poses,
                                      num_iters=self.options.gn_iterations)
        for s, T in zip(trajectory, out):
            s.global_pose = T
            # UpdateAllPose mirrors the poses into the ViewGraph
            # (isam_optimizer.cc:106-125)
            self.view_graph.add_vertex(s.id, T)
        self._dirty = False

    def save_view_graph(self, out_dir: str) -> None:
        """ViewGraph text + png export (view_graph.h:61-63; saved at
        shutdown when output_graph_pic is on, isam_optimizer.h:62)."""
        os.makedirs(out_dir, exist_ok=True)
        self.view_graph.save_text_file(os.path.join(out_dir,
                                                    "view_graph.txt"))
        self.view_graph.save_image(os.path.join(out_dir, "view_graph.png"))

    def run_final_optimization(self, trajectory) -> None:
        """RunFinalOptimazation (isam_optimizer.cc:351-368)."""
        if self.graph.num_nodes >= 2 and (len(self.graph.factors) > 0
                                          or self.graph.has_aux_factors):
            self._solve(trajectory)
        if self.options.use_odom and self._odom_calib_prior_added:
            # updated calibration: tf_odom_lidar = calib⁻¹ (cc:360-366)
            self.tf_odom_lidar = np_se3.inverse(
                self.graph.get_special_value(SPECIAL_ODOM_CALIB))

    def get_gps_coord_transform(self) -> np.ndarray:
        """GetGpsCoordTransform (isam_optimizer.cc:370-383)."""
        if self.options.use_gps and self._calculated_first_gps_coord:
            return self.graph.get_special_value(SPECIAL_GPS_COORD)
        return np.eye(4)
