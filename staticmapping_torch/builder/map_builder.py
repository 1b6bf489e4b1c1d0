"""MapBuilder — the orchestrator; the PyTorch counterpart of
``staticmapping_tpu.builder.map_builder`` (reference:
builder/map_builder.h:122-276).

It owns the front end (the sequential ``FrontEnd`` by default, or the
chunked ``DeviceFrontEnd`` with ``pipelined=True``), the submap builder, the
trajectory and, when one is attached, the pose-graph back end.  Keyframes go
into submaps; full submaps are merged, given target normals and registered
onto their predecessors, one at a time or in batches of ``pair_match_batch``
(the reference's SubmapPairMatch queue, map_builder.cc:399-446), and then
handed to the back end in submap order.  ``finish`` runs the final
optimization and writes ``kitti_pose.txt``, ``path.csv``, the MRVM static
map, the direct combined map and, with ``save_map_package``, the map package
and its pieces (``builder/map_package.py``).
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..common import np_se3, prof
from ..data import cloud as cloud_lib
from ..data.cloud import NormalCloud, PointCloud
from ..data.data_collector import (DataCollector, DataCollectorOptions,
                                   ImuMsg, NavSatFixMsg, OdomMsg)
from ..io import kitti as kitti_io
from ..io import pcd as pcd_io
from ..registration.icp_fast import align_point_to_plane
from .frame import (Frame, MemoryManager, Submap, SubmapOptions, Trajectory,
                    _batch_merge_frames)
from .frontend import FrontEnd, FrontEndOptions, _target_normals
from .map_package import MapPackageOptions, save_map_pieces, save_trajectory
from .mrvm import MrvmSettings, MultiResolutionVoxelMap
from .pipeline import DeviceFrontEnd
from .pose_extrapolator import ImuData, PoseExtrapolator


def _stride_sample(cloud: PointCloud, stride: int) -> PointCloud:
    """Uniform source subsampling for submap-pair registration: compact the
    valid points to the front (stable, so scan-time order survives) and keep
    every ``stride``-th slot, shrinking the capacity by ``stride``.  The
    brute-force correspondence search costs O(capacity_src × capacity_tgt)
    whatever the valid count, so the capacity itself must shrink."""
    return cloud.compact().slots(slice(None, None, stride))


def _batch_pair_align(sources, targets, guesses: torch.Tensor, stride: int,
                      n_iters: int, tile: int,
                      dist_outlier_ratio: float = 0.7,
                      score_spacing_ref: float = 0.0):
    """Submap-pair registration batch (SubmapPairMatch queue,
    map_builder.cc:705-709): stride-sample every source, stack, and run the
    batched fixed-trip point-to-plane ICP, each pair frozen once converged.
    Returns ``(T [B, 4, 4], score [B])`` on the device.

    Submap clouds are voxel-compacted, so a plain slot stride subsamples
    their valid points uniformly without a compact per source."""
    if stride > 1:
        sources = [s.slots(slice(None, None, stride)) for s in sources]
    return align_point_to_plane(
        cloud_lib.stack(sources), cloud_lib.stack_normals(targets), guesses,
        dist_outlier_ratio=dist_outlier_ratio, tile=tile,
        fixed_iterations=n_iters, score_spacing_ref=score_spacing_ref)


def _batch_normals(clouds, leaf_size: int) -> Tuple[NormalCloud, ...]:
    """Target normals of B submap clouds in one batched pass; returns one
    ``NormalCloud`` per input cloud."""
    ncs = _target_normals(cloud_lib.stack(clouds), leaf_size=leaf_size)
    return tuple(ncs[k] for k in range(len(clouds)))


@dataclasses.dataclass
class MapBuilderOptions:
    """MapBuilderOptions (builder/map_builder.h:97-120), with the JAX
    package's names and defaults."""

    front_end: FrontEndOptions = dataclasses.field(
        default_factory=FrontEndOptions)
    submap: SubmapOptions = dataclasses.field(default_factory=SubmapOptions)
    data_collector: DataCollectorOptions = dataclasses.field(
        default_factory=DataCollectorOptions)
    use_imu: bool = False
    # GPS and odometry inputs feed the pose-graph back end
    use_gps: bool = False
    use_odom: bool = False
    export_file_path: str = "./"
    output_kitti_pose: bool = True
    output_mrvm: bool = True
    output_direct_combined_map: bool = True
    # piecewise direct map export: close and restart the combined/MRVM maps
    # every `separate_step` submaps, writing part_map_<k>.pcd /
    # static_part_map_<k>.pcd (whole_options, map_builder.h:104-109,
    # SaveMaps cc:857-891)
    separate_output: bool = False
    separate_step: int = 200
    save_map_package: bool = False
    mrvm_settings: MrvmSettings = dataclasses.field(
        default_factory=MrvmSettings)
    map_package: MapPackageOptions = dataclasses.field(
        default_factory=MapPackageOptions)
    submap_capacity: int = 65536
    # back_end submap matcher (registrators/interface.h:61)
    submap_matcher_accepted_min_score: float = 0.7
    submap_matcher_leaf_size: int = 8
    # source subsampling stride for pair matches (1 = the full cloud)
    submap_matcher_source_stride: int = 4
    enable_submap_pair_match: bool = True
    # chunked device front end (builder/pipeline.py), `pipeline_chunk` scans
    # per chunk; False = the sequential front end (builder/frontend.py)
    pipelined: bool = False
    pipeline_chunk: int = 16
    # match deferred submap pairs `pair_match_batch` at a time in one
    # batched pass (1 = match each submap as it completes)
    pair_match_batch: int = 1
    # fixed ICP trip count of the batched pair matches
    pair_match_fixed_iterations: int = 10
    # density normalization anchor for acceptance scores (metres of target
    # median NN spacing; 0 = the raw exp(-avg_dist) law, interface.h:61)
    score_spacing_ref: float = 0.0


class MapBuilder:
    """Feed scans with :meth:`insert_pointcloud`, then call :meth:`finish`.

    ``device`` is where clouds and the front-end state live: the GPU unless
    the caller names another device.  ``backend`` is an attached pose-graph
    optimizer (``backend.optimizer.IncrementalOptimizer``) or None."""

    def __init__(self, options: MapBuilderOptions = None,
                 filter_chain: Optional[Callable] = None,
                 backend=None, device=None):
        self.options = options or MapBuilderOptions()
        self.backend = backend
        self.device = resolve_device(device)
        if self.options.pipelined:
            if self.options.front_end.matcher_type not in (3, 5, 6):
                raise ValueError(
                    "pipelined=True supports matcher types 3/5/6, got "
                    f"matcher_type={self.options.front_end.matcher_type}; "
                    "use pipelined=False for type 1 (IcpUsingPointMatcher, "
                    "registrators/interface.cc:139-173 registry)")
            # gyro samples ride with each chunk and drive the rotation
            # prediction on the device
            self.options.front_end.use_imu = self.options.use_imu
            self.front_end = DeviceFrontEnd(
                self.options.front_end, filter_chain=filter_chain,
                chunk_size=self.options.pipeline_chunk, device=self.device)
        else:
            # use_imu selects the IMU-driven extrapolator mode
            # (map_builder.cc:68-75: InitialWithImu vs InitialSimpleCTRV)
            extrapolator = (PoseExtrapolator(mode=PoseExtrapolator.MODE_IMU)
                            if self.options.use_imu else None)
            self.front_end = FrontEnd(self.options.front_end,
                                      filter_chain=filter_chain,
                                      extrapolator=extrapolator,
                                      device=self.device)
        self.data_collector = DataCollector(self.options.data_collector)
        self.trajectory = Trajectory(0)
        self._current_submap: Optional[Submap] = None
        self._next_submap_id = 0
        self._pending_submaps: List[Submap] = []       # deferred pair queue
        self._pair_results_inflight: List[tuple] = []  # matched batches
        self._num_scans = 0          # insert_pointcloud calls (span ids)
        self._submap_dir = None
        self.memory_manager: Optional[MemoryManager] = None
        if self.options.submap.enable_disk_saving:
            self._submap_dir = os.path.join(
                self.options.export_file_path, "submaps")
            self.memory_manager = MemoryManager(
                self.trajectory,
                delay_seconds=float(self.options.submap.disk_saving_delay))
        # static extrinsics (SetTrackingTo*, map_builder.h:124-137)
        self.tracking_to_lidar = np.eye(4)
        self.tracking_to_imu = np.eye(4)
        self.tracking_to_odom = np.eye(4)
        self.tracking_to_gps = np.eye(4)
        # live visualization observers (SetShow{Map,Submap,Path,Edge}
        # Function, map_builder.h:139-162)
        self._show_map_fn = None
        self._show_submap_fn = None
        self._show_path_fn = None
        self._show_edge_fn = None
        self.show_map_every = 10      # submaps between whole-map callbacks

    # ----------------------------------------------- observer callbacks --
    # SetShow*Function (map_builder.h:139-162).  Callbacks fire on the host
    # after each completed submap reaches the back end (the reference fires
    # them from the ConnectAllSubmap daemon, map_builder.cc:495-557).
    def set_show_map_function(self, fn) -> None:
        """fn(points [N, 4]) — the current optimized map, every
        ``show_map_every`` submaps and at finish."""
        self._show_map_fn = fn

    def set_show_submap_function(self, fn) -> None:
        """fn(points [N, 4]) — the newest submap cloud (submap frame)."""
        self._show_submap_fn = fn

    def set_show_path_function(self, fn) -> None:
        """fn(poses: List[np [4, 4]]) — the current submap poses."""
        self._show_path_fn = fn

    def set_show_edge_function(self, fn) -> None:
        """fn(edges: List[(i, j)]) — the current pose-graph edges."""
        self._show_edge_fn = fn

    def _notify_observers(self, submap, final: bool = False) -> None:
        if (self._show_submap_fn is not None and submap is not None
                and submap.cloud is not None):
            self._show_submap_fn(cloud_lib.to_numpy(submap.cloud))
        if self._show_path_fn is not None:
            self._show_path_fn([s.global_pose for s in self.trajectory])
        if self._show_edge_fn is not None:
            edges = []
            if self.backend is not None:
                edges = [(a, b) for a, lst
                         in self.backend.view_graph.edges.items()
                         for b, _ in lst]
            self._show_edge_fn(edges)
        if self._show_map_fn is not None and (
                final or len(self.trajectory) % self.show_map_every == 0):
            parts = [cloud_lib.to_numpy(s.cloud.transform(torch.as_tensor(
                         s.global_pose.astype(np.float32),
                         device=s.cloud.device)))
                     for s in self.trajectory if s.cloud is not None]
            if parts:
                self._show_map_fn(np.vstack(parts))

    # ------------------------------------------------- extrinsic setters --
    def set_tracking_to_lidar(self, T: np.ndarray):
        self.tracking_to_lidar = np.asarray(T, dtype=np.float64)

    def set_tracking_to_imu(self, T: np.ndarray):
        self.tracking_to_imu = np.asarray(T, dtype=np.float64)

    def set_tracking_to_odom(self, T: np.ndarray):
        self.tracking_to_odom = np.asarray(T, dtype=np.float64)
        if self.backend is not None:
            # tf_odom_lidar = tracking_to_odom⁻¹ · tracking_to_lidar
            self.backend.set_transform_odom_to_lidar(
                np_se3.inverse(self.tracking_to_odom)
                @ self.tracking_to_lidar)

    def set_tracking_to_gps(self, T: np.ndarray):
        self.tracking_to_gps = np.asarray(T, dtype=np.float64)
        if self.backend is not None:
            self.backend.set_transform_tracking_to_gps(self.tracking_to_gps)

    # ------------------------------------------------------------------
    def insert_pointcloud(self, stamp: float, points: np.ndarray) -> None:
        """InsertPointcloudMsg for host arrays (map_builder.cc:156-178):
        transform into the tracking frame, accumulate, then feed the front
        end."""
        with prof.block("InsertPointcloud", req=self._num_scans):
            self._num_scans += 1
            self._insert_pointcloud(stamp, points)

    def _insert_pointcloud(self, stamp: float, points: np.ndarray) -> None:
        points = np.asarray(points)
        if not np.allclose(self.tracking_to_lidar, np.eye(4)):
            R = self.tracking_to_lidar[:3, :3].astype(points.dtype)
            t = self.tracking_to_lidar[:3, 3].astype(points.dtype)
            xyz = points[:, :3] @ R.T + t
            points = (np.column_stack([xyz, points[:, 3:]])
                      if points.shape[1] > 3 else xyz)
        out = self.data_collector.add_cloud(stamp, points)
        if out is None:
            return
        frame = self.front_end.process(*out)
        if isinstance(frame, list):           # pipelined: keyframe burst
            for f in frame:
                self._insert_frame(f)
        elif frame is not None:
            self._insert_frame(frame)

    def insert_imu(self, stamp: float, angular_velocity, linear_acceleration):
        """InsertImuMsg (map_builder.cc:172-192): rotate into the tracking
        frame, store, and hand the gyro sample to the chunked front end."""
        R = self.tracking_to_imu[:3, :3]
        w = R @ np.asarray(angular_velocity, dtype=np.float64)
        a = R @ np.asarray(linear_acceleration, dtype=np.float64)
        self.data_collector.add_imu(ImuMsg(stamp, w, a))
        if self.options.pipelined:
            self.front_end.add_imu(stamp, w)
        else:
            self.front_end.extrapolator.add_imu_data(ImuData(stamp, w, a))

    def insert_odom(self, stamp: float, pose: np.ndarray) -> None:
        """InsertOdomMsg (map_builder.cc:194-205), for INS-RTK-class
        odometry; only the pose is used."""
        if self.options.use_odom:
            self.data_collector.add_odom(OdomMsg(stamp, np.asarray(pose)))

    def insert_gps(self, stamp: float, latitude: float, longitude: float,
                   altitude: float, status: int = 0) -> None:
        """InsertGpsMsg (map_builder.cc:206-211)."""
        if self.options.use_gps:
            self.data_collector.add_gps(NavSatFixMsg(
                stamp, latitude, longitude, altitude, status))

    def _insert_frame(self, frame: Frame) -> None:
        """InsertFrameForSubmap + the SubmapProcessing merge step
        (map_builder.cc:221-229, 662-709)."""
        with prof.block("SubmapInsert"):
            self._insert_frame_inner(frame)

    def _insert_frame_inner(self, frame: Frame) -> None:
        opts = self.options
        if self._current_submap is None or self._current_submap.full:
            self._current_submap = Submap(
                self._next_submap_id, opts.submap,
                capacity=opts.submap_capacity, save_dir=self._submap_dir,
                device=self.device)
            # batched path: the flush merges the frames
            self._current_submap.defer_merge = (
                opts.pair_match_batch > 1
                and not opts.submap.enable_inner_mrvm)
            self._next_submap_id += 1
            self.trajectory.append(self._current_submap)
        if self.memory_manager is not None:
            self.memory_manager.tick(time.monotonic())
        submap = self._current_submap
        submap.insert_frame(frame)
        if not submap.full:
            return
        # sensor tags at the submap stamp (map_builder.cc:690-701)
        if opts.use_gps:
            submap.related_gps_enu = self.data_collector.interpolate_gps(
                submap.stamp, 0.001, trim_data=True)
        if opts.use_odom:
            submap.related_odom = self.data_collector.interpolate_odom(
                submap.stamp, 0.001, trim_data=True)
        if opts.pair_match_batch > 1:
            self._pending_submaps.append(submap)
            if len(self._pending_submaps) >= opts.pair_match_batch:
                self._flush_pair_matches()
            return
        if opts.enable_submap_pair_match and submap.id > 0:
            self._submap_pair_match(submap.id, submap.id - 1)
        self._to_backend(submap)

    def _to_backend(self, submap: Submap) -> None:
        """Hand a matched submap to the back end, then the observers."""
        if self.backend is not None:
            self.backend.add_submap(self.trajectory, submap)
        self._notify_observers(submap)

    def _flush_pair_matches(self, drain: bool = False) -> None:
        """Resolve the deferred pair-match queue (SubmapPairMatch,
        map_builder.cc:399-446) in three batched passes: merge the queued
        submaps, build the missing target normals, register every pair.
        The results are read back one flush later
        (:meth:`_consume_pair_results`), so the device works through this
        flush while the host feeds the next chunks; ``drain=True``
        (finish) reads everything now."""
        queued = self._pending_submaps
        self._pending_submaps = []
        if queued:
            opts = self.options
            pairs = [s for s in queued
                     if opts.enable_submap_pair_match and s.id > 0]
            record = (queued, [], [], None, None)
            with prof.block("SubmapPairMatchBatch"):
                self._batch_finalize(queued)
                if pairs:
                    leaf = opts.submap_matcher_leaf_size
                    target_subs = [self.trajectory[s.id - 1] for s in pairs]
                    missing = [t for t in target_subs
                               if t._normals is None
                               or t._normals_leaf != leaf]
                    if missing:
                        ncs = _batch_normals([t.cloud for t in missing], leaf)
                        for t, nc in zip(missing, ncs):
                            t.set_normal_cloud(nc, leaf)
                    guesses = [
                        np_se3.inverse(
                            self.trajectory[s.id - 1].frames[0].global_pose)
                        @ s.frames[0].global_pose for s in pairs]
                    gs = torch.as_tensor(
                        np.stack(guesses).astype(np.float32),
                        device=self.device)
                    Ts_d, scores_d = _batch_pair_align(
                        [s.cloud for s in pairs],
                        [t.normal_cloud(leaf) for t in target_subs], gs,
                        stride=opts.submap_matcher_source_stride,
                        n_iters=opts.pair_match_fixed_iterations,
                        tile=opts.front_end.nn_tile,
                        score_spacing_ref=opts.score_spacing_ref)
                    record = (queued, pairs, guesses, Ts_d, scores_d)
            self._pair_results_inflight.append(record)
        # one record stays in flight during the insert loop
        keep = 0 if drain else 1
        while len(self._pair_results_inflight) > keep:
            self._consume_pair_results()

    def _batch_finalize(self, queued: List[Submap]) -> None:
        """Merge the queued submaps' frames in one batched pass (the
        deferred ``Submap._finalize``; submap.cc:98-162)."""
        todo = [s for s in queued
                if s.defer_merge and s.cloud is None and s.frames]
        if not todo:
            return
        counts = {len(s.frames) for s in todo}
        if len(counts) != 1:
            # ragged tail (end of stream): per-submap merges
            for s in todo:
                s.defer_merge = False
                s._finalize()
            return
        opts = self.options.submap
        merged = _batch_merge_frames(
            [f.cloud for s in todo for f in s.frames],
            np.stack([np.stack([f.local_pose for f in s.frames])
                      for s in todo]),
            n_frames=counts.pop(), capacity=self.options.submap_capacity,
            voxel_size=opts.voxel_size,
            voxel_mode="round" if opts.enable_voxel_filter else None)
        for s, pc in zip(todo, merged):
            s.install_merged_cloud(pc)

    def _consume_pair_results(self) -> None:
        """Read back the oldest matched batch, store each pair's transform
        on its target submap, then hand the batch's submaps to the back end
        in submap order."""
        queued, pairs, guesses, Ts_d, scores_d = \
            self._pair_results_inflight.pop(0)
        # the batch's request id is its first submap's id
        with prof.block("SubmapPairConsume", req=queued[0].id):
            if pairs:
                with prof.block("SubmapPairConsume:read"):
                    prof.count("host_reads", 2)
                    Ts = Ts_d.cpu().double().numpy()
                    scores = scores_d.cpu().double().numpy()
                for k, s in enumerate(pairs):
                    self._store_pair_result(s, self.trajectory[s.id - 1],
                                            Ts[k], float(scores[k]),
                                            guesses[k])
            for s in queued:
                self._to_backend(s)

    def _store_pair_result(self, source: Submap, target: Submap,
                           T: np.ndarray, score: float,
                           guess: np.ndarray) -> None:
        """Accept the matched transform, or keep the odometry transform
        when the score is too low (map_builder.cc:439-444)."""
        source.match_score_to_previous = score
        if score >= self.options.submap_matcher_accepted_min_score:
            target.match_transform_to_next = np_se3.normalize_rotation(T)
        else:
            target.match_transform_to_next = np.asarray(guess,
                                                        dtype=np.float64)

    def _submap_pair_match(self, source_index: int, target_index: int) -> None:
        """SubmapPairMatch (map_builder.cc:399-446) of one pair: register
        submap ``source`` onto its predecessor with the while-form ICP; the
        predecessor stores the transform to next."""
        with prof.block("SubmapPairMatch"):
            source = self.trajectory[source_index]
            target = self.trajectory[target_index]
            guess = (np_se3.inverse(target.frames[0].global_pose)
                     @ source.frames[0].global_pose)
            target_nc = target.normal_cloud(
                self.options.submap_matcher_leaf_size)
            stride = self.options.submap_matcher_source_stride
            src = (_stride_sample(source.cloud, stride) if stride > 1
                   else source.cloud)
            T, score = align_point_to_plane(
                src, target_nc,
                torch.as_tensor(guess.astype(np.float32), device=self.device),
                tile=self.options.front_end.nn_tile,
                score_spacing_ref=self.options.score_spacing_ref)
            self._store_pair_result(source, target,
                                    T.cpu().double().numpy(), float(score),
                                    guess)

    # ------------------------------------------------------------------
    def finish(self) -> None:
        """FinishAllComputations (map_builder.cc:715-746): flush the front
        end and the pair queue, run the final optimization, then write the
        outputs (SaveMaps cc:825-911).  Stops the chunked front end's stage
        thread."""
        with prof.block("Finish"):
            self._finish()

    def _finish(self) -> None:
        if self.options.pipelined:
            for f in self.front_end.flush():
                self._insert_frame(f)
            self.front_end.close()
        self._flush_pair_matches(drain=True)
        if self.backend is not None:
            self.backend.run_final_optimization(self.trajectory)
            for s in self.trajectory:
                s.update_inner_frame_poses()
            self._calculate_coord_transform_to_gps()

        out_dir = self.options.export_file_path
        os.makedirs(out_dir, exist_ok=True)
        if self.options.output_kitti_pose:
            kitti_io.write_poses(os.path.join(out_dir, "kitti_pose.txt"),
                                 self.submap_poses())
        self._output_path_files(out_dir)
        if self.options.output_mrvm or self.options.output_direct_combined_map:
            self._save_maps(out_dir)
        if self.options.save_map_package:
            package_dir = os.path.join(out_dir, "map_package")
            save_trajectory(self.trajectory, package_dir,
                            self.options.map_package)
            # bounded-size map pieces (SaveTrajectoriesAsMapPackage,
            # map_package.cc:51-230)
            save_map_pieces(self.trajectory,
                            os.path.join(package_dir, "pieces"),
                            self.options.map_package,
                            self.options.mrvm_settings)
        if (self.backend is not None
                and self.backend.options.output_graph_pic):
            self.backend.save_view_graph(out_dir)
        self._notify_observers(None, final=True)

    def _calculate_coord_transform_to_gps(self) -> None:
        """CalculateCoordTransformToGps (map_builder.cc:748-762): rotate the
        whole map into the ENU frame."""
        if not self.options.use_gps:
            return
        T = self.backend.get_gps_coord_transform()
        if np.allclose(T, np.eye(4)):
            return
        for submap in self.trajectory:
            submap.global_pose = np_se3.normalize_rotation(
                T @ submap.global_pose)
            submap.update_inner_frame_poses()

    def _output_path_files(self, out_dir: str) -> None:
        """OutputPath (map_builder.cc:615-642): path.csv with stamp,
        translation and quaternion of every keyframe."""
        rows = []
        for s in self.trajectory:
            for f in s.frames:
                q = np_se3.matrix_to_quat(f.global_pose[:3, :3])
                rows.append([f.stamp, *f.global_pose[:3, 3], *q])
        if rows:
            np.savetxt(os.path.join(out_dir, "path.csv"), np.asarray(rows),
                       header="stamp x y z qw qx qy qz", comments="# ")
        # raw sensor paths (RawGpsDataToFile / RawOdomDataToFile,
        # data_collector.cc:58-71)
        gps_path = self.data_collector.raw_gps_path()
        if gps_path.size:
            pcd_io.write_pcd(os.path.join(out_dir, "original_gps.pcd"),
                             gps_path)
        odom_path = self.data_collector.raw_odom_path()
        if odom_path.size:
            pcd_io.write_pcd(os.path.join(out_dir, "original_odom.pcd"),
                             np.column_stack([odom_path,
                                              np.zeros(len(odom_path))]))

    def _write_static(self, path: str, mrvm: MultiResolutionVoxelMap
                      ) -> None:
        pts = mrvm.output_to_numpy()
        if self.options.mrvm_settings.output_rgb:
            # grayscale rgb from intensity (OutputToPointCloud cc:187-209)
            pcd_io.write_pcd_rgb(path, pts[:, :3], pts[:, 3])
        else:
            pcd_io.write_pcd(path, pts)

    def _save_maps(self, out_dir: str) -> None:
        """SaveMaps (map_builder.cc:825-911): every submap cloud at its
        final global pose, ray-cast into the MRVM for ``static_map.pcd`` and
        stacked for ``whole_map.pcd``.  With ``separate_output`` both maps
        are written and restarted every ``separate_step`` submaps
        (cc:857-891).

        The MRVM runs one deep: the device reduces submap k's ray events
        while the host merges submap k−1's into the store."""
        opts = self.options
        mrvm = (MultiResolutionVoxelMap(opts.mrvm_settings)
                if opts.output_mrvm else None)
        combined = []
        n_submaps = len(self.trajectory)
        pending = None

        def drain():
            nonlocal pending
            if pending is not None:
                mrvm.consume(pending)
                pending = None

        with prof.block("SaveMaps"):
            for s in self.trajectory:
                if s.cloud is not None:
                    global_cloud = s.cloud.transform(torch.as_tensor(
                        s.global_pose.astype(np.float32),
                        device=s.cloud.device))
                    if mrvm is not None:
                        handle = mrvm.dispatch(global_cloud,
                                               s.global_pose[:3, 3])
                        drain()
                        pending = handle
                    if opts.output_direct_combined_map:
                        combined.append(cloud_lib.to_numpy(global_cloud))
                # flush on the part boundary even when this submap's cloud
                # is missing, so the tail part is always written
                if opts.separate_output and (
                        s.id == n_submaps - 1
                        or (s.id + 1) % opts.separate_step == 0):
                    part = s.id // opts.separate_step
                    if opts.output_direct_combined_map and combined:
                        pcd_io.write_pcd(
                            os.path.join(out_dir, f"part_map_{part}.pcd"),
                            np.vstack(combined))
                        combined = []
                    drain()
                    if mrvm is not None and mrvm.num_voxels:
                        self._write_static(
                            os.path.join(out_dir,
                                         f"static_part_map_{part}.pcd"),
                            mrvm)
                        mrvm = MultiResolutionVoxelMap(opts.mrvm_settings)
            drain()
            if opts.separate_output:
                return
            if mrvm is not None and mrvm.num_voxels:
                self._write_static(os.path.join(out_dir, "static_map.pcd"),
                                   mrvm)
            if combined:
                pcd_io.write_pcd(os.path.join(out_dir, "whole_map.pcd"),
                                 np.vstack(combined))

    def submap_poses(self) -> List[np.ndarray]:
        return [s.global_pose for s in self.trajectory]

    def frame_poses(self) -> List[np.ndarray]:
        return [f.global_pose for s in self.trajectory for f in s.frames]
