"""Keyframe / submap containers — the PyTorch counterpart of
``staticmapping_tpu.builder.frame`` (reference: builder/frame.h:33-63,
builder/submap.h:41-51, builder/trajectory.h:57-79).

Clouds live on the device as fixed-capacity ``PointCloud``s; poses are host
float64 numpy, cast to float32 where they meet a device tensor.
"""
from __future__ import annotations

import dataclasses
import os
from typing import List, Optional

import numpy as np
import torch

from .. import resolve_device
from ..common import np_se3, se3
from ..data import cloud as cloud_lib
from ..data.cloud import PointCloud
from ..ops import voxel as voxel_ops
from .mrvm import MrvmSettings, MultiResolutionVoxelMap


def _pose_tensor(poses, device) -> torch.Tensor:
    """Host float64 pose(s) → float32 device tensor (the explicit cast the
    JAX package got implicitly from 32-bit mode)."""
    return torch.as_tensor(np.asarray(poses, dtype=np.float32), device=device)


def _merge_body(xyz, intensity, factor, mask, local_poses, capacity: int,
                voxel_size, voxel_mode) -> PointCloud:
    """Submap merge on stacked tensors ``[..., F, N, ...]`` + poses
    ``[..., F, 4, 4]`` → merged PointCloud of ``capacity`` per leading
    index."""
    lead = xyz.shape[:-3]
    total = xyz.shape[-3] * xyz.shape[-2]
    pts = se3.apply(local_poses, xyz)          # T broadcast over N
    flat = PointCloud(xyz=pts.reshape(lead + (total, 3)),
                      intensity=intensity.reshape(lead + (total,)),
                      factor=factor.reshape(lead + (total,)),
                      mask=mask.reshape(lead + (total,)))
    if flat.capacity > capacity:
        # valid-first order matters only when truncating
        flat = flat.compact()
    merged = flat.slots(slice(None, capacity))
    if voxel_mode is not None:
        merged = voxel_ops.voxel_downsample(merged, voxel_size,
                                            mode=voxel_mode)
    return merged


def _merge_frames(clouds, local_poses, capacity: int, voxel_size,
                  voxel_mode) -> PointCloud:
    """Submap merge (Submap::InsertFrame merge step, submap.cc:98-162):
    transform every frame's cloud into the submap-local frame, flatten,
    compact to ``capacity``, optional voxel filter.  ``local_poses``
    ``[F, 4, 4]``; ``voxel_mode`` None disables the voxel filter."""
    s = cloud_lib.stack(clouds)
    return _merge_body(s.xyz, s.intensity, s.factor, s.mask,
                       _pose_tensor(local_poses, s.device), capacity,
                       voxel_size, voxel_mode)


def _batch_merge_frames(clouds_flat, local_poses, n_frames: int,
                        capacity: int, voxel_size, voxel_mode):
    """Merge S submaps of ``n_frames`` frames each in one batched pass.

    clouds_flat: S·F per-frame ``PointCloud``s in submap-major order;
    local_poses ``[S, F, 4, 4]``.  Returns a tuple of S merged clouds."""
    s = cloud_lib.stack(clouds_flat)

    def split(x):
        return x.reshape((-1, n_frames) + x.shape[1:])

    merged = _merge_body(split(s.xyz), split(s.intensity), split(s.factor),
                         split(s.mask), _pose_tensor(local_poses, s.device),
                         capacity, voxel_size, voxel_mode)
    return tuple(merged[k] for k in range(len(clouds_flat) // n_frames))


@dataclasses.dataclass
class Frame:
    """One keyframe (FrameBase, builder/frame_base.h:51-118)."""

    stamp: float
    cloud: PointCloud                 # sensor-frame points (compensated)
    global_pose: np.ndarray           # [4, 4] f64
    local_pose: np.ndarray = None     # pose within its submap
    match_score: float = 1.0
    descriptor: Optional[np.ndarray] = None   # M2DP, filled by the back end

    def transform_cloud_to_global(self) -> PointCloud:
        return self.cloud.transform(torch.as_tensor(
            self.global_pose, dtype=torch.float32, device=self.cloud.device))


@dataclasses.dataclass
class SubmapOptions:
    """builder/submap_options.h:30-45 (same defaults)."""

    frame_count: int = 5
    enable_voxel_filter: bool = False
    voxel_size: float = 0.1
    enable_inner_mrvm: bool = False
    enable_random_sampling: bool = False
    random_sampling_rate: float = 0.5
    # disk offload (submap.cc:197-236 + memory_manager.cc:51-62)
    enable_disk_saving: bool = False
    disk_saving_delay: int = 30       # inactive seconds before RAM release
    saving_name_prefix: str = "s_"


class Submap:
    """``frame_count`` frames merged in the first frame's coordinate system
    (Submap::InsertFrame, builder/submap.cc:76-163).

    Disk offload (submap.cc:197-236): with a save dir attached, the merged
    cloud can be written to an npz and dropped from memory
    (:meth:`offload`); the next ``.cloud`` access reloads it onto
    ``device``."""

    def __init__(self, submap_id: int, options: SubmapOptions,
                 capacity: int, save_dir: Optional[str] = None,
                 device=None):
        self.id = submap_id
        self.options = options
        self.capacity = capacity
        self.device = device
        self.frames: List[Frame] = []
        self.global_pose: np.ndarray = np.eye(4)   # pose of first frame
        self._cloud: Optional[PointCloud] = None   # merged, submap-local
        self.descriptor: Optional[np.ndarray] = None   # M2DP (back end)
        self.match_transform_to_next: Optional[np.ndarray] = None
        self.match_score_to_previous: float = 1.0
        self.stamp: float = 0.0
        # sensor tags interpolated at the submap stamp
        # (SetRelatedGpsInENU / SetRelatedOdom, map_builder.cc:690-701)
        self.related_gps_enu: Optional[np.ndarray] = None   # [3]
        self.related_odom: Optional[np.ndarray] = None      # [4, 4]
        self.save_dir = save_dir
        self.inactive_time: float = 0.0
        self._on_disk = False
        # target normals, computed once per submap and cached
        self._normals = None
        self._normals_leaf: int = -1
        # when True the orchestrator's batched flush merges the frames
        self.defer_merge = False

    # ---------------------------------------------------- normal cache --
    def normal_cloud(self, leaf_size: int):
        """Downsampled submap cloud + normals at ``leaf_size``, cached."""
        if self._normals is None or self._normals_leaf != leaf_size:
            from .frontend import _target_normals
            self._normals = _target_normals(self.cloud, leaf_size=leaf_size)
            self._normals_leaf = leaf_size
        return self._normals

    def set_normal_cloud(self, nc, leaf_size: int) -> None:
        """Install externally computed normals (batched fill path)."""
        self._normals = nc
        self._normals_leaf = leaf_size

    # ------------------------------------------------- cloud + offload --
    @property
    def cloud(self) -> Optional[PointCloud]:
        """Reload-on-access (submap.cc:217-222); touching resets the
        inactivity age."""
        self.inactive_time = 0.0
        if self._cloud is None and self._on_disk:
            self._load_from_disk()
        return self._cloud

    @cloud.setter
    def cloud(self, value: Optional[PointCloud]):
        self._cloud = value

    @property
    def cloud_in_memory(self) -> bool:
        return self._cloud is not None

    def _disk_path(self) -> str:
        return os.path.join(self.save_dir,
                            f"{self.options.saving_name_prefix}{self.id}.npz")

    def save_to_disk(self) -> bool:
        """Write the valid points of the merged cloud to an npz
        (SaveToDisk role, submap.cc:197-215)."""
        if self.save_dir is None or self._cloud is None:
            return False
        os.makedirs(self.save_dir, exist_ok=True)
        m = self._cloud.mask.cpu().numpy()
        np.savez(self._disk_path(),
                 stamp=self.stamp,
                 xyz=self._cloud.xyz.cpu().numpy()[m],
                 intensity=self._cloud.intensity.cpu().numpy()[m],
                 factor=self._cloud.factor.cpu().numpy()[m])
        self._on_disk = True
        return True

    def offload(self) -> bool:
        """Write to disk (if not already) and drop the memory copy and the
        cached normals (UpdateInactiveTime path, submap.cc:224-236)."""
        if self._cloud is None:
            return False
        if not self._on_disk and not self.save_to_disk():
            return False
        self._cloud = None
        self._normals = None
        self._normals_leaf = -1
        return True

    def _load_from_disk(self) -> None:
        with np.load(self._disk_path()) as z:
            xyz, inten, factor = z["xyz"], z["intensity"], z["factor"]
        dev = resolve_device(self.device)
        pc = cloud_lib.from_numpy(xyz, intensity=inten,
                                  capacity=self.capacity,
                                  stamp_factors=False, device=dev)
        fac = np.zeros((self.capacity,), dtype=np.float32)
        fac[:len(factor)] = factor
        self._cloud = dataclasses.replace(pc,
                                          factor=torch.from_numpy(fac).to(dev))

    def update_inactive_time(self, dt: float) -> Optional[float]:
        """Age the submap; returns the new age (submap.cc:224-236)."""
        self.inactive_time += dt
        return self.inactive_time

    @property
    def full(self) -> bool:
        return len(self.frames) >= self.options.frame_count

    def insert_frame(self, frame: Frame) -> None:
        if self.full:
            raise ValueError(f"submap {self.id} is full")
        if not self.frames:
            self.global_pose = frame.global_pose.copy()
            self.stamp = frame.stamp
        frame.local_pose = np_se3.inverse(self.global_pose) @ frame.global_pose
        self.frames.append(frame)
        if self.full:
            self._finalize()

    def _finalize(self) -> None:
        """Merge frames in local coordinates with the optional inner MRVM
        and voxel filter (submap.cc:98-162)."""
        if self.options.enable_inner_mrvm:
            self._finalize_inner_mrvm()
            return
        if self.defer_merge:
            return   # the batched flush installs the cloud
        poses = np.stack([f.local_pose for f in self.frames])
        self.cloud = _merge_frames(
            tuple(f.cloud for f in self.frames), poses,
            capacity=self.capacity, voxel_size=self.options.voxel_size,
            voxel_mode="round" if self.options.enable_voxel_filter else None)

    def _finalize_inner_mrvm(self) -> None:
        """Dynamic-object removal inside the submap: ray-cast every frame
        from its own viewpoint into an MRVM and keep the occupied voxels'
        average points.  The reference builds this map but never outputs it
        (submap.cc:100-113 ends at a TODO); this follows the JAX package,
        which completes it."""
        vm = MultiResolutionVoxelMap(MrvmSettings(output_average=True,
                                                  prob_threshold=0.5))
        for f in self.frames:
            local = f.cloud.transform(_pose_tensor(f.local_pose,
                                                   f.cloud.device))
            vm.insert_point_cloud(local, f.local_pose[:3, 3])
        pts = vm.output_to_numpy()[:self.capacity]
        merged = cloud_lib.from_numpy(pts[:, :3], pts[:, 3],
                                      capacity=self.capacity,
                                      stamp_factors=False,
                                      device=self.frames[0].cloud.device)
        if self.options.enable_voxel_filter:
            merged = voxel_ops.voxel_downsample(
                merged, self.options.voxel_size, mode="round")
        self.cloud = merged

    def install_merged_cloud(self, pc: PointCloud) -> None:
        """Install the batch-merged cloud (deferred-merge path)."""
        self._cloud = pc

    def update_inner_frame_poses(self) -> None:
        """Submap::UpdateInnerFramePose (submap.cc:268-274): after the
        pose graph moved the submap, its frames follow."""
        for f in self.frames:
            f.global_pose = self.global_pose @ f.local_pose


class MemoryManager:
    """Ages submaps and drops inactive clouds to disk
    (builder/memory_manager.{h,cc}; ticked from the insertion loop).  A
    submap becomes offloadable once its ``match_transform_to_next`` is set
    (submap.cc:197-215)."""

    def __init__(self, trajectory: "Trajectory", delay_seconds: float = 30.0,
                 keep_last: int = 2):
        self.trajectory = trajectory
        self.delay = delay_seconds
        self.keep_last = keep_last
        self._last_tick = None

    def tick(self, now: float) -> int:
        """Age + offload; returns how many submaps were offloaded."""
        if self._last_tick is None:
            self._last_tick = now
            return 0
        dt = now - self._last_tick
        if dt <= 0:
            return 0
        self._last_tick = now
        n_off = 0
        cutoff = max(0, len(self.trajectory) - self.keep_last)
        for s in self.trajectory.submaps[:cutoff]:
            if not s.cloud_in_memory or s.match_transform_to_next is None:
                continue
            if s.update_inactive_time(dt) >= self.delay and s.offload():
                n_off += 1
        return n_off


class Trajectory:
    """Ordered submap list (builder/trajectory.h:57-79)."""

    def __init__(self, trajectory_id: int = 0):
        self.id = trajectory_id
        self.submaps: List[Submap] = []

    def __iter__(self):
        return iter(self.submaps)

    def __len__(self):
        return len(self.submaps)

    def __getitem__(self, i):
        return self.submaps[i]

    def append(self, s: Submap):
        self.submaps.append(s)
