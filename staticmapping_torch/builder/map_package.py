"""Map package: whole-map serialization — the PyTorch counterpart of
``staticmapping_tpu.builder.map_package`` (reference: builder/map_package.
{h,cc}; Trajectory::ToXmlNode trajectory.cc:32-58; GenerateMapPackage
map_builder.cc:807-814).

A package holds per-submap poses, inter-submap transforms, frame skeletons
and cloud payloads: the substrate of checkpoint/resume and of the
multi-trajectory merge.  Its format is the JAX package's, so a package
written by either package loads in the other: a ``map.xml`` descriptor
plus one ``submap_<id>.npz`` per submap holding ``points`` (``[n, 4]``
x, y, z, intensity, the valid points) and, once the back end computed it,
``descriptor`` (M2DP).  Poses are host float64 and written with 9
significant digits.

``save_map_pieces`` tiles the map into bounded pieces, each a static map
built by the port's ``MultiResolutionVoxelMap`` on the device.
"""
from __future__ import annotations

import dataclasses
import os
import xml.etree.ElementTree as ET
from typing import Optional

import numpy as np
import torch

from .. import resolve_device
from ..common import prof
from ..data import cloud as cloud_lib
from ..io import pcd as pcd_io
from .frame import Frame, Submap, SubmapOptions, Trajectory
from .mrvm import MrvmSettings, MultiResolutionVoxelMap


@dataclasses.dataclass
class MapPackageOptions:
    """builder/map_package.h:36-42, with the JAX package's names and
    defaults."""

    enable: bool = True
    border_offset: float = 100.0
    piece_width: float = 500.0
    cloud_file_prefix: str = "submap_"
    descript_filename: str = "map.xml"


def _pose_to_str(T: np.ndarray) -> str:
    return " ".join(f"{v:.9g}" for v in np.asarray(T, dtype=np.float64)
                    .reshape(-1))


def _pose_from_str(s: str) -> np.ndarray:
    return np.array(s.split(), dtype=np.float64).reshape(4, 4)


def save_trajectory(trajectory: Trajectory, out_dir: str,
                    options: MapPackageOptions = None) -> str:
    """Write the package; returns the path of the descriptor XML."""
    options = options or MapPackageOptions()
    with prof.block("SaveTrajectory"):
        os.makedirs(out_dir, exist_ok=True)
        root = ET.Element("MapPackage")
        traj_el = ET.SubElement(root, "Trajectory", id=str(trajectory.id))
        for s in trajectory:
            file_name = f"{options.cloud_file_prefix}{s.id}.npz"
            sub_el = ET.SubElement(traj_el, "Submap", id=str(s.id),
                                   stamp=f"{s.stamp:.9f}", file=file_name)
            ET.SubElement(sub_el, "GlobalPose").text = _pose_to_str(
                s.global_pose)
            if s.match_transform_to_next is not None:
                ET.SubElement(sub_el, "TransformToNext").text = \
                    _pose_to_str(s.match_transform_to_next)
            frames_el = ET.SubElement(sub_el, "Frames")
            for f in s.frames:
                f_el = ET.SubElement(frames_el, "Frame",
                                     stamp=f"{f.stamp:.9f}",
                                     score=f"{f.match_score:.6f}")
                ET.SubElement(f_el, "LocalPose").text = _pose_to_str(
                    f.local_pose if f.local_pose is not None else np.eye(4))
            if s.cloud is not None:
                payload = {"points": cloud_lib.to_numpy(s.cloud)}
                if s.descriptor is not None:
                    payload["descriptor"] = np.asarray(s.descriptor)
                np.savez_compressed(os.path.join(out_dir, file_name),
                                    **payload)
        tree = ET.ElementTree(root)
        ET.indent(tree)
        path = os.path.join(out_dir, options.descript_filename)
        tree.write(path)
    return path


def load_trajectory(package_dir: str, options: MapPackageOptions = None,
                    submap_options: SubmapOptions = None,
                    capacity: Optional[int] = None,
                    device=None) -> Trajectory:
    """Reload a saved package onto ``device`` (the GPU unless named): the
    role promised by the reference's
    MultiTrajectoryMapBuilder::LoadBaseMap (multi_trajectory_map_builder.
    h:64).  Each submap cloud gets ``capacity`` slots, or the smallest
    2048-multiple that holds it; its frames come back as skeletons (stamp,
    score, local and global pose, no cloud)."""
    options = options or MapPackageOptions()
    submap_options = submap_options or SubmapOptions()
    dev = resolve_device(device)
    root = ET.parse(os.path.join(package_dir,
                                 options.descript_filename)).getroot()
    traj_el = root.find("Trajectory")
    trajectory = Trajectory(int(traj_el.get("id")))
    for sub_el in traj_el.findall("Submap"):
        s = Submap(int(sub_el.get("id")), submap_options,
                   capacity=capacity or 1, device=dev)
        s.stamp = float(sub_el.get("stamp"))
        s.global_pose = _pose_from_str(sub_el.find("GlobalPose").text)
        nxt = sub_el.find("TransformToNext")
        if nxt is not None:
            s.match_transform_to_next = _pose_from_str(nxt.text)
        npz_path = os.path.join(package_dir, sub_el.get("file"))
        if os.path.exists(npz_path):
            with np.load(npz_path) as data:
                pts = data["points"]
                if "descriptor" in data:
                    s.descriptor = data["descriptor"]
            s.capacity = capacity or cloud_lib.pad_capacity(pts.shape[0])
            s.cloud = cloud_lib.from_numpy(pts[:, :3], pts[:, 3],
                                           capacity=s.capacity,
                                           stamp_factors=False, device=dev)
        frames_el = sub_el.find("Frames")
        if frames_el is not None:
            for f_el in frames_el.findall("Frame"):
                f = Frame(stamp=float(f_el.get("stamp")), cloud=None,
                          global_pose=np.eye(4),
                          match_score=float(f_el.get("score")))
                f.local_pose = _pose_from_str(f_el.find("LocalPose").text)
                f.global_pose = s.global_pose @ f.local_pose
                s.frames.append(f)
        trajectory.append(s)
    return trajectory


def save_map_pieces(trajectories, out_dir: str,
                    options: MapPackageOptions = None,
                    mrvm_settings: MrvmSettings = None) -> Optional[str]:
    """SaveTrajectoriesAsMapPackage (map_package.cc:51-230): tile the map
    into ``piece_width``-sized pieces on a half-width grid, build a
    per-piece MRVM static map from the submaps whose centers fall inside
    the border-offset box, cut each piece's cloud to its box, store it
    center-relative, and write the XML descriptor with the piece centers.

    Each piece's MRVM runs one deep, as ``MapBuilder._save_maps`` does: the
    device reduces submap k's ray events while the host merges submap
    k−1's.  Returns the descriptor path (None when there is nothing to
    save)."""
    options = options or MapPackageOptions()
    mrvm_settings = mrvm_settings or MrvmSettings()
    if not isinstance(trajectories, (list, tuple)):
        trajectories = [trajectories]
    centers = [s.global_pose[:3, 3] for t in trajectories for s in t]
    if not centers:
        return None
    centers = np.stack(centers)
    min_xy = centers[:, :2].min(axis=0) - options.border_offset
    max_xy = centers[:, :2].max(axis=0) + options.border_offset
    half = options.piece_width * 0.5
    x_steps = max(int((max_xy[0] - min_xy[0]) / half), 1)
    y_steps = max(int((max_xy[1] - min_xy[1]) / half), 1)

    with prof.block("SaveMapPieces"):
        os.makedirs(out_dir, exist_ok=True)
        root = ET.Element("MapPackage")
        for x in range(x_steps):
            for y in range(y_steps):
                center = np.array([min_xy[0] + (x + 1) * half,
                                   min_xy[1] + (y + 1) * half])
                bb_min = np.clip(center - half, min_xy, max_xy)
                bb_max = np.clip(center + half, min_xy, max_xy)
                pts = _piece_cloud(trajectories, bb_min - options.border_offset,
                                   bb_max + options.border_offset,
                                   mrvm_settings)
                if pts is None:
                    continue
                inside = ((pts[:, 0] >= bb_min[0]) & (pts[:, 0] <= bb_max[0])
                          & (pts[:, 1] >= bb_min[1])
                          & (pts[:, 1] <= bb_max[1]))
                pts = pts[inside]
                if not len(pts):
                    continue
                pts[:, 0] -= center[0]
                pts[:, 1] -= center[1]
                fname = f"{options.cloud_file_prefix}{x}_{y}.pcd"
                pcd_io.write_pcd(os.path.join(out_dir, fname), pts)
                piece = ET.SubElement(root, "Piece")
                piece.set("x", f"{center[0]:.6f}")
                piece.set("y", f"{center[1]:.6f}")
                piece.set("file", fname)
        tree = ET.ElementTree(root)
        ET.indent(tree)
        path = os.path.join(out_dir, options.descript_filename)
        tree.write(path)
    return path


def _piece_cloud(trajectories, off_min, off_max,
                 settings: MrvmSettings) -> Optional[np.ndarray]:
    """The MRVM static map ``[n, 4]`` of every submap whose center lies in
    the box ``[off_min, off_max]`` (x, y), or None when no submap with a
    cloud does or the map is empty."""
    vm = MultiResolutionVoxelMap(settings)
    pending = None
    for t in trajectories:
        for s in t:
            p = s.global_pose[:3, 3]
            if not (off_min[0] <= p[0] <= off_max[0]
                    and off_min[1] <= p[1] <= off_max[1]):
                continue
            if s.cloud is None:
                continue
            gc = s.cloud.transform(torch.as_tensor(
                s.global_pose.astype(np.float32), device=s.cloud.device))
            handle = vm.dispatch(gc, p)
            if pending is not None:
                vm.consume(pending)
            pending = handle
    if pending is None:
        return None
    vm.consume(pending)
    pts = vm.output_to_numpy()
    return pts if len(pts) else None
