"""URDF static-extrinsics reader — ros_node/urdf_reader.cc parity; the
PyTorch port's copy of ``staticmapping_tpu.io.urdf``.

The reference resolves sensor extrinsics by loading a URDF model and
collecting every FIXED joint's parent→child transform into a tf buffer
(ReadStaticTransformsFromUrdf, urdf_reader.cc:33-69), then looks up
tracking→{lidar, imu, odom, gps} (static_mapping_node.cpp:319-356).
Here: stdlib XML parse of ``<joint type="fixed"><origin xyz rpy>``
elements and a graph walk to chain transforms between any two links.
"""
from __future__ import annotations

import xml.etree.ElementTree as ET
from typing import Dict, Optional, Tuple

import numpy as np

from ..common import np_se3


def _origin_to_matrix(origin: Optional[ET.Element]) -> np.ndarray:
    T = np.eye(4)
    if origin is None:
        return T
    xyz = [float(v) for v in (origin.get("xyz") or "0 0 0").split()]
    rpy = [float(v) for v in (origin.get("rpy") or "0 0 0").split()]
    T[:3, :3] = np_se3.euler_to_matrix(np.asarray(rpy))
    T[:3, 3] = xyz
    return T


def read_fixed_transforms(urdf_path_or_string: str
                          ) -> Dict[Tuple[str, str], np.ndarray]:
    """{(parent_link, child_link): T_parent_child} over fixed joints."""
    import os
    if os.path.isfile(urdf_path_or_string):
        root = ET.parse(urdf_path_or_string).getroot()
    else:
        root = ET.fromstring(urdf_path_or_string)
    out: Dict[Tuple[str, str], np.ndarray] = {}
    for joint in root.findall("joint"):
        if joint.get("type") != "fixed":
            continue
        parent = joint.find("parent")
        child = joint.find("child")
        if parent is None or child is None:
            continue
        out[(parent.get("link"), child.get("link"))] = _origin_to_matrix(
            joint.find("origin"))
    return out


def lookup_transform(transforms: Dict[Tuple[str, str], np.ndarray],
                     target: str, source: str) -> Optional[np.ndarray]:
    """T such that p_target = T · p_source, chaining fixed joints (the
    tf-buffer lookup role, static_mapping_node.cpp:327-350).  None when
    the links are not connected."""
    if target == source:
        return np.eye(4)
    # build an undirected adjacency with edge transforms
    adj: Dict[str, list] = {}
    for (p, c), T in transforms.items():
        adj.setdefault(p, []).append((c, T))
        adj.setdefault(c, []).append((p, np_se3.inverse(T)))
    # BFS from target to source accumulating T_target_link
    from collections import deque
    seen = {target}
    q = deque([(target, np.eye(4))])
    while q:
        link, T_t_l = q.popleft()
        if link == source:
            return T_t_l
        for (nxt, T_l_n) in adj.get(link, []):
            if nxt in seen:
                continue
            seen.add(nxt)
            q.append((nxt, T_t_l @ T_l_n))
    return None


def apply_urdf_extrinsics(map_builder, urdf_path: str,
                          tracking_frame: str = "base_link",
                          lidar_frame: str = "velodyne",
                          imu_frame: str = "imu",
                          odom_frame: str = "odom",
                          gps_frame: str = "gps") -> None:
    """SetTrackingTo* from a URDF (static_mapping_node.cpp:319-356 role).
    Missing links are skipped (identity extrinsic stays)."""
    tfs = read_fixed_transforms(urdf_path)
    for name, setter in (
            (lidar_frame, map_builder.set_tracking_to_lidar),
            (imu_frame, map_builder.set_tracking_to_imu),
            (odom_frame, map_builder.set_tracking_to_odom),
            (gps_frame, map_builder.set_tracking_to_gps)):
        T = lookup_transform(tfs, tracking_frame, name)
        if T is not None:
            setter(T)
