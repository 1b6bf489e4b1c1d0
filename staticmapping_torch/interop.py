"""State carried between the JAX package and this port.

This system has no weights: its state is point clouds, the chunked front
end's ``_FeState``, the sequential front end's poses and target, and the
back end's pose graph.  The functions here build the port's ``PointCloud``,
``NormalCloud``, ``NdtMap``, ``GicpCloud``, ``_FeState``, ``PoseGraph`` and
``Trajectory`` (and a pose-graph solver's argument tuple) from any object
with the same field names (the JAX package's dataclasses and NamedTuples,
or plain mappings) whose leaves convert with ``numpy.asarray``, load a
sequential ``FrontEnd`` from another one's state, and turn the port's
objects back into nested dicts of numpy arrays.  The loop detector's history is submaps: their clouds go through
:func:`point_cloud` and :func:`normal_cloud`.  Nothing here imports JAX: a
JAX array is read through ``numpy.asarray`` like any other array.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Any

import numpy as np
import torch

from . import resolve_device
from .backend import pose_graph as pg
from .builder.frame import Frame, Submap, SubmapOptions, Trajectory
from .builder.frontend import FrontEnd
from .builder.pipeline import _FeState
from .data.cloud import NormalCloud, PointCloud
from .registration.gicp import GicpCloud
from .registration.ndt import NdtMap

_CLOUD_FIELDS = ("xyz", "intensity", "factor", "mask")
_NORMAL_FIELDS = ("xyz", "normals", "mask")
_NDT_FIELDS = NdtMap._fields
_STATE_FIELDS = ("pose_target", "prev_pose", "prev_stamp", "vel_lin",
                 "vel_ang", "has_velocity")


def _field(src: Any, name: str):
    return src[name] if isinstance(src, dict) else getattr(src, name)


def _tensor(leaf, device: torch.device) -> torch.Tensor:
    # np.array copies: a read-only or foreign buffer becomes a fresh one
    return torch.from_numpy(np.array(leaf)).to(device)


def point_cloud(src, device=None) -> PointCloud:
    """The port's ``PointCloud`` from ``src`` (fields xyz, intensity,
    factor, mask)."""
    dev = resolve_device(device)
    return PointCloud(*(_tensor(_field(src, f), dev) for f in _CLOUD_FIELDS))


def normal_cloud(src, device=None) -> NormalCloud:
    """The port's ``NormalCloud`` from ``src`` (fields xyz, normals,
    mask)."""
    dev = resolve_device(device)
    return NormalCloud(*(_tensor(_field(src, f), dev)
                         for f in _NORMAL_FIELDS))


def ndt_map(src, device=None) -> NdtMap:
    """The port's ``NdtMap`` from ``src`` (fields key, mean, inv_cov, valid,
    origin, resolution), so that both packages can align on one identical
    field."""
    dev = resolve_device(device)
    return NdtMap(*(_tensor(_field(src, f), dev) for f in _NDT_FIELDS))


def _target(src, dev: torch.device):
    """A front-end target: a normal cloud (type 6), an NDT map (type 5) or
    an (NDT map, GICP cloud) pair (type 3)."""
    if isinstance(src, tuple) and not hasattr(src, "_fields"):
        ndt, gicp = src
        return (ndt_map(ndt, dev),
                GicpCloud(*(_tensor(_field(gicp, f), dev)
                            for f in _NORMAL_FIELDS)))
    if "inv_cov" in (src if isinstance(src, dict) else dir(src)):
        return ndt_map(src, dev)
    return normal_cloud(src, dev)


def fe_state(src, device=None) -> _FeState:
    """The port's front-end state from ``src`` (a ``_FeState`` whose target
    is a normal cloud, an NDT map or an (NDT map, GICP cloud) pair)."""
    dev = resolve_device(device)
    return _FeState(_target(_field(src, "target"), dev),
                    *(_tensor(_field(src, f), dev) for f in _STATE_FIELDS))


def load_frontend(front_end: FrontEnd, src) -> None:
    """Give the port's sequential ``front_end`` the state of ``src`` (the
    JAX package's ``FrontEnd``, or any object with its attributes): the
    keyframe pose, the motion accumulated since it, the target (onto
    ``front_end.device``: the normal cloud of type 6, or the compacted scan
    that a factory matcher is then given as its target), the counters, and
    the extrapolator's pose queue and pose-derived velocities.  The IMU
    tracker's state is not carried."""
    for name in ("pose_target", "accumulative"):
        setattr(front_end, name, np.array(_field(src, name), dtype=np.float64))
    for name in ("got_first", "last_score", "num_scans"):
        setattr(front_end, name, _field(src, name))
    target = _field(src, "target")
    if target is None:
        front_end.target = None
    elif front_end.matcher is None:
        front_end.target = normal_cloud(target, front_end.device)
    else:
        front_end.target = point_cloud(target, front_end.device)
        front_end.matcher.set_input_target(front_end.target)
    ex_src, ex = _field(src, "extrapolator"), front_end.extrapolator
    ex.timed_pose_queue = collections.deque(
        (float(t), np.array(T, dtype=np.float64))
        for t, T in ex_src.timed_pose_queue)
    for name in ("linear_velocity_from_poses", "angular_velocity_from_poses"):
        setattr(ex, name, np.array(getattr(ex_src, name), dtype=np.float64))


def _host_list(values) -> list:
    return [np.array(v, dtype=np.float64) if np.ndim(v) else v
            for v in values]


def pose_graph(src, device=None) -> "pg.PoseGraph":
    """The port's ``PoseGraph`` (on ``device``) holding ``src``'s nodes,
    factor lists and special-node values."""
    g = pg.PoseGraph(device=device)
    g.num_nodes = int(_field(src, "num_nodes"))
    for name, cls in (("factors", pg.FactorBatch),
                      ("gps_factors", pg.GpsFactorBatch),
                      ("odom_factors", pg.OdomFactorBatch),
                      ("prior_factors", pg.PriorFactorBatch)):
        batch = _field(src, name)
        setattr(g, name, cls(*(_host_list(getattr(batch, f.name))
                               for f in dataclasses.fields(cls))))
    g.special_values = _host_list(_field(src, "special_values"))
    return g


def _pose(T) -> np.ndarray:
    return None if T is None else np.array(T, dtype=np.float64)


def trajectory(src, device=None) -> Trajectory:
    """The port's ``Trajectory`` (clouds on ``device``) holding ``src``'s
    submaps: id, options, stamp, global pose, ``match_transform_to_next``,
    the score to the previous submap, the M2DP descriptor, the merged
    cloud (at its own capacity) and the frames as skeletons (stamp, poses
    and score, no cloud)."""
    dev = resolve_device(device)
    out = Trajectory(int(_field(src, "id")))
    for s_src in _field(src, "submaps"):
        opts_src = _field(s_src, "options")
        opts = SubmapOptions(**{f.name: _field(opts_src, f.name)
                                for f in dataclasses.fields(SubmapOptions)})
        cloud = _field(s_src, "cloud")
        s = Submap(int(_field(s_src, "id")), opts,
                   capacity=(int(np.shape(_field(cloud, "mask"))[-1])
                             if cloud is not None
                             else int(_field(s_src, "capacity"))),
                   device=dev)
        s.stamp = float(_field(s_src, "stamp"))
        s.global_pose = _pose(_field(s_src, "global_pose"))
        s.match_transform_to_next = _pose(
            _field(s_src, "match_transform_to_next"))
        s.match_score_to_previous = float(
            _field(s_src, "match_score_to_previous"))
        desc = _field(s_src, "descriptor")
        s.descriptor = None if desc is None else np.array(desc)
        s.cloud = None if cloud is None else point_cloud(cloud, dev)
        for f in _field(s_src, "frames"):
            s.frames.append(Frame(
                stamp=float(_field(f, "stamp")), cloud=None,
                global_pose=_pose(_field(f, "global_pose")),
                local_pose=_pose(_field(f, "local_pose")),
                match_score=float(_field(f, "match_score"))))
        out.append(s)
    return out


def solver_args(args, device=None) -> tuple:
    """A pose-graph solver's argument tuple (``PoseGraph.solver_args``'s
    first result) for the port: 0-d leaves become Python numbers, integer
    arrays int64 tensors, every other array a tensor on ``device``."""
    dev = resolve_device(device)
    out = []
    for a in args:
        a = np.asarray(a)
        if a.ndim == 0:
            out.append(a.item())
        elif a.dtype.kind in "iu":
            out.append(torch.from_numpy(a.astype(np.int64)).to(dev))
        else:
            out.append(_tensor(a, dev))
    return tuple(out)


def to_numpy(obj):
    """A ``PointCloud``, ``NormalCloud``, ``GicpCloud``, ``NdtMap`` or
    ``_FeState`` of the port as a nested dict of numpy arrays, keyed by
    field name (an (NDT map, GICP cloud) target as a pair of them)."""
    if isinstance(obj, _FeState):
        out = {f: obj._asdict()[f].cpu().numpy() for f in _STATE_FIELDS}
        out["target"] = to_numpy(obj.target)
        return out
    if isinstance(obj, tuple) and not hasattr(obj, "_fields"):
        return tuple(to_numpy(o) for o in obj)
    if isinstance(obj, NdtMap):
        fields = _NDT_FIELDS
    else:
        fields = (_CLOUD_FIELDS if isinstance(obj, PointCloud)
                  else _NORMAL_FIELDS)
    return {f: getattr(obj, f).cpu().numpy() for f in fields}
