"""State carried between the JAX package and this port.

This system has no weights: its state is point clouds, the chunked front
end's ``_FeState``, the sequential front end's poses and target, and the
back end's pose graph.  The functions here build the port's ``PointCloud``,
``NormalCloud``, ``_FeState`` and ``PoseGraph`` (and a pose-graph solver's
argument tuple) from any object with the same field names (the JAX
package's dataclasses and NamedTuples, or plain mappings) whose leaves
convert with ``numpy.asarray``, load a sequential ``FrontEnd`` from another
one's state, and turn the port's objects back into nested dicts of numpy
arrays.  The loop detector's history is submaps: their clouds go through
:func:`point_cloud` and :func:`normal_cloud`.  Nothing here imports JAX: a
JAX array is read through ``numpy.asarray`` like any other array.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Any, Dict

import numpy as np
import torch

from . import resolve_device
from .backend import pose_graph as pg
from .builder.frontend import FrontEnd
from .builder.pipeline import _FeState
from .data.cloud import NormalCloud, PointCloud

_CLOUD_FIELDS = ("xyz", "intensity", "factor", "mask")
_NORMAL_FIELDS = ("xyz", "normals", "mask")
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


def fe_state(src, device=None) -> _FeState:
    """The port's type-6 front-end state from ``src`` (a ``_FeState`` whose
    target is a normal cloud)."""
    dev = resolve_device(device)
    return _FeState(normal_cloud(_field(src, "target"), dev),
                    *(_tensor(_field(src, f), dev) for f in _STATE_FIELDS))


def load_frontend(front_end: FrontEnd, src) -> None:
    """Give the port's sequential ``front_end`` the state of ``src`` (the
    JAX package's ``FrontEnd``, or any object with its attributes): the
    keyframe pose, the motion accumulated since it, the target normal cloud
    (onto ``front_end.device``), the counters, and the extrapolator's pose
    queue and pose-derived velocities.  The IMU tracker's state is not
    carried."""
    for name in ("pose_target", "accumulative"):
        setattr(front_end, name, np.array(_field(src, name), dtype=np.float64))
    for name in ("got_first", "last_score", "num_scans"):
        setattr(front_end, name, _field(src, name))
    target = _field(src, "target")
    front_end.target = (None if target is None
                        else normal_cloud(target, front_end.device))
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


def to_numpy(obj) -> Dict[str, Any]:
    """A ``PointCloud``, ``NormalCloud`` or ``_FeState`` of the port as a
    nested dict of numpy arrays, keyed by field name."""
    if isinstance(obj, _FeState):
        out = {f: obj._asdict()[f].cpu().numpy() for f in _STATE_FIELDS}
        out["target"] = to_numpy(obj.target)
        return out
    fields = _CLOUD_FIELDS if isinstance(obj, PointCloud) else _NORMAL_FIELDS
    return {f: getattr(obj, f).cpu().numpy() for f in fields}
