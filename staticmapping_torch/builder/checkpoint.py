"""Run-state checkpoint and resume — the PyTorch counterpart of
``staticmapping_tpu.builder.checkpoint``.

The reference serializes submap clouds and a map.xml descriptor but has no
mid-run optimizer resume (SURVEY §5.4).  A checkpoint here captures, in the
JAX package's files (so either package loads the other's):

  * ``trajectory/``: the full submaps as a map package
    (``builder/map_package.py``);
  * ``checkpoint.json``: the front end's state, the back end's counters,
    the GPS two-stage state, the loop detector's status and counter, the
    extrinsics;
  * ``frontend_target.npz``: the sequential front end's keyframe target
    (a normal cloud: matcher type 6);
  * ``pose_graph.npz``: the back end's four factor batches and the special
    node values.

``save_checkpoint(map_builder, dir)`` writes them;
``load_checkpoint(dir, options…)`` returns a ``MapBuilder`` that goes on
from there.  A partially filled submap is dropped: the caller replays the
scans from the first one whose keyframe went into it (from the first scan
after the save when every submap was full), and the replayed keyframes
fill that submap's id again.

What each front end resumes from:

  * sequential ``FrontEnd``: the keyframe pose ``pose_target``, the motion
    ``accumulative`` since it, its target, the counters, and an
    extrapolator seeded with ``pose_target`` alone (no velocity).  A
    replayed scan is matched against the saved target.
  * chunked ``DeviceFrontEnd``: the stage thread and the in-flight chunks
    are drained into the builder before the save, then ``base``,
    ``num_scans`` and ``last_score`` are kept, as in the JAX package.  Its
    device state is not: the first replayed scan takes the first-scan
    branch and becomes a keyframe at the identity, not at ``base``, with
    the velocity dropped; later keyframes compose onto ``base`` again.
    This is the JAX package's behaviour, kept as it is (ROADMAP.md queue
    C).
"""
from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np
import torch

from ..backend.loop_detector import LoopStatus
from ..data.cloud import NormalCloud
from .frame import Trajectory
from .frontend import FrontEnd
from .map_package import MapPackageOptions, load_trajectory, save_trajectory

_TARGET_FIELDS = ("xyz", "normals", "mask")


def _rows(values, shape) -> np.ndarray:
    return np.stack(values) if values else np.zeros((0,) + shape)


def save_checkpoint(mb, out_dir: str) -> str:
    """Serialize a ``MapBuilder`` mid-run.  Returns the checkpoint dir."""
    os.makedirs(out_dir, exist_ok=True)
    fe = mb.front_end
    sequential = isinstance(fe, FrontEnd)
    if not sequential:
        # settle the stage thread and the in-flight chunks into submaps
        for f in fe.flush():
            mb._insert_frame(f)
    # settle the deferred pair-match queue so the snapshot is consistent
    mb._flush_pair_matches(drain=True)

    full = Trajectory(mb.trajectory.id)
    for s in mb.trajectory:
        if s.full:
            full.append(s)
    save_trajectory(full, os.path.join(out_dir, "trajectory"),
                    MapPackageOptions())
    meta = {"next_submap_id": mb._next_submap_id,
            "num_full_submaps": len(full),
            "use_gps": mb.options.use_gps, "use_odom": mb.options.use_odom}

    if sequential:
        fe_state = {"kind": "sequential",
                    "pose_target": np.asarray(fe.pose_target).tolist(),
                    "accumulative": np.asarray(fe.accumulative).tolist(),
                    "last_score": fe.last_score, "num_scans": fe.num_scans,
                    "got_first": fe.got_first}
        if fe.target is not None:
            if not isinstance(fe.target, NormalCloud):
                raise ValueError(
                    "a checkpoint holds the sequential front end's target "
                    "as a normal cloud (matcher type 6) only, as the JAX "
                    f"package's does; matcher type "
                    f"{fe.options.matcher_type} keeps a point cloud")
            np.savez_compressed(
                os.path.join(out_dir, "frontend_target.npz"),
                **{k: getattr(fe.target, k).cpu().numpy()
                   for k in _TARGET_FIELDS})
    else:
        fe_state = {"kind": "pipelined",
                    "base": np.asarray(fe.base).tolist(),
                    "num_scans": fe.num_scans, "last_score": fe.last_score}
    meta["front_end"] = fe_state

    be = mb.backend
    if be is not None:
        g = be.graph
        np.savez_compressed(
            os.path.join(out_dir, "pose_graph.npz"),
            between_i=np.asarray(g.factors.i, dtype=np.int64),
            between_j=np.asarray(g.factors.j, dtype=np.int64),
            between_T=_rows(g.factors.T_meas, (4, 4)),
            between_s=_rows(g.factors.sigmas, (6,)),
            gps_i=np.asarray(g.gps_factors.i, dtype=np.int64),
            gps_enu=_rows(g.gps_factors.enu, (3,)),
            gps_ptg=_rows(g.gps_factors.p_tg, (3,)),
            gps_s=_rows(g.gps_factors.sigmas, (3,)),
            gps_ue=np.asarray(g.gps_factors.use_err, dtype=bool),
            odom_i=np.asarray(g.odom_factors.i, dtype=np.int64),
            odom_T=_rows(g.odom_factors.T_odom, (4, 4)),
            odom_s=_rows(g.odom_factors.sigmas, (6,)),
            prior_i=np.asarray(g.prior_factors.i, dtype=np.int64),
            prior_T=_rows(g.prior_factors.T_prior, (4, 4)),
            prior_s=_rows(g.prior_factors.sigmas, (6,)),
            special=np.stack(g.special_values))
        meta["backend"] = {
            "num_nodes": g.num_nodes,
            "loop_edge_count": be.loop_edge_count,
            "loop_status": int(be.loop_detector.status.value),
            "accumulate_count": be.loop_detector.accumulate_count,
            "calculated_first_gps_coord": be._calculated_first_gps_coord,
            "cached_enu": {str(k): np.asarray(v).tolist()
                           for k, v in be._cached_enu.items()},
            "odom_calib_prior_added": be._odom_calib_prior_added,
            "tf_odom_lidar": be.tf_odom_lidar.tolist(),
            "tf_tracking_gps": be.tf_tracking_gps.tolist()}

    with open(os.path.join(out_dir, "checkpoint.json"), "w") as f:
        json.dump(meta, f, indent=1)
    return out_dir


def load_checkpoint(ckpt_dir: str, map_builder_options=None,
                    backend: Optional[object] = None, filter_chain=None,
                    device=None):
    """Rebuild a ``MapBuilder`` on ``device`` (the GPU unless named) from
    :func:`save_checkpoint` output.  Pass a fresh back end
    (``IncrementalOptimizer``) when the run used one.  A loop status that
    does not name a ``LoopStatus`` raises ``ValueError``."""
    from .map_builder import MapBuilder, MapBuilderOptions

    with open(os.path.join(ckpt_dir, "checkpoint.json")) as f:
        meta = json.load(f)

    options = map_builder_options or MapBuilderOptions()
    mb = MapBuilder(options, filter_chain=filter_chain, backend=backend,
                    device=device)
    for s in load_trajectory(os.path.join(ckpt_dir, "trajectory"),
                             MapPackageOptions(),
                             submap_options=options.submap,
                             capacity=options.submap_capacity,
                             device=mb.device):
        mb.trajectory.append(s)
    # the partial submap is dropped: its replayed keyframes take its id
    # again (the JAX package resumes the counter past it, and the next
    # submap's pair match then indexes past the trajectory's end)
    mb._next_submap_id = meta["num_full_submaps"]
    mb._current_submap = None

    fe_state = meta["front_end"]
    fe = mb.front_end
    if (fe_state["kind"] == "sequential") != isinstance(fe, FrontEnd):
        raise ValueError(f"a {fe_state['kind']} front end's checkpoint "
                         f"cannot load into a {type(fe).__name__}")
    fe.num_scans = fe_state["num_scans"]
    fe.last_score = fe_state["last_score"]
    if fe_state["kind"] == "sequential":
        fe.pose_target = np.asarray(fe_state["pose_target"])
        fe.accumulative = np.asarray(fe_state["accumulative"])
        fe.got_first = fe_state["got_first"]
        tpath = os.path.join(ckpt_dir, "frontend_target.npz")
        if os.path.exists(tpath):
            with np.load(tpath) as z:
                fe.target = NormalCloud(*(torch.from_numpy(z[k]).to(mb.device)
                                          for k in _TARGET_FIELDS))
            fe.extrapolator.add_pose(0.0, fe.pose_target)
    else:
        fe.base = np.asarray(fe_state["base"])

    be = mb.backend
    if be is not None and "backend" in meta:
        bm = meta["backend"]
        g = be.graph
        with np.load(os.path.join(ckpt_dir, "pose_graph.npz")) as z:
            for k in range(len(z["between_i"])):
                g.factors.add(int(z["between_i"][k]), int(z["between_j"][k]),
                              z["between_T"][k], z["between_s"][k])
            for k in range(len(z["gps_i"])):
                g.gps_factors.add(int(z["gps_i"][k]), z["gps_enu"][k],
                                  z["gps_ptg"][k], z["gps_s"][k],
                                  bool(z["gps_ue"][k]))
            for k in range(len(z["odom_i"])):
                g.odom_factors.add(int(z["odom_i"][k]), z["odom_T"][k],
                                   z["odom_s"][k])
            for k in range(len(z["prior_i"])):
                g.prior_factors.add(int(z["prior_i"][k]), z["prior_T"][k],
                                    z["prior_s"][k])
            g.special_values = [np.asarray(T, dtype=np.float64)
                                for T in z["special"]]
        g.num_nodes = bm["num_nodes"]
        be.loop_edge_count = bm["loop_edge_count"]
        be._calculated_first_gps_coord = bm["calculated_first_gps_coord"]
        be._cached_enu = {int(k): np.asarray(v)
                          for k, v in bm["cached_enu"].items()}
        be._odom_calib_prior_added = bm["odom_calib_prior_added"]
        be.tf_odom_lidar = np.asarray(bm["tf_odom_lidar"])
        be.tf_tracking_gps = np.asarray(bm["tf_tracking_gps"])
        # the loop detector's history and the view graph mirror the
        # reloaded trajectory
        be.loop_detector.frames = list(mb.trajectory.submaps)
        be.loop_detector.status = LoopStatus(bm["loop_status"])
        be.loop_detector.accumulate_count = bm.get("accumulate_count", 0)
        for s in mb.trajectory:
            be.view_graph.add_vertex(s.id, s.global_pose)
    return mb
