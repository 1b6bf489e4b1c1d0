"""Replay a recorded back-end stream of ``chip_smoke.py``'s ``sensors_loop``
phase through either package's ``IncrementalOptimizer`` on the CPU.

The phase writes ``chiprun_out/sensors_loop_stream.json``: for every
``add_submap`` call of the card run, the submap's id and pose, its
predecessor's match, its ENU fix and odometry pose, the extrinsics the back
end held, and what the loop detector returned (its state and the accepted
loop edges).  This script hands the same submaps to a fresh optimizer of
``--package`` with the same options and extrinsics, its loop detector
replaced by the recorded results (so no verifier runs: the JAX package's
verifier at these widths does not finish on the CPU), runs the final
optimization and prints one JSON line: the GPS coordinate transform, the
calibrated ``tf_odom_lidar``, the loop edges, the solves' count and
seconds, and the gaps of each to the card run's.  The JAX package's
replay is the reference the phase's transforms are held to.

    python3 scripts/sensor_loop_replay.py --stream FILE [--package jax|torch]

``--package jax`` needs JAX (the CPU); ``torch`` runs the port on the CPU.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
import types

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def _package(name):
    if name == "jax":
        import jax
        if jax.config.jax_platforms != "cpu":
            jax.config.update("jax_platforms", "cpu")
            from jax.extend.backend import clear_backends
            clear_backends()
        from staticmapping_tpu.backend import loop_detector, optimizer
        return optimizer, loop_detector, {}
    from staticmapping_torch.backend import loop_detector, optimizer
    return optimizer, loop_detector, {"device": "cpu"}


def _array(x):
    return None if x is None else np.asarray(x, dtype=np.float64)


def replay(stream: dict, package: str) -> dict:
    from scripts.main_path import transform_gap
    opt, ld, kw = _package(package)
    subs = stream["submaps"]
    be = opt.IncrementalOptimizer(
        opt.OptimizerOptions(**stream["options"]),
        loop_settings=ld.LoopDetectorSettings(use_descriptor=False), **kw)
    be.set_transform_odom_to_lidar(_array(subs[0]["tf_odom_lidar"]))
    be.set_transform_tracking_to_gps(_array(subs[0]["tf_tracking_gps"]))
    recorded = iter(subs)

    def add_frame(submap, do_loop_detect=True):
        rec = next(recorded)
        be.loop_detector.frames.append(submap)
        return ld.DetectResult(
            submap.id, ld.LoopStatus[rec["status"]],
            [ld.LoopEdge(e["target"], e["source"], _array(e["transform"]),
                         e["score"]) for e in rec["edges"]],
            rec["close_succeed"])
    be.loop_detector.add_frame = add_frame
    solves = {"count": 0, "seconds": 0.0}
    optimize = be.graph.optimize

    def timed(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return optimize(*args, **kwargs)
        finally:
            solves["count"] += 1
            solves["seconds"] += time.perf_counter() - t0
    be.graph.optimize = timed
    traj = []
    for rec in subs:
        if rec["match_prev"] is not None:
            traj[-1].match_transform_to_next = _array(rec["match_prev"])
        sm = types.SimpleNamespace(
            id=rec["id"], global_pose=_array(rec["pose"]),
            match_transform_to_next=None, related_gps_enu=_array(rec["enu"]),
            related_odom=_array(rec["odom"]), descriptor=np.zeros(1),
            cloud=None)
        traj.append(sm)
        be.add_submap(traj, sm)
    be.run_final_optimization(traj)
    coord = np.asarray(be.get_gps_coord_transform(), dtype=np.float64)
    calib = np.asarray(be.tf_odom_lidar, dtype=np.float64)
    # the card run's poses were moved into ENU at ``finish``
    poses = np.stack([coord @ s.global_pose for s in traj])
    card_poses = np.asarray(stream["poses"])
    return {
        "package": package, "submaps": len(traj),
        "loop_edge_count": be.loop_edge_count,
        "gps_coord_transform": coord.tolist(), "tf_odom_lidar": calib.tolist(),
        "pose_graph_solves": solves["count"],
        "pose_graph_solve_s": solves["seconds"],
        "gaps_to_card": {
            "gps_coord_transform": transform_gap(
                coord, stream["gps_coord_transform"]),
            "tf_odom_lidar": transform_gap(calib, stream["tf_odom_lidar"]),
            "poses_m": float(np.abs(poses[:, :3, 3]
                                    - card_poses[:, :3, 3]).max())}}


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--stream", required=True, metavar="FILE")
    p.add_argument("--package", default="jax", choices=["jax", "torch"])
    args = p.parse_args()
    with open(args.stream) as f:
        stream = json.load(f)
    t0 = time.perf_counter()
    out = replay(stream, args.package)
    print(json.dumps({**out, "seconds": time.perf_counter() - t0}))


if __name__ == "__main__":
    main()
