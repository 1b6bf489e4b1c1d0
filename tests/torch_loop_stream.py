"""A fixed submap stream around a small square loop, fed through either
package's ``IncrementalOptimizer``: shared by
tests/test_torch_loop_detector.py (loop closing alone) and
tests/test_torch_sensors_loop.py (loop closing with GPS and odometry).
Not a test module.

The stream, by default: a 44-pose square loop (io/synthetic.py, 5 side
and 5 corner steps, 4 poses of overlap), one submap every second pose with a 2000-point
scan rendered at its ground-truth pose (2048 slots), the JAX package's
leaf-8 target normals, and matches that drift ``YAW_DRIFT`` rad a submap
in yaw."""
import numpy as np

from staticmapping_tpu.builder import frontend as jfrontend
from staticmapping_tpu.data import cloud as jcloud
from staticmapping_tpu.io import synthetic
from staticmapping_torch import interop
from staticmapping_torch.common import np_se3

# the loop detector's settings for the stream: config/synthetic.xml's
# thresholds and density-normalised scores, with gates cut to the small loop
STREAM_SETTINGS = dict(
    loop_ignore_threshold=8, max_close_loop_distance=5.0,
    nearest_history_pos_num=1, use_descriptor=True, m2dp_match_score=0.9,
    accept_scan_match_score=0.75, score_spacing_ref=0.35, nn_tile=512)
YAW_DRIFT = 0.003   # rad the "front end" adds to each submap-to-submap match


def yaw(a):
    return np_se3.from_rt(np_se3.euler_to_matrix(np.array([0.0, 0.0, a])),
                          np.zeros(3))


class StreamSubmap:
    """What ``add_submap`` reads of a submap: its id, pose, cloud, M2DP
    descriptor, match to the next submap and cached target normals, and
    (for the sensor stream) its stamp, ENU fix and odometry pose."""

    def __init__(self, idx, pose, cloud, normals, T_next, enu=None,
                 odom=None):
        self.id, self.global_pose, self.cloud = idx, pose.copy(), cloud
        self._normals, self.match_transform_to_next = normals, T_next
        self.descriptor = None
        self.stamp = float(idx)
        self.related_gps_enu, self.related_odom = enu, odom

    def normal_cloud(self, leaf_size):
        return self._normals


def make_stream(side_steps: int = 5, corner_steps: int = 5,
                overlap: int = 4, stride: int = 2):
    """The stream's ground truth, drifted poses, matches, and the JAX
    package's clouds and target normals: a submap every ``stride`` poses
    of the square, ``overlap`` poses past the start closing the loop (the
    defaults: 22 submaps)."""
    gt = synthetic.square_loop_trajectory(
        side_steps=side_steps, corner_steps=corner_steps,
        overlap=overlap)[::stride]
    world = synthetic.make_world(seed=3)
    matches = [np_se3.inverse(a) @ b @ yaw(YAW_DRIFT)
               for a, b in zip(gt[:-1], gt[1:])]
    poses = [gt[0]]
    for m in matches:
        poses.append(poses[-1] @ m)
    clouds = [jcloud.from_numpy(synthetic.render_scan(
        world, g, max_points=2000, max_range=30.0, seed=k)[:, :3],
        capacity=2048) for k, g in enumerate(gt)]
    normals = [jfrontend._target_normals(c, leaf_size=8) for c in clouds]
    return dict(gt=gt, drifted=poses, matches=matches, clouds=clouds,
                normals=normals)


def package_inputs(stream, package, device="cpu"):
    """``(clouds, normals)`` of the stream for ``package`` ("jax" or
    "torch")."""
    if package == "jax":
        return stream["clouds"], stream["normals"]
    return ([interop.point_cloud(c, device) for c in stream["clouds"]],
            [interop.normal_cloud(n, device) for n in stream["normals"]])


def run_stream(backend, clouds, normals, poses, matches, tags=None):
    """Hand every submap to ``backend.add_submap`` in order; ``tags`` are
    ``(enu, odom)`` a submap.  Returns the submaps and the loop detector's
    state after each."""
    subs, states = [], []
    for k in range(len(clouds)):
        enu, odom = tags[k] if tags is not None else (None, None)
        subs.append(StreamSubmap(k, poses[k], clouds[k], normals[k],
                                 matches[k] if k < len(matches) else None,
                                 enu, odom))
        backend.add_submap(subs, subs[-1])
        states.append(backend.loop_detector.status)
    return subs, states


def loop_edges(backend):
    """``[(target, source, T)]`` of the backend's loop factors."""
    g = backend.graph.factors
    return [(i, j, T) for i, j, T in zip(g.i, g.j, g.T_meas) if j != i + 1]
