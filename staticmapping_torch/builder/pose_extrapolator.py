"""Pose extrapolation for ICP initial guesses — host-side (poses are tiny;
this is bookkeeping, not compute).  The PyTorch port's copy of
``staticmapping_tpu.builder.pose_extrapolator``.

Parity with the reference's ``PoseExtrapolator``
(builder/pose_extrapolator.{h,cc}). Two modes:
  * ``CTRV``  — constant turn rate & velocity from the pose queue
    (pose_extrapolator.cc:287-319 kSimpleCTRV branches)
  * ``IMU``   — Cartographer-style gyro integration via ``ImuTracker``
    (cc:124-133, 177-197; tracker in builder/imu_tracker.{h,cc})

Poses are 4×4 numpy float64 on host (the reference also keeps poses f64).
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Deque, Optional, Tuple

import numpy as np

from ..common import np_se3

# kExpolatorMinDuration (map_builder.cc:49)
DEFAULT_POSE_QUEUE_DURATION = 0.001


@dataclasses.dataclass
class ImuData:
    stamp: float
    angular_velocity: np.ndarray      # [3] rad/s
    linear_acceleration: np.ndarray   # [3] m/s^2


class ImuTracker:
    """Orientation filter: integrate gyro, correct roll/pitch by gravity
    low-pass (parity: builder/imu_tracker.{h,cc})."""

    def __init__(self, imu_gravity_time_constant: float, time: float):
        self.imu_gravity_time_constant = imu_gravity_time_constant
        self.time = time
        self.last_linear_acceleration_time = -np.inf
        self.orientation = np.array([1.0, 0, 0, 0])  # wxyz
        self.gravity_vector = np.array([0.0, 0, 1.0])  # UnitZ (imu_tracker.cc:36)
        self.imu_angular_velocity = np.zeros(3)

    def advance(self, time: float):
        """imu_tracker.cc:39-47: integrate gyro (note: the reference converts
        w*dt via EulerAnglesToQuaternion, not axis-angle — kept for parity)."""
        assert time >= self.time
        dt = time - self.time
        rotation = np_se3.euler_to_quat(self.imu_angular_velocity * dt)
        self.orientation = np_se3.quat_normalize(
            np_se3.quat_mul(self.orientation, rotation))
        self.gravity_vector = np_se3.quat_rotate(
            np_se3.quat_conj(rotation), self.gravity_vector)
        self.time = time

    def add_imu_linear_acceleration_observation(self, acc: np.ndarray):
        """imu_tracker.cc:49-67: gravity EMA + orientation correction."""
        dt = (self.time - self.last_linear_acceleration_time
              if np.isfinite(self.last_linear_acceleration_time) else np.inf)
        self.last_linear_acceleration_time = self.time
        alpha = 1.0 - np.exp(-dt / self.imu_gravity_time_constant)
        self.gravity_vector = ((1.0 - alpha) * self.gravity_vector
                               + alpha * np.asarray(acc, dtype=np.float64))
        # rotation = FromTwoVectors(gravity, orientation⁻¹ · UnitZ)
        rot = np_se3.quat_from_two_vectors(
            self.gravity_vector,
            np_se3.quat_rotate(np_se3.quat_conj(self.orientation),
                               np.array([0.0, 0, 1.0])))
        self.orientation = np_se3.quat_normalize(
            np_se3.quat_mul(self.orientation, rot))

    def add_imu_angular_velocity_observation(self, w: np.ndarray):
        self.imu_angular_velocity = np.asarray(w, dtype=np.float64)


class PoseExtrapolator:
    """See module docstring. Thread-free (the front end is a single host
    loop; the reference needed mutexes, this does not)."""

    MODE_IMU = "imu"
    MODE_CTRV = "ctrv"

    def __init__(self, pose_queue_duration: float = DEFAULT_POSE_QUEUE_DURATION,
                 imu_gravity_time_constant: float = 10.0,
                 mode: str = MODE_IMU):
        self.mode = mode
        self.pose_queue_duration = pose_queue_duration
        self.gravity_time_constant = imu_gravity_time_constant
        self.timed_pose_queue: Deque[Tuple[float, np.ndarray]] = \
            collections.deque()
        self.imu_data: Deque[ImuData] = collections.deque()
        self.linear_velocity_from_poses = np.zeros(3)
        self.angular_velocity_from_poses = np.zeros(3)
        self.imu_tracker: Optional[ImuTracker] = None
        self.extrapolation_imu_tracker: Optional[ImuTracker] = None

    @classmethod
    def initial_simple_ctrv(cls, pose_queue_duration: float =
                            DEFAULT_POSE_QUEUE_DURATION) -> "PoseExtrapolator":
        """InitialSimpleCTRV parity (pose_extrapolator.cc:69-73)."""
        return cls(pose_queue_duration, mode=cls.MODE_CTRV)

    # ------------------------------------------------------------------
    def last_pose_time(self) -> Optional[float]:
        return self.timed_pose_queue[-1][0] if self.timed_pose_queue else None

    def add_pose(self, time: float, pose: np.ndarray):
        """AddPose parity (pose_extrapolator.cc:90-122)."""
        self.timed_pose_queue.append((time, np.asarray(pose, dtype=np.float64)))
        while (len(self.timed_pose_queue) > 2 and
               self.timed_pose_queue[1][0] <= time - self.pose_queue_duration):
            self.timed_pose_queue.popleft()
        self._update_velocities_from_poses()
        if self.mode == self.MODE_CTRV:
            return
        if self.imu_tracker is None:
            tracker_start = time
            if self.imu_data:
                tracker_start = min(tracker_start, self.imu_data[0].stamp)
            self.imu_tracker = ImuTracker(self.gravity_time_constant,
                                          tracker_start)
        self._advance_imu_tracker(time, self.imu_tracker)
        self._trim_imu_data()
        self.extrapolation_imu_tracker = _copy_tracker(self.imu_tracker)

    def add_imu_data(self, imu: ImuData):
        if self.mode == self.MODE_CTRV:
            return
        self.imu_data.append(imu)
        self._trim_imu_data()

    def extrapolate_pose(self, time: float) -> np.ndarray:
        """ExtrapolatePose parity (pose_extrapolator.cc:177-197)."""
        assert self.timed_pose_queue, "no poses yet"
        newest_time, newest_pose = self.timed_pose_queue[-1]
        if time < newest_time:
            return newest_pose.copy()
        translation = (self._extrapolate_translation(time)
                       + newest_pose[:3, 3])
        rotation_q = np_se3.quat_mul(
            np_se3.matrix_to_quat(newest_pose[:3, :3]),
            self._extrapolate_rotation(time))
        out = np.eye(4)
        out[:3, :3] = np_se3.quat_to_matrix(rotation_q)
        out[:3, 3] = translation
        return out

    # ------------------------------------------------------------------
    def _update_velocities_from_poses(self):
        """UpdateVelocitiesFromPoses parity (cc:216-240)."""
        if len(self.timed_pose_queue) < 2:
            return
        newest_time, newest_pose = self.timed_pose_queue[-1]
        oldest_time, oldest_pose = self.timed_pose_queue[0]
        queue_delta = newest_time - oldest_time
        if queue_delta < self.pose_queue_duration:
            return
        self.linear_velocity_from_poses = (
            newest_pose[:3, 3] - oldest_pose[:3, 3]) / queue_delta
        rel = oldest_pose[:3, :3].T @ newest_pose[:3, :3]
        self.angular_velocity_from_poses = (
            np_se3.matrix_to_euler(rel) / queue_delta)

    def _extrapolate_rotation(self, time: float) -> np.ndarray:
        newest_time, _ = self.timed_pose_queue[-1]
        dt = time - newest_time
        if self.mode == self.MODE_CTRV:
            return np_se3.euler_to_quat(self.angular_velocity_from_poses * dt)
        tracker = self.extrapolation_imu_tracker
        self._advance_imu_tracker(time, tracker)
        last_orientation = self.imu_tracker.orientation
        return np_se3.quat_mul(np_se3.quat_conj(last_orientation),
                               tracker.orientation)

    def _extrapolate_translation(self, time: float) -> np.ndarray:
        newest_time, _ = self.timed_pose_queue[-1]
        dt = time - newest_time
        return dt * self.linear_velocity_from_poses

    def _advance_imu_tracker(self, time: float, tracker: ImuTracker):
        """AdvanceImuTracker parity (cc:259-286)."""
        assert tracker is not None
        if time < tracker.time:
            return
        if not self.imu_data or time < self.imu_data[0].stamp:
            tracker.advance(time)
            return
        i = 0
        data = list(self.imu_data)
        while i < len(data) and data[i].stamp <= tracker.time:
            i += 1
        while i < len(data) and data[i].stamp < time:
            tracker.advance(data[i].stamp)
            tracker.add_imu_linear_acceleration_observation(
                data[i].linear_acceleration)
            tracker.add_imu_angular_velocity_observation(
                data[i].angular_velocity)
            i += 1
        tracker.advance(time)

    def _trim_imu_data(self):
        while (len(self.imu_data) > 1 and self.timed_pose_queue and
               self.imu_data[1].stamp <= self.timed_pose_queue[-1][0]):
            self.imu_data.popleft()


def _copy_tracker(t: ImuTracker) -> ImuTracker:
    c = ImuTracker(t.imu_gravity_time_constant, t.time)
    c.last_linear_acceleration_time = t.last_linear_acceleration_time
    c.orientation = t.orientation.copy()
    c.gravity_vector = t.gravity_vector.copy()
    c.imu_angular_velocity = t.imu_angular_velocity.copy()
    return c
