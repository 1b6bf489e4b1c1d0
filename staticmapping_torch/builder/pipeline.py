"""Device-resident chunked front end — the PyTorch counterpart of
``staticmapping_tpu.builder.pipeline`` for matcher types 6, 5 and 3.

The front-end state (the matcher's target, pose_target, CTRV velocities)
lives on the device.  Scans are buffered into chunks of K; each chunk is
packed on the host into one int16 array (xyz at 1/256 m, intensity at
1/64 — kept for parity with the JAX package), copied to the device on a
stage thread, and advanced scan by scan: filter chain → motion
compensation → alignment → motion filter → keyframe target switch.
The JAX package runs that as one ``lax.scan`` with a ``lax.cond`` target
switch; here it is a Python loop that reads the keyframe flag on the host
once per scan and builds the target only for keyframes, and skips the
padded slots of a partial chunk, which the host knows.  The host keeps a
float64 base pose; the device works chunk-locally in f32 and re-bases its
pose state at the start of every chunk (the target stays in its
keyframe's frame).

Semantics follow the sequential front end (map_builder.cc:260-397) with the
JAX package's documented deviations: CTRV velocity from the last two poses,
in-order chunks, stamps as f32 seconds since the first scan.
"""
from __future__ import annotations

import math
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, List, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from .. import resolve_device
from ..common import np_se3, prof, se3
from ..data.cloud import PAD_COORD, NormalCloud, PointCloud
from ..ops.voxel import voxel_downsample
from ..registration.gicp import GicpCloud, align_gicp, compute_point_normals
from ..registration.icp_fast import align_point_to_plane
from ..registration.ndt import NdtMap, align_ndt, build_ndt_map
from ..registration.ndt_gicp import NdtWithGicp
from .frame import Frame
from .frontend import FrontEndOptions, _target_normals

_QXYZ = 256.0     # 1/256 m xyz resolution, ±127.9 m range
_QINT = 64.0      # 1/64 intensity resolution, ±511 range

# max IMU samples carried per scan slot (100-200 Hz IMU vs 10 Hz scans)
_IMU_PER_SCAN = 32


def _pack_chunk(buf, base_stamp: float, K: int, cap: int, imu=None):
    """[(stamp, points)] → (int16 [K, cap, 4], f32 [K, 4] meta,
    f32 [K, J, 4] imu).

    meta rows: (chunk-relative stamp, n_valid, valid flag, 0).
    imu rows per scan: (dt_sample, wx, wy, wz) for the gyro samples in
    (prev_stamp, stamp], zero-padded (dt 0 = no sample)."""
    q = np.zeros((K, cap, 4), dtype=np.int16)
    meta = np.zeros((K, 4), dtype=np.float32)
    imu_out = np.zeros((K, _IMU_PER_SCAN, 4), dtype=np.float32)
    for i, (st, pts) in enumerate(buf):
        n = min(len(pts), cap)
        q[i, :n, :3] = np.clip(np.round(pts[:n, :3] * _QXYZ),
                               -32767, 32767)
        if pts.shape[1] > 3:
            q[i, :n, 3] = np.clip(np.round(pts[:n, 3] * _QINT),
                                  -32767, 32767)
        meta[i, 0] = st - base_stamp
        meta[i, 1] = n
        meta[i, 2] = 1.0
        if imu is not None and imu[i]:
            rows = imu[i][-_IMU_PER_SCAN:]
            imu_out[i, :len(rows)] = rows
    return q, meta, imu_out


def _unpack_chunk(qdata: torch.Tensor, meta: torch.Tensor):
    """Device-side dequantize: int16 chunk → (stamps, xyz, inten, mask,
    valid) in the layout the scan step consumes."""
    cap = qdata.shape[1]
    counts = meta[:, 1]
    mask = (torch.arange(cap, dtype=torch.float32, device=qdata.device)[None]
            < counts[:, None])                            # [K, cap]
    xyz = qdata[..., :3].to(torch.float32) * (1.0 / _QXYZ)
    xyz = torch.where(mask[..., None], xyz, PAD_COORD)
    inten = qdata[..., 3].to(torch.float32) * (1.0 / _QINT)
    return meta[:, 0], xyz, inten, mask, meta[:, 2] > 0.0


def _matcher_pack(opts: FrontEndOptions):
    """(make_target, align) functions for the configured matcher:

      type 6  IcpFast      normals target + point-to-plane ICP
      type 5  Ndt          voxel-Gaussian field + GN on NDT weights
      type 3  NdtWithGicp  NDT coarse stage chained into GICP refinement
              (ndt_gicp.cc:55-112: voxel filter 0.2, NDT res 1.0 / eps
              0.01 / 35 iterations, an NDT score under the gate keeps the
              guess, GICP 35 iterations)
    """
    t = opts.matcher_type
    if t == 6:
        def make_target(src: PointCloud):
            return _target_normals(src, leaf_size=opts.target_leaf_size)

        def align(src, target, guess):
            return align_point_to_plane(
                src, target, guess,
                dist_outlier_ratio=opts.dist_outlier_ratio,
                max_iteration=opts.max_iteration, tile=opts.nn_tile)
        return make_target, align
    if t == 5:
        def make_target(src: PointCloud):
            return build_ndt_map(src, 1.0, min_points=4)

        def align(src, target, guess):
            return align_ndt(src, target, guess,
                             max_iteration=min(opts.max_iteration, 35))
        return make_target, align
    if t == 3:
        ndt_min_score = NdtWithGicp.ndt_min_score

        def make_target(src: PointCloud):
            f = voxel_downsample(src, 0.2)
            return (build_ndt_map(f, 1.0, min_points=4),
                    compute_point_normals(f, k=20))

        def align(src, target, guess):
            ndt_map, tgt_gicp = target
            srcf = voxel_downsample(src, 0.2)
            T_ndt, s_ndt = align_ndt(srcf, ndt_map, guess, max_iteration=35)
            # NDT diverged: keep the caller's guess (ndt_gicp.cc:106-109),
            # chosen on the device
            ndt_guess = torch.where(s_ndt >= ndt_min_score, T_ndt, guess)
            return align_gicp(compute_point_normals(srcf, k=20), tgt_gicp,
                              ndt_guess, max_iteration=35)
        return make_target, align
    raise ValueError(
        f"the chunked front end supports matcher types 3/5/6, got {t} "
        "(type 1 IcpUsingPointMatcher runs on the sequential front end)")


class _FeState(NamedTuple):
    # the matcher's target, held in its keyframe's frame: a NormalCloud
    # (type 6), an NdtMap (type 5) or an (NdtMap, GicpCloud) pair (type 3)
    target: Union[NormalCloud, NdtMap, Tuple[NdtMap, GicpCloud]]
    pose_target: torch.Tensor    # [4, 4] chunk-local
    prev_pose: torch.Tensor      # [4, 4] chunk-local (newest pose)
    prev_stamp: torch.Tensor     # scalar f32 (seconds since first scan)
    vel_lin: torch.Tensor        # [3] chunk-frame m/s
    vel_ang: torch.Tensor        # [3] euler rad/s
    has_velocity: torch.Tensor   # bool


def _make_step(chain: Optional[Callable], opts: FrontEndOptions):
    """Build the single-scan step: ``step(state, scan) → (state, (pose,
    score, is_keyframe, cloud))`` with ``is_keyframe`` a host bool."""
    mf = opts.motion_filter
    make_target, align_fn = _matcher_pack(opts)

    def step(state: _FeState, scan):
        stamp, xyz, inten, mask, imu = scan
        n_valid = torch.sum(mask).clamp_min(1)
        factor = torch.where(
            mask, torch.cumsum(mask.to(torch.float32), 0) - 1.0,
            0.0) / n_valid
        pc = PointCloud(xyz=xyz, intensity=inten, factor=factor, mask=mask)
        if chain is not None:
            with prof.block("ScanStep:filter"):
                pc = chain(pc)

        # CTRV extrapolation (pose_extrapolator.cc:177-197) with the
        # predicted step clamped to 5 m / 0.5 rad per scan, so one bad
        # alignment cannot throw the next guess out of ICP's basin
        dt = torch.clamp_min(stamp - state.prev_stamp, 0.0)
        ang = state.vel_ang * dt
        if opts.use_imu:
            # gyro integral over the scan interval (imu_tracker.cc:39-47);
            # scans with no samples keep the CTRV rate
            gyro_ang = torch.sum(imu[:, 1:4] * imu[:, 0:1], dim=0)
            has_imu = torch.sum(imu[:, 0]) > 0
            ang = torch.where(has_imu, gyro_ang, ang)
        ang_n = torch.linalg.vector_norm(ang)
        ang = ang * (torch.clamp_max(ang_n, 0.5) / torch.clamp_min(ang_n, 1e-9))
        step_t = state.vel_lin * dt
        t_n = torch.linalg.vector_norm(step_t)
        step_t = step_t * (torch.clamp_max(t_n, 5.0)
                           / torch.clamp_min(t_n, 1e-9))
        dR = se3.euler_to_matrix(ang)
        pred = state.prev_pose.clone()
        pred[:3, :3] = state.prev_pose[:3, :3] @ dR
        pred[:3, 3] += step_t
        pred = torch.where(state.has_velocity, pred, state.prev_pose)
        guess = se3.inverse(state.pose_target) @ pred

        # per-scan motion for compensation: the predicted scan-to-scan delta
        delta = se3.inverse(state.prev_pose) @ pred
        src = pc.motion_compensate(delta) if opts.motion_compensation else pc
        with prof.block("ScanStep:icp"):
            T, score = align_fn(src, state.target, guess)
        if opts.motion_compensation and opts.use_average:
            T = se3.average_transforms(torch.stack([T, guess]))
        pose_source = se3.normalize_rotation(state.pose_target @ T)
        if opts.motion_compensation:
            src = pc.motion_compensate(se3.inverse(state.prev_pose)
                                       @ pose_source)

        # CTRV velocity from the last pose pair
        vel_ok = dt > 1e-6
        dt_safe = torch.clamp_min(dt, 1e-6)
        new_vel_lin = torch.where(
            vel_ok, (pose_source[:3, 3] - state.prev_pose[:3, 3]) / dt_safe,
            state.vel_lin)
        rel_R = state.prev_pose[:3, :3].T @ pose_source[:3, :3]
        new_vel_ang = torch.where(
            vel_ok, se3.matrix_to_euler(rel_R) / dt_safe, state.vel_ang)

        # motion filter (map_builder.cc:369-392): T is target-relative ==
        # the motion accumulated since the last keyframe
        accu_t = torch.linalg.vector_norm(T[:3, 3])
        eul = se3.matrix_to_euler(T[:3, :3])
        accu_a = torch.sum(torch.abs(eul)) * (180.0 / math.pi)
        is_kf = accu_t >= mf.translation_range
        if mf.angle_range > 1e-3:
            is_kf = is_kf | (accu_a >= mf.angle_range)
        with prof.block("ScanStep:keyframe_read"):
            prof.count("host_reads")
            is_kf = bool(is_kf)
        if is_kf:
            with prof.block("ScanStep:target"):
                target = make_target(src)
        else:
            target = state.target

        new_state = _FeState(
            target=target,
            pose_target=pose_source if is_kf else state.pose_target,
            prev_pose=pose_source, prev_stamp=stamp,
            vel_lin=new_vel_lin, vel_ang=new_vel_ang,
            has_velocity=torch.ones_like(state.has_velocity))
        return new_state, (pose_source, score, is_kf, src)

    return step


def _rebase(state: _FeState) -> _FeState:
    """Re-express the state in the frame of its newest pose, keeping every
    chunk-local coordinate small so f32 never sees absolute drift (the f64
    base on the host absorbs the long-horizon accumulation)."""
    rebase_inv = se3.inverse(se3.normalize_rotation(state.prev_pose))
    return state._replace(
        pose_target=rebase_inv @ state.pose_target,
        prev_pose=torch.eye(4, dtype=torch.float32,
                            device=state.prev_pose.device),
        # vel_lin is a chunk-frame vector; vel_ang is body-relative
        vel_lin=rebase_inv[:3, :3] @ state.vel_lin)


class DeviceFrontEnd:
    """Chunked device-resident front end.

    ``process`` buffers scans and returns a list of keyframes whenever a
    chunk of ``chunk_size`` scans completes (call :meth:`flush` at the end
    of the stream).  The host keeps a float64 base pose; the device works
    chunk-locally in f32 and is re-based between chunks.
    """

    def __init__(self, options: FrontEndOptions = None,
                 filter_chain: Optional[Callable] = None,
                 chunk_size: int = 16, queue_depth: int = 2, device=None):
        self.options = options or FrontEndOptions()
        self.device = resolve_device(device)
        self.chunk_size = chunk_size
        self.filter_chain = filter_chain
        self._step = _make_step(filter_chain, self.options)
        self._make_target = _matcher_pack(self.options)[0]
        self.base = np.eye(4)            # f64 global pose of the device frame
        self.state: Optional[_FeState] = None
        self._base_stamp = 0.0           # absolute stamp of the first scan
        self.num_scans = 0
        self.last_score = 1.0            # score of the newest harvested scan
        self._buf: List[Tuple[float, np.ndarray]] = []
        # _staged: chunks whose pack + host-to-device copy runs on the stage
        # thread; the oldest is run when the next chunk fills.  _inflight:
        # run chunks awaiting harvest, ``queue_depth`` deep — keyframes come
        # out at the same chunk boundaries as in the JAX package.
        self.queue_depth = max(1, queue_depth)
        self._inflight: List[tuple] = []   # (stamps_abs, chunk, outputs)
        # (stamps_abs, valid, future, chunk index, first scan index)
        self._staged: List[tuple] = []
        self._num_chunks = 0
        self._stage_pool = ThreadPoolExecutor(max_workers=1)
        self.use_imu = bool(self.options.use_imu)
        self._imu_buf: List[tuple] = []    # (stamp, wx, wy, wz) sorted
        self._prev_scan_stamp: Optional[float] = None

    def close(self) -> None:
        """Stop the stage thread."""
        self._stage_pool.shutdown(wait=True)

    # ------------------------------------------------------------------
    def add_imu(self, stamp: float, angular_velocity) -> None:
        """Buffer one gyro sample (InsertImuMsg route of the chunked front
        end)."""
        w = np.asarray(angular_velocity, dtype=np.float64)
        self._imu_buf.append((float(stamp), w[0], w[1], w[2]))

    def _take_imu(self, scan_stamps: List[float]):
        """Partition buffered samples into per-scan (dt, ω) row lists for
        the intervals (prev_scan, scan]."""
        out = []
        prev = self._prev_scan_stamp
        buf = self._imu_buf
        j = 0
        for st in scan_stamps:
            rows = []
            last_t = prev if prev is not None else (buf[j][0] - 1e-3
                                                    if j < len(buf) else st)
            while j < len(buf) and buf[j][0] <= st:
                t, wx, wy, wz = buf[j]
                rows.append((max(t - last_t, 0.0), wx, wy, wz))
                last_t = t
                j += 1
            out.append(rows)
            prev = st
        self._imu_buf = buf[j:]
        self._prev_scan_stamp = scan_stamps[-1] if scan_stamps else prev
        return out

    # ------------------------------------------------------------------
    def _run_chunk(self, state: _FeState, qdata, meta, imu_arr, valid,
                   first_scan: int = 0):
        """Run one chunk's valid scans; ``first_scan`` is the scan index
        of its first slot, the request id of each ``ScanStep`` span."""
        stamps, xyz, inten, mask, _ = _unpack_chunk(qdata, meta)
        state = _rebase(state)
        outputs = []
        for k in np.flatnonzero(valid):      # padded slots are skipped
            with prof.block("ScanStep", req=first_scan + int(k)):
                state, out = self._step(
                    state, (stamps[k], xyz[k], inten[k], mask[k],
                            imu_arr[k]))
            pose, score, is_kf, src = out
            outputs.append((pose, score, is_kf, src if is_kf else None))
        return state, outputs

    def _pad_cloud(self, points: np.ndarray):
        cap = self.options.scan_capacity
        n = min(len(points), cap)
        xyz = np.full((cap, 3), PAD_COORD, dtype=np.float32)
        xyz[:n] = points[:n, :3]
        inten = np.zeros((cap,), dtype=np.float32)
        if points.shape[1] > 3:
            inten[:n] = points[:n, 3]
        mask = np.zeros((cap,), dtype=bool)
        mask[:n] = True
        return xyz, inten, mask

    def process(self, stamp: float, points: np.ndarray) -> List[Frame]:
        """Feed one scan; returns keyframes completed so far (possibly
        empty; they arrive in bursts at chunk boundaries)."""
        self.num_scans += 1
        points = np.asarray(points)
        if self.state is None:
            # first scan: becomes target + first keyframe at identity
            # (map_builder.cc:281-293)
            xyz, inten, mask = self._pad_cloud(points)
            dev = self.device
            inten_t = torch.from_numpy(inten).to(dev)
            pc = PointCloud(xyz=torch.from_numpy(xyz).to(dev),
                            intensity=inten_t,
                            factor=torch.zeros_like(inten_t),
                            mask=torch.from_numpy(mask).to(dev))
            if self.filter_chain is not None:
                pc = self.filter_chain(pc)
            eye = torch.eye(4, dtype=torch.float32, device=dev)
            self._base_stamp = stamp
            self.state = _FeState(
                target=self._make_target(pc), pose_target=eye, prev_pose=eye,
                prev_stamp=torch.zeros((), dtype=torch.float32, device=dev),
                vel_lin=torch.zeros(3, dtype=torch.float32, device=dev),
                vel_ang=torch.zeros(3, dtype=torch.float32, device=dev),
                has_velocity=torch.zeros((), dtype=torch.bool, device=dev))
            return [Frame(stamp=stamp, cloud=pc, global_pose=np.eye(4),
                          match_score=1.0)]
        self._buf.append((stamp, points))
        if len(self._buf) < self.chunk_size:
            return []
        return self._dispatch_and_maybe_harvest()

    def flush(self) -> List[Frame]:
        frames: List[Frame] = []
        if self._buf and self.state is not None:
            self._stage_buffered()
        self._pump(force=True)
        while self._inflight:
            frames.extend(self._harvest_one())
        return frames

    # ------------------------------------------------------------------
    def _dispatch_and_maybe_harvest(self) -> List[Frame]:
        with prof.block("FrontEndChunk"):
            self._stage_buffered()
            # run the previous staged chunk (its copy had a full period to
            # complete on the stage thread), keep the newest staging
            self._pump(force=False)
            frames: List[Frame] = []
            while len(self._inflight) >= self.queue_depth:
                frames.extend(self._harvest_one())
            return frames

    def _stage_buffered(self) -> None:
        """Hand the buffered scans to the stage thread: pack to int16 and
        copy to the device (pinned memory, non-blocking) off the main
        thread."""
        K = self.chunk_size
        cap = self.options.scan_capacity
        buf = self._buf
        self._buf = []
        stamps_abs = [st for st, _ in buf]
        valid = np.zeros((K,), dtype=bool)
        valid[:len(buf)] = True
        base = self._base_stamp
        imu = self._take_imu(stamps_abs) if self.use_imu else None
        dev = self.device

        def to_device(a: np.ndarray) -> torch.Tensor:
            t = torch.from_numpy(a)
            if dev.type == "cuda":
                return t.pin_memory().to(dev, non_blocking=True)
            return t.to(dev)

        chunk = self._num_chunks
        self._num_chunks += 1

        def job():
            with prof.block("StageChunk", req=chunk):
                q, meta, imu_arr = _pack_chunk(buf, base, K, cap, imu)
                return to_device(q), to_device(meta), to_device(imu_arr)

        # the scan index of the chunk's first scan: scan 0 ran alone
        self._staged.append((stamps_abs, valid, self._stage_pool.submit(job),
                             chunk, self.num_scans - len(buf)))

    def _pump(self, force: bool) -> None:
        """Run staged chunks in order.  Leaves the newest one staging
        unless ``force`` (flush)."""
        while self._staged and (force or len(self._staged) > 1):
            stamps_abs, valid, fut, chunk, first_scan = self._staged.pop(0)
            with prof.block("FrontEndChunk:stage_wait", req=chunk):
                qdata, meta, imu_arr = fut.result()
            with prof.block("FrontEndChunk:run", req=chunk):
                self.state, outputs = self._run_chunk(
                    self.state, qdata, meta, imu_arr, valid, first_scan)
            self._inflight.append((stamps_abs, chunk, outputs))

    def _harvest_one(self) -> List[Frame]:
        """Read the oldest run chunk's poses and scores in one transfer,
        build its keyframes, and compose the f64 global base from its
        final pose."""
        stamps_abs, chunk, outputs = self._inflight.pop(0)
        if not outputs:
            return []
        with prof.block("FrontEndChunk:harvest_read", req=chunk):
            prof.count("host_reads", 2)
            poses_h = torch.stack([o[0] for o in outputs]).cpu().double(
            ).numpy()
            scores_h = torch.stack([o[1] for o in outputs]).cpu().double(
            ).numpy()
        self.last_score = float(scores_h[-1])
        frames = [
            Frame(stamp=float(stamps_abs[i]), cloud=src,
                  global_pose=np_se3.normalize_rotation(
                      self.base @ poses_h[i]),
                  match_score=float(scores_h[i]))
            for i, (_, _, is_kf, src) in enumerate(outputs) if is_kf]
        B = np_se3.normalize_rotation(poses_h[-1])
        self.base = np_se3.normalize_rotation(self.base @ B)
        return frames
