"""Multi-resolution voxel map (MRVM), the probability-filtered static map —
the PyTorch counterpart of ``staticmapping_tpu.builder.mrvm`` (reference:
builder/multi_resolution_voxel_map.{h,cc}).

Per-voxel occupancy log-odds are built by ray casting every scan from its
origin: a hit at each ray's end, misses sampled along the ray.  Only voxels
whose occupancy probability exceeds a threshold are exported, which removes
dynamic objects.  As in the JAX package, rays are sampled at an adaptive
spacing (at most ``max_ray_steps`` samples a ray) and each scan's events are
reduced per voxel on the device by one sort and segment sums; log-odds add
up order-free and are clamped once at output.

On the device, ``_scan_events`` turns one scan into per-voxel aggregates:
- the 3-key lexicographic sort is three stable sorts (``ops/voxel.py``),
  invalid events last;
- ``segment_sum`` is ``ops/voxel.py::_segment_sum`` (each voxel summed in
  event order, the GPU's sums the CPU's) and ``segment_max`` is
  ``scatter_reduce(..., "amax")``; keys and counts are exact.
``_scan_events_packed`` keeps the JAX package's int16 packing (keys clipped
to ±32767, counts to 65535), and the host reads back only the valid prefix.

On the host, the aggregates merge into a sparse store: the native C++ hash
map of ``builder/mrvm_store.py``.  ``dispatch`` and ``consume`` split one
insert so that a caller can let the device reduce scan k while the host
merges scan k−1.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from ..data.cloud import PointCloud
from ..ops import voxel as voxel_ops
from .mrvm_store import make_store


def prob_to_log_odds(p: float) -> float:
    return math.log(p / (1.0 - p))


def log_odds_to_prob(l):
    return 1.0 / (1.0 + np.exp(-np.clip(l, -50.0, 50.0)))


@dataclasses.dataclass
class MrvmSettings:
    """MrvmSettings (multi_resolution_voxel_map.h:55-66), with the JAX
    package's names and defaults."""

    output_average: bool = False
    use_max_intensity: bool = True
    # write the static map as XYZRGB with r=g=b=intensity (grayscale) —
    # multi_resolution_voxel_map.h:57, OutputToPointCloud cc:187-209, 233
    output_rgb: bool = False
    prob_threshold: float = 0.6
    high_resolution: float = 0.1
    hit_prob: float = 0.55
    miss_prob: float = 0.48
    z_offset: float = 0.0
    # cap on hit points admitted into per-cell position/intensity averages
    # (multi_resolution_voxel_map.cc:100); 0 disables the cap
    max_point_num_in_cell: int = 10
    # miss samples are spaced max(high_resolution, dist/max_ray_steps) along
    # each ray: voxel-rate marching near the sensor, sparser on long rays
    max_ray_steps: int = 96


# probability clamps (multi_resolution_voxel_map.cc:30-33)
MIN_PROB, MAX_PROB = 0.1, 0.9

_INVALID_OUT_KEY = -2**31 + 1


def _scan_events(xyz: torch.Tensor, mask: torch.Tensor,
                 intensity: torch.Tensor, origin: torch.Tensor,
                 resolution: float, max_steps: int):
    """One scan → per-voxel aggregates.

    Returns ``(keys [M, 3] i32, hit_cnt [M], miss_cnt [M], sum_xyz [M, 3],
    max_int [M], sum_int [M], valid [M])`` with ``M = N · (1 + max_steps)``
    slots, deduplicated by voxel within this scan.  Valid voxels fill a
    prefix of the slots in key order."""
    n = xyz.shape[0]
    dev = xyz.device
    f32 = torch.float32
    # a 0-dim tensor divisor keeps a true f32 division on every device
    res = torch.as_tensor(resolution, dtype=f32, device=dev)
    delta = xyz - origin[None, :]
    dist = torch.linalg.vector_norm(delta, dim=1)
    direction = delta / torch.clamp_min(dist, 1e-9)[:, None]

    # miss samples: per-ray adaptive spacing (see MrvmSettings)
    step_len = torch.clamp_min((dist - resolution) / max_steps, resolution)
    steps = torch.arange(max_steps, dtype=f32, device=dev)
    t = (steps[None, :] + 0.5) * step_len[:, None]                # [N, S]
    miss_valid = (t < dist[:, None] - resolution) & mask[:, None]
    miss_pos = (origin[None, None, :]
                + direction[:, None, :] * t[:, :, None])          # [N, S, 3]
    miss_keys = torch.floor(miss_pos / res).to(torch.int32)
    hit_keys = torch.floor(xyz / res).to(torch.int32)             # [N, 3]

    all_keys = torch.cat([hit_keys, miss_keys.reshape(n * max_steps, 3)])
    is_hit = torch.zeros((n * (1 + max_steps),), dtype=torch.bool, device=dev)
    is_hit[:n] = True
    valid = torch.cat([mask, miss_valid.reshape(-1)])
    zeros = torch.zeros((n * max_steps,), dtype=f32, device=dev)
    ev = (is_hit & valid,
          torch.cat([xyz[:, 0], zeros]), torch.cat([xyz[:, 1], zeros]),
          torch.cat([xyz[:, 2], zeros]), torch.cat([intensity, zeros]))
    m = all_keys.shape[0]
    skeys, sv, (sh, sx, sy, sz, si), seg = voxel_ops._sort_by_voxel(
        all_keys, valid, ev)

    hit_f = sh.to(f32)
    miss_f = (sv & ~sh).to(f32)
    sums = voxel_ops._segment_sum(
        torch.stack([hit_f, miss_f, sx * hit_f, sy * hit_f, sz * hit_f,
                     si * hit_f], dim=1), seg, m, sv)
    max_int = torch.full((m,), -math.inf, dtype=f32, device=dev)
    max_int.scatter_reduce_(0, seg, torch.where(sh, si, -1.0), "amax")
    keys_out = torch.full((m, 3), -2**31, dtype=torch.int32, device=dev)
    keys_out.scatter_reduce_(
        0, seg[:, None].expand(m, 3),
        torch.where(sv[:, None], skeys, _INVALID_OUT_KEY), "amax")
    hit_cnt, miss_cnt = sums[:, 0], sums[:, 1]
    valid_out = (hit_cnt + miss_cnt) > 0
    return (keys_out, hit_cnt, miss_cnt, sums[:, 2:5], max_int, sums[:, 5],
            valid_out)


def _as_int16(v: torch.Tensor) -> torch.Tensor:
    """Integers in [0, 65535] → int16 with the same 16 bits (the
    ``uint16 → int16`` reinterpretation of the JAX package)."""
    v = v.to(torch.int32)
    return torch.where(v >= 32768, v - 65536, v).to(torch.int16)


def _f32_to_2xi16(x: torch.Tensor) -> torch.Tensor:
    """``[...]`` f32 → ``[..., 2]`` int16 (bit halves, low half first)."""
    bits = x.contiguous().view(torch.int32)
    return torch.stack([_as_int16(bits & 0xFFFF),
                        _as_int16((bits >> 16) & 0xFFFF)], dim=-1)


def _scan_events_packed(xyz, mask, intensity, origin, resolution: float,
                        max_steps: int, with_avg: bool):
    """``_scan_events`` packed into int16 columns on the device:

      cols 0-2: voxel key (clipped to ±32767)
      col  3:   hit count (uint16 bits, clipped to 65535)
      col  4:   miss count (uint16 bits, clipped to 65535)
      cols 5-6: max intensity (f32 bit halves)
      [with_avg] cols 7-12: sum_xyz (3 × f32 halves), 13-14: sum_int

    The packing was built for the TPU's host link and is kept for parity
    with the JAX package.  Returns ``(packed [M, C] int16, n_valid)``; the
    valid slots are a prefix (invalid keys sort last)."""
    keys, hit, miss, sxyz, mint, sint, valid = _scan_events(
        xyz, mask, intensity, origin, resolution, max_steps)
    cols = [torch.clamp(keys, -32767, 32767).to(torch.int16),
            _as_int16(torch.clamp_max(hit, 65535.0))[:, None],
            _as_int16(torch.clamp_max(miss, 65535.0))[:, None],
            _f32_to_2xi16(mint)]
    if with_avg:
        cols.append(_f32_to_2xi16(sxyz).reshape(keys.shape[0], 6))
        cols.append(_f32_to_2xi16(sint))
    return torch.cat(cols, dim=1), torch.sum(valid).to(torch.int32)


def _2xi16_to_f32(cols: np.ndarray) -> np.ndarray:
    """Host inverse of :func:`_f32_to_2xi16` — ``[..., 2]`` int16 → f32."""
    u = np.ascontiguousarray(cols).view(np.uint16).astype(np.uint32)
    bits = u[..., 0] | (u[..., 1] << 16)
    return bits.view(np.float32)


class _Pending:
    """A dispatched scan: its packed events on the device, the valid count
    on its way to pinned host memory, and the event that marks the end of
    its device work."""

    def __init__(self, packed: torch.Tensor, n_valid: torch.Tensor,
                 with_avg: bool):
        self.packed = packed
        self.with_avg = with_avg
        self.event = None
        if packed.is_cuda:
            self.n_valid = torch.empty((), dtype=torch.int32, pin_memory=True)
            self.n_valid.copy_(n_valid, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.n_valid = n_valid

    def read(self) -> np.ndarray:
        """The valid prefix of the packed events on the host.  On the GPU
        this waits for this scan's work only: the copy runs on a side
        stream behind this scan's event, not behind work queued later."""
        if self.event is None:
            return self.packed[:int(self.n_valid)].numpy()
        self.event.synchronize()
        nv = int(self.n_valid)
        out = torch.empty((nv, self.packed.shape[1]), dtype=torch.int16,
                          pin_memory=True)
        side = torch.cuda.Stream(device=self.packed.device)
        side.wait_event(self.event)
        with torch.cuda.stream(side):
            out.copy_(self.packed[:nv], non_blocking=True)
        side.synchronize()
        return out.numpy()


class MultiResolutionVoxelMap:
    """Host-side sparse accumulator fed by the per-scan device reduction."""

    def __init__(self, settings: MrvmSettings = None):
        self.settings = settings or MrvmSettings()
        s = self.settings
        s.hit_prob = min(max(s.hit_prob, 0.501), MAX_PROB)
        s.miss_prob = min(max(s.miss_prob, MIN_PROB), 0.499)
        self._store = make_store()
        self._snapshot = None     # cached export, invalidated by inserts

    # ------------------------------------------------------------------
    def insert_point_cloud(self, cloud: PointCloud, origin: np.ndarray
                           ) -> None:
        """InsertPointCloud (cc:54-123).  ``cloud`` must already be in
        global/map coordinates; ``origin`` is the sensor position."""
        self.consume(self.dispatch(cloud, origin))

    def dispatch(self, cloud: PointCloud, origin: np.ndarray) -> _Pending:
        """Queue the device reduction of one scan and return a handle for
        :meth:`consume`."""
        s = self.settings
        origin = np.asarray(origin, dtype=np.float32).copy()
        origin[2] += s.z_offset
        with_avg = bool(s.output_average) or not s.use_max_intensity
        packed, n_valid = _scan_events_packed(
            cloud.xyz, cloud.mask, cloud.intensity,
            torch.as_tensor(origin, device=cloud.device), s.high_resolution,
            s.max_ray_steps, with_avg)
        return _Pending(packed, n_valid, with_avg)

    def consume(self, handle: _Pending) -> None:
        """Read back one dispatched scan's valid events and merge them into
        the host store."""
        s = self.settings
        arr = handle.read()
        nv = arr.shape[0]
        keys = arr[:, 0:3].astype(np.int32)
        hit = np.ascontiguousarray(arr[:, 3]).view(np.uint16) \
            .astype(np.float32)
        miss = np.ascontiguousarray(arr[:, 4]).view(np.uint16) \
            .astype(np.float32)
        mint = _2xi16_to_f32(arr[:, 5:7])
        if handle.with_avg:
            sxyz = _2xi16_to_f32(arr[:, 7:13].reshape(-1, 3, 2))
            sint = _2xi16_to_f32(arr[:, 13:15])
        else:
            sxyz = np.zeros((nv, 3), dtype=np.float32)
            sint = np.zeros((nv,), dtype=np.float32)
        self._store.merge(keys, hit, miss, sxyz, mint, sint,
                          cap=float(s.max_point_num_in_cell))
        self._snapshot = None

    # ------------------------------------------------------------------
    def _export(self):
        if self._snapshot is None:
            self._snapshot = self._store.export()
        return self._snapshot

    def probabilities(self) -> np.ndarray:
        s = self.settings
        _, hits, misses, _, _, _, _ = self._export()
        lo = (hits * prob_to_log_odds(s.hit_prob)
              + misses * prob_to_log_odds(s.miss_prob))
        p = log_odds_to_prob(lo)
        return np.clip(p, MIN_PROB, MAX_PROB)

    def output_to_numpy(self, threshold: Optional[float] = None
                        ) -> np.ndarray:
        """OutputToPointCloud (cc:125-242): voxels with occupancy above
        ``threshold`` as rows (x, y, z, intensity)."""
        keys, hits, misses, sum_xyz, max_int, sum_int, avg_cnt = \
            self._export()
        if not len(hits):
            return np.zeros((0, 4), dtype=np.float32)
        s = self.settings
        threshold = s.prob_threshold if threshold is None else threshold
        p = self.probabilities()
        keep = (p > threshold) & (hits > 0)
        centers = (keys[keep].astype(np.float64) + 0.5) \
            * s.high_resolution
        if s.output_average:
            pts = sum_xyz[keep] / np.maximum(avg_cnt[keep], 1)[:, None]
        else:
            pts = centers
        # use_max_intensity selects max vs per-voxel average intensity;
        # averages run over the ≤ max_point_num_in_cell admitted points
        if s.use_max_intensity:
            inten = max_int[keep]
        else:
            inten = sum_int[keep] / np.maximum(avg_cnt[keep], 1)
        return np.column_stack([pts, inten]).astype(np.float32)

    @property
    def num_voxels(self) -> int:
        return self._store.size
