"""GroundRemoval2 — Himmelsbach line-fit ground segmentation, the PyTorch
counterpart of ``staticmapping_tpu.filters.ground_removal2`` (reference:
pre_processors/filter_ground_removal2.{h,cc}; "Fast Segmentation of 3D
Pointcloud for Ground Vehicles", 2010):

  1. a polar (segment × bin) grid of per-cell min-z points
     (SetInputCloud, filter_ground_removal2.cc:126-210);
  2. per-segment incremental ground-line fitting (FitLines, cc:240-330);
  3. ground labelling by vertical distance to the fitted segment lines,
     searching neighbour segments within ``search_angle`` (ClusterGround,
     cc:337-400); ground points are removed.

Step 2 is a loop over the bins with the segment axis as the batch
dimension: every segment's line state machine advances one bin a trip,
each transition a select (the JAX package's ``vmap(lax.scan)``).  Step 3
is vectorized over points × candidate segments × lines.

The JAX package's deviations are kept: the rejection test checks the new
point's residual against the running least-squares fit, and out-of-range
points (r < r_min or r > r_max) are never ground (the reference's range
test at cc:161 can never be true).
"""
from __future__ import annotations

import dataclasses
import math
from typing import ClassVar, Dict, Tuple

import torch

from ..data.cloud import PointCloud
from .filters import Filter

_BIG = 1.0e6


def _fit(cnt, sx, sy, sxx, sxy):
    """Least-squares line z = m·d + b from running sums."""
    den = cnt * sxx - sx * sx
    m = torch.where(den.abs() > 1e-12, (cnt * sxy - sx * sy) / den, 0.0)
    b = torch.where(cnt > 0, (sy - m * sx) / cnt.clamp_min(1.0), 0.0)
    return m, b


def _put_line(lines, n_lines, line, when, max_lines: int):
    """``lines[s, clip(n_lines[s])] = line[s]`` where ``when[s]``."""
    slot = n_lines.clamp(0, max_lines - 1)
    hit = ((torch.arange(max_lines, device=lines.device)[None, :]
            == slot[:, None]) & when[:, None])
    return torch.where(hit[..., None], line[:, None, :], lines)


def _fit_lines(min_d, min_z, occ, p, max_lines: int):
    """FitLines (cc:240-330) for every segment at once: ``min_d``,
    ``min_z``, ``occ`` are ``[S, B]``; returns ``(lines [S, L, 4] as (d0,
    z0, d1, z1), n_lines [S])``."""
    S = min_d.shape[0]
    dev = min_d.device
    zero = torch.zeros(S, dtype=torch.float32, device=dev)
    cnt, sx, sy, sxx, sxy, first_d = (zero,) * 6
    last_d = torch.full_like(zero, -_BIG)
    last_z = zero
    is_long = torch.zeros(S, dtype=torch.bool, device=dev)
    ground_h = torch.full_like(zero, p["start_ground_height"])
    lines = torch.zeros((S, max_lines, 4), dtype=torch.float32, device=dev)
    n_lines = torch.zeros(S, dtype=torch.int32, device=dev)
    for j in range(min_d.shape[1]):
        d, zz, has = min_d[:, j], min_z[:, j], occ[:, j]
        # long-line detection (cc:258-261) once the line has a point
        new_long = is_long | ((cnt >= 1.0)
                              & (d - last_d >= p["long_line_threshold"]))
        m, b = _fit(cnt, sx, sy, sxx, sxy)
        # grown line (>= 2 points): tentatively add, test, maybe close
        a_cnt, a_sx, a_sy = cnt + 1.0, sx + d, sy + zz
        a_sxx, a_sxy = sxx + d * d, sxy + d * zz
        m2, b2 = _fit(a_cnt, a_sx, a_sy, a_sxx, a_sxy)
        err = torch.abs(m2 * d + b2 - zz)
        expected_z = m * d + b
        bad = ((err > p["max_error"]) | (torch.abs(m2) > p["max_slope"])
               | (new_long & (cnt > 2)
                  & (torch.abs(expected_z - zz)
                     > p["max_long_line_height"])))
        # close the current line into the buffer if it has >= 3 points
        line = torch.stack([first_d, m * first_d + b,
                            last_d, m * last_d + b], dim=1)
        can_close = cnt >= 3.0
        lines_c = _put_line(lines, n_lines, line, can_close, max_lines)
        n_lines_c = torch.where(can_close,
                                torch.clamp_max(n_lines + 1, max_lines),
                                n_lines)
        ground_c = torch.where(can_close, m * last_d + b, ground_h)
        # rejected: restart from the previous last point, which the new
        # point joins when it is near the ground height (cc:305-315)
        attach = torch.abs(last_z - ground_c) < p["max_start_height"]
        r_cnt = torch.where(attach, 2.0, 1.0)
        r_sx = torch.where(attach, last_d + d, d)
        r_sy = torch.where(attach, last_z + zz, zz)
        r_sxx = torch.where(attach, last_d * last_d + d * d, d * d)
        r_sxy = torch.where(attach, last_d * last_z + d * zz, d * zz)
        r_first = torch.where(attach, last_d, d)
        # short line (< 2 points): attach if near the ground height
        small = (~new_long) & (torch.abs(last_z - ground_h)
                               < p["max_start_height"])
        s_cnt = torch.where(small, cnt + 1.0, 1.0)
        s_sx = torch.where(small, sx + d, d)
        s_sy = torch.where(small, sy + zz, zz)
        s_sxx = torch.where(small, sxx + d * d, d * d)
        s_sxy = torch.where(small, sxy + d * zz, d * zz)
        s_first = torch.where(small, first_d, d)

        grown = cnt >= 2.0
        empty = cnt < 1.0
        reject = grown & bad

        def pick(r, a, first, s):
            return torch.where(grown, torch.where(bad, r, a),
                               torch.where(empty, first, s))
        new = (pick(r_cnt, a_cnt, torch.ones_like(cnt), s_cnt),
               pick(r_sx, a_sx, d, s_sx), pick(r_sy, a_sy, zz, s_sy),
               pick(r_sxx, a_sxx, d * d, s_sxx),
               pick(r_sxy, a_sxy, d * zz, s_sxy),
               pick(r_first, first_d, d, s_first), d, zz,
               torch.where(reject, False, new_long),
               torch.where(reject, ground_c, ground_h),
               torch.where(reject[:, None, None], lines_c, lines),
               torch.where(reject, n_lines_c, n_lines))
        old = (cnt, sx, sy, sxx, sxy, first_d, last_d, last_z, is_long,
               ground_h, lines, n_lines)
        # an empty cell leaves the segment's state as it is
        (cnt, sx, sy, sxx, sxy, first_d, last_d, last_z, is_long, ground_h,
         lines, n_lines) = (
            torch.where(has.reshape((S,) + (1,) * (o.dim() - 1)), nw, o)
            for o, nw in zip(old, new))
    # final flush (cc:326-330)
    m, b = _fit(cnt, sx, sy, sxx, sxy)
    line = torch.stack([first_d, m * first_d + b, last_d, m * last_d + b],
                       dim=1)
    flush = cnt >= 3.0
    lines = _put_line(lines, n_lines, line, flush, max_lines)
    n_lines = torch.where(flush, torch.clamp_max(n_lines + 1, max_lines),
                          n_lines)
    return lines, n_lines


def _fit_and_label(xyz, mask, p, search_steps: int, segment_num: int,
                   bin_num: int, max_lines: int):
    """``is_ground`` per point."""
    f32 = torch.float32
    dev = xyz.device
    x, y, z = xyz[:, 0], xyz[:, 1], xyz[:, 2]
    r_min = torch.tensor(p["r_min"], dtype=f32, device=dev)
    r_max = torch.tensor(p["r_max"], dtype=f32, device=dev)
    rng = torch.sqrt(x * x + y * y)
    in_range = mask & (rng >= r_min) & (rng <= r_max)

    two_pi = 2.0 * math.pi
    rad = torch.atan2(y, x)
    rad = torch.where(rad < 0, rad + two_pi, rad)
    # 0-dim device tensors keep these true f32 divisions
    d_alpha = torch.tensor(two_pi / segment_num, dtype=f32, device=dev)
    d_bin = (r_max - r_min) / bin_num
    s_idx = torch.clamp((rad / d_alpha).to(torch.int32), 0, segment_num - 1)
    b_idx = torch.clamp(((rng - r_min) / d_bin).to(torch.int32), 0,
                        bin_num - 1)
    cell = (s_idx * bin_num + b_idx).long()
    n_cells = segment_num * bin_num

    # per-cell min-z point (d, z) by scatter-min
    zq = torch.where(in_range, z, _BIG)
    cell_safe = torch.where(in_range, cell, 0)
    big = torch.full((n_cells,), _BIG, dtype=f32, device=dev)
    cell_min_z = big.scatter_reduce(0, cell_safe, zq, "amin")
    # d of an argmin-z point: the least d among the points at the min z
    is_min = in_range & (z <= cell_min_z[cell] + 1e-6)
    dq = torch.where(is_min, rng, _BIG)
    cell_min_d = big.scatter_reduce(0, cell_safe, dq, "amin")
    occ = cell_min_z < _BIG * 0.5

    seg_lines, seg_counts = _fit_lines(
        cell_min_d.reshape(segment_num, bin_num),
        cell_min_z.reshape(segment_num, bin_num),
        occ.reshape(segment_num, bin_num), p, max_lines)

    # ground labelling (ClusterGround, cc:337-400): candidate segments in
    # the reference's priority order own, +K, −K, …, +1, −1 (cc:343-347)
    offs = [0]
    for i in range(search_steps, 0, -1):
        offs.extend([i, -i])
    offsets = torch.tensor(offs, dtype=torch.int64, device=dev)
    cand = (s_idx[:, None].long() + offsets[None, :]) % segment_num  # [N, C]
    lines = seg_lines[cand]                                   # [N, C, L, 4]
    n_l = seg_counts[cand]                                    # [N, C]
    d = rng[:, None, None]
    zz = z[:, None, None]
    # VerticalDistanceToSegment (cc:403-421): the last covering line
    lid = torch.arange(max_lines, device=dev)
    covers = ((lid[None, None, :] < n_l[..., None])
              & (lines[..., 0] - 0.1 < d) & (lines[..., 2] + 0.1 > d))
    dd = lines[..., 2] - lines[..., 0]
    ez = torch.where(dd.abs() > 1e-9,
                     (d - lines[..., 0]) / dd * (lines[..., 3] - lines[..., 1])
                     + lines[..., 1], lines[..., 1])
    dist = torch.abs(zz - ez)                                 # [N, C, L]
    last = torch.amax(torch.where(covers, lid, -1), dim=-1)   # [N, C]
    picked = torch.gather(dist, -1, last.clamp(0, max_lines - 1)[..., None])
    dists = torch.where(last >= 0, picked[..., 0], -1.0)
    pos = dists > 0.0
    first = torch.argmax(pos.to(torch.uint8), dim=1)          # first in order
    dist_p = torch.where(pos.any(dim=1),
                         torch.gather(dists, 1, first[:, None])[:, 0], -1.0)
    ground = (dist_p > 0.0) & (dist_p <= p["max_dist_to_line"])
    # only near-min-z cell members are ground candidates (cc:199-205: the
    # grid keeps points with z <= min_z + 0.5)
    candidate = in_range & (z <= cell_min_z[cell] + 0.5)
    return candidate & ground


@dataclasses.dataclass
class GroundRemoval2Filter(Filter):
    """See the module docstring.  Parameter names and defaults:
    filter_ground_removal2.cc:73-106."""

    r_max: float = 100.0
    r_min: float = 1.0
    bin_num: int = 200
    segment_num: int = 180
    start_ground_height: float = -0.25
    long_line_threshold: float = 1.0
    max_long_line_height: float = 0.1
    max_start_height: float = 0.2
    max_error: float = 0.05
    max_slope: float = math.tan(math.pi / 12.0)
    max_b: float = 0.1                    # kept for config parity (the
    # reference's |b − ground_height| test is commented out, cc:281)
    max_dist_to_line: float = 0.05
    search_angle: float = 10.0            # degrees
    thread_num: int = 4                   # config parity; no host threads
    max_lines: int = 32

    NAME: ClassVar[str] = "GroundRemoval2"
    PARAMS: ClassVar[Dict[str, Tuple[str, type]]] = {
        "r_max": ("r_max", float), "r_min": ("r_min", float),
        "bin_num": ("bin_num", int), "segment_num": ("segment_num", int),
        "start_ground_height": ("start_ground_height", float),
        "long_line_threshold": ("long_line_threshold", float),
        "max_long_line_height": ("max_long_line_height", float),
        "max_start_height": ("max_start_height", float),
        "max_error": ("max_error", float),
        "max_slope": ("max_slope", float),
        "max_b": ("max_b", float),
        "max_dist_to_line": ("max_dist_to_line", float),
        "search_angle": ("search_angle", float),
        "thread_num": ("thread_num", int),
    }

    def configs_valid(self) -> bool:
        return (0 <= self.r_min < self.r_max and self.bin_num > 1
                and self.segment_num > 1)

    def ground_mask(self, cloud: PointCloud) -> torch.Tensor:
        d_alpha = 2.0 * math.pi / self.segment_num
        steps = int(self.search_angle / 180.0 * math.pi / d_alpha)
        names = ("r_min", "r_max", "start_ground_height",
                 "long_line_threshold", "max_long_line_height",
                 "max_start_height", "max_error", "max_slope",
                 "max_dist_to_line")
        return _fit_and_label(
            cloud.xyz, cloud.mask, {k: getattr(self, k) for k in names},
            steps, segment_num=self.segment_num, bin_num=self.bin_num,
            max_lines=self.max_lines)

    def __call__(self, cloud: PointCloud) -> PointCloud:
        return cloud.with_mask(~self.ground_mask(cloud))
