"""Synthetic drives: a world of box buildings and poles around a path, and
LiDAR scans rendered along it, made from the run's seed.

A plain-torch rewrite of the port's ``io/synthetic.py`` world
(``make_world``) and renderer (``render_scan``), frozen here so that a
change to the port cannot change the inputs.  What a traffic mix sets
(``mapbench/traffic/<name>.json``):

- ``path``: ``segments``, each ``{"straight_m": L}`` or ``{"arc_deg": a,
  "radius_m": r}`` (left turn for a > 0), driven from the origin heading
  along +x; ``repeat`` drives them again and again (laps).
- ``step_m`` and ``scan_period_s``: the distance and time between scans.
- ``jitter``: i.i.d. per-scan noise on the pose, ``along_m``, ``lateral_m``
  (standard deviations) and ``yaw_deg``, as a car's speed and steering
  wander, so that the constant-velocity prediction is never the answer.
- ``world``: ``margin_m`` around the driven path's bounding box, and the
  densities of ``make_world`` (150 buildings on 216 m x 216 m, 75 poles on
  240 m x 240 m, 12 wall points per 6 m2 of wall).
- ``sensor``: ``height_m``, ``max_range_m``, ``ground_fraction``,
  ``ground_range_m``, ``noise_m`` as ``render_scan``'s arguments.

The configuration sets the points of a scan (``points_per_scan``).  One
departure from ``render_scan``: where the structure in range holds fewer
points than its share, the ground takes the rest, so every scan has the
same number of points.
"""
from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

# make_world's densities (io/synthetic.py: extent 120, 150 buildings with
# centres in +-0.9 extent, 75 poles in +-extent, wall density 12)
_BUILDINGS_PER_M2 = 150 / (2 * 0.9 * 120.0) ** 2
_POLES_PER_M2 = 75 / (2 * 120.0) ** 2
_WALL_DENSITY = 12.0
_POLE_POINTS = 40


def seed_key(seed: int, *salt: int) -> int:
    """A non-negative 63-bit key from the run's seed (any whole number, up
    to past 2**31, negative too) and a salt: the same for the same
    arguments on every machine."""
    h = np.random.SeedSequence([seed % (1 << 64), *salt]).generate_state(2)
    return int((int(h[0]) << 32 | int(h[1])) & ((1 << 63) - 1))


def _path_point(segments, s: float,
                repeat: bool) -> Tuple[float, float, float]:
    """(x, y, heading) at arc length ``s`` along ``segments`` driven from
    the origin heading +x.  With ``repeat`` the path is a lap and ``s``
    wraps; without, ``s`` before the start lies on the +x axis."""
    if repeat:
        lap = sum(seg.get("straight_m", 0.0)
                  + math.radians(abs(seg.get("arc_deg", 0.0)))
                  * seg.get("radius_m", 0.0) for seg in segments)
        s = s % lap
    elif s < 0.0:
        return s, 0.0, 0.0
    x = y = yaw = 0.0
    for seg in segments:
        if "straight_m" in seg:
            length = seg["straight_m"]
            d = min(s, length)
            x += d * math.cos(yaw)
            y += d * math.sin(yaw)
        else:
            r = seg["radius_m"]
            sweep = math.radians(seg["arc_deg"])
            length = abs(sweep) * r
            d = min(s, length)
            turn = math.copysign(d / r, sweep)
            # centre of the turn on the left (right) of the heading
            side = math.copysign(1.0, sweep)
            cx = x - side * r * math.sin(yaw)
            cy = y + side * r * math.cos(yaw)
            yaw += turn
            x = cx + side * r * math.sin(yaw)
            y = cy - side * r * math.cos(yaw)
        s -= d
        if s <= 0.0:
            break
    return x, y, yaw


def true_poses(traffic: dict, n_scans: int, seed: int) -> np.ndarray:
    """``[n_scans, 4, 4]`` float64 sensor poses of the drive."""
    seg = traffic["path"]["segments"]
    repeat = bool(traffic["path"].get("repeat", False))
    step = traffic["step_m"]
    jit = traffic["jitter"]
    rng = np.random.default_rng(seed_key(seed, 1))
    along = rng.normal(0.0, jit["along_m"], n_scans)
    lateral = rng.normal(0.0, jit["lateral_m"], n_scans)
    yaw_n = rng.normal(0.0, math.radians(jit["yaw_deg"]), n_scans)
    poses = np.zeros((n_scans, 4, 4))
    h = traffic["sensor"]["height_m"]
    for k in range(n_scans):
        x, y, yaw = _path_point(seg, k * step + along[k], repeat)
        x -= lateral[k] * math.sin(yaw)
        y += lateral[k] * math.cos(yaw)
        yaw += yaw_n[k]
        c, s = math.cos(yaw), math.sin(yaw)
        poses[k] = [[c, -s, 0.0, x], [s, c, 0.0, y], [0.0, 0.0, 1.0, h],
                    [0.0, 0.0, 0.0, 1.0]]
    return poses


def make_world(traffic: dict, poses: np.ndarray, seed: int,
               device) -> torch.Tensor:
    """Box buildings and poles at ``make_world``'s densities over the
    driven path's bounding box grown by ``world.margin_m``: ``[M, 3]``
    points on ``device``."""
    g = torch.Generator(device=device).manual_seed(seed_key(seed, 2))
    margin = traffic["world"]["margin_m"]
    lo = poses[:, :2, 3].min(0) - margin
    hi = poses[:, :2, 3].max(0) + margin
    area = float(np.prod(hi - lo))
    lo_t = torch.tensor(lo, dtype=torch.float32, device=device)
    span = torch.tensor(hi - lo, dtype=torch.float32, device=device)

    def uniform(n, a=0.0, b=1.0, cols=None):
        shape = (n,) if cols is None else (n, cols)
        return a + (b - a) * torch.rand(shape, generator=g, device=device)

    nb = max(1, round(_BUILDINGS_PER_M2 * area))
    centre = lo_t + uniform(nb, cols=2) * span
    wd = uniform(nb, 6.0, 20.0, cols=2)
    height = uniform(nb, 4.0, 15.0)
    n_wall = (2.0 * wd.sum(1) * height * _WALL_DENSITY / 6.0).long()
    owner = torch.repeat_interleave(torch.arange(nb, device=device), n_wall)
    m = owner.numel()
    side = torch.randint(0, 4, (m,), generator=g, device=device)
    u = uniform(m)
    z = uniform(m) * height[owner]
    cx, cy = centre[owner, 0], centre[owner, 1]
    w, d = wd[owner, 0], wd[owner, 1]
    x = torch.where(side == 0, cx - w / 2,
                    torch.where(side == 1, cx + w / 2, cx - w / 2 + u * w))
    y = torch.where(side <= 1, cy - d / 2 + u * d,
                    torch.where(side == 2, cy - d / 2, cy + d / 2))

    npole = max(1, round(_POLES_PER_M2 * area))
    pc = lo_t + uniform(npole, cols=2) * span
    pc = pc.repeat_interleave(_POLE_POINTS, 0)
    jitter = 0.02 * torch.randn((pc.shape[0], 2), generator=g,
                                device=device)
    pz = uniform(pc.shape[0], 0.0, 4.0)
    return torch.cat([torch.stack([x, y, z], 1),
                      torch.cat([pc + jitter, pz[:, None]], 1)])


def render_scan(world: torch.Tensor, pose: np.ndarray, sensor: dict,
                n_points: int, seed: int, index: int) -> torch.Tensor:
    """Scan ``index`` of the drive, seen from ``pose``: ``[n_points, 4]``
    float32 (sensor-frame xyz, intensity) on the world's device, drawn
    from its own generator."""
    dev = world.device
    g = torch.Generator(device=dev).manual_seed(seed_key(seed, 3, index))
    n_ground = int(n_points * sensor["ground_fraction"])
    n_struct = n_points - n_ground
    t = torch.tensor(pose[:3, 3], dtype=torch.float32, device=dev)
    R = torch.tensor(pose[:3, :3], dtype=torch.float32, device=dev)
    d = world - t
    sel = torch.nonzero(torch.sum(d * d, 1)
                        < sensor["max_range_m"] ** 2).squeeze(1)
    pick = torch.randperm(sel.numel(), generator=g, device=dev)[:n_struct]
    sel = torch.sort(sel[pick]).values
    n_ground = n_points - sel.numel()
    r = sensor["ground_range_m"] * (
        0.02 + 0.98 * torch.rand(n_ground, generator=g, device=dev)) ** 0.7
    theta = 2.0 * math.pi * torch.rand(n_ground, generator=g, device=dev)
    ground = torch.stack([t[0] + r * torch.cos(theta),
                          t[1] + r * torch.sin(theta),
                          torch.zeros_like(r)], 1)
    pts = torch.cat([world[sel], ground])
    # sensor frame: R^T (p - t), elementwise so no matmul precision mode
    # can touch the inputs
    rel = pts - t
    local = torch.sum(rel[:, :, None] * R[None], 1)
    local = local + sensor["noise_m"] * torch.randn(
        local.shape, generator=g, device=dev)
    inten = torch.rand((n_points, 1), generator=g, device=dev)
    perm = torch.randperm(n_points, generator=g, device=dev)
    return torch.cat([local, inten], 1)[perm]


def render_drive(traffic: dict, n_points: int, scan_capacity: int,
                 n_scans: int, seed: int, device):
    """The drive's true poses ``[n, 4, 4]`` (float64) and its ``n_scans``
    scans as one host float32 array ``[n, n_points, 4]`` (rendered on
    ``device``, copied to the host once).  Refuses a scan larger than
    ``scan_capacity``: the front end drops the points past it."""
    if n_points > scan_capacity:
        raise ValueError(f"{n_points} points a scan do not fit the "
                         f"configuration's scan_capacity {scan_capacity}")
    poses = true_poses(traffic, n_scans, seed)
    world = make_world(traffic, poses, seed, device)
    scans = np.empty((n_scans, n_points, 4), dtype=np.float32)
    block = 64
    for b0 in range(0, n_scans, block):
        b1 = min(n_scans, b0 + block)
        out = torch.stack([render_scan(world, poses[k], traffic["sensor"],
                                       n_points, seed, k)
                           for k in range(b0, b1)])
        scans[b0:b1] = out.cpu().numpy()
    return poses, scans
