"""Bounded-depth octree over points — the port's copy of
``staticmapping_tpu.common.octree`` (reference: ``common/octree.{h,cc}``,
octree.h:70; built there but exercised only by
``common/test/test_octree.cc``).  Host-side numpy utility: the device path
never pointer-chases a tree (ops/nn_search.py replaces kd/oct-trees with a
brute-force 1-NN kernel); this exists for the offline-tool surface the
reference ships.

Construction is vectorized: points get a per-level Morton child code; the
"tree" is a dict keyed by (depth, cell index) holding point indices —
equivalent query semantics to the reference's recursive nodes without
per-node allocation.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np


class Octree:
    """Fixed-depth octree over ``points`` within an axis-aligned cube."""

    def __init__(self, points: np.ndarray, max_depth: int = 5,
                 center: Optional[np.ndarray] = None,
                 half_size: Optional[float] = None):
        self.points = np.asarray(points, dtype=np.float64).reshape(-1, 3)
        n = len(self.points)
        if center is None or half_size is None:
            lo = self.points.min(axis=0) if n else np.zeros(3)
            hi = self.points.max(axis=0) if n else np.zeros(3)
            center = (lo + hi) / 2.0
            half_size = float(np.max(hi - lo) / 2.0) + 1e-9
        self.center = np.asarray(center, dtype=np.float64)
        self.half_size = float(half_size)
        self.max_depth = int(max_depth)

        # per-depth cell index of every point (vectorized build)
        self._cells: List[np.ndarray] = []
        side = 1
        for d in range(self.max_depth + 1):
            side = 1 << d
            rel = (self.points - (self.center - self.half_size)) \
                / (2.0 * self.half_size)
            ijk = np.clip((rel * side).astype(np.int64), 0, side - 1)
            self._cells.append(ijk[:, 0] * side * side
                               + ijk[:, 1] * side + ijk[:, 2])
        # leaf occupancy map
        self._leaf: Dict[int, np.ndarray] = {}
        if n:
            order = np.argsort(self._cells[-1], kind="stable")
            sorted_cells = self._cells[-1][order]
            bounds = np.flatnonzero(np.diff(sorted_cells)) + 1
            for seg in np.split(order, bounds):
                self._leaf[int(self._cells[-1][seg[0]])] = seg

    # ------------------------------------------------------------------
    def __len__(self) -> int:
        return len(self.points)

    @property
    def num_leaves(self) -> int:
        return len(self._leaf)

    def contains(self, p) -> bool:
        p = np.asarray(p, dtype=np.float64)
        return bool(np.all(np.abs(p - self.center) <= self.half_size))

    def leaf_of(self, p) -> Optional[np.ndarray]:
        """Indices of points sharing the max-depth cell of ``p`` (None if
        outside the cube or the cell is empty)."""
        if not self.contains(p):
            return None
        side = 1 << self.max_depth
        rel = (np.asarray(p, dtype=np.float64)
               - (self.center - self.half_size)) / (2.0 * self.half_size)
        ijk = np.clip((rel * side).astype(np.int64), 0, side - 1)
        key = int(ijk[0] * side * side + ijk[1] * side + ijk[2])
        return self._leaf.get(key)

    def radius_search(self, p, radius: float) -> np.ndarray:
        """Indices of points within ``radius`` of ``p`` — the octree prunes
        whole leaf cells whose cube cannot intersect the ball."""
        p = np.asarray(p, dtype=np.float64)
        side = 1 << self.max_depth
        cell = 2.0 * self.half_size / side
        lo = np.clip(((p - radius - (self.center - self.half_size)) / cell)
                     .astype(np.int64), 0, side - 1)
        hi = np.clip(((p + radius - (self.center - self.half_size)) / cell)
                     .astype(np.int64), 0, side - 1)
        hits: List[np.ndarray] = []
        for i in range(int(lo[0]), int(hi[0]) + 1):
            for j in range(int(lo[1]), int(hi[1]) + 1):
                for k in range(int(lo[2]), int(hi[2]) + 1):
                    seg = self._leaf.get(i * side * side + j * side + k)
                    if seg is not None:
                        hits.append(seg)
        if not hits:
            return np.zeros(0, dtype=np.int64)
        cand = np.concatenate(hits)
        d2 = np.sum((self.points[cand] - p) ** 2, axis=1)
        return cand[d2 <= radius * radius]

    def nearest(self, p) -> Tuple[int, float]:
        """(index, distance) of the nearest point (brute fallback over
        expanding cell rings; exact)."""
        p = np.asarray(p, dtype=np.float64)
        r = 2.0 * self.half_size / (1 << self.max_depth)
        while True:
            idx = self.radius_search(p, r)
            if len(idx):
                d = np.linalg.norm(self.points[idx] - p, axis=1)
                k = int(np.argmin(d))
                return int(idx[k]), float(d[k])
            if r > 4.0 * self.half_size:
                return -1, float("inf")
            r *= 2.0
