"""RangeImage — spherical range-image projection filter and depth
clustering, the PyTorch counterpart of
``staticmapping_tpu.filters.range_image`` (reference:
pre_processors/filter_range_image.{h,cc}):

  * the filter projects every point into an H×W spherical range image
    (vertical FOV [btm_angle, top_angle], azimuth wrap) and keeps exactly
    one point a pixel, the first arrival (filter_range_image.cc:81-138);
    out-of-image points go;
  * ``depth_cluster``: angle-threshold depth clustering with labels and
    small-cluster (< 20 px) removal (cc:141-170, LabelOneComponent
    cc:245-306).  The reference's BFS is min-label propagation with
    pointer jumping, a fixed number of vectorized sweeps;
  * ``to_image``: the range image as an array (the reference writes PNG,
    cc:174-243; ``save_pgm`` writes a PGM).

"First arrival" is the lowest point index a pixel (scan order for
in-order clouds).
"""
from __future__ import annotations

import dataclasses
import math
from typing import ClassVar, Dict, Tuple

import numpy as np
import torch

from ..data.cloud import PointCloud
from .filters import Filter

_SEG_RAD_THRESHOLD = 10.0 / 180.0 * math.pi   # segmentation_rad_threshold_


def _f32(v, device) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32, device=device)


def _project(xyz, mask, top_angle: float, btm_angle: float, offset,
             rows: int, cols: int):
    """Returns ``(keep_mask, pixel_id, range)``: one winner a pixel."""
    dev = xyz.device
    n = xyz.shape[0]
    p = xyz + offset
    x, y, z = p[:, 0], p[:, 1], p[:, 2]
    dxy = torch.sqrt(x * x + y * y)
    # f32 constants and 0-dim device divisors, as the JAX package's traced
    # scalars: true f32 divisions on every device
    h_res = _f32(2.0 * math.pi / cols, dev)
    top, btm = _f32(top_angle, dev), _f32(btm_angle, dev)
    v_res = (top - btm) / _f32(rows, dev) / _f32(180.0, dev) * math.pi

    v_rad = torch.atan2(z, dxy)
    row = ((v_rad - btm / _f32(180.0, dev) * math.pi) / v_res
           ).to(torch.int32)
    h_rad = torch.atan2(y, x)
    h_rad = torch.where(h_rad < 0, h_rad + 2.0 * math.pi, h_rad)
    col = torch.round(h_rad / h_res).to(torch.int32)
    col = torch.where(col >= cols, col - cols, col)

    ok = (mask & (dxy >= 0.01) & (row >= 0) & (row < rows)
          & (col >= 0) & (col < cols))
    pix = torch.where(ok, row * cols + col, rows * cols).long()
    # first arrival = lowest point index a pixel
    idx = torch.arange(n, device=dev)
    winner = torch.full((rows * cols + 1,), n, dtype=torch.int64,
                        device=dev).scatter_reduce(
        0, pix, torch.where(ok, idx, n), "amin")
    keep = ok & (winner[pix] == idx)
    rng = torch.sqrt(x * x + y * y + z * z)
    return keep, pix, rng


def _shift(arr: torch.Tensor, dr: int, dc: int, fill):
    """``arr`` moved by (−dr, −dc), the azimuth wrapping and the rows
    filled with ``fill``."""
    rolled = torch.roll(arr, shifts=(-dr, -dc), dims=(0, 1))
    if dr > 0:        # vertical edges do not wrap
        rolled[-dr:, :] = fill
    elif dr < 0:
        rolled[:-dr, :] = fill
    return rolled


def _depth_cluster(image: torch.Tensor, v_res: torch.Tensor, rows: int,
                   cols: int, sweeps: int = 24) -> torch.Tensor:
    """Angle-criterion connected components on the range image.

    ``image`` [rows, cols] with 0 = empty; ``v_res`` the vertical angular
    resolution in radians (f32).  Neighbours (0,±1), (0,±2), (±1,0) with
    azimuth wrap (LabelOneComponent, cc:251-258); edge criterion
    beta = atan2(d2·sin a, d1 − d2·cos a) > threshold (cc:288-302).
    Returns int32 labels [rows, cols] (0 = empty); a component's label is
    its least flat pixel id + 1, after ``sweeps`` rounds of neighbour-min
    propagation and two pointer jumps a round."""
    dev = image.device
    h_res = 2.0 * math.pi / cols
    occ = image > 1e-6
    empty_lab = rows * cols
    neighbors = [(0, 1), (0, -1), (0, 2), (0, -2), (1, 0), (-1, 0)]
    conn_masks = []
    for dr, dc in neighbors:
        alpha = _f32(h_res * abs(dc), dev) if dr == 0 else v_res
        nb = _shift(image, dr, dc, 0.0)
        d1 = torch.maximum(image, nb)
        d2 = torch.minimum(image, nb)
        beta = torch.atan2(d2 * torch.sin(alpha), d1 - d2 * torch.cos(alpha))
        conn_masks.append(occ & (nb > 1e-6) & (beta > _SEG_RAD_THRESHOLD))

    flat_ids = torch.arange(rows * cols, dtype=torch.int64,
                            device=dev).reshape(rows, cols)
    labels = torch.where(occ, flat_ids, empty_lab)
    tail = torch.full((1,), empty_lab, dtype=torch.int64, device=dev)
    for _ in range(sweeps):
        new = labels
        for (dr, dc), conn in zip(neighbors, conn_masks):
            nb_lab = _shift(labels, dr, dc, empty_lab)
            new = torch.where(conn, torch.minimum(new, nb_lab), new)
        # pointer jumping: label ← label[label], twice
        flat = new.reshape(-1)
        flat = torch.cat([flat, tail])[flat]
        flat = torch.cat([flat, tail])[flat]
        labels = flat.reshape(rows, cols)
    return torch.where(occ, labels + 1, 0).to(torch.int32)


@dataclasses.dataclass
class RangeImageFilter(Filter):
    """See the module docstring.  Parameter names and defaults:
    filter_range_image.cc:28-52."""

    top_angle: float = 30.0
    btm_angle: float = -15.0
    offset_x: float = 0.0
    offset_y: float = 0.0
    offset_z: float = 0.0
    vertical_line_num: int = 40
    horizontal_line_num: int = 1800
    min_cluster_size: int = 20      # LabelOneComponent, cc:305

    NAME: ClassVar[str] = "RangeImage"
    PARAMS: ClassVar[Dict[str, Tuple[str, type]]] = {
        "top_angle": ("top_angle", float),
        "btm_angle": ("btm_angle", float),
        "offset_x": ("offset_x", float),
        "offset_y": ("offset_y", float),
        "offset_z": ("offset_z", float),
        "vertical_line_num": ("vertical_line_num", int),
        "horizontal_line_num": ("horizontal_line_num", int),
    }

    def configs_valid(self) -> bool:
        return (self.vertical_line_num > 0 and self.horizontal_line_num > 0
                and self.btm_angle < self.top_angle)

    def _project(self, cloud: PointCloud):
        offset = torch.tensor([self.offset_x, self.offset_y, self.offset_z],
                              dtype=torch.float32, device=cloud.device)
        return _project(cloud.xyz, cloud.mask, self.top_angle,
                        self.btm_angle, offset, rows=self.vertical_line_num,
                        cols=self.horizontal_line_num)

    def __call__(self, cloud: PointCloud) -> PointCloud:
        keep, _, _ = self._project(cloud)
        return cloud.with_mask(keep)

    def _image(self, keep, pix, rng) -> torch.Tensor:
        """The range image, flat, with one overflow slot at the end."""
        n_pix = self.vertical_line_num * self.horizontal_line_num
        return torch.zeros(n_pix + 1, dtype=torch.float32,
                           device=rng.device).scatter_reduce(
            0, torch.where(keep, pix, n_pix), torch.where(keep, rng, 0.0),
            "amax")

    def to_image(self, cloud: PointCloud) -> np.ndarray:
        """The range image [rows, cols] (0 = empty), ToPng's data."""
        rows, cols = self.vertical_line_num, self.horizontal_line_num
        img = self._image(*self._project(cloud))
        return img[:rows * cols].reshape(rows, cols).cpu().numpy()

    def save_pgm(self, cloud: PointCloud, path: str,
                 max_range: float = 75.0) -> None:
        """Debug dump (the reference writes PNG; PGM needs no image
        library and every viewer opens it)."""
        img = self.to_image(cloud)
        g = np.clip(img / max_range * 255.0, 0, 255).astype(np.uint8)
        with open(path, "wb") as f:
            f.write(b"P5\n%d %d\n255\n" % (g.shape[1], g.shape[0]))
            f.write(g.tobytes())

    def depth_cluster(self, cloud: PointCloud, sweeps: int = 24):
        """Per-point cluster labels (0 = unclustered or in a cluster under
        ``min_cluster_size`` pixels): DepthCluster and its gate
        (cc:305)."""
        keep, pix, rng = self._project(cloud)
        rows, cols = self.vertical_line_num, self.horizontal_line_num
        img = self._image(keep, pix, rng)
        v_res = _f32((self.top_angle - self.btm_angle) / rows / 180.0
                     * math.pi, cloud.device)
        flat = _depth_cluster(img[:rows * cols].reshape(rows, cols), v_res,
                              rows, cols, sweeps=sweeps).reshape(-1).long()
        sizes = torch.zeros(rows * cols + 2, dtype=torch.int64,
                            device=flat.device).index_add_(
            0, flat, torch.ones_like(flat))
        good = sizes[flat] >= self.min_cluster_size
        flat = torch.where((flat > 0) & good, flat, 0)
        ext = torch.cat([flat, flat.new_zeros(1)])
        return torch.where(keep, ext[pix.clamp_max(rows * cols)],
                           0).to(torch.int32)
