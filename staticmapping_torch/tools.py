"""Offline tools — the PyTorch port's counterpart of
``staticmapping_tpu.tools``, the reference's ``tools/`` utilities (SURVEY
L9, tools/CMakeLists.txt:1-14) as subcommands:

    python -m staticmapping_torch.tools join_pieces  PIECES_DIR OUT.pcd
    python -m staticmapping_torch.tools path_statistic PATH_FILE
    python -m staticmapping_torch.tools bin_to_pcd   IN.bin OUT.pcd
    python -m staticmapping_torch.tools pcd_sampler  IN.pcd OUT.pcd --rate R
    python -m staticmapping_torch.tools pcd_to_las   IN.pcd OUT.las

* join_pieces: merge a map-package pieces dir (center-relative part pcds +
  XML descriptor, builder/map_package.cc:210-230) back into one global
  cloud (tools/join_pieces.cc role).
* path_statistic: trajectory length / extent / duration from ``path.csv``
  or a KITTI pose file (tools/path_statistic.cc role).
* bin_to_pcd: KITTI velodyne .bin → pcd (tools/bin_viewer.cc role, minus
  the GUI).
* pcd_sampler: random downsample of a pcd with numpy's
  ``default_rng(seed)`` (tools/pcd_sampler.cc role).
* pcd_to_las: pcd → LAS 1.2 (tools/pcd_to_las.cc role; direct-header
  writer, no libLAS — io/las.py).

Every tool is host numpy over the port's ``io`` modules: it needs no
device, and writes the same bytes as the JAX package's tool for the same
input.
"""
from __future__ import annotations

import argparse
import os
import sys
import xml.etree.ElementTree as ET

import numpy as np


def join_pieces(pieces_dir: str, out_path: str,
                descript_filename: str = "map.xml") -> int:
    from .io import pcd as pcd_io
    desc = os.path.join(pieces_dir, descript_filename)
    if not os.path.exists(desc):
        # fall back to any xml descriptor in the dir
        cands = [f for f in os.listdir(pieces_dir) if f.endswith(".xml")]
        if not cands:
            print(f"no descriptor xml in {pieces_dir}", file=sys.stderr)
            return 2
        desc = os.path.join(pieces_dir, cands[0])
    root = ET.parse(desc).getroot()
    parts = []
    for piece in root.findall("Piece"):
        f = piece.get("file")
        cx, cy = float(piece.get("x")), float(piece.get("y"))
        pts = pcd_io.read_pcd(os.path.join(pieces_dir, f))
        if not len(pts):
            continue
        pts = pts.copy()
        pts[:, 0] += cx
        pts[:, 1] += cy
        parts.append(pts)
    if not parts:
        print("no pieces found", file=sys.stderr)
        return 2
    merged = np.vstack(parts)
    pcd_io.write_pcd(out_path, merged)
    print(f"joined {len(parts)} pieces, {len(merged)} points -> {out_path}")
    return 0


def path_statistic(path_file: str) -> int:
    if path_file.endswith(".csv"):
        data = np.loadtxt(path_file)
        stamps, xyz = data[:, 0], data[:, 1:4]
    else:   # KITTI 12-number pose rows
        data = np.loadtxt(path_file)
        xyz = data[:, [3, 7, 11]]
        stamps = None
    if len(xyz) < 2:
        print("path too short")
        return 2
    seg = np.linalg.norm(np.diff(xyz, axis=0), axis=1)
    length = float(seg.sum())
    bbox = xyz.max(axis=0) - xyz.min(axis=0)
    print(f"poses:        {len(xyz)}")
    print(f"length:       {length:.2f} m")
    print(f"bbox (x,y,z): {bbox[0]:.1f} x {bbox[1]:.1f} x {bbox[2]:.1f} m")
    if stamps is not None and stamps[-1] > stamps[0]:
        dur = float(stamps[-1] - stamps[0])
        print(f"duration:     {dur:.1f} s  (avg {length / dur:.2f} m/s)")
    return 0


def bin_to_pcd(in_path: str, out_path: str) -> int:
    from .io import kitti as kitti_io
    from .io import pcd as pcd_io
    pts = kitti_io.read_bin(in_path)
    pcd_io.write_pcd(out_path, pts)
    print(f"{len(pts)} points -> {out_path}")
    return 0


def pcd_sampler(in_path: str, out_path: str, rate: float,
                seed: int = 0) -> int:
    from .io import pcd as pcd_io
    pts = pcd_io.read_pcd(in_path)
    rng = np.random.default_rng(seed)
    keep = rng.random(len(pts)) < rate
    pcd_io.write_pcd(out_path, pts[keep])
    print(f"{len(pts)} -> {int(keep.sum())} points ({rate:.2f}) "
          f"-> {out_path}")
    return 0


def pcd_to_las(in_path: str, out_path: str, scale: float = 0.001) -> int:
    from .io import las as las_io
    from .io import pcd as pcd_io
    pts = pcd_io.read_pcd(in_path)
    las_io.write_las(out_path, pts, scale=scale)
    print(f"{len(pts)} points -> {out_path}")
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="staticmapping_torch.tools")
    sub = p.add_subparsers(dest="cmd", required=True)
    j = sub.add_parser("join_pieces")
    j.add_argument("pieces_dir")
    j.add_argument("out")
    j.add_argument("--descriptor", default="map.xml")
    s = sub.add_parser("path_statistic")
    s.add_argument("path_file")
    b = sub.add_parser("bin_to_pcd")
    b.add_argument("infile")
    b.add_argument("out")
    r = sub.add_parser("pcd_sampler")
    r.add_argument("infile")
    r.add_argument("out")
    r.add_argument("--rate", type=float, default=0.5)
    r.add_argument("--seed", type=int, default=0)
    l = sub.add_parser("pcd_to_las")
    l.add_argument("infile")
    l.add_argument("out")
    l.add_argument("--scale", type=float, default=0.001)
    a = p.parse_args(argv)
    if a.cmd == "join_pieces":
        return join_pieces(a.pieces_dir, a.out, a.descriptor)
    if a.cmd == "path_statistic":
        return path_statistic(a.path_file)
    if a.cmd == "bin_to_pcd":
        return bin_to_pcd(a.infile, a.out)
    if a.cmd == "pcd_sampler":
        return pcd_sampler(a.infile, a.out, a.rate, a.seed)
    if a.cmd == "pcd_to_las":
        return pcd_to_las(a.infile, a.out, a.scale)
    return 2


if __name__ == "__main__":
    sys.exit(main())
