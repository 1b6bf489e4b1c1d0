"""Minimal LAS 1.2 writer and reader — the port's copy of
``staticmapping_tpu.io.las``, the ``pcd_to_las`` tool's output format
(reference: tools/pcd_to_las.cc, which uses libLAS; here the 227-byte
LAS 1.2 public header + point-format-0 records are written directly, no
third-party library).  The header carries the same system identifier as
the JAX package's, so both tools write the same bytes for the same cloud.

Point data record format 0 (20 bytes): int32 x, y, z (scaled), uint16
intensity, bit fields, classification, int8 scan angle, uint8 user data,
uint16 point source id.
"""
from __future__ import annotations

import struct

import numpy as np

_HEADER_SIZE = 227
_POINT_SIZE = 20


def write_las(path: str, points: np.ndarray,
              scale: float = 0.001) -> None:
    """points: [N, 3] or [N, 4] (x, y, z[, intensity 0..1 or 0..255])."""
    pts = np.asarray(points, dtype=np.float64)
    if pts.ndim != 2 or pts.shape[1] not in (3, 4):
        raise ValueError(f"expected [N,3|4], got {pts.shape}")
    n = pts.shape[0]
    xyz = pts[:, :3]
    if pts.shape[1] == 4:
        inten = pts[:, 3]
        # accept either 0..1 (our clouds) or raw 0..255+ intensity
        if inten.size and inten.max() <= 1.0 + 1e-6:
            inten = inten * 65535.0
        inten = np.clip(inten, 0, 65535).astype(np.uint16)
    else:
        inten = np.zeros(n, dtype=np.uint16)

    mins = xyz.min(axis=0) if n else np.zeros(3)
    maxs = xyz.max(axis=0) if n else np.zeros(3)
    offset = mins
    quant = np.round((xyz - offset) / scale).astype(np.int32)

    header = bytearray(_HEADER_SIZE)
    struct.pack_into("<4s", header, 0, b"LASF")
    struct.pack_into("<BB", header, 24, 1, 2)           # version 1.2
    struct.pack_into("<32s", header, 26, b"staticmapping_tpu")
    struct.pack_into("<32s", header, 58, b"pcd_to_las")
    struct.pack_into("<HH", header, 90, 1, 2026)        # day/year (nominal)
    struct.pack_into("<H", header, 94, _HEADER_SIZE)    # header size
    struct.pack_into("<I", header, 96, _HEADER_SIZE)    # offset to points
    struct.pack_into("<I", header, 100, 0)              # no VLRs
    struct.pack_into("<B", header, 104, 0)              # point format 0
    struct.pack_into("<H", header, 105, _POINT_SIZE)
    struct.pack_into("<I", header, 107, n)              # num point records
    struct.pack_into("<I", header, 111, n)              # return 1 count
    struct.pack_into("<3d", header, 131, scale, scale, scale)
    struct.pack_into("<3d", header, 155, *offset)
    struct.pack_into("<6d", header, 179, maxs[0], mins[0], maxs[1],
                     mins[1], maxs[2], mins[2])

    rec = np.zeros(n, dtype=np.dtype([
        ("x", "<i4"), ("y", "<i4"), ("z", "<i4"), ("intensity", "<u2"),
        ("flags", "u1"), ("classification", "u1"), ("scan_angle", "i1"),
        ("user_data", "u1"), ("point_source_id", "<u2")]))
    rec["x"], rec["y"], rec["z"] = quant[:, 0], quant[:, 1], quant[:, 2]
    rec["intensity"] = inten
    rec["flags"] = 0b00001001      # return 1 of 1

    with open(path, "wb") as f:
        f.write(bytes(header))
        f.write(rec.tobytes())


def read_las(path: str) -> np.ndarray:
    """Read a format-0/1/2/3 LAS file → [N, 4] (x, y, z, intensity)."""
    with open(path, "rb") as f:
        header = f.read(_HEADER_SIZE)
        if header[:4] != b"LASF":
            raise ValueError("not a LAS file")
        (offset_to_points,) = struct.unpack_from("<I", header, 96)
        (point_size,) = struct.unpack_from("<H", header, 105)
        (n,) = struct.unpack_from("<I", header, 107)
        scale = struct.unpack_from("<3d", header, 131)
        off = struct.unpack_from("<3d", header, 155)
        f.seek(offset_to_points)
        raw = np.frombuffer(f.read(n * point_size), dtype=np.uint8)
    raw = raw.reshape(n, point_size)
    xyz_i = raw[:, :12].copy().view("<i4").reshape(n, 3).astype(np.float64)
    inten = raw[:, 12:14].copy().view("<u2").reshape(n).astype(np.float32)
    xyz = xyz_i * np.asarray(scale) + np.asarray(off)
    return np.column_stack([xyz.astype(np.float32), inten / 65535.0])
