"""ViewGraph — pose-graph mirror for export/visualization; a copy of
``staticmapping_tpu.backend.view_graph`` (numpy and ``zlib`` only).

Parity with back_end/view_graph.{h,cc}: vertices (index → pose) with a
running 2-D bbox, directed edges with transforms, text dump
(``SaveTextFile``, view_graph.cc:68-87) and a rendered image
(``SaveImage``, cc:90-150 — the reference uses CImg+libpng; here a
dependency-free PNG writer over ``zlib``: vertices red, edges blue).
"""
from __future__ import annotations

import struct
import zlib
from typing import Dict, List, Tuple

import numpy as np


class ViewGraph:
    def __init__(self):
        self.vertices: Dict[int, np.ndarray] = {}
        self.edges: Dict[int, List[Tuple[int, np.ndarray]]] = {}
        self.min_b = np.array([np.inf, np.inf])
        self.max_b = np.array([-np.inf, -np.inf])

    def add_vertex(self, index: int, pose: np.ndarray) -> None:
        """AddVertex (view_graph.cc:51-67): insert/update + bbox."""
        pose = np.asarray(pose, dtype=np.float64)
        self.vertices[int(index)] = pose
        self.min_b = np.minimum(self.min_b, pose[:2, 3])
        self.max_b = np.maximum(self.max_b, pose[:2, 3])

    def add_edge(self, a: int, b: int, t: np.ndarray) -> bool:
        """AddEdge (view_graph.cc:42-49): both endpoints must exist."""
        if a not in self.vertices or b not in self.vertices:
            return False
        self.edges.setdefault(int(a), []).append(
            (int(b), np.asarray(t, dtype=np.float64)))
        return True

    def save_text_file(self, path: str) -> None:
        """'index > connected, connected, …' dump (view_graph.cc:68-87)."""
        lines = []
        for idx in sorted(self.vertices):
            conns = ", ".join(str(b) for b, _ in self.edges.get(idx, []))
            lines.append(f"{idx} > {conns}{', ' if conns else ''}")
        with open(path, "w") as f:
            f.write("\n".join(lines) + "\n")

    # ------------------------------------------------------------------
    def render(self, resolution: float = 0.05,
               max_dim: int = 4096) -> np.ndarray:
        """RGB uint8 image of the graph (SaveImage geometry,
        view_graph.cc:90-150): x→col, y flipped to row; vertices red
        squares, edges blue lines."""
        if not self.vertices:
            return np.full((1, 1, 3), 255, dtype=np.uint8)
        margin = 1.0
        mn = self.min_b - margin
        mx = self.max_b + margin
        span = mx - mn
        res = max(resolution, float(max(span) / max_dim))
        w = max(int(span[0] / res), 1)
        h = max(int(span[1] / res), 1)
        img = np.full((h, w, 3), 255, dtype=np.uint8)

        def to_px(pose):
            x = int((pose[0, 3] - mn[0]) / res)
            y = int((mx[1] - pose[1, 3]) / res)
            return min(max(x, 0), w - 1), min(max(y, 0), h - 1)

        blue = np.array([0, 0, 255], dtype=np.uint8)
        red = np.array([255, 0, 0], dtype=np.uint8)
        for a, conns in self.edges.items():
            xa, ya = to_px(self.vertices[a])
            for b, _t in conns:
                xb, yb = to_px(self.vertices[b])
                n = max(abs(xb - xa), abs(yb - ya), 1)
                xs = np.linspace(xa, xb, n + 1).round().astype(int)
                ys = np.linspace(ya, yb, n + 1).round().astype(int)
                img[ys, xs] = blue
        for pose in self.vertices.values():
            x, y = to_px(pose)
            x0, x1 = max(x - 1, 0), min(x + 2, w)
            y0, y1 = max(y - 1, 0), min(y + 2, h)
            img[y0:y1, x0:x1] = red
        return img

    def save_image(self, path: str, resolution: float = 0.05) -> None:
        _write_png(path, self.render(resolution))


def _write_png(path: str, rgb: np.ndarray) -> None:
    """Minimal RGB8 PNG writer (zlib is stdlib; no image library needed)."""
    h, w, _ = rgb.shape
    raw = b"".join(b"\x00" + rgb[y].tobytes() for y in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    png = (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
           + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(png)
