"""Host-side sparse voxel store for the MRVM — the PyTorch port's copy of
``staticmapping_tpu.builder.mrvm_store``: a ctypes binding over the native
C++ open-addressing hash map (``csrc/mrvm_store.cpp``), and a numpy store
with the same semantics (sort + unique merge).

The native store is the one the map builder uses: the per-scan merge of
voxel aggregates is host-side data-structure work (the reference's TBB
concurrent map role, multi_resolution_voxel_map.h:81-85), O(events) per scan
in the hash map and a full-map sort/unique per scan, O(V log V), in numpy.
:func:`make_store` builds the native library at first use and raises if it
cannot; the numpy store is taken only when the caller asks for it.
"""
from __future__ import annotations

import ctypes
import numpy as np

from .. import cuda_build


class _NativeStore:
    def __init__(self, lib: ctypes.CDLL):
        self._lib = lib
        lib.mrvm_store_create.restype = ctypes.c_void_p
        lib.mrvm_store_destroy.argtypes = [ctypes.c_void_p]
        lib.mrvm_store_size.argtypes = [ctypes.c_void_p]
        lib.mrvm_store_size.restype = ctypes.c_int64
        lib.mrvm_store_merge.argtypes = [
            ctypes.c_void_p,
            np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
            ctypes.c_int64,
            ctypes.c_double,
        ]
        lib.mrvm_store_export.argtypes = [
            ctypes.c_void_p,
            np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
        ]
        self._h = lib.mrvm_store_create()

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.mrvm_store_destroy(self._h)
            self._h = None

    def merge(self, keys, hits, misses, sum_xyz, max_int, sum_int,
              cap: float = 0.0) -> None:
        n = len(hits)
        if n == 0:
            return
        self._lib.mrvm_store_merge(
            self._h,
            np.ascontiguousarray(keys, dtype=np.int32),
            np.ascontiguousarray(hits, dtype=np.float64),
            np.ascontiguousarray(misses, dtype=np.float64),
            np.ascontiguousarray(sum_xyz, dtype=np.float64),
            np.ascontiguousarray(max_int, dtype=np.float32),
            np.ascontiguousarray(sum_int, dtype=np.float64),
            n, float(cap))

    @property
    def size(self) -> int:
        return int(self._lib.mrvm_store_size(self._h))

    def export(self):
        v = self.size
        keys = np.empty((v, 3), dtype=np.int32)
        hits = np.empty(v, dtype=np.float64)
        misses = np.empty(v, dtype=np.float64)
        sum_xyz = np.empty((v, 3), dtype=np.float64)
        max_int = np.empty(v, dtype=np.float32)
        sum_int = np.empty(v, dtype=np.float64)
        avg_cnt = np.empty(v, dtype=np.float64)
        if v:
            self._lib.mrvm_store_export(self._h, keys, hits, misses,
                                        sum_xyz, max_int, sum_int, avg_cnt)
        return keys, hits, misses, sum_xyz, max_int, sum_int, avg_cnt


class _NumpyStore:
    """The same semantics in numpy (sort/unique merge per scan)."""

    def __init__(self):
        self.keys = np.zeros((0, 3), dtype=np.int64)
        self.hits = np.zeros(0)
        self.misses = np.zeros(0)
        self.sum_xyz = np.zeros((0, 3))
        self.max_int = np.zeros(0, dtype=np.float32)
        self.sum_int = np.zeros(0)
        self.avg_cnt = np.zeros(0)

    def merge(self, keys, hits, misses, sum_xyz, max_int, sum_int,
              cap: float = 0.0) -> None:
        all_keys = np.concatenate([self.keys, keys.astype(np.int64)])
        uniq, inv = np.unique(all_keys, axis=0, return_inverse=True)
        nv = uniq.shape[0]
        n_old = len(self.hits)

        def acc(a, b):
            return np.bincount(inv, weights=np.concatenate([a, b]),
                               minlength=nv)

        # max_point_num_in_cell (multi_resolution_voxel_map.cc:100): admit
        # at most cap hit points per cell into the position/intensity sums
        # (fractional when a scan straddles the cap)
        if cap > 0.0:
            old_cnt = np.zeros(nv)
            np.add.at(old_cnt, inv[:n_old], self.avg_cnt)
            allowed = np.clip(cap - old_cnt[inv[n_old:]], 0.0, hits)
            frac = np.divide(allowed, hits, out=np.zeros_like(allowed),
                             where=hits > 0)
            sum_xyz = sum_xyz * frac[:, None]
            sum_int = sum_int * frac
            new_avg = allowed
        else:
            new_avg = np.asarray(hits, dtype=np.float64)

        self.hits = acc(self.hits, hits)
        self.misses = acc(self.misses, misses)
        self.avg_cnt = acc(self.avg_cnt, new_avg)
        self.sum_xyz = np.column_stack([
            acc(self.sum_xyz[:, k], sum_xyz[:, k]) for k in range(3)])
        self.sum_int = acc(self.sum_int, sum_int)
        mi = np.full(nv, -1.0, dtype=np.float32)
        np.maximum.at(mi, inv,
                      np.concatenate([self.max_int,
                                      max_int.astype(np.float32)]))
        self.max_int = mi
        self.keys = uniq

    @property
    def size(self) -> int:
        return len(self.hits)

    def export(self):
        return (self.keys.astype(np.int32), self.hits, self.misses,
                self.sum_xyz, self.max_int, self.sum_int, self.avg_cnt)


def make_store(prefer_native: bool = True):
    """The native store, built at first use (a failed build raises), or
    the numpy store when ``prefer_native`` is False."""
    if prefer_native:
        return _NativeStore(cuda_build.load("mrvm_store"))
    return _NumpyStore()
