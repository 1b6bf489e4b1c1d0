"""How far the port's NDT voxel Gaussians lie from the JAX package's, on the
CPU, on one full-range synthetic scan: the raw f32 second moment minus
mean² of ``ops/voxel.py::voxel_stats`` is summed in another order by
``index_add_`` than by ``segment_sum``, and its rounding grows with the
coordinates².

    python3 scripts/ndt_parity.py [--max-range 70]

Builds ``build_ndt_map`` (1 m voxels, at least 4 points) of the main
path's first scan (``scripts/main_path.py::MAIN_PATH``'s world, 30000
points) in both packages, and a float64 run of the port's code, and prints
one JSON line: whether the keys and validity match, the valid voxels, and
per voxel the largest covariance gap between the packages and from
float64 (largest, 99th percentile and median, in m²), beside the median
of the thinnest axis's variance, and the regularized inverse's gap
relative to its largest entry.  Needs JAX and torch.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def _stats(gap: np.ndarray) -> dict:
    return {"max": float(gap.max()), "p99": float(np.percentile(gap, 99)),
            "median": float(np.median(gap))}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--max-range", type=float, default=70.0)
    args = ap.parse_args()

    import jax
    if jax.config.jax_platforms != "cpu":
        jax.config.update("jax_platforms", "cpu")
        from jax.extend.backend import clear_backends
        clear_backends()
    import torch

    from scripts.main_path import MAIN_PATH
    from staticmapping_tpu.data import cloud as jcloud
    from staticmapping_tpu.io import synthetic
    from staticmapping_tpu.ops import voxel as jvoxel
    from staticmapping_tpu.registration import ndt as jndt
    from staticmapping_torch import interop
    from staticmapping_torch.ops import voxel as tvoxel
    from staticmapping_torch.registration import ndt as tndt

    P = MAIN_PATH
    scans, _ = synthetic.make_sequence(
        n_scans=1, seed=P["seed"], trajectory=P["trajectory"],
        step=P["step"], max_points=P["max_points"],
        max_range=args.max_range)
    jc = jcloud.from_numpy(scans[0], capacity=P["scan_capacity"])
    tc = interop.point_cloud(jc, "cpu")
    m_j = jndt.build_ndt_map(jc, 1.0)
    m_t = tndt.build_ndt_map(tc, 1.0)
    valid = np.asarray(m_j.valid)

    # the per-voxel covariances, slot for slot (the same sort, the same
    # segments), and a float64 run of the port's code
    origin = np.array(m_j.origin)
    cov_j = np.asarray(jvoxel.voxel_stats_floor(jc, 1.0, origin)["cov"])
    cov_t = tvoxel.voxel_stats_floor(tc, 1.0, torch.from_numpy(origin)
                                     )["cov"].numpy()
    tc64 = tc.__class__(tc.xyz.double(), tc.intensity, tc.factor, tc.mask)
    cov_64 = tvoxel.voxel_stats_floor(
        tc64, torch.tensor(1.0, dtype=torch.float64),
        torch.from_numpy(origin.astype(np.float64)))["cov"].numpy()
    stats = tvoxel.voxel_stats_floor(tc, 1.0, torch.from_numpy(origin))
    keep = (stats["count"].numpy() >= 4)
    thin = np.linalg.eigvalsh(cov_64[keep])[:, 0]
    gap_pkg = np.abs(cov_t - cov_j)[keep].max(axis=(1, 2))
    gap_j64 = np.abs(cov_j - cov_64)[keep].max(axis=(1, 2))
    gap_t64 = np.abs(cov_t - cov_64)[keep].max(axis=(1, 2))
    inv_j = np.asarray(m_j.inv_cov)[valid]
    inv_gap = (np.abs(m_t.inv_cov.numpy()[valid] - inv_j).max(axis=(1, 2))
               / np.abs(inv_j).max(axis=(1, 2)))
    print(json.dumps({
        "points": int(np.asarray(jc.mask).sum()),
        "max_range_m": args.max_range,
        "keys_equal": bool(np.array_equal(m_t.key.numpy(),
                                          np.asarray(m_j.key))),
        "valid_equal": bool(np.array_equal(m_t.valid.numpy(), valid)),
        "valid_voxels": int(valid.sum()),
        "voxels_4plus": int(keep.sum()),
        "cov_gap_packages_m2": _stats(gap_pkg),
        "cov_gap_jax_f64_m2": _stats(gap_j64),
        "cov_gap_torch_f64_m2": _stats(gap_t64),
        "thin_axis_variance_median_m2": float(np.median(thin)),
        "inv_cov_gap_relative": _stats(inv_gap)}))


if __name__ == "__main__":
    main()
