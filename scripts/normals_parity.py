"""How far the port's leaf normals lie from the JAX package's, on the CPU,
at the scan of ``tests/test_torch_ops.py::test_kdsplit_normals_match_jax``
(seed 4), or another seed's with a share of the slots masked at random.

    python3 scripts/normals_parity.py [--leaf 8] [--method kdsplit|morton]
        [--seed 4] [--invalid 0.0]

Prints one JSON line: the leaves, how many differ from JAX by more than
1e-3 and by how much at most, and how far each package strays from a
float64 run of the port's code (largest and 99th percentile).  Needs JAX
and torch.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--leaf", type=int, default=8)
    ap.add_argument("--method", choices=("kdsplit", "morton"),
                    default="kdsplit")
    ap.add_argument("--seed", type=int, default=4)
    ap.add_argument("--invalid", type=float, default=0.0,
                    help="share of the slots masked at random")
    args = ap.parse_args()

    import jax
    if jax.config.jax_platforms != "cpu":
        jax.config.update("jax_platforms", "cpu")
        from jax.extend.backend import clear_backends
        clear_backends()

    from staticmapping_tpu.data import cloud as jcloud
    from staticmapping_tpu.io import synthetic
    from staticmapping_tpu.ops import normals as jnormals
    from staticmapping_torch import interop
    from staticmapping_torch.ops import normals as tnormals

    import jax.numpy as jnp
    import torch

    world = synthetic.make_world(seed=args.seed)
    pose = synthetic.straight_trajectory(1)[0]
    pts = synthetic.render_scan(world, pose, max_points=3500, seed=args.seed)
    jc = jcloud.from_numpy(pts, capacity=4096)
    rng = np.random.default_rng(args.seed)
    jc = dataclasses.replace(jc, mask=jnp.asarray(
        np.asarray(jc.mask) & (rng.random(4096) >= args.invalid)))
    if args.method == "kdsplit":
        jc = jc.compact()
    want = jnormals.estimate_normals(jc, leaf_size=args.leaf,
                                     method=args.method)
    pc = interop.point_cloud(jc, "cpu")
    got = tnormals.estimate_normals(pc, leaf_size=args.leaf,
                                    method=args.method)
    if args.method == "kdsplit":
        exact = tnormals.estimate_normals(
            dataclasses.replace(pc, xyz=pc.xyz.double()),
            leaf_size=args.leaf)
    else:
        # the same leaves (the f32 Morton order), solved in float64
        perm = torch.sort(tnormals.morton_keys(pc), stable=True).indices
        xyz = pc.xyz[perm].double()
        exact = tnormals._leaf_normals(xyz[:, 0], xyz[:, 1], xyz[:, 2],
                                       pc.mask[perm], args.leaf)

    m = np.asarray(want.mask)
    n_t = got.normals.numpy()[m]
    n_j = np.asarray(want.normals)[m]
    n_64 = exact.normals.numpy()[m]
    diff = np.abs(n_t - n_j).max(1)
    port_stray = np.abs(n_t - n_64).max(1)
    jax_stray = np.abs(n_j - n_64).max(1)
    print(json.dumps({
        "method": args.method, "seed": args.seed, "invalid": args.invalid,
        "leaf_size": args.leaf, "leaves": int(m.sum()),
        "over_1e-3": int(np.sum(diff > 1e-3)),
        "share_over_1e-3": float(np.mean(diff > 1e-3)),
        "max_diff": float(diff.max()),
        "port_stray_max": float(port_stray.max()),
        "jax_stray_max": float(jax_stray.max()),
        "port_stray_q99": float(np.quantile(port_stray, 0.99)),
        "jax_stray_q99": float(np.quantile(jax_stray, 0.99))}))


if __name__ == "__main__":
    main()
