"""The loop verifier's false-accept experiment through the port: the
port's side of ``tools/experiment_verifier.py``, with its protocol.

True pairs are two clouds rendered within 4 m and 20° of each other in the
synthetic world (seed 7), presented with a drifted guess (up to 3 m and
0.1 rad off); false pairs are rendered 75 m apart, presented with the
identity.  Every pair is scored by three verifiers:
- ``icp_pm``: point-to-plane ICP (``registration/icp_fast.py``, 60 trips)
  onto the target's leaf-8 normals (``builder/frontend.py::
  _target_normals``), the density-normalised fitness; accepted above 0.75;
- ``ndt``: ``registration/ndt.py`` (1 m voxels, 35 trips);
- ``gicp``: the loop detector's independent gate (``registration/gicp.py``):
  4×-thinned clouds, k=20 normals, 8 trips at the guess, a 2 m
  correspondence gate, the spacing-normalised fitness.
NDT and GICP are accepted above 0.85 × their median true score.  The
output has the JAX tool's keys.

    python3 scripts/torch_experiment_verifier.py [--device cpu]
        [--pairs 12] [--capacity 16384] [--max-points 15000]

``pairs`` and ``score_pair`` are the tool's protocol at module level, the
size as arguments.  It needs torch, not JAX; the GPU unless ``--device
cpu``.
"""
from __future__ import annotations

import argparse
import functools
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

ACCEPT = 0.75
SPACING_REF = 0.35
CAPACITY = 16384
LEAF = 8
MAX_POINTS = 15000
MAX_RANGE = 60.0
N_PAIRS = 12
SEED = 42
VERIFIERS = ("icp_pm", "ndt", "gicp")
VERIFIER_RESULTS = os.path.join("tools", "experiment_verifier_results.json")


@functools.lru_cache(maxsize=1)
def _world():
    from staticmapping_torch.io import synthetic
    return synthetic.make_world(seed=7)


def _points_at(world_pose, seed, max_points, max_range):
    from staticmapping_torch.io import synthetic
    return synthetic.render_scan(_world(), world_pose, seed=seed,
                                 max_points=max_points, max_range=max_range)


def _pose(x, y, yaw):
    from staticmapping_torch.common import np_se3
    T = np.eye(4)
    T[:3, :3] = np_se3.euler_to_matrix(np.array([0.0, 0.0, yaw]))
    T[:3, 3] = (x, y, 1.8)
    return T


def pairs(rng, n, far, max_points=MAX_POINTS, max_range=MAX_RANGE):
    """``n`` pairs ``(source points, target points, guess f32, T_true or
    None)`` drawn from ``rng`` as the tool draws them: true pairs within
    4 m and 0.35 rad with a drifted guess, false pairs (``far``) 75 m
    apart with the identity.  The points are host arrays."""
    out = []
    for k in range(n):
        x, y = rng.uniform(-30, 30, 2)
        yaw = rng.uniform(-np.pi, np.pi)
        A = _pose(x, y, yaw)
        if far:
            ang = rng.uniform(0, 2 * np.pi)
            B = _pose(x + 75 * np.cos(ang), y + 75 * np.sin(ang),
                      rng.uniform(-np.pi, np.pi))
        else:
            B = _pose(x + rng.uniform(-4, 4), y + rng.uniform(-4, 4),
                      yaw + rng.uniform(-0.35, 0.35))
        src = _points_at(B, 100 + 2 * k, max_points, max_range)
        tgt = _points_at(A, 101 + 2 * k, max_points, max_range)
        T_true = np.linalg.solve(A, B)
        # the detector's drifted guess, z zeroed as the loop detector does
        drift = _pose(rng.uniform(-3, 3), rng.uniform(-3, 3),
                      rng.uniform(-0.1, 0.1))
        drift[:3, 3][2] = 0.0
        guess = T_true @ drift if not far else np.eye(4)
        out.append((src, tgt, guess.astype(np.float32),
                    None if far else T_true))
    return out


def cloud(points, capacity=CAPACITY, device=None):
    """A pair's points as the port's padded cloud."""
    from staticmapping_torch.data import cloud as cloud_lib
    return cloud_lib.from_numpy(points, capacity=capacity, device=device)


def verify_icp_pm(src, tgt_nc, guess):
    from staticmapping_torch.registration.icp_fast import (
        align_point_to_plane)
    T, s = align_point_to_plane(src, tgt_nc, guess, max_iteration=60,
                                score_spacing_ref=SPACING_REF)
    return T.double().cpu().numpy(), float(s)


def verify_ndt(src, tgt, guess, ndt_map=None, max_iteration=35):
    """NDT from ``guess`` onto the target's 1 m field (``ndt_map``, when
    given, instead of the one built from ``tgt``)."""
    from staticmapping_torch.registration.ndt import align_ndt, build_ndt_map
    m = (build_ndt_map(tgt.compact(), 1.0, min_points=4) if ndt_map is None
         else ndt_map)
    T, s = align_ndt(src, m, guess, max_iteration=max_iteration)
    return T.double().cpu().numpy(), float(s)


def verify_gicp(src_g, tgt_g, guess):
    """The loop detector's gate scoring (``LoopDetector._independent_gate``):
    8 trips at the guess, a 2 m correspondence gate, the fitness raised to
    ``SPACING_REF / spacing``."""
    import torch
    from staticmapping_torch.registration.gicp import align_gicp
    from staticmapping_torch.registration.icp_fast import target_spacing
    T, s = align_gicp(src_g, tgt_g, guess, max_iteration=8,
                      max_correspondence_dist=2.0)
    sp = torch.clamp_min(target_spacing(tgt_g), 1e-3)
    return T.double().cpu().numpy(), float(s ** (SPACING_REF / sp))


def score_pair(name, src, tgt, guess, leaf=LEAF):
    """``(T, score)`` of verifier ``name`` on the port's clouds ``src`` and
    ``tgt`` from ``guess`` (a host 4×4)."""
    import torch
    from staticmapping_torch.builder.frontend import _target_normals
    from staticmapping_torch.registration.gicp import compute_point_normals
    guess = torch.as_tensor(guess, dtype=torch.float32, device=src.device)
    if name == "icp_pm":
        return verify_icp_pm(src, _target_normals(tgt, leaf), guess)
    if name == "ndt":
        return verify_ndt(src, tgt, guess)
    if name == "gicp":
        def thin(c):
            return c.slots(slice(None, None, 4))
        return verify_gicp(compute_point_normals(thin(src), k=20),
                           compute_point_normals(thin(tgt), k=20), guess)
    raise ValueError(f"unknown verifier {name!r}")


def run(device=None, n_pairs=N_PAIRS, capacity=CAPACITY,
        max_points=MAX_POINTS, sync=lambda: None) -> dict:
    """The experiment: the tool's JSON per verifier, plus every score and
    the seconds each verifier took over the 2·``n_pairs`` pairs."""
    rng = np.random.default_rng(SEED)
    true_pairs = pairs(rng, n_pairs, far=False, max_points=max_points)
    false_pairs = pairs(rng, n_pairs, far=True, max_points=max_points)

    def clouds(ps):
        return [(cloud(s, capacity, device), cloud(t, capacity, device), g,
                 T) for s, t, g, T in ps]
    true_pairs, false_pairs = clouds(true_pairs), clouds(false_pairs)
    results, scores, seconds = {}, {}, {}
    for name in VERIFIERS:
        sync()
        t0 = time.perf_counter()
        trues = [score_pair(name, s, t, g) + (Tt,)
                 for s, t, g, Tt in true_pairs]
        falses = [score_pair(name, s, t, g)[1] for s, t, g, _ in false_pairs]
        sync()
        seconds[name] = time.perf_counter() - t0
        # NDT and GICP scores follow their own laws: each family's
        # threshold is 0.85 x its median true score, as the tool sets it
        thr = ACCEPT if name == "icp_pm" else \
            0.85 * float(np.median([s for _, s, _ in trues]))
        ta = sum(1 for _, s, _ in trues if s > thr)
        fa = sum(1 for s in falses if s > thr)
        pose_err = [float(np.linalg.norm(np.linalg.solve(Tt, T)[:3, 3]))
                    for T, s, Tt in trues if s > thr]
        results[name] = {
            "threshold": round(thr, 3),
            "true_accept": f"{ta}/{len(true_pairs)}",
            "false_accept": f"{fa}/{len(false_pairs)}",
            "max_false_score": round(max(falses), 3),
            "min_true_score": round(min(s for _, s, _ in trues), 3),
            "accepted_pose_err_mean_m": round(float(np.mean(pose_err)), 3)
            if pose_err else None,
        }
        scores[name] = {"threshold": thr,
                        "true": [s for _, s, _ in trues], "false": falses}
    return {"results": results, "scores": scores, "seconds": seconds}


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--pairs", type=int, default=N_PAIRS)
    p.add_argument("--capacity", type=int, default=CAPACITY)
    p.add_argument("--max-points", type=int, default=MAX_POINTS)
    args = p.parse_args()
    import torch
    sync = (torch.cuda.synchronize if args.device == "cuda"
            else (lambda: None))
    out = run(args.device, args.pairs, args.capacity, args.max_points, sync)
    for name, row in out["results"].items():
        print(f"[exp] {name}: {row} ({out['seconds'][name]:.2f} s)",
              file=sys.stderr, flush=True)
    print(json.dumps(out["results"], indent=1))


if __name__ == "__main__":
    main()
