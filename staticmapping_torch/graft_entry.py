"""Driver entry points of the port, the counterparts of the repository's
``__graft_entry__.py``:

``entry(device=None)``
    ``(fn, example_args)``: the forward step of the flagship kernel,
    point-to-plane ICP of one scan pair (10 trips, tile 256), on the pair
    ``example_pair`` draws.
``dryrun_multichip(n_devices, device=None)``
    one process a device over :mod:`parallel.multihost` (NCCL on CUDA,
    gloo with ``device="cpu"``) runs one sharded step in two stages:
    2·n registrations of known transforms through ``align_pairs_sharded``
    (largest translation error under 0.05 m, mean score at least 0.7, the
    sharded result within 1e-3 of one process's ``align_pairs``), then a
    64-node pose graph through the sharded PCG solve (χ² under 50).  It
    prints the summary line of the JAX package's dry run and returns its
    numbers.

    python -m staticmapping_torch.graft_entry [--device cpu] [--devices N]

runs ``entry()`` once, then ``dryrun_multichip`` over every card (or N
ranks).
"""
from __future__ import annotations

import argparse
import datetime
import os
import socket
import sys
import traceback

import numpy as np
import torch

from . import resolve_device
from .common import np_se3

# stage 1: two pairs a rank, sources and targets dense enough that the
# converged fitness clears the pipeline's acceptance threshold (0.7,
# config/lidar_only_kitti.xml:95)
PAIRS_PER_RANK = 2
CAPACITY, TARGET_CAPACITY = 8192, 2048
ALIGN_TRIPS = 30
# stage 2: a 64-node chain with loop factors, 4 Gauss-Newton trips
CHAIN_NODES = 64
SOLVE_TRIPS = 4
# the asserts of the JAX package's dry run
MAX_T_ERR_M = 0.05
MIN_MEAN_SCORE = 0.7
MAX_SHARDED_GAP = 1e-3
MAX_CHI2 = 50.0
# a collective fails after COLLECTIVE_TIMEOUT_S; the ranks' results are
# awaited RANK_WAIT_S (their start included)
COLLECTIVE_TIMEOUT_S = 120
RANK_WAIT_S = 600


def example_pair(capacity: int = 2048, target_capacity: int = 256,
                 seed: int = 0, device=None):
    """``__graft_entry__._example_pair``: a floor, two walls and a sloped
    roof drawn from ``numpy.random.default_rng(seed)``, as a source cloud
    of ``capacity`` slots and its ``capacity / target_capacity``-leaf
    normals as the target."""
    from .data import cloud as cloud_lib
    from .ops.normals import estimate_normals

    rng = np.random.default_rng(seed)
    per = capacity // 4
    floor = np.column_stack([rng.uniform(-20, 20, per),
                             rng.uniform(-20, 20, per),
                             np.full(per, -1.7)])
    w1 = np.column_stack([np.full(per, 8.0), rng.uniform(-20, 20, per),
                          rng.uniform(-1.5, 4, per)])
    w2 = np.column_stack([rng.uniform(-20, 20, per), np.full(per, -6.0),
                          rng.uniform(-1.5, 4, per)])
    x = rng.uniform(-20, 20, per)
    roof = np.column_stack([x, rng.uniform(-20, 20, per), 4 + 0.2 * x])
    pts = np.vstack([floor, w1, w2, roof]).astype(np.float32)
    source = cloud_lib.from_numpy(pts, capacity=capacity, device=device)
    target = estimate_normals(source.compact(),
                              leaf_size=capacity // target_capacity)
    return source, target


def entry(device=None):
    """Returns ``(fn, example_args)``: the ICP forward step and its
    inputs on ``device`` (the GPU unless named)."""
    from .registration.icp_fast import align_point_to_plane

    dev = resolve_device(device)
    source, target = example_pair(device=dev)
    guess = torch.eye(4, dtype=torch.float32, device=dev)

    def fn(source, target, guess):
        return align_point_to_plane(source, target, guess,
                                    max_iteration=10, tile=256)

    return fn, (source, target, guess)


def registration_inputs(n_devices: int, device):
    """Stage 1's batch: 2·n pairs, each source moved by the inverse of a
    known transform; returns ``(batch_src, batch_tgt, guesses, gt_T)``
    and the generator, whose draws stage 2 continues."""
    from .parallel.align_pairs import stack_pairs

    rng = np.random.default_rng(7)
    srcs, tgts, gt_T = [], [], []
    for i in range(PAIRS_PER_RANK * n_devices):
        s, t = example_pair(capacity=CAPACITY,
                            target_capacity=TARGET_CAPACITY, seed=i,
                            device=device)
        T = np_se3.from_rt(
            np_se3.euler_to_matrix(rng.uniform(-0.03, 0.03, 3)),
            rng.uniform(-0.3, 0.3, 3))
        srcs.append(s.transform(torch.as_tensor(
            np_se3.inverse(T), dtype=torch.float32, device=device)))
        tgts.append(t)
        gt_T.append(T)
    batch = stack_pairs(srcs, tgts, [np.eye(4)] * len(srcs))
    return batch, np.stack(gt_T), rng


def chain_graph(rng, device):
    """Stage 2's graph: 64 nodes a metre apart, odometry with N(0, 0.02)
    m of noise, a loop factor every 8 nodes back 16; returns the port's
    ``PoseGraph`` and the odometry poses."""
    from .backend.pose_graph import PoseGraph

    g = PoseGraph(device=device)
    gt = [np.eye(4)]
    for _ in range(CHAIN_NODES - 1):
        step = np.eye(4)
        step[0, 3] = 1.0
        gt.append(np_se3.normalize_rotation(gt[-1] @ step))
    for _ in range(CHAIN_NODES):
        g.add_node()
    odom = [gt[0]]
    for k in range(CHAIN_NODES - 1):
        nr = np_se3.inverse(gt[k]) @ gt[k + 1]
        nr[:3, 3] += rng.normal(0, 0.02, 3)
        g.add_between(k, k + 1, nr)
        odom.append(np_se3.normalize_rotation(odom[-1] @ nr))
    for k in range(16, CHAIN_NODES, 8):
        g.add_between(k, k - 16, np_se3.inverse(gt[k]) @ gt[k - 16],
                      sigmas=(0.05,) * 3 + (0.02,) * 3)
    return g, np.stack(odom)


def _rank(rank: int, n: int, port: int, device: str, queue) -> None:
    """One rank of the dry run (a spawned process): join the group, run
    both stages, put this rank's numbers on ``queue``."""
    try:
        from .ops import nn_search
        from .parallel import multihost
        from .parallel.align_pairs import align_pairs, align_pairs_sharded

        dev = multihost.initialize(
            f"localhost:{port}", n, rank, device=device,
            timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
        if dev.type == "cpu":           # the ranks share the host's cores
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // n))
        mesh = multihost.global_mesh(device=dev)
        nn_search.reset_launches()
        (src, tgt, guesses), gt_T, rng = registration_inputs(n, dev)
        Ts, scores, mean = align_pairs_sharded(src, tgt, guesses, mesh,
                                               max_iteration=ALIGN_TRIPS)
        Ts1, scores1 = align_pairs(src, tgt, guesses,
                                   max_iteration=ALIGN_TRIPS)
        Ts = Ts.double().cpu().numpy()
        t_errs = np.linalg.norm(Ts[:, :3, 3] - gt_T[:, :3, 3], axis=1)
        g, odom = chain_graph(rng, dev)
        poses = g.optimize(odom, num_iters=SOLVE_TRIPS, solver="pcg",
                           mesh=multihost.global_mesh("graph", device=dev))
        torch.distributed.destroy_process_group()
        queue.put({
            "rank": rank, "device": str(dev),
            "backend": "nccl" if dev.type == "cuda" else "gloo",
            "pairs": len(Ts), "t_errs_m": t_errs.tolist(),
            "max_t_err_m": float(t_errs.max()), "Ts": Ts,
            "scores": scores.cpu().numpy(), "mean_score": float(mean),
            "sharded_t_gap": float(np.abs(
                Ts1.double().cpu().numpy() - Ts).max()),
            "sharded_score_gap": float((scores1 - scores).abs().max()),
            "chi2": float(g.last_chi2), "poses_finite": bool(
                np.isfinite(poses).all()),
            "launches": dict(nn_search.launches)})
    except BaseException:
        queue.put({"rank": rank, "error": traceback.format_exc()})


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def dryrun_multichip(n_devices: int, device=None) -> dict:
    """Spawn ``n_devices`` ranks on ``device`` (every card in turn unless
    the CPU is named), run the two stages, hold them to the JAX package's
    asserts and print its summary line.  Returns rank 0's numbers."""
    import queue as queue_lib
    import torch.multiprocessing as mp

    dev = resolve_device(device)
    if dev.type == "cuda":
        from . import cuda_build
        cuda_build.build("nn_search")     # the ranks load it, never build
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_rank, args=(r, n_devices, port,
                                             dev.type, results))
             for r in range(n_devices)]
    try:
        for p in procs:
            p.start()
        ranks = [results.get(timeout=RANK_WAIT_S) for _ in procs]
        for p in procs:
            p.join(timeout=COLLECTIVE_TIMEOUT_S)
    except queue_lib.Empty:
        raise RuntimeError(f"dryrun_multichip: a rank gave no result "
                           f"within {RANK_WAIT_S} s") from None
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    ranks.sort(key=lambda r: r["rank"])
    for r in ranks:
        if "error" in r:
            raise RuntimeError(f"dryrun_multichip rank {r['rank']} "
                               f"failed:\n{r['error']}")
    out = ranks[0]
    for r in ranks[1:]:
        for key in ("Ts", "scores"):
            if not np.array_equal(r[key], out[key]):
                raise AssertionError(f"rank {r['rank']}'s {key} differ "
                                     "from rank 0's")
    if not out["max_t_err_m"] < MAX_T_ERR_M:
        raise AssertionError(f"transform recovery failed: "
                             f"{out['t_errs_m']}")
    if not out["mean_score"] >= MIN_MEAN_SCORE:
        raise AssertionError(f"mean score {out['mean_score']}")
    if not (out["sharded_t_gap"] < MAX_SHARDED_GAP
            and out["sharded_score_gap"] < MAX_SHARDED_GAP):
        raise AssertionError(f"sharded against single: T "
                             f"{out['sharded_t_gap']}, score "
                             f"{out['sharded_score_gap']}")
    if not (out["poses_finite"] and out["chi2"] < MAX_CHI2):
        raise AssertionError(f"sharded pose-graph solve chi2 {out['chi2']}")
    print(f"dryrun_multichip({n_devices}): OK — {out['pairs']} sharded "
          f"registrations (max T err {out['max_t_err_m']:.4f} m, mean "
          f"score {out['mean_score']:.3f} >= {MIN_MEAN_SCORE} accept "
          f"threshold, sharded==single diff {out['sharded_t_gap']:.2e}), "
          f"sharded pose-graph solve chi2 {out['chi2']:.2f}", flush=True)
    return {**out, "ranks": len(ranks)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m staticmapping_torch."
                                     "graft_entry")
    p.add_argument("--device", default=None, choices=["cuda", "cpu"],
                   help="the GPU unless cpu is named")
    p.add_argument("--devices", type=int, default=None,
                   help="ranks of the dry run (default: every card; "
                        "2 on the CPU)")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    fn, example = entry(dev)
    T, score = fn(*example)
    print(f"entry OK: T {tuple(T.shape)}, score {float(score):.4f}",
          flush=True)
    n = args.devices or (torch.cuda.device_count() if dev.type == "cuda"
                         else 2)
    dryrun_multichip(n, dev)
    return 0


if __name__ == "__main__":
    from staticmapping_torch.graft_entry import main as _main
    sys.exit(_main())
