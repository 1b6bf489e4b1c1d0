"""Run the back-end path's final pose-graph solve and one of its loop
verifications three times on the card, compare the runs bit for bit, and
list the ops of those runs whose float sums depend on the order the card
runs them in.

    python3 scripts/backend_repeat.py [ROOT ...]

For each ROOT (a checkout of the port; this one by default), in turns, a
fresh process imports that checkout's ``staticmapping_torch``, builds its
kernels and runs the back-end path (``scripts/main_path.py::BACKEND_PATH``
through the CLI's entry point, as ``chip_smoke.py``'s ``backend`` phase
does), keeping the inputs of its last pose-graph solve and the candidate
pairs of its last loop verification.  It then runs, three times each: the
final solve with the dense and with the PCG solver, the loop verification
(``LoopDetector._close_loops``: the batched verifier on K2, then the GICP
gate on K1), and the PCG solve of ``chip_smoke.py``'s 4096-node circuit
(its ``multidevice`` phase's one-process solve).  It prints one JSON line
a ROOT: each run's seconds (the third run, untraced), whether the later
runs equal the first bit for bit and the largest gap if not; the census
of the first two runs' aten ops that sum with atomics on the card
(``index_add_``, ``index_put_`` with ``accumulate``, ``scatter_add_``,
``scatter_reduce`` with a sum, ``put_`` with ``accumulate``, ``bincount``
with weights, ``histc``, ``index_reduce``), with their dtypes and call
counts; and the warnings ``torch.use_deterministic_algorithms(True,
warn_only=True)`` gives over one more run of each, which name the ops that
have no order-fixed form.  Only this script sets that mode.  It needs a
GPU; to compare two checkouts, unpack the parent with ``git archive`` into
a directory ``.gitignore`` lists and name both in turns (``parent . .
parent``).
"""
from __future__ import annotations

import argparse
import collections
import json
import os
import subprocess
import sys
import time
import warnings

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# aten ops that sum (or count) into an output with atomics on the card
_ATOMIC = {"index_add", "index_add_", "index_put", "index_put_",
           "_index_put_impl_", "scatter_add", "scatter_add_",
           "scatter_reduce", "scatter_reduce_", "put", "put_", "bincount",
           "histc", "index_reduce", "index_reduce_"}


def _census_key(name, args, kwargs):
    """``(op, dtype, detail, order_dependent)`` of one atomic op call."""
    import torch
    dtype = args[0].dtype if torch.is_tensor(args[0]) else None
    detail = ""
    if name in ("index_put", "index_put_", "_index_put_impl_", "put",
                "put_"):
        acc = kwargs.get("accumulate", args[3] if len(args) > 3
                         else (args[2] if name.startswith("put")
                               and len(args) > 2 else False))
        detail = f"accumulate={bool(acc)}"
        summing = bool(acc)
    elif name.startswith("scatter_reduce") or name.startswith(
            "index_reduce"):
        detail = str(kwargs.get("reduce", args[4] if len(args) > 4
                                else args[3]))
        summing = detail in ("sum", "mean", "prod")
    elif name == "bincount":
        weights = kwargs.get("weights", args[1] if len(args) > 1 else None)
        dtype = weights.dtype if weights is not None else dtype
        detail = "weights" if weights is not None else "counts"
        summing = weights is not None
    else:
        summing = True
    order_dependent = bool(summing and dtype is not None
                           and dtype.is_floating_point)
    return (name, str(dtype).replace("torch.", ""), detail, order_dependent)


def _census():
    """A dispatch mode that counts the atomic ops run under it."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Census(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = collections.Counter()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            name = func.overloadpacket.__name__
            if name in _ATOMIC:
                self.ops[_census_key(name, args, kwargs)] += 1
            return func(*args, **kwargs)
    return Census()


def _equal(a, b):
    """(bit for bit, largest gap) of two nested results: tensors, arrays,
    numbers and sequences of them."""
    import numpy as np
    import torch
    if torch.is_tensor(a) or isinstance(a, (np.ndarray, np.number, int,
                                            float)):
        a, b = (np.asarray(x.cpu() if torch.is_tensor(x) else x)
                for x in (a, b))
        same = a.shape == b.shape and a.tobytes() == b.tobytes()
        gap = 0.0 if same or a.shape != b.shape else float(
            np.abs(a.astype(np.float64) - b.astype(np.float64)).max())
        return same, gap
    if len(a) != len(b):
        return False, float("inf")
    same, gap = True, 0.0
    for x, y in zip(a, b):
        s, g = _equal(x, y)
        same, gap = same and s, max(gap, g)
    return same, gap


def one(root: str, device: str) -> dict:
    """The back-end path and the repeats in this process, on ``root``'s
    port."""
    sys.path.insert(0, os.path.abspath(root))
    import numpy as np
    import torch

    from scripts.main_path import BACKEND_PATH
    from staticmapping_torch import __main__ as cli
    from staticmapping_torch import cuda_build
    from staticmapping_torch.backend import loop_detector as ld
    from staticmapping_torch.backend import pose_graph as pg
    from staticmapping_torch.backend import pose_graph_sparse as pgs

    dev = torch.device(device)
    if dev.type == "cuda":
        cuda_build.build("nn_search", "mrvm_store")
    B = BACKEND_PATH
    out = os.path.join(HERE, "chiprun_out", "backend_repeat")
    args = cli.make_parser().parse_args(
        ["--synthetic", B["trajectory"], "--scans", str(B["n_scans"]),
         "--out", out, "--device", device, "--quiet"]
        + (["--pipelined", "--chunk", str(B["chunk"])] if B["pipelined"]
           else []))

    last = {}
    close_loops, optimize = ld.LoopDetector._close_loops, pg.PoseGraph.optimize

    def rec_close(self, pairs):
        last["verify"] = (self, list(pairs))
        return close_loops(self, pairs)

    def rec_optimize(self, poses_np, num_iters=8, **kw):
        last["solve"] = (self, np.array(poses_np), num_iters,
                         [np.array(v) for v in self.special_values])
        return optimize(self, poses_np, num_iters=num_iters, **kw)
    ld.LoopDetector._close_loops = rec_close
    pg.PoseGraph.optimize = rec_optimize
    t0 = time.perf_counter()
    try:
        cli.run(args)
    finally:
        ld.LoopDetector._close_loops = close_loops
        pg.PoseGraph.optimize = optimize
    path_s = time.perf_counter() - t0

    g, poses, num_iters, special = last["solve"]
    g.special_values = special
    solver_args, ncap, _ = g.solver_args(poses)
    detector, pairs = last["verify"]
    pair_results = []
    align = ld.align_pair_list

    def rec_align(*a, **k):
        pair_results.append(align(*a, **k))
        return pair_results[-1]

    def verify():
        pair_results.clear()
        ld.align_pair_list = rec_align
        try:
            edges = detector._close_loops(pairs)
        finally:
            ld.align_pair_list = align
        return (pair_results[0],
                [(e.target_index, e.source_index,
                  torch.as_tensor(e.transform), torch.tensor(e.score))
                 for e in edges])

    # chip_smoke.py's multidevice phase's one-process solve: the 4096-node
    # circuit, 5 GN trips
    from chip_smoke import MD_CIRCUIT, MD_GN_TRIPS, square_circuit
    circuit, odom = square_circuit(dev, **MD_CIRCUIT)
    circuit_args, _, _ = circuit.solver_args(odom)
    runs = {"dense": lambda: pg.gauss_newton(*solver_args,
                                             num_iters=num_iters),
            "pcg": lambda: pgs.gauss_newton_pcg(*solver_args,
                                                num_iters=num_iters),
            "loop_verification": verify,
            "pcg_circuit": lambda: pgs.gauss_newton_pcg(
                *circuit_args, num_iters=MD_GN_TRIPS)}

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    res = {"root": root, "device": (torch.cuda.get_device_name(dev)
                                     if dev.type == "cuda" else "cpu"),
           "torch": torch.__version__, "path_s": path_s,
           "final_graph": {"nodes": g.num_nodes, "padded_nodes": ncap,
                           "factors": len(g.factors),
                           "num_iters": num_iters},
           "circuit": {"nodes": MD_CIRCUIT["n"],
                       "factors": len(circuit.factors),
                       "num_iters": MD_GN_TRIPS},
           "verification_pairs": pairs, "runs": {}}
    for name, fn in runs.items():
        outs, secs = [], []
        census = _census()
        for _ in range(2):
            sync()
            t = time.perf_counter()
            with census:
                outs.append(fn())
            sync()
            secs.append(time.perf_counter() - t)
        # the same run untraced, for its time alone
        sync()
        t = time.perf_counter()
        outs.append(fn())
        sync()
        plain_s = time.perf_counter() - t
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.use_deterministic_algorithms(True, warn_only=True)
            try:
                fn()
                sync()
            finally:
                torch.use_deterministic_algorithms(False)
        same, gap = _equal(outs[:1] * 2, outs[1:])
        res["runs"][name] = {
            "bit_for_bit": same, "max_gap": gap, "seconds": plain_s,
            "census_seconds": secs,
            "atomic_ops": [{"op": k[0], "dtype": k[1], "detail": k[2],
                            "order_dependent": k[3], "calls": n // 2}
                           for k, n in sorted(census.ops.items())],
            "deterministic_mode_warnings": sorted(
                {str(w.message).splitlines()[0] for w in caught})}
    return res


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("roots", nargs="*", default=["."])
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--one", default=None, help=argparse.SUPPRESS)
    args = p.parse_args()
    if args.one is not None:
        print(json.dumps(one(args.one, args.device)), flush=True)
        return
    if args.device == "cuda":
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            check=True, capture_output=True, text=True).stdout.strip()
        print(smi.splitlines()[0], flush=True)
    for root in args.roots:
        subprocess.run([sys.executable, os.path.abspath(__file__), "--one",
                        root, "--device", args.device], check=True,
                       cwd=HERE)


if __name__ == "__main__":
    main()
