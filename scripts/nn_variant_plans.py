"""Times the NN-variant CUDA kernels (K3, K4) of one or more checkouts under
several launch plans, on one GPU.

    python3 scripts/nn_variant_plans.py FORMS ROOT [ROOT ...]

FORMS is a comma-separated subset of ``packed,aug_packed,aug``.  For each
ROOT in the order given, a fresh Python process imports ROOT's
``staticmapping_torch.ops.nn_variants``, builds its kernel, and at the
variant bench's 16384 x 2048 (seeded inputs, as in chip_smoke.py) runs each
form under each (R, block, S) of PLANS: it checks that the plan gives the
S = 1 plan's d and index bit for bit, then times the whole call by
CUDA-graph replay (``ms``) and splits it into its kernels with
``torch.profiler`` (``kernels_us``).  The K1 kernel at the same shape is
timed too.  One JSON line per ROOT.  To compare checkouts, name them in
turns (``A B B A``) in one run on one card.  GPU only; imports no JAX.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from nn_kernel_times import graph_ms, kernels_us  # noqa: E402

# (R, block, S) of the plans timed; every one exists in the kernel
PLANS = [(2, 256, 1), (2, 256, 2), (2, 256, 4), (2, 256, 8), (2, 128, 4),
         (2, 128, 8), (4, 128, 4), (4, 128, 8), (4, 64, 8)]
SHAPE = (16384, 2048)


def child(forms, root: str) -> dict:
    sys.path.insert(0, root)
    import numpy as np
    import torch
    from staticmapping_torch.ops import nn_search as ns
    from staticmapping_torch.ops import nn_variants as nv
    dev = torch.device("cuda")
    m, n = SHAPE
    rng = np.random.default_rng(2)
    q = torch.from_numpy(rng.uniform(-30, 30, (m, 3))
                         .astype(np.float32)).to(dev)
    t = torch.from_numpy(rng.uniform(-30, 30, (n, 3))
                         .astype(np.float32)).to(dev)
    qa, ta = nv.aug_q(q), nv.aug_t(t)
    operands = {"packed": (nv.pad8(q), nv.pad8(t)), "aug_packed": (qa, ta),
                "aug": (qa, ta)}
    out = {"root": root,
           "k1_ms": graph_ms(lambda: ns._nearest_cuda(q, t), 50)}
    for form in forms:
        a, b = operands[form]
        d0, i0 = nv._cuda(form, a, b, nv.AUG_IDX_BITS,
                          nv.plan(m, n, splits=1))
        for r, block, splits in PLANS:
            p = nv.plan(m, n, r, block, splits)
            call = lambda p=p: nv._cuda(form, a, b, nv.AUG_IDX_BITS, p)
            d, i = call()
            if not (torch.equal(d, d0) and torch.equal(i, i0)):
                raise AssertionError(f"{form}: plan {p} differs from S = 1")
            out[f"{form} r={r} block={block} S={splits}"] = {
                "ms": graph_ms(call, 50), "kernels_us": kernels_us(call, 20)}
    return out


def main(argv) -> int:
    if argv[:1] == ["--child"]:
        print(json.dumps(child(argv[1].split(","),
                               os.path.abspath(argv[2]))), flush=True)
        return 0
    forms, roots = argv[0], argv[1:]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(json.dumps({"nvidia_smi": smi}), flush=True)
    for root in roots:
        subprocess.run([sys.executable, os.path.abspath(__file__), "--child",
                        forms, root], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
