"""The output check's control: the reference put in the program's place,
computed with TF32 matrix products (the next precision below the
configuration's float32 without TF32), at the cell's own sizes.

    python3 -m mapbench.control --workload <name> --seeds 1 2 3 \
        [--seconds <s>]

For each seed it draws the cell's drive, samples the window's scans and
submaps as a run's check does (the window's size from ``--seconds``; the
start of each step from the drive's true poses, as the program is not
run), and prints, as one JSON line a seed, the numbers the check compares
for the control's answers, beside the cell's limits: the core check's,
and those of each of the cell's own checks that gives a ``control``
(``check.py``).  The benchmark's runs do not run it.
"""
from __future__ import annotations

import argparse
import json
import sys


def control_numbers(bench: dict, workload: str, seed: int, seconds: float,
                    device, root) -> dict:
    """The check's numbers for the control's answers on the cell's drive
    from ``seed``: the scans and submaps a window of ``seconds`` samples,
    each step started from the drive's true poses."""
    from mapbench import check, drive, generator, manifest

    parts = manifest.cell(bench, workload, root)
    config, traffic, cell = parts["config"], parts["traffic"], parts["cell"]
    s = config["settings"]
    chunk = s["map_builder.pipeline_chunk"]
    warm = traffic["warmup_scans"]
    n_window = drive.window_scans(cell, config, seconds)
    poses, scans = generator.render_drive(
        traffic, config["points_per_scan"],
        s["map_builder.front_end.scan_capacity"], warm + n_window, seed,
        device)
    # what a run would have harvested: all but the last two chunks
    frames = {k: poses[k] for k in range(warm + n_window - 2 * chunk)}
    pending = 2 * s["map_builder.pair_match_batch"] + 1
    starts = range(0, len(frames) - 1, 2)
    submaps = [([k, k + 1], None if i >= len(starts) - pending else True,
                None) for i, k in enumerate(starts)]
    fe, pm, _, _ = check.sample_items(seed, (warm, warm + n_window), frames,
                                      submaps, 2 * chunk, pending, cell)
    numbers = check.gaps(scans, frames, submaps, fe, pm, config["reference"],
                         device, control=True)
    own = {name: m for name, m in manifest.checks(cell, root).items()
           if hasattr(m, "control")}
    if own:
        run = check.run_of(scans, {"frames": frames, "submaps": submaps},
                           (warm, warm + n_window), 2 * chunk, pending,
                           config, cell, seed, device)
        with check.full_float32():
            numbers = check.merge({"check.py": numbers, **{
                f"checks/{name}": m.control(run)
                for name, m in own.items()}})
    return {"workload": workload, "seed": seed, "numbers": numbers,
            "limits": cell["limits"], "frontend_items": fe,
            "pair_items": pm}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=None)
    args = p.parse_args(argv)
    import torch
    from mapbench import manifest
    if not torch.cuda.is_available():
        print("mapbench.control: no CUDA device", file=sys.stderr)
        return 2
    bench = manifest.load()
    seconds = args.seconds or bench["run_seconds"]
    for seed in args.seeds:
        print(json.dumps(control_numbers(bench, args.workload, seed, seconds,
                                         "cuda", manifest.ROOT)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
