"""One run of one cell: set-up, the measured window, the readers and the
output check.

The program under test is ``staticmapping_torch``: its XML loader and
``build_map_builder`` make the builder, and the window drives nothing but
``MapBuilder.insert_pointcloud``, closed loop, as fast as the builder
takes the scans.  The window opens and closes right after a scan that
completes a chunk, with the device synchronised, once the warm-up has run
every shape the window uses; both ends then find the pipeline in the same
state (one chunk staged, one run and awaiting harvest, one pair-match
batch in flight), so the window holds the work of exactly its scans.
``finish()``, the static-map export, making the inputs and file I/O all
stay out of it.
"""
from __future__ import annotations

import gc
import importlib
import math
import os
import time

import numpy as np
import torch

from . import check, generator, manifest, trace

HERE = os.path.dirname(os.path.abspath(__file__))
PROGRAM = "staticmapping_torch"
# chunks of the window under the device trace: enough for a steady
# reading, few enough that the profiler keeps every event and its buffers
# are read back in well under a minute
TRACE_CHUNKS = 8


class Context:
    """What the readers read: the window's size and times, the program's
    ``prof`` blocks over the window, the benchmark's own spans around each
    ``insert_pointcloud`` call, and the reduced device trace of the
    window's first ``trace_scans`` scans."""

    def __init__(self):
        self.window_scans = 0
        self.window_submaps = 0
        self.window_s = None
        self.setup_s = None
        self.peak_bytes = None
        self.prof = {}
        self.feed_s = []
        self.trace = None
        self.trace_scans = 0
        self.trace_stop_s = None
        self.trace_read_s = None

    @staticmethod
    def program(module: str):
        """A module of the program, by its name inside the package."""
        return importlib.import_module(f"{PROGRAM}.{module}")


def build_builder(config: dict, device):
    """The builder ``build_map_builder`` makes from the configuration's
    XML with its ``settings`` put on the loaded config (dotted attribute
    paths)."""
    config_lib = importlib.import_module(f"{PROGRAM}.config")
    cfg = config_lib.load_config(os.path.join(HERE, "configs",
                                              config["xml"]))
    for dotted, value in config["settings"].items():
        *parents, leaf = dotted.split(".")
        obj = cfg
        for p in parents:
            obj = getattr(obj, p)
        if not hasattr(obj, leaf):
            raise AttributeError(f"the program's config has no {dotted}")
        setattr(obj, leaf, value)
    return config_lib.build_map_builder(cfg, with_backend=config["backend"],
                                        device=device)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def window_scans(cell: dict, config: dict, seconds: float) -> int:
    """Scans in the window: ``seconds`` at the cell's nominal rate, in
    whole chunks, at least one."""
    chunk = config["settings"]["map_builder.pipeline_chunk"]
    return chunk * max(1, math.ceil(seconds * cell["window_scans_per_s"]
                                    / chunk))


def program_outputs(mb, period: float) -> dict:
    """The MapBuilder's outputs as host data: each keyframe's pose by scan
    index, and each submap's scans, matched transform to the next and
    match score to the previous."""
    frames, submaps = {}, []
    for s in mb.trajectory:
        idx = [int(round(f.stamp / period)) for f in s.frames]
        for k, f in zip(idx, s.frames):
            frames[k] = np.asarray(f.global_pose, dtype=np.float64)
        T = s.match_transform_to_next
        submaps.append((idx, None if T is None
                        else np.asarray(T, dtype=np.float64),
                        float(s.match_score_to_previous)))
    return {"frames": frames, "submaps": submaps}


def run_cell(bench: dict, workload: str, seed: int, seconds: float,
             traced: bool, device, t_start: float,
             root: str = manifest.ROOT) -> dict:
    """Run the cell once and return the result line's fields (without the
    platform checks of ``run.py``).  ``t_start`` is the process's start on
    ``time.perf_counter``'s clock."""
    parts = manifest.cell(bench, workload, root)
    config, traffic, cell = parts["config"], parts["traffic"], parts["cell"]
    own = manifest.checks(cell, root)
    chunk = config["settings"]["map_builder.pipeline_chunk"]
    warm = traffic["warmup_scans"]
    if (warm - 1) % chunk:
        raise ValueError(f"warmup_scans {warm} must be 1 + whole chunks "
                         f"of {chunk}")
    n_window = window_scans(cell, config, seconds)
    period = traffic["scan_period_s"]
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()

    _, scans = generator.render_drive(
        traffic, config["points_per_scan"],
        config["settings"]["map_builder.front_end.scan_capacity"],
        warm + n_window, seed, device)
    mb = build_builder(config, device)
    prof = importlib.import_module(f"{PROGRAM}.common.prof")
    ctx = Context()
    readers = ({m["name"]: manifest.reader(m["name"])
                for m in manifest.metrics_of(bench, workload, "per_layer")}
               if traced else {})

    for i in range(warm):
        mb.insert_pointcloud(i * period, scans[i])
    _sync(device)
    gc.collect()
    for r in readers.values():
        if hasattr(r, "at_open"):
            r.at_open(ctx)
    profiler = None
    traced_device = traced and cuda
    if traced:
        prof.reset()
        prof.enable(report_at_exit=False)
    if traced_device:
        profiler = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA])
        profiler.start()
        trace.mark()
    submaps0 = len(mb.trajectory)
    # the device trace covers the window's first TRACE_CHUNKS chunks
    trace_end = warm + min(n_window, TRACE_CHUNKS * chunk)
    t_open = time.perf_counter()
    if traced:
        for i in range(warm, warm + n_window):
            t = time.perf_counter()
            mb.insert_pointcloud(i * period, scans[i])
            ctx.feed_s.append(time.perf_counter() - t)
            if traced_device and i + 1 == trace_end:
                _sync(device)
                trace.mark()
                _sync(device)
                t = time.perf_counter()
                profiler.stop()
                ctx.trace_stop_s = time.perf_counter() - t
    else:
        for i in range(warm, warm + n_window):
            mb.insert_pointcloud(i * period, scans[i])
    _sync(device)
    t_close = time.perf_counter()
    if traced:
        prof.disable()
        ctx.prof = prof.stats()
    ctx.window_scans = n_window
    ctx.trace_scans = trace_end - warm
    ctx.window_submaps = len(mb.trajectory) - submaps0
    ctx.window_s = t_close - t_open
    ctx.setup_s = t_open - t_start
    ctx.peak_bytes = torch.cuda.max_memory_allocated() if cuda else None
    if traced_device:
        t = time.perf_counter()
        ctx.trace = trace.reduce(profiler)
        del profiler
        ctx.trace_read_s = time.perf_counter() - t

    group = "per_layer" if traced else "end_to_end"
    metrics = {}
    for m in manifest.metrics_of(bench, workload, group):
        r = readers.get(m["name"]) or manifest.reader(m["name"])
        v = r.read(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}

    out = program_outputs(mb, period)
    collected = {name: m.collect(mb, period) for name, m in own.items()}
    pending = 2 * config["settings"]["map_builder.pair_match_batch"] + 1
    close = getattr(mb.front_end, "close", None)
    if close is not None:
        close()
    del mb
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    fe, pm, missing_kf, missing_pm = check.sample_items(
        seed, (warm, warm + n_window), out["frames"], out["submaps"],
        2 * chunk, pending, cell)
    numbers = {"missing_keyframes": check.keyframes_missed(
                   scans, out["frames"], missing_kf, config["reference"],
                   device),
               "missing_pair_matches": missing_pm}
    numbers.update(check.gaps(scans, out["frames"], out["submaps"], fe, pm,
                              config["reference"], device))
    if own:
        run = check.run_of(scans, out, (warm, warm + n_window), 2 * chunk,
                           pending, config, cell, seed, device)
        with check.full_float32():
            numbers = check.merge({"check.py": numbers, **{
                f"checks/{name}": m.numbers(collected[name], run)
                for name, m in own.items()}})
    correct, checks = check.judge(numbers, cell["limits"])
    res = {"correct": correct, "attempted": n_window,
           "failed": numbers["missing_keyframes"], "metrics": metrics,
           "device": {"platform": "gpu" if cuda else "cpu",
                      "kind": (torch.cuda.get_device_name(0) if cuda
                               else "cpu"),
                      "count": parts["workload"]["chips"],
                      "memory_peak_bytes": ctx.peak_bytes}}
    if traced and ctx.trace is not None:
        res["device"]["busy_s"] = ctx.trace["busy_s"]
        res["device"]["window_s"] = ctx.trace["window_s"]
        res["breakdown"] = {"device_ops": ctx.trace["device_ops"],
                            "idle_gaps": ctx.trace["idle_gaps"]}
    if traced_device:
        res["trace_s"] = {"stop": ctx.trace_stop_s, "read": ctx.trace_read_s}
    res["checks"] = checks
    return res
