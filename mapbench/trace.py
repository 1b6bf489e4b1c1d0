"""Reduction of a ``torch.profiler`` trace of the window, in memory.

The traced run records the device's activity only (kernels, copies,
sets, and the CUDA runtime calls on the host), which costs the host far
less than recording every operator.  ``reduce`` reads the profiler's raw
events (no export to disk) and keeps what the readers and the result line
need: the device's operations between the window's two marks, their
union, the longest idle gaps with the runtime call that was running when
each began, and the operations that took the most device time.
"""
from __future__ import annotations

import bisect
from typing import Dict, List, Optional, Tuple

NAME_CHARS = 120

# the window's two ends are marked on the device by a short spin kernel
MARK = "spin_kernel"
MARK_CYCLES = 1000
DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")


def mark() -> None:
    """Put a window mark on the current CUDA stream."""
    import torch
    torch.cuda._sleep(MARK_CYCLES)


def _raw_events(prof):
    """``(name, start_us, end_us, on_device)`` of the profiler's device
    operations (kernels, copies, sets) and host events; the device-side
    copies of host annotations are left out."""
    from torch.autograd import DeviceType
    cpu = DeviceType.CPU
    out = []
    for e in prof.profiler.kineto_results.events():
        on_device = e.device_type() != cpu
        if on_device:
            # older torch has no activity_type: keep what is no annotation
            kind = getattr(e, "activity_type", None)
            if (e.is_user_annotation() if kind is None
                    else str(kind()).lower() not in DEVICE_KINDS):
                continue
        s = e.start_ns() / 1e3
        out.append((e.name(), s, s + e.duration_ns() / 1e3, on_device))
    return out


def union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """Sorted, merged intervals."""
    merged: List[List[float]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def is_copy(name: str) -> bool:
    return name.startswith(("Memcpy", "Memset", "memcpy", "memset"))


def reduce_events(events, window: Tuple[float, float], top: int = 10) -> dict:
    """The window's device operations and host gaps from ``events``
    (``(name, start_us, end_us, on_device)``)."""
    w0, w1 = window
    dev = [(n, max(s, w0), min(e, w1)) for n, s, e, d in events
           if d and e > w0 and s < w1 and MARK not in n]
    host = sorted((s, e, n) for n, s, e, d in events
                  if not d and e > w0 and s < w1)
    busy = union([(s, e) for _, s, e in dev])
    busy_us = sum(e - s for s, e in busy)
    per_name: Dict[str, float] = {}
    for n, s, e in dev:
        per_name[n] = per_name.get(n, 0.0) + (e - s)
    gaps, prev = [], w0
    for s, e in busy:
        if s > prev:
            gaps.append((s - prev, prev))
        prev = max(prev, e)
    if w1 > prev:
        gaps.append((w1 - prev, prev))
    gaps.sort(reverse=True)
    starts = [h[0] for h in host]
    named_gaps = []
    for length, at in gaps[:top]:
        named_gaps.append([_host_at(host, starts, at), length / 1e6])
    return {
        "window_s": (w1 - w0) / 1e6,
        "busy_s": busy_us / 1e6,
        "kernels": [(n, (e - s) / 1e6) for n, s, e in dev if not is_copy(n)],
        "device_ops": sorted(([n[:NAME_CHARS], t / 1e6]
                              for n, t in per_name.items()),
                             key=lambda x: -x[1])[:top],
        "idle_gaps": named_gaps,
    }


def _host_at(host, starts, t: float, look_back: int = 20000) -> str:
    """The innermost host operation running at ``t`` (the latest to start
    of those that cover it), named with the outermost one."""
    i = bisect.bisect_right(starts, t)
    covering = [h for h in host[max(0, i - look_back):i] if h[1] > t]
    if not covering:
        return "host"
    outer = min(covering)[2][:NAME_CHARS]
    inner = max(covering)[2][:NAME_CHARS]
    return inner if inner == outer else f"{outer} / {inner}"


def reduce(prof, top: int = 10) -> Optional[dict]:
    """The reduced trace of a finished ``torch.profiler.profile`` whose
    window is marked at both ends with :func:`mark`; None without the
    marks (no device)."""
    events = _raw_events(prof)
    marks = [(s, e) for n, s, e, d in events if d and MARK in n]
    if len(marks) < 2:
        return None
    return reduce_events(events, (min(s for s, _ in marks),
                                  max(e for _, e in marks)), top)
