"""Process metrics sampler — ProcessProfiler parity; the PyTorch port's copy
of ``staticmapping_tpu.common.process_info``.

The reference runs a background thread sampling /proc CPU% and memory into
``~/.static_mapping_log`` (common/performance/process_info.h:46-66,
analyzed offline by tools/scripts/mem_analyse.py).  Same role here:
:class:`ProcessProfiler` samples /proc/self at a fixed period from a
daemon thread and writes ``time cpu_pct rss_mb vms_mb`` lines; enable from
the CLI with ``--log-resources``.
"""
from __future__ import annotations

import os
import threading
import time
from typing import Optional


def _read_stat():
    with open("/proc/self/stat") as f:
        parts = f.read().split()
    utime, stime = int(parts[13]), int(parts[14])
    return (utime + stime) / os.sysconf("SC_CLK_TCK")


def _read_mem():
    rss = vms = 0
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                rss = int(line.split()[1]) / 1024.0
            elif line.startswith("VmSize:"):
                vms = int(line.split()[1]) / 1024.0
    return rss, vms


class ProcessProfiler:
    def __init__(self, log_path: str = None, period: float = 1.0):
        self.log_path = log_path or os.path.expanduser(
            "~/.staticmapping_torch_log")
        self.period = period
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "ProcessProfiler":
        if self._thread is not None:
            return self
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None

    def _run(self) -> None:
        t_prev = time.monotonic()
        cpu_prev = _read_stat()
        with open(self.log_path, "a") as f:
            f.write("# time_s cpu_pct rss_mb vms_mb\n")
            while not self._stop.wait(self.period):
                t = time.monotonic()
                cpu = _read_stat()
                pct = 100.0 * (cpu - cpu_prev) / max(t - t_prev, 1e-6)
                rss, vms = _read_mem()
                f.write(f"{t:.2f} {pct:.1f} {rss:.1f} {vms:.1f}\n")
                f.flush()
                t_prev, cpu_prev = t, cpu
