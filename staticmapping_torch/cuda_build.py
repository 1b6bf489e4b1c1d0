"""Build and load the port's native libraries at first use.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for Hopper (``sm_90a``), and
each ``csrc/<name>.cpp`` with the host C++ compiler, into a shared library
with a plain C interface under ``staticmapping_torch/_build/``, named by a
hash of its source and flags, and loads with ``ctypes``.  Nothing here runs
at import time: the CPU-only test environment imports every module but
builds only the host libraries it uses.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, List

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# name -> {"seconds": build wall time (0 when cached), "log": compiler output}
build_info: Dict[str, dict] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "staticmapping_torch's kernels")


def _cxx() -> str:
    for name in ("g++", "c++"):
        path = shutil.which(name)
        if path:
            return path
    raise RuntimeError("no host C++ compiler (g++ or c++) found: it is needed "
                       "to build staticmapping_torch's host libraries")


def _source(name: str) -> str:
    for ext in (".cu", ".cpp"):
        src = os.path.join(CSRC_DIR, name + ext)
        if os.path.exists(src):
            return src
    raise FileNotFoundError(f"no csrc/{name}.cu or csrc/{name}.cpp")


def _command(src: str, out: str) -> List[str]:
    if src.endswith(".cu"):
        return [_nvcc(), *NVCC_FLAGS, "-o", out, src]
    return [_cxx(), *CXX_FLAGS, "-o", out, src]


def library_path(name: str) -> str:
    src = _source(name)
    flags = NVCC_FLAGS if src.endswith(".cu") else CXX_FLAGS
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(flags).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:16]}.so")


def build(*names: str) -> List[str]:
    """Compile ``csrc/<name>.cu`` or ``.cpp`` for every name whose library
    does not exist yet, all compilers started together; returns the
    libraries' paths in order."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    outs = [library_path(n) for n in names]
    running = []
    t0 = time.perf_counter()
    for name, out in zip(names, outs):
        if os.path.exists(out):
            build_info.setdefault(name, {"seconds": 0.0, "log": "cached"})
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        proc = subprocess.Popen(_command(_source(name), tmp),
                                stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running.append((name, out, tmp, proc))
    failed = []
    for name, out, tmp, proc in running:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"csrc/{name}:\n{log}")
            continue
        os.replace(tmp, out)          # atomic: concurrent builders agree
        build_info[name] = {"seconds": time.perf_counter() - t0, "log": log}
    if failed:
        raise RuntimeError("build failed for " + "\n".join(failed))
    return outs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(build(name)[0])
            _libs[name] = lib
        return lib
