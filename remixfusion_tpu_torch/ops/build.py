"""Build the port's CUDA sources with nvcc at first use and load them.

Each `csrc/<name>.cu` exposes a plain C interface and is compiled into its
own shared library, `build/kernels/lib<name>-<hash>.so` under the checkout
root, and loaded with ctypes (no PyTorch headers: a build takes seconds).
The hash covers the source and the flags, so an edited source never loads a
stale library. `-Xptxas -v` output (registers, shared memory, spills) is kept
beside the library as `<name>-<hash>.log`.

Nothing here runs at import time: the CPU tests import every module, and
a machine without nvcc must still be able to.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, List

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "kernels")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "--fmad=false",
              "-Xptxas", "-v"]

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (CUDA toolkit required to build "
                           "the port's kernels)")
    return path


def sources() -> List[str]:
    return sorted(f[:-3] for f in os.listdir(CSRC) if f.endswith(".cu"))


def _paths(name: str):
    src = os.path.join(CSRC, name + ".cu")
    with open(src, "rb") as f:
        digest = hashlib.sha256(
            f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    stem = os.path.join(BUILD_DIR, f"{name}-{digest}")
    return src, os.path.join(BUILD_DIR, f"lib{name}-{digest}.so"), \
        stem + ".log"


def _start(name: str):
    """Start nvcc for one source; returns (Popen, tmp, lib, log) or None if
    the library is already built."""
    src, lib, log = _paths(name)
    if os.path.exists(lib):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    proc = subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    return proc, tmp, lib, log


def _finish(name: str, job) -> None:
    proc, tmp, lib, log = job
    out, _ = proc.communicate()
    text = out.decode(errors="replace")
    with open(log, "w") as f:
        f.write(text)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{text}")
    os.replace(tmp, lib)


def build_all() -> Dict[str, str]:
    """Compile every csrc/*.cu at once (one nvcc each, started together).
    Returns {name: ptxas log}."""
    jobs = {n: _start(n) for n in sources()}
    for n, job in jobs.items():
        if job is not None:
            _finish(n, job)
    return {n: build_log(n) for n in jobs}


def build_log(name: str) -> str:
    log = _paths(name)[2]
    if not os.path.exists(log):
        return ""
    with open(log) as f:
        return f.read()


def load(name: str) -> ctypes.CDLL:
    """The ctypes handle of csrc/<name>.cu, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            job = _start(name)
            if job is not None:
                _finish(name, job)
            lib = ctypes.CDLL(_paths(name)[1])
            _libs[name] = lib
        return lib


_sm_counts: Dict[str, int] = {}


def sm_count(device) -> int:
    """Streaming multiprocessors of a CUDA device, read once per process
    (launch shapes need it on every call)."""
    key = str(device)
    n = _sm_counts.get(key)
    if n is None:
        import torch

        n = torch.cuda.get_device_properties(device).multi_processor_count
        _sm_counts[key] = n
    return n
