"""Build the port's native sources at first use and load them with ctypes.

Each `csrc/<name>.cu` (a CUDA kernel) exposes a plain C interface and is
compiled by nvcc into its own shared library,
`build/kernels/lib<name>-<hash>.so` under the checkout root (no PyTorch
headers: a build takes seconds). `-Xptxas -v` output (registers, shared
memory, spills) is kept beside the library as `<name>-<hash>.log`.

Each `csrc/<name>.cpp` (host code: marching tetrahedra, the depth
rasterizer) is compiled by g++ into `build/host/lib<name>-<hash>.so` with
-O3 -march=native. A failed build raises with the compiler's output; there
is no fallback to the plain numpy versions.

The hash covers the source and the flags, so an edited source never loads
a stale library.

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
HOST_BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "host")
HOST_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC"]
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "--fmad=false",
              "-Xptxas", "-v"]

_libs: Dict[str, ctypes.CDLL] = {}
_host_libs: Dict[str, ctypes.CDLL] = {}
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


def host_sources() -> List[str]:
    return sorted(f[:-4] for f in os.listdir(CSRC) if f.endswith(".cpp"))


def _host_path(name: str):
    src = os.path.join(CSRC, name + ".cpp")
    with open(src, "rb") as f:
        digest = hashlib.sha256(
            f.read() + " ".join(HOST_FLAGS).encode()).hexdigest()[:12]
    return src, os.path.join(HOST_BUILD_DIR, f"lib{name}-{digest}.so")


def load_host(name: str) -> ctypes.CDLL:
    """The ctypes handle of csrc/<name>.cpp, built with g++ on first use.
    Raises with g++'s output when the build fails."""
    with _lock:
        lib = _host_libs.get(name)
        if lib is None:
            src, so = _host_path(name)
            if not os.path.exists(so):
                os.makedirs(HOST_BUILD_DIR, exist_ok=True)
                tmp = f"{so}.{os.getpid()}.tmp"
                out = subprocess.run(["g++", *HOST_FLAGS, "-o", tmp, src],
                                     capture_output=True, text=True)
                if out.returncode != 0:
                    raise RuntimeError(f"g++ failed for {name}.cpp:\n"
                                       f"{out.stderr}")
                os.replace(tmp, so)
            lib = ctypes.CDLL(so)
            _host_libs[name] = lib
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
