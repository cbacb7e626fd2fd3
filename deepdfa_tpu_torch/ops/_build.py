"""Build the package's CUDA sources at first use and load them with ctypes.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, under ``deepdfa_tpu_torch/_build/``
(listed in ``.gitignore``); the sources share device code through
``csrc/*.cuh`` headers. The library's file name carries a digest of every
source, header and flag, so an edited source is rebuilt and a stale
library is never loaded. Several sources build in parallel, one ``nvcc``
each, and :func:`build` returns when all have finished. Builds and loads
hold one lock, so threads that reach a kernel together (the server's
dispatchers) never compile the same source twice. A failed build raises:
there is no fallback.

:func:`load_host` builds a plain C++ source (the dataflow solver of
``native/dfa_solver.cpp``) with the host's C++ compiler into the same
directory, under the same digest rule.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

__all__ = ["BUILD_DIR", "CSRC", "CXX_FLAGS", "NVCC_FLAGS", "build", "load",
           "load_host"]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# the flags of native/Makefile: no -march=native, the library must run on
# whatever host loads it
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared")

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.RLock()


def _nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and Path("/usr/local/cuda/bin/nvcc").exists():
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found: the CUDA kernels of deepdfa_tpu_torch are built "
            "at first use and need the CUDA toolkit")
    return nvcc


def _target(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(*names: str) -> str:
    """Compile ``csrc/<name>.cu`` for each name whose library does not exist
    yet, one ``nvcc`` per source, all started together, and wait for them.
    Returns nvcc's output (ptxas reports registers, shared memory and
    spills), or "" when every library was already built."""
    with _lock:
        return _build(names)


def _build(names) -> str:
    jobs = []
    for name in names:
        target = _target(name)
        if target.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs.append((name, target, tmp, proc))
    logs, failed = [], []
    for name, target, tmp, proc in jobs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name} (nvcc exit {proc.returncode}):\n{out}")
            continue
        os.replace(tmp, target)
        logs.append(out)
    if failed:
        raise RuntimeError("CUDA build failed: " + "\n".join(failed))
    return "".join(logs)


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build(name)
            lib = ctypes.CDLL(str(_target(name)))
            _libs[name] = lib
        return lib


def _host_target(name: str, source: Path) -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(source.read_bytes())
    return BUILD_DIR / f"lib{name}-host-{h.hexdigest()[:12]}.so"


def load_host(name: str, source: Path) -> ctypes.CDLL:
    """The loaded library of the C++ ``source``, compiled first with the
    host's C++ compiler (``c++`` or ``g++``) if its digest-named library
    does not exist yet. Raises when there is no compiler or the build
    fails."""
    source = Path(source)
    key = f"host:{name}"
    with _lock:
        lib = _libs.get(key)
        if lib is not None:
            return lib
        target = _host_target(name, source)
        if not target.exists():
            cxx = shutil.which("c++") or shutil.which("g++")
            if cxx is None:
                raise RuntimeError(f"no C++ compiler to build {source.name}")
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = target.with_suffix(f".{os.getpid()}.tmp")
            proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(source)],
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"C++ build of {source.name} failed "
                                   f"(exit {proc.returncode}):\n{proc.stderr}")
            os.replace(tmp, target)
        lib = ctypes.CDLL(str(target))
        _libs[key] = lib
        return lib
