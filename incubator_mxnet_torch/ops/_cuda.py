"""Build and load the port's hand-written CUDA kernels.

Each kernel is one source under ``ops/csrc/`` with a plain C entry point.
It is compiled by ``nvcc`` for ``sm_90a`` into a shared library under the
checkout's ``build/kernels/`` at first use, keyed by a hash of everything
that goes into the compile (the source, every header it includes from
``csrc/``, the flags and ``nvcc --version``), and loaded with ``ctypes``.  Nothing here runs at import time,
so the package imports on a machine without ``nvcc``.

``build_cubin`` compiles a user's kernel source handed over at runtime
(``mx.rtc.CudaModule``) into a cubin under ``build/kernels/rtc/``, keyed by
a hash of the source, the flags and ``nvcc --version``; the CUDA driver
loads it (``ops/_driver.py``).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path

__all__ = ["build", "load", "build_cubin", "includes", "source_digest"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
RTC_DIR = BUILD_DIR / "rtc"
CUBIN_FLAGS = ("-cubin", "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
               "-Xptxas", "-v")

_lock = threading.Lock()
_version_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
_nvcc_versions: dict[str, str] = {}


def _nvcc():
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found: the port's CUDA kernels are built from source "
            "with the CUDA toolkit on the machine that has the card")
    return path


_INCLUDE = re.compile(r'^\s*#\s*include\s*"([^"]+)"', re.M)


def includes(src):
    """The headers that ``src`` includes with ``#include "..."``, found
    beside it and followed through their own includes, in first-seen
    order."""
    found, todo = [], [Path(src)]
    while todo:
        here = todo.pop(0)
        for name in _INCLUDE.findall(here.read_text()):
            path = (here.parent / name).resolve()
            if path.exists() and path not in found:
                found.append(path)
                todo.append(path)
    return found


def source_digest(src, flags, compiler_version):
    """Key of a build of ``src``: its bytes and those of every header it
    includes from its directory, the flags and the compiler's version
    string."""
    h = hashlib.sha256()
    for path in (Path(src), *includes(src)):
        h.update(path.name.encode() + b"\0" + path.read_bytes() + b"\0")
    h.update(" ".join(flags).encode() + b"\0" + compiler_version.encode())
    return h.hexdigest()[:16]


def build(name):
    """Compile ``csrc/<name>.cu`` unless a library of the same source,
    headers, flags and compiler exists.  Returns ``(path, ptxas_log,
    seconds)``; ``seconds`` is 0.0 and the log the saved one when nothing
    was compiled."""
    src = CSRC / f"{name}.cu"
    nvcc = _nvcc()
    lib = BUILD_DIR / f"lib{name}-{source_digest(src, NVCC_FLAGS, _nvcc_version(nvcc))}.so"
    log = lib.with_suffix(".log")
    if lib.exists():
        return lib, log.read_text() if log.exists() else "", 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)],
                          capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stdout}\n{proc.stderr}")
    log.write_text(proc.stdout + proc.stderr)
    os.replace(tmp, lib)  # atomic: a concurrent loader sees all or nothing
    return lib, proc.stdout + proc.stderr, seconds


def load(name):
    """The loaded library of kernel ``name``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = _libs[name] = ctypes.CDLL(str(build(name)[0]))
        return lib


def _nvcc_version(nvcc):
    with _version_lock:
        if nvcc not in _nvcc_versions:
            _nvcc_versions[nvcc] = subprocess.run([nvcc, "--version"], capture_output=True,
                                                  text=True, check=True).stdout
        return _nvcc_versions[nvcc]


def build_cubin(source, options=()):
    """Compile CUDA C++ ``source`` (a string) for ``sm_90a`` with the
    caller's nvcc ``options`` added, unless a cubin of the same source,
    flags and compiler exists.  Returns ``(path, ptxas_log, seconds)`` as
    :func:`build` does."""
    nvcc = _nvcc()
    flags = (*CUBIN_FLAGS, *options)
    key = "\0".join((source, " ".join(flags), _nvcc_version(nvcc)))
    cubin = RTC_DIR / f"{hashlib.sha256(key.encode()).hexdigest()[:16]}.cubin"
    log = cubin.with_suffix(".log")
    if cubin.exists():
        return cubin, log.read_text() if log.exists() else "", 0.0
    RTC_DIR.mkdir(parents=True, exist_ok=True)
    src = cubin.with_name(f"{cubin.stem}.{os.getpid()}.{threading.get_ident()}.cu")
    tmp = src.with_suffix(".cubin.tmp")
    src.write_text(source)
    t0 = time.perf_counter()
    try:
        proc = subprocess.run([nvcc, *flags, "-o", str(tmp), str(src)],
                              capture_output=True, text=True)
    finally:
        src.unlink(missing_ok=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed on a runtime kernel source:\n{proc.stdout}\n"
                           f"{proc.stderr}")
    log.write_text(proc.stdout + proc.stderr)
    os.replace(tmp, cubin)  # atomic: a concurrent loader sees all or nothing
    return cubin, proc.stdout + proc.stderr, seconds
