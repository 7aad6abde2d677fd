"""Build and load the port's native decode pool (``io/csrc/mxnet_io.cpp``).

The source is compiled by the host's C++ compiler (``$CXX``, else ``g++``)
into a shared library under the checkout's ``build/native/`` at first use,
keyed by a hash of the source, the flags and the compiler's version, and
loaded with ``ctypes``.  Nothing here runs at import time.

The build probes its decoder first: libjpeg when the compiler finds
``jpeglib.h`` and links ``-ljpeg`` (the JAX package's decoder); else nvJPEG
from the CUDA toolkit (``MXNET_IO_NVJPEG``), when ``nvjpeg.h`` is there;
else it raises naming both.  A failed build or load raises with the
compiler's or loader's message: the port never falls back quietly to a
slower decode.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

__all__ = ["load", "build", "decoder"]

SRC = Path(__file__).resolve().parent / "csrc" / "mxnet_io.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-Wall", "-pthread")
CUDA_HOME = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))

_lock = threading.Lock()
_lib = None
_decoder = None


def _cxx():
    name = os.environ.get("CXX", "g++")
    path = shutil.which(name)
    if path is None:
        raise RuntimeError(f"C++ compiler {name!r} not found: the native decode pool "
                           "(io/csrc/mxnet_io.cpp) is built from source at first use")
    return path


def _links(cxx, flags, libs):
    """Whether a program including ``jpeglib.h`` compiles and links."""
    probe = "#include <cstdio>\n#include <jpeglib.h>\nint main() { jpeg_decompress_struct c; " \
            "c.err = jpeg_std_error(nullptr); return 0; }\n"
    proc = subprocess.run([cxx, "-x", "c++", "-std=c++17", *flags, "-", "-o", os.devnull, *libs],
                          input=probe, capture_output=True, text=True)
    return proc.returncode == 0


def _variant(cxx):
    """``(decoder, flags, libs)`` for this machine."""
    if _links(cxx, (), ("-ljpeg",)):
        return "libjpeg", (), ("-ljpeg",)
    inc, lib = CUDA_HOME / "include", CUDA_HOME / "lib64"
    if (inc / "nvjpeg.h").exists():
        return ("nvjpeg", ("-DMXNET_IO_NVJPEG", f"-I{inc}"),
                (f"-L{lib}", f"-Wl,-rpath,{lib}", "-lnvjpeg", "-lcudart_static", "-ldl",
                 "-lrt"))
    raise RuntimeError(
        "no JPEG decoder for the native decode pool: the C++ compiler finds no libjpeg "
        f"(jpeglib.h, -ljpeg) and the CUDA toolkit at {CUDA_HOME} has no nvjpeg.h")


def build():
    """Compile the decode pool unless a library of the same source, flags
    and compiler exists.  Returns ``(path, decoder)``."""
    cxx = _cxx()
    decoder, flags, libs = _variant(cxx)
    version = subprocess.run([cxx, "--version"], capture_output=True, text=True).stdout
    cmd = (*CXX_FLAGS, *flags, *libs)
    key = hashlib.sha256(SRC.read_bytes() + b"\0" + " ".join(cmd).encode() + b"\0"
                         + version.encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"libmxnet_io-{decoder}-{key}.so"
    if lib.exists():
        return lib, decoder
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, *flags, str(SRC), "-o", str(tmp), *libs],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{cxx} failed on {SRC}:\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, lib)  # atomic: a concurrent loader sees all or nothing
    return lib, decoder


def load():
    """The loaded decode pool, built on first use; raises if it cannot be
    built or loaded."""
    global _lib, _decoder
    with _lock:
        if _lib is not None:
            return _lib
        path, decoder = build()
        lib = ctypes.CDLL(str(path))  # OSError with the loader's message
        f_ptr = ctypes.POINTER(ctypes.c_float)
        lib.MXTImageIterCreate.restype = ctypes.c_void_p
        lib.MXTImageIterCreate.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_uint, ctypes.c_int, ctypes.c_int,
            f_ptr, f_ptr, ctypes.c_int, ctypes.c_int, ctypes.c_int]
        lib.MXTImageIterNumSamples.restype = ctypes.c_long
        lib.MXTImageIterNumSamples.argtypes = [ctypes.c_void_p]
        lib.MXTImageIterNext.restype = ctypes.c_int
        lib.MXTImageIterNext.argtypes = [ctypes.c_void_p, f_ptr, f_ptr]
        lib.MXTImageIterReset.argtypes = [ctypes.c_void_p]
        lib.MXTImageIterFree.argtypes = [ctypes.c_void_p]
        _lib, _decoder = lib, decoder
        return lib


def decoder():
    """``"libjpeg"`` or ``"nvjpeg"``: the decoder of the loaded pool."""
    load()
    return _decoder
