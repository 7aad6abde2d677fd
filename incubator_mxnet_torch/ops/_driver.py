"""A small ctypes binding of the CUDA driver API, for kernels compiled at
runtime (``mx.rtc.CudaModule``).

It binds ``libcuda.so.1`` and nothing else, at first use, so the package
imports on a machine without a card.  Modules load into the device's
primary context, the one PyTorch uses, so a kernel sees PyTorch's pointers
and runs on its streams; no context is created.  Every ``CUresult`` is
checked and raised with its name.
"""
from __future__ import annotations

import ctypes
import threading

__all__ = ["DriverError", "use_device", "load_module", "get_function", "function_attributes",
           "launch"]

CUDA_ERROR_NOT_FOUND = 500
# CUfunction_attribute
_ATTRIBUTES = {"max_threads_per_block": 0, "static_shared_bytes": 1, "local_bytes": 3,
               "registers": 4}

_lock = threading.Lock()
_lib = None
_contexts: dict[int, ctypes.c_void_p] = {}


class DriverError(RuntimeError):
    """A CUDA driver call returned an error; ``code`` is its CUresult."""

    def __init__(self, call, code, name, text):
        super().__init__(f"{call} failed: {name} ({code}): {text}")
        self.code = code
        self.name = name


def _cuda():
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL("libcuda.so.1")
            p, vp, i, u = ctypes.POINTER, ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
            sig = {
                "cuInit": [u],
                "cuDeviceGet": [p(i), i],
                "cuDevicePrimaryCtxRetain": [p(vp), i],
                "cuCtxGetCurrent": [p(vp)],
                "cuCtxSetCurrent": [vp],
                "cuModuleLoadData": [p(vp), ctypes.c_char_p],
                "cuModuleGetFunction": [p(vp), vp, ctypes.c_char_p],
                "cuFuncGetAttribute": [p(i), i, vp],
                "cuLaunchKernel": [vp, u, u, u, u, u, u, u, vp, p(vp), p(vp)],
                "cuGetErrorName": [i, p(ctypes.c_char_p)],
                "cuGetErrorString": [i, p(ctypes.c_char_p)],
            }
            for name, argtypes in sig.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = i
            _lib = lib
        return _lib


def _check(call, rc):
    if rc == 0:
        return
    lib = _cuda()
    name, text = ctypes.c_char_p(), ctypes.c_char_p()
    lib.cuGetErrorName(rc, ctypes.byref(name))
    lib.cuGetErrorString(rc, ctypes.byref(text))
    raise DriverError(call, rc, (name.value or b"CUDA_ERROR_UNKNOWN").decode(),
                      (text.value or b"unrecognized error code").decode())


def use_device(index):
    """Make device ``index``'s primary context current on this thread
    (retained once per process) and return it."""
    lib = _cuda()
    with _lock:
        ctx = _contexts.get(index)
        if ctx is None:
            _check("cuInit", lib.cuInit(0))
            dev = ctypes.c_int()
            _check("cuDeviceGet", lib.cuDeviceGet(ctypes.byref(dev), index))
            ctx = ctypes.c_void_p()
            _check("cuDevicePrimaryCtxRetain",
                   lib.cuDevicePrimaryCtxRetain(ctypes.byref(ctx), dev))
            _contexts[index] = ctx
    current = ctypes.c_void_p()
    _check("cuCtxGetCurrent", lib.cuCtxGetCurrent(ctypes.byref(current)))
    if current.value != ctx.value:
        _check("cuCtxSetCurrent", lib.cuCtxSetCurrent(ctx))
    return ctx


def load_module(image, index):
    """Load a cubin image (bytes) into device ``index``'s primary context;
    returns the CUmodule handle."""
    use_device(index)
    mod = ctypes.c_void_p()
    _check("cuModuleLoadData", _cuda().cuModuleLoadData(ctypes.byref(mod), image))
    return mod


def get_function(module, name):
    """The CUfunction ``name`` of a loaded module.  C++ mangles names, so a
    kernel is found only when it is declared ``extern "C"``."""
    fn = ctypes.c_void_p()
    rc = _cuda().cuModuleGetFunction(ctypes.byref(fn), module, name.encode())
    if rc == CUDA_ERROR_NOT_FOUND:
        raise DriverError(f"cuModuleGetFunction({name!r})", rc, "CUDA_ERROR_NOT_FOUND",
                          f'no kernel named {name!r} in the module: declare it '
                          f'extern "C" __global__, or C++ mangles its name')
    _check(f"cuModuleGetFunction({name!r})", rc)
    return fn


def function_attributes(fn):
    """Registers, local memory and the like of a CUfunction."""
    out = {}
    for key, attr in _ATTRIBUTES.items():
        v = ctypes.c_int()
        _check("cuFuncGetAttribute", _cuda().cuFuncGetAttribute(ctypes.byref(v), attr, fn))
        out[key] = v.value
    return out


def launch(fn, grid, block, shared_mem, stream, params):
    """``cuLaunchKernel`` on ``stream`` (a ``cudaStream_t`` as an int).
    ``params`` are ctypes objects, one per kernel parameter in order; each
    entry of kernelParams points at one, and all stay alive until the call
    returns.  Errors of the kernel's run are asynchronous and surface at a
    later synchronization."""
    ptrs = (ctypes.c_void_p * len(params))(*[ctypes.addressof(p) for p in params])
    _check("cuLaunchKernel", _cuda().cuLaunchKernel(
        fn, grid[0], grid[1], grid[2], block[0], block[1], block[2], shared_mem, stream,
        ptrs, None))
