"""``mx.rtc``: a user's CUDA kernels, compiled at runtime and launched on
the card.

Counterpart of the JAX package's ``rtc.py`` (``PallasModule``), which
compiles Pallas kernel source handed over at runtime; here, as in the
reference's ``mx.rtc.CudaModule``, the source is CUDA C++.  ``nvcc`` builds
it for ``sm_90a`` into a cubin at the first launch (``ops/_cuda.py``
``build_cubin``), the CUDA driver loads it into the card's primary context
once per device (``ops/_driver.py``), and ``Kernel.launch`` runs it on
PyTorch's current stream.

The contract is the Pallas one: a kernel takes its inputs, then one
pointer per declared output, which ``launch`` allocates on the inputs'
device.  Kernels are found by scanning the source for ``extern "C"
__global__`` functions and their C parameter lists; ``signature=`` (the
reference's C parameter string) stands in where the scan cannot see a
kernel, as with macros or templates.  Tensors pass as device pointers and
must be contiguous and of the parameter's pointee type; Python numbers pass
as the declared scalar.  Every mismatch raises before the launch.

A user's CUDA source has no plain version, so a kernel runs on CUDA tensors
only and raises on CPU tensors.  Like the reference's, these kernels are
raw compute: wrap one in ``mx.operator.CustomOp`` to differentiate through
it.
"""
from __future__ import annotations

import ctypes
import numbers
import re
import textwrap
import threading
from collections import namedtuple

import torch

from .base import as_torch_dtype
from .context import Context, current_context
from .ops import _cuda, _driver

__all__ = ["CudaModule", "Kernel"]

# Pointee types a tensor may be passed as, and the scalars a number may be.
_POINTEES = {
    "float": torch.float32, "double": torch.float64, "__nv_bfloat16": torch.bfloat16,
    "nv_bfloat16": torch.bfloat16, "__half": torch.float16, "half": torch.float16,
    "int": torch.int32, "int32_t": torch.int32, "long long": torch.int64,
    "long long int": torch.int64, "int64_t": torch.int64, "unsigned char": torch.uint8,
    "uint8_t": torch.uint8, "signed char": torch.int8, "int8_t": torch.int8, "bool": torch.bool,
}
_SCALARS = {
    "float": ctypes.c_float, "double": ctypes.c_double, "int": ctypes.c_int,
    "int32_t": ctypes.c_int32, "unsigned int": ctypes.c_uint, "unsigned": ctypes.c_uint,
    "uint32_t": ctypes.c_uint32, "long long": ctypes.c_longlong,
    "long long int": ctypes.c_longlong, "int64_t": ctypes.c_int64,
    "unsigned long long": ctypes.c_ulonglong, "uint64_t": ctypes.c_uint64,
    "size_t": ctypes.c_size_t,
}
_QUALIFIERS = {"const", "volatile", "__restrict__", "__restrict", "restrict"}
# Comments and preprocessor lines (continuations included) are not scanned:
# a kernel a macro defines is out of the scan's sight.
_COMMENTS = re.compile(r"//[^\n]*|/\*.*?\*/|^[ \t]*#(?:[^\n]*\\\n)*[^\n]*", re.S | re.M)
_BOUNDS = r"(?:__launch_bounds__\s*\([^)]*\)\s*)?"
_GLOBAL = re.compile(r"__global__\s+" + _BOUNDS + r"void\s+" + _BOUNDS + r"(\w+)\s*\(([^)]*)\)")
_EXTERN_C_BLOCK = re.compile(r'extern\s+"C"\s*\{')
_IDENT = re.compile(r"[A-Za-z_]\w*$")

Param = namedtuple("Param", "pointer dtype ctype text")
Param.__doc__ = ("One kernel parameter: a pointer to ``dtype`` elements, or a scalar "
                 "passed as ``ctype``.")


def _parse_param(text):
    tokens = re.findall(r"\w+|\*|\S", text)
    stars = tokens.count("*")
    idents = [t for t in tokens if t not in _QUALIFIERS and t != "*"]
    if stars > 1 or any(not _IDENT.match(t) for t in idents) or not idents:
        return None
    table = _POINTEES if stars else _SCALARS
    ctype = " ".join(idents)
    if ctype not in table:
        ctype = " ".join(idents[:-1])  # the last word names the parameter
        if ctype not in table:
            return None
    if stars:
        return Param(True, table[ctype], ctypes.c_void_p, text.strip())
    return Param(False, None, table[ctype], text.strip())


def parse_signature(params):
    """The :class:`Param` list of a C parameter list such as ``"const float*
    x, int n"``, or None where a parameter is of a type the launcher does not
    pass (a template parameter, a struct, a pointer to a pointer)."""
    params = params.strip()
    if params in ("", "void"):
        return []
    parsed = [_parse_param(p) for p in params.split(",")]
    return None if any(p is None for p in parsed) else parsed


def _block_spans(source):
    """(start, end) of the bodies of ``extern "C" { ... }`` blocks."""
    spans = []
    for m in _EXTERN_C_BLOCK.finditer(source):
        depth = 0
        for i in range(m.end() - 1, len(source)):
            depth += {"{": 1, "}": -1}.get(source[i], 0)
            if depth == 0:
                spans.append((m.end(), i))
                break
    return spans


def scan(source):
    """``({name: params or None}, {names of __global__ functions that are not
    extern "C"})`` of a CUDA source; ``params`` is None where
    :func:`parse_signature` cannot parse the list."""
    source = _COMMENTS.sub(" ", source)
    spans = _block_spans(source)
    found, mangled = {}, set()
    for m in _GLOBAL.finditer(source):
        before = source[:m.start()]
        if re.search(r'extern\s+"C"\s*$', before) or any(a <= m.start() < b for a, b in spans):
            found[m.group(1)] = parse_signature(m.group(2))
        else:
            mangled.add(m.group(1))
    return found, mangled


def _dims(what, dims):
    if dims is None:
        raise ValueError(f"give {what}: a CUDA kernel needs its grid and block dimensions")
    dims = (dims,) if isinstance(dims, int) else tuple(dims)
    if not 1 <= len(dims) <= 3 or any(not isinstance(d, int) or d < 1 for d in dims):
        raise ValueError(f"{what} must be 1 to 3 positive ints, got {dims}")
    return dims + (1,) * (3 - len(dims))


class Kernel:
    """A launchable kernel of a :class:`CudaModule` (parity: the reference's
    ``CudaKernel``) with its outputs declared.  ``launches`` counts its
    launches."""

    def __init__(self, module, name, params, out_shapes, out_dtypes, grid, block):
        self._module = module
        self.name = name
        self.params = params
        self._out_shapes = tuple(tuple(s) for s in out_shapes)
        self._out_dtypes = tuple(out_dtypes)
        self._grid = grid
        self._block = block
        self.launches = 0

    def __repr__(self):
        return f"<Kernel {self.name}({', '.join(p.text for p in self.params)})>"

    def _marshal(self, args, ctx=None):
        """The host half of a launch: check ``args`` against the parameters,
        allocate the outputs on the inputs' device, and turn both into
        ``(ctype, value)`` pairs in parameter order.  Returns ``(device,
        outputs, pairs)``."""
        args = list(args)
        n_in = len(self.params) - len(self._out_shapes)
        if len(args) != n_in:
            raise ValueError(f"kernel {self!r} takes {n_in} arguments before its "
                             f"{len(self._out_shapes)} outputs, got {len(args)}")
        devices = {a.device for a in args if isinstance(a, torch.Tensor)}
        if len(devices) > 1:
            raise ValueError(f"kernel {self.name!r}: inputs on several devices {devices}")
        device = devices.pop() if devices else None
        if ctx is not None:
            if isinstance(ctx, Context):  # compared without asking for the card
                want = (torch.device("cpu") if ctx.device_type == "cpu"
                        else torch.device("cuda", ctx.device_id))
            else:
                want = torch.device(ctx)
            if device is not None and want != device:
                raise ValueError(f"kernel {self.name!r}: ctx {want} is not the inputs' "
                                 f"device {device}")
            device = want
        if device is None:
            device = current_context().device
        pairs = []
        for i, (a, p) in enumerate(zip(args, self.params)):
            where = f"kernel {self.name!r} argument {i} ({p.text})"
            if p.pointer:
                if not isinstance(a, torch.Tensor):
                    raise ValueError(f"{where} takes a tensor, got {type(a).__name__}")
                if a.dtype != p.dtype:
                    raise ValueError(f"{where} takes {p.dtype}, got {a.dtype}")
                if not a.is_contiguous():
                    raise ValueError(f"{where} takes a contiguous tensor, got strides "
                                     f"{a.stride()} for shape {tuple(a.shape)}")
                pairs.append((ctypes.c_void_p, a.data_ptr()))
            else:
                integral = p.ctype not in (ctypes.c_float, ctypes.c_double)
                kind = numbers.Integral if integral else numbers.Real
                if isinstance(a, torch.Tensor) or not isinstance(a, kind):
                    raise ValueError(f"{where} takes a Python "
                                     f"{'int' if integral else 'number'}, got {a!r}")
                if integral and p.ctype(a).value != a:
                    raise ValueError(f"{where}: {a} does not fit")
                pairs.append((p.ctype, a))
        outs = [torch.empty(s, dtype=d, device=device)
                for s, d in zip(self._out_shapes, self._out_dtypes)]
        pairs += [(ctypes.c_void_p, o.data_ptr()) for o in outs]
        return device, outs, pairs

    def launch(self, args, ctx=None, grid_dims=None, block_dims=None, shared_mem=0):
        """Run the kernel on ``args`` (tensors and numbers, in parameter
        order) with the grid and block given here or at ``get_kernel``, on
        PyTorch's current stream of the inputs' device (or ``ctx``'s).
        Returns the output tensor, or a tuple of them.  Does not
        synchronize."""
        grid = _dims("grid_dims", grid_dims if grid_dims is not None else self._grid)
        block = _dims("block_dims", block_dims if block_dims is not None else self._block)
        device, outs, pairs = self._marshal(args, ctx)
        if device.type != "cuda":
            raise RuntimeError(f"kernel {self.name!r} runs on CUDA tensors only, got {device}: "
                               "a user's CUDA source has no plain version to run instead")
        index = device.index if device.index is not None else torch.cuda.current_device()
        stream = torch.cuda.current_stream(device).cuda_stream
        fn = self._module._function(self.name, index)
        _driver.use_device(index)
        _driver.launch(fn, grid, block, shared_mem, stream, [ct(v) for ct, v in pairs])
        self.launches += 1
        return outs[0] if len(outs) == 1 else tuple(outs)


class CudaModule:
    """Compile CUDA C++ source at runtime (parity: the reference's
    ``mx.rtc.CudaModule``; the JAX package's ``PallasModule``).

    ``source`` is a string, dedented; ``options`` are extra nvcc flags;
    ``exports`` optionally limits which kernels are retrievable.  Nothing
    is compiled until a kernel's first launch.

    Example::

        src = '''
        extern "C" __global__ void scale_add(const float* x, const float* y,
                                             long long n, float* out) {
            long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
            if (i < n) out[i] = 2.0f * x[i] + y[i];
        }
        '''
        mod = mx.rtc.CudaModule(src, exports=["scale_add"])
        k = mod.get_kernel("scale_add", out_shapes=[(64, 64)], grid=(16,), block=(256,))
        z = k.launch([x, y, x.numel()])
    """

    def __init__(self, source, options=(), exports=()):
        if not isinstance(source, str):
            raise TypeError("CudaModule compiles CUDA C++ source given as a string; a "
                            "callable kernel body (a Pallas kernel) has no CUDA counterpart")
        self.source = textwrap.dedent(source)
        self.options = tuple(options)
        found, self._mangled = scan(self.source)
        self._exports = tuple(exports)
        if self._exports:
            missing = sorted(set(self._exports) - set(found))
            if missing:
                raise ValueError(f'exports not found among the extern "C" __global__ '
                                 f"functions of the source: {missing}")
            found = {k: v for k, v in found.items() if k in self._exports}
        self._kernels = found
        self._lock = threading.Lock()
        self._image = None
        self._modules = {}
        self._functions = {}

    def get_kernel(self, name, out_shapes, out_dtypes=None, grid=None, block=None,
                   signature=None, in_specs=None, out_specs=None):
        """A launchable :class:`Kernel`.  ``out_shapes``/``out_dtypes``
        declare the outputs, which are the kernel's last parameters;
        ``grid``/``block`` are the default launch dimensions; ``signature``
        (the C parameter list) overrides the scanned one, and is needed for
        a kernel the scan cannot see."""
        if in_specs is not None or out_specs is not None:
            raise ValueError("in_specs/out_specs are Pallas BlockSpecs; a CUDA kernel tiles "
                             "by blockIdx and computes its own offsets")
        if name not in self._kernels and (self._exports or signature is None
                                          or not _IDENT.match(name)):
            hint = (' (it is __global__ but not extern "C", so C++ mangles its name)'
                    if name in self._mangled else "")
            raise ValueError(f"kernel {name!r} not in module{hint} "
                             f"(have {sorted(self._kernels)})")
        params = self._kernels.get(name)
        if signature is not None:
            params = parse_signature(signature)
            if params is None:
                raise ValueError(f"cannot parse signature {signature!r}")
        elif params is None:
            raise ValueError(f"cannot parse the parameters of kernel {name!r}; "
                             "give signature=")
        if isinstance(out_shapes[0], int):
            out_shapes = [out_shapes]
        if out_dtypes is None:
            out_dtypes = ["float32"] * len(out_shapes)
        elif isinstance(out_dtypes, (str, torch.dtype)):
            out_dtypes = [out_dtypes] * len(out_shapes)
        if len(out_dtypes) != len(out_shapes):
            raise ValueError(f"out_dtypes has {len(out_dtypes)} entries for "
                             f"{len(out_shapes)} out_shapes")
        out_dtypes = [as_torch_dtype(d) for d in out_dtypes]
        if len(params) < len(out_shapes):
            raise ValueError(f"kernel {name!r} has {len(params)} parameters for "
                             f"{len(out_shapes)} outputs")
        for p, d in zip(params[len(params) - len(out_shapes):], out_dtypes):
            if not p.pointer or p.dtype != d:
                raise ValueError(f"kernel {name!r}: output parameter ({p.text}) does not "
                                 f"take the declared {d}")
        return Kernel(self, name, params, out_shapes, out_dtypes,
                      None if grid is None else _dims("grid", grid),
                      None if block is None else _dims("block", block))

    def _function(self, name, index):
        """The CUfunction ``name`` on device ``index``: the source is compiled
        once per module and loaded once per device."""
        fn = self._functions.get((name, index))
        if fn is not None:
            return fn
        with self._lock:
            if self._image is None:
                path, _, _ = _cuda.build_cubin(self.source, self.options)
                self._image = path.read_bytes()
            if index not in self._modules:
                self._modules[index] = _driver.load_module(self._image, index)
            fn = self._functions[name, index] = _driver.get_function(self._modules[index], name)
        return fn

    def attributes(self, name, device=0):
        """Registers, local memory and static shared memory of kernel
        ``name`` as compiled for ``device`` (an index)."""
        return _driver.function_attributes(self._function(name, device))
