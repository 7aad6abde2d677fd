"""NDArray: MXNet's n-d array over one ``torch.Tensor``.

Counterpart of the JAX package's ``ndarray/ndarray.py``.  An NDArray wraps
one tensor (``_data``) and the Context it lives on; it is not a
``torch.Tensor`` subclass, because MXNet gives ``size``, ``reshape``,
``transpose``, ``split``, ``repeat``, ``tile``, ``flip``, ``sort``,
``topk``, ``max`` and ``backward`` other meanings than PyTorch does.
Tensors stay the port's internal currency (blocks, parameters, the
Trainer and the kernel wrappers take tensors); NDArray is the user's.
Every op method and operator goes through the registered op of the same
name, under ``amp.init()``'s casts, and returns NDArrays on the output's
device.

* Autograd: PyTorch records the graph.  An NDArray op records only inside
  ``autograd.record()`` (outside it runs with grad mode off, as MXNet runs
  off the tape), and an op registered ``differentiable=False`` never
  records.  ``attach_grad(grad_req)`` makes ``_data`` a leaf whose
  gradient lands in ``grad`` by MXNet's ``write``/``add`` rule (the hook of
  ``gluon/parameter.py``); ``backward()`` seeds with ones.
* Mutation: ``a[...] = v`` and ``a += b`` give the array a new buffer, as
  the JAX package does; on an ``attach_grad`` leaf outside ``record()``
  they write in place, so the array stays the same leaf.
* Synchronisation: ``wait_to_read``/``wait_to_write`` synchronise the
  array's device stream; ``waitall`` synchronises every card (a no-op on
  the CPU).
* bf16: numpy has no bfloat16 without ``ml_dtypes``, which the port does
  not need.  So ``dtype`` is the numpy dtype where numpy has one, and for
  bfloat16 the name ``"bfloat16"`` (a ``str`` with ``name`` and
  ``itemsize``), which ``base.dtype_name`` and every ``dtype=`` parameter
  take; ``asnumpy()`` of a bf16 array returns float32 with the same values.
"""
from __future__ import annotations

from time import perf_counter as _perf

import numpy as _np
import torch

from .. import autograd
from .. import profiler as _profiler
from ..base import as_torch_dtype, dtype_name
from ..context import Context, current_context
from ..ops import registry as _registry

__all__ = ["NDArray", "array", "zeros", "ones", "full", "empty", "arange", "invoke", "waitall"]


class _DtypeName(str):
    """A dtype numpy lacks, by its MXNet name."""

    def __new__(cls, name, itemsize):
        self = super().__new__(cls, name)
        self.itemsize = itemsize
        return self

    @property
    def name(self):
        return str(self)


BFLOAT16 = _DtypeName("bfloat16", 2)
_NP_DTYPES = {}
_CTX = {}


def _np_dtype(dtype):
    """The numpy dtype of a torch dtype (``BFLOAT16`` for bf16)."""
    out = _NP_DTYPES.get(dtype)
    if out is None:
        name = dtype_name(dtype)
        out = _NP_DTYPES[dtype] = BFLOAT16 if name == "bfloat16" else _np.dtype(name)
    return out


def _ctx_of(device):
    ctx = _CTX.get(device)
    if ctx is None:
        ctx = _CTX[device] = (Context("cpu", 0) if device.type == "cpu"
                              else Context("gpu", device.index or 0))
    return ctx


def _canonical(arr):
    """A host array as the JAX package canonicalizes it (64-bit to 32-bit,
    as JAX does without x64); ``ml_dtypes`` bf16 through float32."""
    name = arr.dtype.name
    if name == "float64":
        return arr.astype(_np.float32), None
    if name == "int64":
        return arr.astype(_np.int32), None
    if name == "bfloat16":
        return arr.astype(_np.float32), torch.bfloat16
    return arr, None


def _from_host(data, dtype, device):
    if dtype is None and not hasattr(data, "dtype"):
        dtype = "float32"
    arr = _np.asarray(data)
    arr, cast = _canonical(arr)
    t = torch.from_numpy(_np.array(arr, copy=True, order="C"))
    want = as_torch_dtype(dtype) if dtype is not None else cast
    if want is not None and t.dtype != want:
        t = t.to(want)
    return t.to(device)


def _run(fn, args, kwargs, differentiable=True):
    """Run an op for NDArrays: recorded only inside ``autograd.record()``
    and only if the op is differentiable.  With the profiler armed the call
    is a ``dispatch.raw`` span (host time of the step's telemetry)."""
    if _profiler._active:
        t0 = _perf()
        out = _call(fn, args, kwargs, differentiable)
        _profiler.record_span("dispatch.raw", "dispatch", t0)
        return out
    return _call(fn, args, kwargs, differentiable)


def _call(fn, args, kwargs, differentiable):
    rec = differentiable and autograd.is_recording()
    if torch.is_grad_enabled() == rec:
        return fn(*args, **kwargs)
    with torch.set_grad_enabled(rec):
        return fn(*args, **kwargs)


def _wrap(t, ctx=None):
    out = object.__new__(NDArray)
    out._data = t
    out._ctx = ctx if ctx is not None else _ctx_of(t.device)
    out._grad = None
    out._grad_req = "null"
    out._hook = None
    out._version = 0
    return out


def _wrap_out(out):
    """Op outputs to NDArrays: a tensor becomes one, a tuple or list a list."""
    if isinstance(out, torch.Tensor):
        return _wrap(out)
    if isinstance(out, (tuple, list)):
        return [_wrap_out(o) for o in out]
    return out


def _unwrap(x):
    return x._data if isinstance(x, NDArray) else x


def _unwrap_nested(x):
    if isinstance(x, NDArray):
        return x._data
    if isinstance(x, (list, tuple)):
        return type(x)(_unwrap_nested(e) for e in x)
    return x


def _rewrap_nested(x):
    if isinstance(x, torch.Tensor):
        return _wrap(x)
    if isinstance(x, (list, tuple)):
        return type(x)(_rewrap_nested(e) for e in x)
    return x


def _has_nd(seq):
    """Whether any entry of ``seq`` (lists and tuples searched) is an
    NDArray."""
    for a in seq:
        if isinstance(a, NDArray) or (isinstance(a, (list, tuple)) and _has_nd(a)):
            return True
    return False


def _op(name, *arrays, **kwargs):
    op = _registry.get_op(name)
    fn = _registry.resolve(op)
    args = [_unwrap(a) for a in arrays]
    kwargs = {k: _unwrap(v) for k, v in kwargs.items()}
    return _wrap_out(_run(fn, args, kwargs, op.differentiable))


class NDArray:
    """An n-dimensional array on a device context."""

    __slots__ = ("_data", "_ctx", "_grad", "_grad_req", "_hook", "_version", "__weakref__")

    # win over numpy in mixed operator expressions
    __array_priority__ = 1000.0

    def __init__(self, data, ctx=None, dtype=None):
        if isinstance(data, NDArray):
            data = data._data
        if isinstance(data, torch.Tensor):
            if dtype is not None:
                data = data.to(as_torch_dtype(dtype))
            if ctx is not None and data.device != ctx.device:
                data = data.to(ctx.device)
        else:
            data = _from_host(data, dtype, (ctx or current_context()).device)
        self._data = data
        self._ctx = ctx if ctx is not None else _ctx_of(data.device)
        self._grad = None
        self._grad_req = "null"
        self._hook = None
        self._version = 0

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        """A ``torch`` function given NDArrays runs on their tensors and
        returns NDArrays (``torch.equal(a, b)`` and the like work)."""
        out = func(*_unwrap_nested(args), **{k: _unwrap_nested(v) for k, v in
                                             (kwargs or {}).items()})
        return _rewrap_nested(out)

    # -- properties -----------------------------------------------------------
    @property
    def shape(self):
        return tuple(self._data.shape)

    @property
    def dtype(self):
        return _np_dtype(self._data.dtype)

    @property
    def size(self):
        return self._data.numel()

    @property
    def ndim(self):
        return self._data.ndim

    @property
    def context(self):
        return self._ctx

    ctx = context
    device = context

    @property
    def T(self):
        return self.transpose()

    @property
    def grad(self):
        return self._grad

    @property
    def stype(self):
        return "default"

    def __len__(self):
        if self.ndim == 0:
            raise TypeError("len() of unsized object")
        return self.shape[0]

    def __repr__(self):
        return f"\n{self.asnumpy()}\n<NDArray {'x'.join(map(str, self.shape))} @{self._ctx}>"

    # -- synchronisation ------------------------------------------------------
    def wait_to_read(self):
        """Block until every operation queued on the array's device stream
        has finished."""
        if self._data.is_cuda:
            torch.cuda.current_stream(self._data.device).synchronize()
        return self

    wait_to_write = wait_to_read

    # -- host transfer ----------------------------------------------------------
    def asnumpy(self):
        """A numpy copy; bfloat16 comes back as float32 of the same values."""
        t = self._data.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        host = t.cpu()
        return (host.clone() if host is t else host).numpy()

    def asscalar(self):
        if self.size != 1:
            raise ValueError("The current array is not a scalar")
        return self.asnumpy().reshape(()).item()

    def item(self):
        return self.asscalar()

    def tolist(self):
        return self.asnumpy().tolist()

    def __array__(self, dtype=None, copy=None):
        a = self.asnumpy()
        return a.astype(dtype) if dtype is not None else a

    def __bool__(self):
        if self.size != 1:
            raise ValueError("The truth value of an NDArray with multiple elements is ambiguous")
        return bool(self.asscalar())

    def __float__(self):
        return float(self.asscalar())

    def __int__(self):
        return int(self.asscalar())

    def __index__(self):
        return int(self.asscalar())

    # -- conversion and placement ---------------------------------------------
    def astype(self, dtype, copy=True):
        if not copy and self._data.dtype == as_torch_dtype(dtype):
            return self
        return _op("cast", self, dtype=dtype)

    def copyto(self, other):
        """Copy into another NDArray (its buffer, cast to its dtype) or to a
        Context (a new array there)."""
        if isinstance(other, Context):
            return _wrap(_run(lambda t: t.to(other.device, copy=True), (self._data,), {}), other)
        if isinstance(other, NDArray):
            if other.shape != self.shape:
                raise ValueError(f"shape mismatch {self.shape} vs {other.shape}")
            with torch.no_grad():
                other._data.copy_(self._data)
            other._version += 1
            return other
        raise TypeError(f"cannot copy to {type(other)}")

    def copy(self):
        return _wrap(_run(torch.clone, (self._data,), {}), self._ctx)

    def as_in_context(self, ctx):
        if ctx == self._ctx:
            return self
        return _wrap(_run(lambda t: t.to(ctx.device), (self._data,), {}), ctx)

    as_in_ctx = as_in_context
    to_device = as_in_context

    def detach(self):
        return _wrap(self._data.detach(), self._ctx)

    # -- autograd -------------------------------------------------------------
    def attach_grad(self, grad_req="write", stype=None):
        """Make this array a leaf of the graph with a zero gradient buffer
        (``grad``): a backward overwrites it (``write``) or adds to it
        (``add``)."""
        if grad_req not in ("write", "add", "null"):
            raise ValueError(f"grad_req must be 'write', 'add' or 'null', got {grad_req!r}")
        if self._hook is not None:
            self._hook.remove()
            self._hook = None
        self._data = self._data.detach().requires_grad_(grad_req != "null")
        self._grad_req = grad_req
        self._grad = _wrap(torch.zeros_like(self._data), self._ctx)
        if grad_req != "null":
            self._hook = self._data.register_post_accumulate_grad_hook(self._take_grad)
        return self

    @torch.no_grad()
    def _take_grad(self, tensor):
        g, tensor.grad = tensor.grad, None
        if g is None:  # a backward that reached the leaf with no gradient
            return
        if self._grad_req == "add":
            self._grad._data.add_(g)
        else:
            self._grad._data = g
        self._grad._version += 1
        if autograd._ready_hooks:
            autograd._grad_ready(self)

    def zero_grad(self):
        if self._grad is not None:
            self._grad._data.zero_()

    def backward(self, out_grad=None, retain_graph=False, train_mode=True):
        """Back-propagate from this array, seeded with ``out_grad`` or ones
        (so a per-sample loss vector needs no sum)."""
        autograd.backward([self], [out_grad], retain_graph=retain_graph, train_mode=train_mode)

    # -- indexing -------------------------------------------------------------
    def __getitem__(self, key):
        key = _convert_key(key)
        return _wrap(_run(lambda t: t[key], (self._data,), {}))

    def __setitem__(self, key, value):
        key = _convert_key(key)
        value = _unwrap(value)
        data = self._data
        with torch.no_grad():
            if data.is_leaf and data.requires_grad:
                data[key] = value  # the leaf stays the same tensor
            elif isinstance(key, slice) and key == slice(None):
                value = torch.as_tensor(value, dtype=data.dtype, device=data.device)
                self._data = value.broadcast_to(data.shape).clone()
            else:
                new = data.detach().clone()
                new[key] = value
                self._data = new
        self._version += 1

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    # -- arithmetic -----------------------------------------------------------
    def __add__(self, other):
        return _op("broadcast_add", self, other)

    def __radd__(self, other):
        return _op("broadcast_add", other, self)

    def __sub__(self, other):
        return _op("broadcast_sub", self, other)

    def __rsub__(self, other):
        return _op("broadcast_sub", other, self)

    def __mul__(self, other):
        return _op("broadcast_mul", self, other)

    def __rmul__(self, other):
        return _op("broadcast_mul", other, self)

    def __truediv__(self, other):
        return _op("broadcast_div", self, other)

    def __rtruediv__(self, other):
        return _op("broadcast_div", other, self)

    def __mod__(self, other):
        return _op("broadcast_mod", self, other)

    def __rmod__(self, other):
        return _op("broadcast_mod", other, self)

    def __pow__(self, other):
        return _op("broadcast_power", self, other)

    def __rpow__(self, other):
        return _op("broadcast_power", other, self)

    def __neg__(self):
        return _op("negative", self)

    def __abs__(self):
        return _op("abs", self)

    def __matmul__(self, other):
        return _op("matmul", self, other)

    def __eq__(self, other):
        if other is None:
            return False
        return _op("broadcast_equal", self, other)

    def __ne__(self, other):
        if other is None:
            return True
        return _op("broadcast_not_equal", self, other)

    def __gt__(self, other):
        return _op("broadcast_greater", self, other)

    def __ge__(self, other):
        return _op("broadcast_greater_equal", self, other)

    def __lt__(self, other):
        return _op("broadcast_lesser", self, other)

    def __le__(self, other):
        return _op("broadcast_lesser_equal", self, other)

    def __hash__(self):
        return id(self)

    def _inplace(self, opname, other):
        data = self._data
        if data.is_leaf and data.requires_grad and not autograd.is_recording():
            # ``w -= lr * w.grad`` outside record(): the leaf stays a leaf
            new = _op(opname, self, other)._data
            with torch.no_grad():
                data.copy_(new)
        else:
            self._data = _op(opname, self, other)._data
        self._version += 1
        return self

    def __iadd__(self, other):
        return self._inplace("broadcast_add", other)

    def __isub__(self, other):
        return self._inplace("broadcast_sub", other)

    def __imul__(self, other):
        return self._inplace("broadcast_mul", other)

    def __itruediv__(self, other):
        return self._inplace("broadcast_div", other)

    # -- op methods -----------------------------------------------------------
    def reshape(self, *shape, **kwargs):
        if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
            shape = tuple(shape[0])
        return _op("reshape", self, shape=shape, reverse=kwargs.get("reverse", False))

    def reshape_like(self, other):
        return _op("reshape_like", self, other)

    def flatten(self):
        return _op("flatten", self)

    def transpose(self, axes=None):
        return _op("transpose", self, axes=axes)

    def swapaxes(self, dim1, dim2):
        return _op("swapaxes", self, dim1=dim1, dim2=dim2)

    def expand_dims(self, axis):
        return _op("expand_dims", self, axis=axis)

    def squeeze(self, axis=None):
        return _op("squeeze", self, axis=axis)

    def broadcast_to(self, shape):
        return _op("broadcast_to", self, shape=shape)

    def broadcast_like(self, other):
        return _op("broadcast_like", self, other)

    def tile(self, reps):
        return _op("tile", self, reps=reps)

    def pad(self, mode="constant", pad_width=(), constant_value=0.0):
        return _op("pad", self, mode=mode, pad_width=pad_width, constant_value=constant_value)

    def round(self):
        return _op("round", self)

    def floor(self):
        return _op("floor", self)

    def ceil(self):
        return _op("ceil", self)

    def diag(self, k=0):
        return _op("diag", self, k=k)

    def repeat(self, repeats, axis=None):
        return _op("repeat", self, repeats=repeats, axis=axis)

    def flip(self, axis):
        return _op("flip", self, axis=axis)

    def split(self, num_outputs, axis=1, squeeze_axis=False):
        return _op("split", self, num_outputs=num_outputs, axis=axis, squeeze_axis=squeeze_axis)

    def slice(self, begin, end, step=None):
        return _op("slice", self, begin=begin, end=end, step=step)

    def slice_axis(self, axis, begin, end):
        return _op("slice_axis", self, axis=axis, begin=begin, end=end)

    def take(self, indices, axis=0, mode="clip"):
        return _op("take", self, indices, axis=axis, mode=mode)

    def one_hot(self, depth, on_value=1.0, off_value=0.0, dtype="float32"):
        return _op("one_hot", self, depth=depth, on_value=on_value, off_value=off_value,
                   dtype=dtype)

    def pick(self, index, axis=-1, keepdims=False, mode="clip"):
        return _op("pick", self, index, axis=axis, keepdims=keepdims, mode=mode)

    def clip(self, a_min=None, a_max=None):
        return _op("clip", self, a_min=a_min, a_max=a_max)

    def abs(self):
        return _op("abs", self)

    def sign(self):
        return _op("sign", self)

    def sqrt(self):
        return _op("sqrt", self)

    def square(self):
        return _op("square", self)

    def exp(self):
        return _op("exp", self)

    def log(self):
        return _op("log", self)

    def relu(self):
        return _op("relu", self)

    def sigmoid(self):
        return _op("sigmoid", self)

    def tanh(self):
        return _op("tanh", self)

    def softmax(self, axis=-1, temperature=None):
        return _op("softmax", self, axis=axis, temperature=temperature)

    def log_softmax(self, axis=-1):
        return _op("log_softmax", self, axis=axis)

    def dot(self, other, transpose_a=False, transpose_b=False):
        return _op("dot", self, other, transpose_a=transpose_a, transpose_b=transpose_b)

    def zeros_like(self):
        return _op("zeros_like", self)

    def ones_like(self):
        return _op("ones_like", self)

    def as_np_ndarray(self):
        return self

    def as_nd_ndarray(self):
        return self

    def tostype(self, stype):
        """This array (``"default"``) or its ``row_sparse`` or ``csr`` form
        (``ndarray/sparse.py``)."""
        if stype == "default":
            return self
        from . import sparse as _sparse
        if stype == "row_sparse":
            return _sparse.row_sparse_array(self)
        if stype == "csr":
            return _sparse.csr_matrix(self)
        raise ValueError(f"unknown storage type {stype!r}")

    # -- reductions -------------------------------------------------------------
    def sum(self, axis=None, keepdims=False, **kw):
        return _op("sum", self, axis=axis, keepdims=keepdims)

    def mean(self, axis=None, keepdims=False, **kw):
        return _op("mean", self, axis=axis, keepdims=keepdims)

    def prod(self, axis=None, keepdims=False, **kw):
        return _op("prod", self, axis=axis, keepdims=keepdims)

    def max(self, axis=None, keepdims=False, **kw):
        return _op("max", self, axis=axis, keepdims=keepdims)

    def min(self, axis=None, keepdims=False, **kw):
        return _op("min", self, axis=axis, keepdims=keepdims)

    def argmax(self, axis=None, keepdims=False):
        return _op("argmax", self, axis=axis, keepdims=keepdims)

    def argmin(self, axis=None, keepdims=False):
        return _op("argmin", self, axis=axis, keepdims=keepdims)

    def norm(self, ord=2, axis=None, keepdims=False):
        return _op("norm", self, ord=ord, axis=axis, keepdims=keepdims)

    def topk(self, axis=-1, k=1, ret_typ="indices", is_ascend=False, dtype="float32"):
        return _op("topk", self, axis=axis, k=k, ret_typ=ret_typ, is_ascend=is_ascend,
                   dtype=dtype)

    def sort(self, axis=-1, is_ascend=True):
        return _op("sort", self, axis=axis, is_ascend=is_ascend)

    def argsort(self, axis=-1, is_ascend=True, dtype="float32"):
        return _op("argsort", self, axis=axis, is_ascend=is_ascend, dtype=dtype)


def _convert_key(key):
    """Index keys as tensors: an NDArray key by its tensor, a float index
    array as integers."""
    def conv(k):
        k = _unwrap(k)
        if isinstance(k, torch.Tensor) and k.is_floating_point():
            return k.long()
        return k

    if isinstance(key, tuple):
        return tuple(conv(k) for k in key)
    return conv(key)


def invoke(fn, arrays, kwargs, name="", ctx=None):
    """Run a function of tensors on NDArray (or scalar) arguments: the
    arguments unwrapped, the call recorded inside ``autograd.record()``,
    every tensor output wrapped (on ``ctx`` if one is given)."""
    args = [_unwrap(a) for a in arrays]
    kwargs = {k: _unwrap(v) for k, v in (kwargs or {}).items()}
    out = _run(fn, args, kwargs)
    if ctx is not None:
        out = (out.to(ctx.device) if isinstance(out, torch.Tensor)
               else type(out)(o.to(ctx.device) for o in out))
    return _wrap_out(out)


# -- creation ------------------------------------------------------------------


def _resolve_ctx(ctx):
    return ctx if ctx is not None else current_context()


def array(source_array, ctx=None, dtype=None):
    """An NDArray from any array-like (on the current context unless
    ``ctx`` says otherwise); numpy's 64-bit dtypes become 32-bit, a source
    without a dtype becomes float32."""
    if isinstance(source_array, NDArray):
        source_array = source_array._data
    if isinstance(source_array, torch.Tensor):
        ctx = _resolve_ctx(ctx)
        t = source_array.detach().to(ctx.device, copy=True)
        return _wrap(t.to(as_torch_dtype(dtype)) if dtype is not None else t, ctx)
    ctx = _resolve_ctx(ctx)
    return _wrap(_from_host(source_array, dtype, ctx.device), ctx)


def _shape(shape):
    return (shape,) if isinstance(shape, int) else tuple(shape)


def zeros(shape, ctx=None, dtype="float32", **kwargs):
    ctx = _resolve_ctx(ctx)
    return _wrap(torch.zeros(_shape(shape), dtype=as_torch_dtype(dtype), device=ctx.device), ctx)


def ones(shape, ctx=None, dtype="float32", **kwargs):
    ctx = _resolve_ctx(ctx)
    return _wrap(torch.ones(_shape(shape), dtype=as_torch_dtype(dtype), device=ctx.device), ctx)


def full(shape, val, ctx=None, dtype="float32", **kwargs):
    ctx = _resolve_ctx(ctx)
    return _wrap(torch.full(_shape(shape), val, dtype=as_torch_dtype(dtype), device=ctx.device),
                 ctx)


def empty(shape, ctx=None, dtype="float32"):
    return zeros(shape, ctx=ctx, dtype=dtype)


def arange(start, stop=None, step=1.0, repeat=1, ctx=None, dtype="float32"):
    from ..ops.tensor import arange as _arange

    ctx = _resolve_ctx(ctx)
    return _wrap(_arange(start, stop, step, repeat, ctx=ctx, dtype=dtype), ctx)


def waitall():
    """Block until every card has finished its queued work (a no-op on a
    machine with none)."""
    if torch.cuda.is_available():
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)
