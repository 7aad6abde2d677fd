"""Gluon Parameter / ParameterDict over ``torch.nn.Parameter``.

Counterpart of the JAX package's ``gluon/parameter.py``, with the same
lifecycle: construct (a 0 in the shape means unknown), ``initialize``
(deferred until the first forward infers the shape), ``data()``,
``set_data``, ``cast``, ``reset_ctx``, ``var``, and the gradient API:
``grad()``, ``list_grad()``, ``zero_grad()``, ``grad_req`` and
``lr_mult``/``wd_mult``, and ``stype``/``grad_stype``, kept as the JAX
package keeps them (a ``row_sparse`` parameter is held densely and takes
the optimizer's lazy updates); a parameter made with ``differentiable=False``
(BatchNorm's running statistics) has ``grad_req="null"``, as has a
``Constant``.  A Parameter holds one ``torch.nn.Parameter`` on one device,
so ``list_data``/``list_ctx`` hold one entry.

Gradients follow MXNet, not PyTorch: a Parameter keeps its own gradient
buffer, and a hook run after PyTorch accumulates the backward's gradient
moves it there, overwriting (``grad_req="write"``) or adding
(``"add"``), and clears PyTorch's ``.grad``.  So two backwards without a
step in between leave the second gradient under ``write``, whichever of
``mx.autograd.backward`` or ``Tensor.backward`` ran them.  The buffer is
made at the first backward or ``grad()`` (zeros until a backward writes
it), so a network that only runs inference holds none.
"""
from __future__ import annotations

import numpy as _np
import torch

from .. import autograd
from .. import initializer as _init_mod
from ..base import DeferredInitializationError, as_torch_dtype, dtype_name
from ..context import Context, current_context

__all__ = ["Parameter", "Constant", "ParameterDict"]


def _shape_is_known(shape):
    return shape is not None and all(s > 0 for s in shape)


def _resolve_device(ctx):
    if ctx is None:
        ctx = current_context()
    if isinstance(ctx, (list, tuple)):
        ctx = ctx[0]
    return ctx.device if isinstance(ctx, Context) else torch.device(ctx)


class Parameter:
    """A trainable (or auxiliary) tensor of a Block."""

    def __init__(self, name, grad_req="write", shape=None, dtype="float32", lr_mult=1.0,
                 wd_mult=1.0, init=None, allow_deferred_init=False, differentiable=True,
                 stype="default", grad_stype="default"):
        for kind in (stype, grad_stype):
            if kind not in ("default", "row_sparse", "csr"):
                raise ValueError(f"Parameter {name}: unknown storage type {kind!r}")
        self.name = name
        self._data = None
        self._grad = None
        self._grad_version = 0
        self._hook = None
        self._grad_req = None
        self.grad_req = grad_req if differentiable else "null"
        if isinstance(shape, int):
            shape = (shape,)
        self._shape = tuple(shape) if shape is not None else None
        self.dtype = dtype_name(dtype)
        self.lr_mult = lr_mult
        self.wd_mult = wd_mult
        self.init = init
        self.allow_deferred_init = allow_deferred_init
        self._deferred_init = None
        self._stype = stype
        self._grad_stype = grad_stype

    @property
    def shape(self):
        return self._shape

    @shape.setter
    def shape(self, new_shape):
        new_shape = tuple(new_shape)
        if self._shape is not None and (
                len(self._shape) != len(new_shape)
                or any(s not in (0, n) for s, n in zip(self._shape, new_shape))):
            raise ValueError(f"Parameter {self.name}: shape {new_shape} incompatible "
                             f"with inferred {self._shape}")
        self._shape = new_shape

    @property
    def grad_req(self):
        return self._grad_req

    @property
    def stype(self):
        """The storage type: ``'row_sparse'`` makes SGD and Adam update the
        parameter lazily (only the rows its gradient touches).  The values
        and the gradient are held densely either way."""
        return self._stype

    @grad_req.setter
    def grad_req(self, req):
        if req not in ("write", "add", "null"):
            raise ValueError(f"grad_req must be 'write', 'add' or 'null', got {req!r}")
        self._grad_req = req
        if self._data is not None:
            self._attach_grad()

    @property
    def grad_version(self):
        """Bumped each time a backward writes this parameter's gradient
        (``Trainer.step(ignore_stale_grad=True)`` reads it); -1 under
        ``grad_req="null"``."""
        return -1 if self._grad_req == "null" else self._grad_version

    def _attach_grad(self):
        """Give the current ``torch.nn.Parameter`` the flag and the hook
        that ``grad_req`` asks for; the gradient buffer starts anew."""
        if self._hook is not None:
            self._hook.remove()
            self._hook = None
        self._data.grad = None
        self._grad = None
        self._data.requires_grad_(self._grad_req != "null")
        if self._grad_req != "null":
            self._hook = self._data.register_post_accumulate_grad_hook(self._take_grad)

    @torch.no_grad()
    def _take_grad(self, tensor):
        """After PyTorch accumulates a backward's gradient into ``.grad``:
        move it into the buffer by ``grad_req`` and clear ``.grad``."""
        g, tensor.grad = tensor.grad, None
        if self._grad is None:
            self._grad = g
        elif self._grad_req == "add":
            self._grad.add_(g)
        else:
            self._grad.copy_(g)
        self._grad_version += 1
        if autograd._ready_hooks:
            autograd._grad_ready(tensor)

    def initialize(self, init=None, ctx=None, default_init=None, force_reinit=False):
        """Allocate and initialize on ``ctx`` (default: the current context,
        ``gpu(0)`` unless a ``with ctx:`` says otherwise).  The device is
        resolved here, so asking for a card that is not there raises now,
        even when the shape is still deferred."""
        if default_init is None:
            default_init = _init_mod.Uniform()
        if self._data is not None and not force_reinit:
            return
        device = _resolve_device(ctx)
        if not _shape_is_known(self._shape):
            if self.allow_deferred_init:
                self._deferred_init = (init, device, default_init)
                return
            raise ValueError(
                f"Cannot initialize Parameter {self.name} because it has invalid "
                f"shape {self._shape}; pass concrete shapes or run a forward pass")
        self._finish_init(init, device, default_init)

    def _finish_init(self, init, device, default_init):
        data = torch.zeros(self._shape, dtype=as_torch_dtype(self.dtype), device=device)
        initializer = _init_mod.create(init or self.init or default_init)
        initializer(_init_mod.InitDesc(self.name), data)
        self._data = torch.nn.Parameter(data)
        self._attach_grad()
        self._deferred_init = None

    def _finish_deferred_init(self, inferred_shape=None):
        if self._deferred_init is None:
            return
        if inferred_shape is not None:
            self.shape = inferred_shape
        if not _shape_is_known(self._shape):
            raise DeferredInitializationError(
                f"Parameter {self.name} has unknown shape {self._shape} and deferred "
                "initialization could not infer it")
        self._finish_init(*self._deferred_init)

    def data(self, ctx=None):
        self._check_initialized()
        return self._data

    def grad(self, ctx=None):
        """The gradient buffer (MXNet semantics: see the module doc)."""
        self._check_initialized()
        if self._grad_req == "null":
            raise RuntimeError(f"Cannot get gradient array for Parameter {self.name} "
                               "because grad_req='null'")
        if self._grad is None:
            self._grad = torch.zeros_like(self._data, memory_format=torch.contiguous_format)
        return self._grad

    def list_grad(self):
        return [self.grad()]

    def list_data(self):
        return [self.data()]

    def list_ctx(self):
        """The one context the parameter lives on."""
        self._check_initialized()
        from ..context import cpu, gpu

        dev = self._data.device
        return [gpu(dev.index or 0) if dev.type == "cuda" else cpu()]

    def reset_ctx(self, ctx):
        """Move the parameter to ``ctx`` (the first of a list): a new
        ``torch.nn.Parameter`` there, its gradient buffer anew."""
        self._check_initialized()
        device = _resolve_device(ctx)
        self._data = torch.nn.Parameter(self._data.detach().to(device))
        self._attach_grad()

    def var(self):
        """A Symbol variable of this parameter's name, shape and dtype."""
        from .. import symbol as _sym

        return _sym.var(self.name, shape=self._shape, dtype=self.dtype)

    def zero_grad(self):
        if self._grad is not None:
            self._grad.zero_()

    def _check_initialized(self):
        if self._data is not None:
            return
        if self._deferred_init is not None:
            raise DeferredInitializationError(
                f"Parameter {self.name} has not been initialized yet because "
                "initialization was deferred. Actual initialization happens during "
                "the first forward pass.")
        raise RuntimeError(
            f"Parameter {self.name} has not been initialized. You should initialize "
            "parameters with Block.initialize() before using them.")

    def set_data(self, data):
        """Copy ``data`` (NDArray, tensor or numpy array) in, cast to this
        parameter's dtype.  An uninitialized parameter adopts the shape and
        is materialized first, on its deferred device or the current one."""
        data = getattr(data, "_data", data)  # an NDArray's tensor
        src = data if isinstance(data, torch.Tensor) else torch.from_numpy(_np.array(data))
        if self._data is None:
            self.shape = src.shape
            init = self._deferred_init or (None, _resolve_device(None), None)
            self._finish_init(_init_mod.Zero(), init[1], None)
        if tuple(src.shape) != tuple(self._data.shape):
            raise ValueError(f"Failed to update param {self.name}: shape mismatch, "
                             f"expected {tuple(self._data.shape)}, got {tuple(src.shape)}")
        with torch.no_grad():
            self._data.copy_(src.to(device=self._data.device, dtype=self._data.dtype))

    def cast(self, dtype):
        """A new ``torch.nn.Parameter`` of ``dtype`` and a new (zero)
        gradient: hold Parameters, not the tensors of ``data()``, across a
        cast."""
        self.dtype = dtype_name(dtype)
        if self._data is not None:
            self._data = torch.nn.Parameter(self._data.detach().to(as_torch_dtype(dtype)))
            self._attach_grad()

    def __repr__(self):
        return f"Parameter {self.name} (shape={self._shape}, dtype={self.dtype})"


class Constant(Parameter):
    """A parameter that holds a constant value and takes no gradient
    (parity: ``gluon.Constant``); initializing it writes the value."""

    def __init__(self, name, value):
        value = getattr(value, "_data", value)  # an NDArray's tensor
        if not isinstance(value, torch.Tensor):
            value = torch.from_numpy(_np.asarray(value, dtype="float32"))
        self.value = value

        class _Value(_init_mod.Initializer):
            def __call__(self, _, arr):
                with torch.no_grad():
                    arr.copy_(value)

            _init_weight = __call__

        super().__init__(name, grad_req="null", shape=tuple(value.shape),
                         dtype=dtype_name(value.dtype), init=_Value())


def _load_into(param, value, ctx):
    """Set ``param`` from a loaded tensor, materializing it on ``ctx`` first
    if it was never initialized."""
    if param._data is None and param._deferred_init is None:
        param.shape = tuple(value.shape)
        param.initialize(init=_init_mod.Zero(), ctx=ctx)
    param.set_data(value)


class ParameterDict:
    """Ordered name → Parameter mapping with prefix sharing."""

    def __init__(self, prefix="", shared=None):
        self._prefix = prefix
        self._params = {}
        self._shared = shared

    @property
    def prefix(self):
        return self._prefix

    def __repr__(self):
        lines = "\n".join(f"  {v}" for v in self._params.values())
        return f"ParameterDict '{self._prefix}' (\n{lines}\n)"

    def __getitem__(self, key):
        return self._params[key]

    def __iter__(self):
        return iter(self._params)

    def __len__(self):
        return len(self._params)

    def __contains__(self, key):
        return key in self._params

    def items(self):
        return self._params.items()

    def keys(self):
        return self._params.keys()

    def values(self):
        return self._params.values()

    def get(self, name, **kwargs):
        """Create-or-retrieve by suffix name (a shared dict is checked
        first)."""
        full = self._prefix + name
        param = self._params.get(full)
        if param is None and self._shared is not None and full in self._shared:
            param = self._params[full] = self._shared[full]
        if param is None:
            param = self._params[full] = Parameter(full, **kwargs)
        else:
            shape = kwargs.get("shape")
            if shape is not None:
                param.shape = (shape,) if isinstance(shape, int) else shape
            if kwargs.get("init") is not None and param.init is None:
                param.init = kwargs["init"]
        return param

    def get_constant(self, name, value=None):
        """The constant ``prefix + name``, made from ``value`` on first
        use (a shared dict is checked first)."""
        full = self._prefix + name
        param = self._params.get(full)
        if param is None and self._shared is not None and full in self._shared:
            param = self._params[full] = self._shared[full]
        if param is None:
            if value is None:
                raise KeyError(f"No constant named {full}")
            param = self._params[full] = Constant(full, value)
        return param

    def zero_grad(self):
        for v in self.values():
            v.zero_grad()

    def reset_ctx(self, ctx):
        for v in self.values():
            v.reset_ctx(ctx)

    def setattr(self, name, value):
        """Set an attribute (``grad_req``, ``lr_mult``...) on every
        parameter."""
        for v in self.values():
            setattr(v, name, value)

    def update(self, other):
        for k, v in other.items():
            if k in self._params and self._params[k] is not v:
                raise ValueError("Cannot update self with other because they have "
                                 f"different Parameters with the same name {k}")
            self._params[k] = v

    def initialize(self, init=None, ctx=None, verbose=False, force_reinit=False):
        """Initialize every parameter (the reference's parameters in its
        order; ``verbose`` changes no value)."""
        if init is None:
            init = _init_mod.Uniform()
        for v in self.values():
            v.initialize(None, ctx, init, force_reinit=force_reinit)

    def save(self, filename, strip_prefix=""):
        """Save every parameter's value under its name, less
        ``strip_prefix`` (``mx.nd.save``: ``.params`` or npz by the name)."""
        from ..ndarray.utils import save as nd_save

        arg_dict = {}
        for param in self.values():
            name = param.name
            if strip_prefix and name.startswith(strip_prefix):
                name = name[len(strip_prefix):]
            arg_dict[name] = param.data()
        nd_save(filename, arg_dict)

    def load(self, filename, ctx=None, allow_missing=False, ignore_extra=False,
             restore_prefix=""):
        """Set the parameters from a file of ``save`` (names prefixed with
        ``restore_prefix``); an uninitialized parameter is materialized on
        ``ctx`` (default: the current context)."""
        from ..ndarray.utils import _load_tensors

        loaded = _load_tensors(filename)
        if not isinstance(loaded, dict):
            raise IOError(f"{filename} holds a list of arrays without names, not parameters")
        loaded = {restore_prefix + k: v for k, v in loaded.items()}
        if not allow_missing:
            for name in self.keys():
                if name not in loaded:
                    raise IOError(f"Parameter {name} is missing in file {filename}")
        for name, v in loaded.items():
            if name not in self._params:
                if not ignore_extra:
                    raise IOError(f"Parameter {name} loaded from {filename} is not present "
                                  "in ParameterDict")
                continue
            _load_into(self[name], v, ctx)
