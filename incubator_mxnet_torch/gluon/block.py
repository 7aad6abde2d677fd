"""Gluon Block / HybridBlock as ``torch.nn.Module``s.

Counterpart of the JAX package's ``gluon/block.py``: the same name-scope
and prefix discipline (parameter names match the JAX package's up to the
global counters), ``collect_params``, the structural keys of
``_collect_params_with_prefix`` that ``save_parameters`` uses,
``initialize`` and ``cast``, and ``collect_aux_update`` for the running
statistics of BatchNorm.  Child blocks are the module's submodules.
``hybridize`` records its flag and changes nothing: PyTorch runs eagerly,
and the port's kernels are launched the same way either way.
``save_parameters``/``load_parameters`` write and read the structural keys
through ``mx.nd.save``/``load`` (``.params`` or npz), BatchNorm's running
statistics included.

A Block takes tensors or NDArrays under ``mx.nd``'s currency rule: when
any argument is an NDArray (nested tuples and lists searched), the forward
runs on their tensors and every tensor of its output comes back as an
NDArray; with tensors in, nothing changes (one scan of the arguments).

A Block runs its forward with PyTorch's grad mode on inside
``autograd.record()`` and off outside it, as MXNet records a network only
inside ``record()``; every child's ``__call__`` reads the same flag.

``register_forward_hook``/``register_forward_pre_hook`` and ``apply`` have
MXNet's semantics, not ``torch.nn.Module``'s: a hook gets ``(block,
args)`` or ``(block, args, output)`` as the caller passed and received
them (NDArrays under the currency rule), its return value is ignored, and
the registration returns a handle with ``detach()`` (and ``remove()``);
``apply(fn)`` calls ``fn`` on every child block and then on the block, and
returns the block.  A registration with PyTorch's keywords
(``prepend``, ``with_kwargs``...) goes to PyTorch's own hooks, so
PyTorch's machinery (``.to()``, ``_apply``) is untouched.

``HybridBlock.export(path, epoch)`` writes the parameters as the
reference's checkpoint (``{path}-{epoch:04d}.params``, keys ``arg:<name>``
and ``aux:<name>``) beside a ``{path}-symbol.json`` that records the
port's format and holds no graph, as the JAX package's records its own:
tracing a Block into a symbol graph is something neither package does; the
graph is built with ``mx.sym``.  :class:`SymbolBlock` runs such a graph as
a Block, its parameters named as the graph's variables.
"""
from __future__ import annotations

import contextlib
import functools
import json
import math
import re
import threading
from time import perf_counter as _perf

import torch

from .. import autograd
from .. import profiler as _profiler
from ..base import DeferredInitializationError
from ..ndarray.ndarray import _has_nd, _rewrap_nested, _unwrap_nested
from ..ops.registry import nd
from ..random import get_generator
from .parameter import ParameterDict, _load_into

__all__ = ["Block", "HybridBlock", "SymbolBlock", "block_method", "collect_aux_update",
           "name_scope"]

_tls = threading.local()


def _gen_prefix(hint):
    counters = getattr(_tls, "counters", None)
    if counters is None:
        counters = _tls.counters = {}
    idx = counters.get(hint, 0)
    counters[hint] = idx + 1
    return f"{hint}{idx}_"


@contextlib.contextmanager
def name_scope():
    """A fresh set of the global name counters for the blocks made inside
    (parity: ``gluon.block.name_scope``): the first Dense made in the scope
    is ``dense0_`` again; the counters outside resume on exit."""
    saved = getattr(_tls, "counters", None)
    _tls.counters = {}
    try:
        yield
    finally:
        _tls.counters = saved


class _HookHandle:
    """What ``register_forward_hook`` returns: ``detach()`` (MXNet's name)
    or ``remove()`` takes the hook off."""

    def __init__(self, hooks, hook):
        self._hooks, self._hook = hooks, hook

    def detach(self):
        if any(h is self._hook for h in self._hooks):
            self._hooks.remove(self._hook)

    remove = detach


def collect_aux_update(param, new_value):
    """Give an auxiliary parameter (BatchNorm's running statistics) a new
    value from a forward.  PyTorch runs eagerly, so the update is applied at
    once, in place (``set_data`` records no graph)."""
    param.set_data(new_value)


def _as_block_call(fn, args, kwargs):
    """``fn(*args, **kwargs)`` as a Block call runs: under the currency rule
    (NDArrays in, NDArrays out) and with grad mode on only inside
    ``autograd.record()``."""
    if _has_nd(args) or _has_nd(kwargs.values()):
        args = _unwrap_nested(args)
        kwargs = {k: _unwrap_nested(v) for k, v in kwargs.items()}
        return _rewrap_nested(_as_block_call(fn, args, kwargs))
    with torch.set_grad_enabled(autograd.is_recording()):
        return fn(*args, **kwargs)


def block_method(fn):
    """Decorate a Block method other than ``forward`` that users call
    directly (the Transformer's ``encode`` and ``decode``) so that it runs
    as a Block call does."""

    @functools.wraps(fn)
    def call(self, *args, **kwargs):
        return _as_block_call(functools.partial(fn, self), args, kwargs)

    return call


class _BlockScope:
    """Name-scope manager for Blocks: a child created inside a parent's
    ``name_scope()`` gets the parent's prefix plus its own."""

    _current = threading.local()

    def __init__(self, block):
        self._block = block
        self._counter = {}
        self._old_scope = None

    @staticmethod
    def create(prefix, params, hint):
        current = getattr(_BlockScope._current, "value", None)
        if current is None:
            if prefix is None:
                prefix = _gen_prefix(hint)
            params = ParameterDict(prefix) if params is None else ParameterDict(params.prefix, params)
            return prefix, params
        if prefix is None:
            idx = current._counter.get(hint, 0)
            current._counter[hint] = idx + 1
            prefix = f"{hint}{idx}_"
        if params is None:
            parent = current._block.params
            params = ParameterDict(parent.prefix + prefix, parent._shared)
        else:
            params = ParameterDict(params.prefix, params)
        return current._block.prefix + prefix, params

    def __enter__(self):
        if self._block._empty_prefix:
            return self
        self._old_scope = getattr(_BlockScope._current, "value", None)
        _BlockScope._current.value = self
        return self

    def __exit__(self, *exc):
        if self._block._empty_prefix:
            return
        _BlockScope._current.value = self._old_scope


class Block(torch.nn.Module):
    """Base building block (parity: ``gluon.Block``)."""

    def __init__(self, prefix=None, params=None):
        super().__init__()
        self._mx_pre_hooks, self._mx_hooks = [], []
        self._empty_prefix = prefix == ""
        self._prefix, self._params = _BlockScope.create(prefix, params, self._alias())
        self._name = self._prefix[:-1] if self._prefix.endswith("_") else self._prefix
        self._scope = _BlockScope(self)
        self._active = False

    def _alias(self):
        return type(self).__name__.lower()

    @property
    def prefix(self):
        return self._prefix

    @property
    def name(self):
        return self._name

    def name_scope(self):
        return self._scope

    @property
    def params(self):
        return self._params

    def register_child(self, block, name=None):
        """Add a child block; one already held under an attribute name
        keeps that name."""
        if any(block is m for m in self._modules.values()):
            return
        self.add_module(name or str(len(self._modules)), block)

    def _child_blocks(self):
        return [(n, m) for n, m in self._modules.items() if isinstance(m, Block)]

    def collect_params(self, select=None):
        """All Parameters of self and children, optionally regex-filtered."""
        ret = ParameterDict(self._params.prefix)
        if select is None:
            ret.update(self.params)
        else:
            pattern = re.compile(select)
            ret.update({k: v for k, v in self.params.items() if pattern.match(k)})
        for _, child in self._child_blocks():
            ret.update(child.collect_params(select=select))
        return ret

    def _collect_params_with_prefix(self, prefix=""):
        """Parameters keyed by their structural path
        (``bert.encoder.layer0.attention.qkv.weight``), independent of the
        global name-prefix counters."""
        if prefix:
            prefix += "."
        ret = {}
        for name, param in self.params.items():
            pre = self._params.prefix
            ret[prefix + (name[len(pre):] if name.startswith(pre) else name)] = param
        for cname, child in self._child_blocks():
            ret.update(child._collect_params_with_prefix(prefix + cname))
        return ret

    def initialize(self, init=None, ctx=None, verbose=False, force_reinit=False):
        """Initialize every parameter on ``ctx``; without one, on the current
        context (``gpu(0)``), which raises on a machine with no card.  The
        reference's parameters in its order: ``verbose`` is passed along and
        changes no value."""
        self.collect_params().initialize(init, ctx, verbose, force_reinit)
        return self

    def cast(self, dtype):
        for _, child in self._child_blocks():
            child.cast(dtype)
        for param in self.params.values():
            param.cast(dtype)
        return self

    def hybridize(self, active=True, **kwargs):
        """Record the flag on this block and every child (the reference's
        parameters; PyTorch runs eagerly either way)."""
        self._active = active
        for _, child in self._child_blocks():
            child.hybridize(active, **kwargs)
        return self

    def save_parameters(self, filename, deduplicate=False):
        """Save every parameter's value by its structural key (``.params``
        or npz by the name; ``deduplicate`` is accepted and changes
        nothing, as in the JAX package)."""
        from ..ndarray.utils import save as nd_save

        nd_save(filename, {k: v.data() for k, v in self._collect_params_with_prefix().items()})

    save_params = save_parameters

    def load_parameters(self, filename, ctx=None, allow_missing=False, ignore_extra=False,
                        cast_dtype=False, dtype_source="current"):
        """Set the parameters from a file of ``save_parameters`` (of either
        package).  A parameter never initialized is materialized on ``ctx``
        (default: the current context); values are cast to each
        parameter's dtype, or with ``cast_dtype`` and
        ``dtype_source="saved"`` the parameter takes the saved dtype."""
        from ..ndarray.utils import _load_tensors

        loaded = _load_tensors(filename)
        if not isinstance(loaded, dict):
            raise IOError(f"{filename} holds a list of arrays without names, not parameters")
        params = self._collect_params_with_prefix()
        if not allow_missing:
            for name in params:
                if name not in loaded:
                    raise IOError(f"Parameter {name} missing in {filename}")
        for name, v in loaded.items():
            if name not in params:
                if not ignore_extra:
                    raise IOError(f"Parameter {name} in {filename} not found in Block")
                continue
            if cast_dtype and dtype_source == "saved":
                params[name].cast(v.dtype)
            _load_into(params[name], v, ctx)

    def load_params(self, filename, ctx=None, **kwargs):
        self.load_parameters(filename, ctx, **kwargs)

    def register_forward_pre_hook(self, hook, **torch_kwargs):
        """``hook(block, args)`` before each call, ``args`` as passed; returns
        a handle with ``detach()``.  PyTorch's keywords register a PyTorch
        pre-hook instead."""
        if torch_kwargs:
            return super().register_forward_pre_hook(hook, **torch_kwargs)
        self._mx_pre_hooks.append(hook)
        return _HookHandle(self._mx_pre_hooks, hook)

    def register_forward_hook(self, hook, **torch_kwargs):
        """``hook(block, args, output)`` after each call, as the caller
        passes and receives them; returns a handle with ``detach()``.
        PyTorch's keywords register a PyTorch hook instead."""
        if torch_kwargs:
            return super().register_forward_hook(hook, **torch_kwargs)
        self._mx_hooks.append(hook)
        return _HookHandle(self._mx_hooks, hook)

    def apply(self, fn):
        """``fn(block)`` on every child block (each applying it to its own
        children first), then on this block; returns this block."""
        for _, child in self._child_blocks():
            child.apply(fn)
        fn(self)
        return self

    def summary(self, *inputs):
        """Print one row a child block (name, type, output shape, parameters)
        from one forward of ``inputs``."""
        rows, handles = [], []
        for name, child in self._child_blocks():
            def hook(b, _, out, name=name):
                o = out[0] if isinstance(out, (list, tuple)) else out
                n = sum(math.prod(p.shape) for p in b.params.values()
                        if p.shape and all(d > 0 for d in p.shape))
                rows.append((name or b.name, type(b).__name__, tuple(getattr(o, "shape", ())),
                             n))
            handles.append(child.register_forward_hook(hook))
        try:
            self(*inputs)
        finally:
            for h in handles:
                h.detach()
        header = f"{'Layer':<28}{'Type':<20}{'Output shape':<24}{'Params':<12}"
        print(header)
        print("-" * len(header))
        for r in rows:
            print(f"{r[0]:<28}{r[1]:<20}{str(r[2]):<24}{r[3]:<12}")

    def __call__(self, *args, **kwargs):
        for hook in list(self._mx_pre_hooks):
            hook(self, args)
        out = _as_block_call(super().__call__, args, kwargs)
        for hook in list(self._mx_hooks):
            hook(self, args, out)
        return out


# the format tag of export's symbol file (the JAX package writes its own)
EXPORT_FORMAT = "torch-eager"


class HybridBlock(Block):
    """A Block authored as ``hybrid_forward(F, x, *args, **params)``, with
    ``F`` the ``nd`` namespace and the parameters as keyword tensors."""

    _hybrid_called = False  # a forward ran since hybridize(): export may write

    def hybridize(self, active=True, static_alloc=False, static_shape=False, **kwargs):
        """The reference's ``HybridBlock.hybridize`` parameters, in its
        order: ``static_alloc`` and ``static_shape`` are recorded in
        ``_flags`` and passed to the children; they change nothing here,
        where every call runs eagerly on the port's kernels."""
        self._flags = dict(static_alloc=static_alloc, static_shape=static_shape, **kwargs)
        self._hybrid_called = False
        return super().hybridize(active, static_alloc=static_alloc, static_shape=static_shape,
                                 **kwargs)

    def __call__(self, *args, **kwargs):
        if self._active and not kwargs:
            self._hybrid_called = True
        return super().__call__(*args, **kwargs)

    def cast(self, dtype):
        self._hybrid_called = False
        return super().cast(dtype)

    def export(self, path, epoch=0, remove_amp_cast=True):
        """Write ``{path}-{epoch:04d}.params`` (every parameter by its name,
        ``aux:`` for ``grad_req='null'``, else ``arg:``, in name order: what
        ``predictor.load_checkpoint``, ``Predictor``, ``InferenceServer``
        and :class:`SymbolBlock` load) and ``{path}-symbol.json`` (the
        format record; no graph).  Refused before a forward after
        ``hybridize()``, as the reference refuses.  Returns both paths."""
        if not self._hybrid_called:
            raise RuntimeError("Please first call block.hybridize() and then run forward with "
                               "this block at least once before calling export.")
        from ..ndarray.utils import save as nd_save

        nd_save(f"{path}-{epoch:04d}.params",
                {("aux:" if p.grad_req == "null" else "arg:") + p.name: p.data()
                 for p in sorted(self.collect_params().values(), key=lambda p: p.name)})
        with open(f"{path}-symbol.json", "w") as f:
            f.write(json.dumps({"format": EXPORT_FORMAT,
                                "note": "no graph: build it with mx.sym"}))
        return f"{path}-symbol.json", f"{path}-{epoch:04d}.params"

    def forward(self, x, *args):
        def gather():
            pre = self._params.prefix
            return {(n[len(pre):] if n.startswith(pre) else n): p.data()
                    for n, p in self.params.items()}

        try:
            params = gather()
        except DeferredInitializationError:
            self._shape_inference(x, *args)
            params = gather()
        return self.hybrid_forward(nd, x, *args, **params)

    def infer_shape(self, *args):
        """Finish the deferred parameters' shapes from ``args``: one forward
        with recording off (the JAX package's method of this name leaves
        them to the first call)."""
        with autograd.pause():
            self(*args)

    def optimize_for(self, x, *args, backend=None, **kwargs):
        """``hybridize()`` and one forward, as the JAX package's shim does:
        PyTorch runs eagerly and there is no subgraph backend to pick."""
        self.hybridize()
        self(x, *args)

    def _shape_inference(self, x, *args):
        raise RuntimeError(
            f"{type(self).__name__} has deferred-init parameters but no "
            "shape-inference hook; initialize with concrete shapes")

    def hybrid_forward(self, F, x, *args, **kwargs):
        raise NotImplementedError


class SymbolBlock(HybridBlock):
    """A Block over a Symbol graph (parity: ``gluon.SymbolBlock``).

    ``outputs`` is the graph (a Symbol, or a list grouped into one),
    ``inputs`` its input variable(s).  Every other argument of the graph is
    a Parameter, and every auxiliary state one with ``grad_req='null'``,
    named as the variable is (``params`` shares an existing
    ``ParameterDict``), so a checkpoint of ``HybridBlock.export`` or of
    ``mx.nd.save`` (``arg:``/``aux:`` keys, or bare names) loads by name
    (:meth:`load_parameters`).  A call runs the graph through the
    executor's plan, one plan a signature of its inputs and parameters
    (shapes and dtypes), whose build reports to ``profiler.record_compile``
    under ``gluon.symbol_block``.  Under ``autograd.record()`` the walk
    records as any Block does, so gradients reach the Parameters, and a
    training forward moves BatchNorm's running statistics."""

    def __init__(self, outputs, inputs, params=None):
        super().__init__(prefix="", params=params)
        from .. import symbol as _sym

        if isinstance(outputs, (list, tuple)):
            outputs = outputs[0] if len(outputs) == 1 else _sym.Group(list(outputs))
        inputs = list(inputs) if isinstance(inputs, (list, tuple)) else [inputs]
        self._symbol = outputs
        self._input_names = [i.name for i in inputs]
        unknown = [n for n in self._input_names if n not in outputs.list_inputs()]
        if unknown:
            raise ValueError(f"SymbolBlock: inputs {unknown} are not variables of the graph")
        for name in outputs.list_arguments():
            if name not in self._input_names:
                self.params.get(name, allow_deferred_init=True)
        for name in outputs.list_auxiliary_states():
            self.params.get(name, grad_req="null", allow_deferred_init=True)
        self._plans = {}

    def load_parameters(self, filename, ctx=None, allow_missing=False, ignore_extra=False,
                        cast_dtype=False, dtype_source="current"):
        """Set the parameters from a checkpoint, by name: ``arg:``/``aux:``
        keys stripped by the rule of ``predictor.load_checkpoint``.  A
        parameter never initialized is materialized on ``ctx``; with
        ``cast_dtype`` and ``dtype_source="saved"`` it takes the saved
        dtype."""
        from ..ndarray.utils import _load_tensors
        from ..predictor import _split_param_key

        loaded = _load_tensors(filename)
        if not isinstance(loaded, dict):
            raise IOError(f"{filename} holds a list of arrays without names, not parameters")
        values = {_split_param_key(k)[1]: v for k, v in loaded.items()}
        if not allow_missing:
            missing = [n for n in self.params.keys() if n not in values]
            if missing:
                raise IOError(f"Parameters {missing[:4]} missing in {filename}")
        for name, v in values.items():
            if name not in self.params:
                if not ignore_extra and name not in self._input_names:
                    raise IOError(f"Parameter {name} in {filename} is not a variable of the "
                                  "graph")
                continue
            if cast_dtype and dtype_source == "saved":
                self.params[name].cast(v.dtype)
            _load_into(self.params[name], v, ctx)

    load_params = load_parameters

    def forward(self, *args):
        if len(args) != len(self._input_names):
            raise ValueError(f"SymbolBlock takes {len(self._input_names)} inputs "
                             f"{self._input_names}, got {len(args)}")
        arrays = dict(zip(self._input_names, args))
        if any(p._data is None for p in self.params.values()):
            self._finish_deferred(arrays)
        for name, p in self.params.items():
            arrays[name] = p.data()
        training = autograd.is_training()
        # the graph's Dropout and RNN draw from the port's generator
        key = get_generator(args[0].device) if training else None
        sig = (tuple(sorted((k, tuple(v.shape), v.dtype) for k, v in arrays.items())), training)
        plan = self._plans.get(sig)
        if plan is None:
            from ..executor import _Plan
            from ..ndarray.ndarray import _ctx_of

            tb = _perf()
            plan = _Plan(self._symbol, _ctx_of(args[0].device), training)
            outs, updates = plan.run(arrays, key)
            self._plans[sig] = plan
            _profiler.record_compile(
                "gluon.symbol_block",
                {"__program__": "fwd_train" if training else "fwd",
                 **{k: _profiler.sig_array(arrays[k]) for k in sorted(arrays)}},
                (_perf() - tb) * 1e3)
        else:
            outs, updates = plan.run(arrays, key)
        for name, new in updates.items():
            collect_aux_update(self.params[name], new.detach())
        return outs[0] if len(outs) == 1 else list(outs)

    def _finish_deferred(self, arrays):
        """Deferred parameters take the shapes the graph infers from the
        inputs'."""
        arg_shapes, _, aux_shapes = self._symbol.infer_shape(
            **{k: tuple(v.shape) for k, v in arrays.items()})
        names = self._symbol.list_arguments() + self._symbol.list_auxiliary_states()
        for name, shape in zip(names, arg_shapes + aux_shapes):
            p = self.params._params.get(name) if name in self.params else None
            if p is not None and p._data is None and shape is not None:
                p._finish_deferred_init(tuple(shape))
