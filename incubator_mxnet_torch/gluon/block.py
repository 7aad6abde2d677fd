"""Gluon Block / HybridBlock as ``torch.nn.Module``s.

Counterpart of the JAX package's ``gluon/block.py``: the same name-scope
and prefix discipline (parameter names match the JAX package's up to the
global counters), ``collect_params``, the structural keys of
``_collect_params_with_prefix`` that ``save_parameters`` uses,
``initialize`` and ``cast``.  Child blocks are the module's submodules.
``hybridize`` records its flag and changes nothing: PyTorch runs eagerly,
and the port's kernels are launched the same way either way.

A Block runs its forward with PyTorch's grad mode on inside
``autograd.record()`` and off outside it, as MXNet records a network only
inside ``record()``; every child's ``__call__`` reads the same flag.
"""
from __future__ import annotations

import re
import threading

import torch

from .. import autograd
from ..base import DeferredInitializationError
from ..ops.registry import nd
from .parameter import ParameterDict

__all__ = ["Block", "HybridBlock"]

_tls = threading.local()


def _gen_prefix(hint):
    counters = getattr(_tls, "counters", None)
    if counters is None:
        counters = _tls.counters = {}
    idx = counters.get(hint, 0)
    counters[hint] = idx + 1
    return f"{hint}{idx}_"


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

    def initialize(self, init=None, ctx=None, force_reinit=False):
        """Initialize every parameter on ``ctx``; without one, on the current
        context (``gpu(0)``), which raises on a machine with no card."""
        self.collect_params().initialize(init, ctx, force_reinit)
        return self

    def cast(self, dtype):
        for _, child in self._child_blocks():
            child.cast(dtype)
        for param in self.params.values():
            param.cast(dtype)
        return self

    def hybridize(self, active=True, **kwargs):
        self._active = active
        for _, child in self._child_blocks():
            child.hybridize(active, **kwargs)
        return self

    def __call__(self, *args, **kwargs):
        with torch.set_grad_enabled(autograd.is_recording()):
            return super().__call__(*args, **kwargs)


class HybridBlock(Block):
    """A Block authored as ``hybrid_forward(F, x, *args, **params)``, with
    ``F`` the ``nd`` namespace and the parameters as keyword tensors."""

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

    def _shape_inference(self, x, *args):
        raise RuntimeError(
            f"{type(self).__name__} has deferred-init parameters but no "
            "shape-inference hook; initialize with concrete shapes")

    def hybrid_forward(self, F, x, *args, **kwargs):
        raise NotImplementedError
