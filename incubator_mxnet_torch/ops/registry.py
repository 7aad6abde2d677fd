"""Operator registry and the tensor namespaces ``nd`` / ``nd.contrib``.

Counterpart of the JAX package's ``ops/registry.py``.  An op is a plain
function on ``torch.Tensor``s; registering it makes it reachable by name
as ``nd.<name>`` (and ``nd.contrib.<name>``).  This ``nd`` is the ``F`` that
``HybridBlock.hybrid_forward`` receives: tensors in, tensors out.  The
user's ``mx.nd`` is the ``ndarray`` package, which reaches the same ops and
takes NDArrays too.  With ``amp.init()`` the lookup
returns the op wrapped in AMP's input casts (``amp/amp.py``).  ``nd.Custom``
resolves to ``operator.nd_custom``, whose gradient is the user's
``CustomOp.backward``; ``nd.contrib.foreach``, ``while_loop`` and ``cond``
to ``ops/control_flow.py``.  PyTorch runs eagerly, so the
JAX package's dispatch accelerators (the level-1 jit cache, ``engine.py``
bulking) have no counterpart here.
"""
from __future__ import annotations

import types

__all__ = ["Op", "register", "alias", "get_op", "list_ops", "resolve", "nd"]

_REGISTRY: dict[str, "Op"] = {}
_amp = None  # the AMP policy that amp.init() sets, or None


class Op:
    """A registered operator; ``alias`` files the same object under more
    names.  ``differentiable=False`` marks an op whose outputs carry no
    gradient (comparisons, indices, samplers): ``mx.nd`` runs it off the
    graph for NDArrays.  ``wrap_ndarray=False`` marks a raw op (the
    multi-tensor updates) whose list arguments ``mx.nd`` unwraps as they
    come."""

    __slots__ = ("name", "fn", "differentiable", "wrap_ndarray", "cacheable", "aliases")

    def __init__(self, name, fn, differentiable=True, wrap_ndarray=True, cacheable=True):
        self.name = name
        self.fn = fn
        self.differentiable = differentiable
        self.wrap_ndarray = wrap_ndarray
        self.cacheable = cacheable
        self.aliases = []

    def __call__(self, *args, **kwargs):
        return self.fn(*args, **kwargs)

    def __repr__(self):
        return f"<Op {self.name}>"


def register(name=None, differentiable=True, wrap_ndarray=True, cacheable=True):
    """Register ``fn`` as an operator.  ``cacheable=False`` keeps an op off
    the reference's eager dispatch caches (an op running a user's Python
    with side effects); the port dispatches every op eagerly and caches
    none, so each op already runs its body each call: the flag is kept on
    the Op and changes nothing else."""
    def deco(fn):
        opname = name or fn.__name__
        if opname in _REGISTRY:
            raise ValueError(f"op {opname!r} already registered")
        _REGISTRY[opname] = Op(opname, fn, differentiable, wrap_ndarray, bool(cacheable))
        return fn

    return deco


def alias(new_name, existing):
    op = get_op(existing)
    if new_name in _REGISTRY:
        raise ValueError(f"op {new_name!r} already registered")
    _REGISTRY[new_name] = op
    op.aliases.append(new_name)


def get_op(name):
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"operator {name!r} is not registered") from None


def list_ops():
    return sorted(_REGISTRY)


def resolve(op):
    """``op.fn``, or under ``amp.init()`` the function that casts its
    inputs first: what ``nd.<name>`` calls."""
    return op.fn if _amp is None else _amp.wrap(op)


class _Namespace(types.ModuleType):
    """``nd`` and ``nd.contrib``: attribute access resolves registered ops.
    ``nd.contrib`` also finds ops registered under a ``contrib_`` prefix."""

    def __init__(self, name, prefixes):
        super().__init__(name)
        self._prefixes = prefixes

    def __getattr__(self, name):
        if name.startswith("__"):
            raise AttributeError(name)
        if name == "Custom":  # the user's backward, not an op of the registry
            from ..operator import nd_custom
            return nd_custom
        if "contrib_" in self._prefixes:
            from . import control_flow  # callables, not arrays: not ops of the registry
            if name in control_flow.__all__:
                return getattr(control_flow, name)
        for p in self._prefixes:
            op = _REGISTRY.get(p + name)
            if op is not None:
                return resolve(op)
        raise AttributeError(f"{self.__name__} has no op {name!r}")

    def __dir__(self):
        return list_ops()


nd = _Namespace("incubator_mxnet_torch.nd", ("",))
nd.contrib = _Namespace("incubator_mxnet_torch.nd.contrib", ("contrib_", "_contrib_", ""))
