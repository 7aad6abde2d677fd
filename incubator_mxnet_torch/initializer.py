"""Weight initializers (parity: ``mx.init``), drawing from the port's
explicit per-device generators.

Counterpart of the JAX package's ``initializer.py`` with the same
name-suffix routing: an Initializer is called with a descriptor (the
parameter name) and fills the tensor in place; ``*weight`` goes to the
initializer's own rule, ``*bias``/``*beta`` and the running ``*mean`` to
zero, ``*gamma`` and the running ``*var`` to one.
Random draws are fp32 on the tensor's device, from that device's
generator, then cast (a bf16 parameter gets the rounded fp32 draw);
``Orthogonal`` draws its matrix the same way (the JAX package draws it from
numpy's global generator), so only its distribution is the reference's.
``Initializer.dumps`` gives the reference's ``[name, kwargs]`` JSON, which
an ``InitDesc``'s ``__init__`` attribute routes back to an initializer.
"""
from __future__ import annotations

import json
import math
import re

import numpy as np
import torch

from . import random as _random

__all__ = ["InitDesc", "Initializer", "Zero", "One", "Constant", "Uniform", "Normal",
           "Orthogonal", "Xavier", "MSRAPrelu", "Bilinear", "LSTMBias", "Load", "Mixed",
           "register", "create"]

_REGISTRY = {}
_ALIASES = {"zeros": "zero", "ones": "one", "gaussian": "normal"}


def register(klass):
    _REGISTRY[klass.__name__.lower()] = klass
    return klass


def create(initializer, **kwargs):
    if initializer is None or isinstance(initializer, Initializer):
        return initializer
    if isinstance(initializer, str):
        name = initializer.lower()
        return _REGISTRY[_ALIASES.get(name, name)](**kwargs)
    raise TypeError(initializer)


class InitDesc(str):
    """Parameter descriptor: the parameter's name, as a str, with optional
    ``attrs`` (an ``__init__`` attribute names the initializer to use)."""

    def __new__(cls, name, attrs=None, global_init=None):
        obj = super().__new__(cls, name)
        obj.attrs = attrs or {}
        obj.global_init = global_init
        return obj


class Initializer:
    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def dumps(self):
        """``[name, kwargs]`` as JSON (the reference's form)."""
        return json.dumps([self.__class__.__name__.lower(), getattr(self, "_kwargs", {})])

    def __repr__(self):
        return f"{self.__class__.__name__}({getattr(self, '_kwargs', {})})"

    def __call__(self, desc, arr):
        name = str(desc)
        init = getattr(desc, "attrs", {}).get("__init__", "")
        with torch.no_grad():
            if init:
                kind, kwargs = json.loads(init)
                create(kind, **kwargs)._init_weight(desc, arr)
            elif name.endswith("weight"):
                self._init_weight(desc, arr)
            elif name.endswith("bias") or name.endswith("beta"):
                arr.fill_(0.0)
            elif name.endswith("gamma"):
                arr.fill_(1.0)
            elif name.endswith("mean"):
                arr.fill_(0.0)
            elif name.endswith("var"):
                arr.fill_(1.0)
            else:
                self._init_weight(desc, arr)

    def _init_weight(self, desc, arr):
        raise NotImplementedError


@register
class Zero(Initializer):
    def _init_weight(self, _, arr):
        arr.fill_(0.0)


@register
class One(Initializer):
    def _init_weight(self, _, arr):
        arr.fill_(1.0)


@register
class Constant(Initializer):
    def __init__(self, value=0.0):
        super().__init__(value=value)
        self.value = value

    def _init_weight(self, _, arr):
        arr.fill_(self.value)


@register
class Uniform(Initializer):
    def __init__(self, scale=0.07):
        super().__init__(scale=scale)
        self.scale = scale

    def _init_weight(self, _, arr):
        arr.copy_(_random._uniform(-self.scale, self.scale, arr.shape, arr.device))


@register
class Normal(Initializer):
    def __init__(self, sigma=0.01):
        super().__init__(sigma=sigma)
        self.sigma = sigma

    def _init_weight(self, _, arr):
        arr.copy_(_random._normal(0.0, self.sigma, arr.shape, arr.device))


@register
class Xavier(Initializer):
    """Parity: ``mx.init.Xavier`` (uniform/gaussian, avg/in/out factor)."""

    def __init__(self, rnd_type="uniform", factor_type="avg", magnitude=3):
        super().__init__(rnd_type=rnd_type, factor_type=factor_type, magnitude=magnitude)
        self.rnd_type = rnd_type
        self.factor_type = factor_type
        self.magnitude = float(magnitude)

    def _init_weight(self, desc, arr):
        shape = tuple(arr.shape)
        if len(shape) < 2:
            raise ValueError(f"Xavier requires ndim>=2, got {shape} for {desc}")
        hw = float(math.prod(shape[2:])) if len(shape) > 2 else 1.0
        fan_in, fan_out = shape[1] * hw, shape[0] * hw
        factor = {"avg": (fan_in + fan_out) / 2.0, "in": fan_in,
                  "out": fan_out}[self.factor_type]
        scale = math.sqrt(self.magnitude / factor)
        if self.rnd_type == "uniform":
            arr.copy_(_random._uniform(-scale, scale, shape, arr.device))
        else:
            arr.copy_(_random._normal(0.0, scale, shape, arr.device))


@register
class Orthogonal(Initializer):
    """``scale`` times the orthonormal factor of the SVD of a uniform (or
    normal) draw, reshaped to the weight (rows = its first dimension)."""

    def __init__(self, scale=1.414, rand_type="uniform"):
        super().__init__(scale=scale, rand_type=rand_type)
        self.scale = scale
        self.rand_type = rand_type

    def _init_weight(self, _, arr):
        rows = arr.shape[0]
        cols = math.prod(arr.shape[1:]) if arr.dim() > 1 else 1
        if self.rand_type == "uniform":
            tmp = _random._uniform(-1.0, 1.0, (rows, cols), arr.device)
        else:
            tmp = _random._normal(0.0, 1.0, (rows, cols), arr.device)
        u, _, v = torch.linalg.svd(tmp.double(), full_matrices=False)
        q = u if tuple(u.shape) == (rows, cols) else v
        arr.copy_((self.scale * q).reshape(arr.shape))


@register
class MSRAPrelu(Xavier):
    """Xavier's gaussian with magnitude 2 / (1 + slope²) (He et al.)."""

    def __init__(self, factor_type="avg", slope=0.25):
        super().__init__("gaussian", factor_type, 2.0 / (1 + slope ** 2))
        self._kwargs = {"factor_type": factor_type, "slope": slope}


@register
class Bilinear(Initializer):
    """The bilinear upsampling kernel over the last two axes."""

    def _init_weight(self, _, arr):
        shape = tuple(arr.shape)
        f = np.ceil(shape[3] / 2.0)
        c = (2 * f - 1 - f % 2) / (2.0 * f)
        i = np.arange(math.prod(shape))
        x, y = i % shape[3], (i // shape[3]) % shape[2]
        weight = ((1 - np.abs(x / f - c)) * (1 - np.abs(y / f - c))).astype(np.float32)
        arr.copy_(torch.from_numpy(weight.reshape(shape)))


@register
class LSTMBias(Initializer):
    """The forget gate's quarter of the bias set to ``forget_bias``, the
    rest 0."""

    def __init__(self, forget_bias=1.0):
        super().__init__(forget_bias=forget_bias)
        self.forget_bias = forget_bias

    def _init_weight(self, desc, arr):
        n = arr.shape[0] // 4
        arr.fill_(0.0)
        arr[n:2 * n] = self.forget_bias

    def __call__(self, desc, arr):
        with torch.no_grad():
            self._init_weight(desc, arr)


def _as_tensor(x):
    x = getattr(x, "_data", x)  # an NDArray's tensor
    return x if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x))


@register
class Load:
    """Initialize from a dict of arrays by name (also ``arg:``/``aux:``
    names), else with ``default_init``."""

    def __init__(self, param, default_init=None, verbose=False):
        self.param = param
        self.default_init = default_init
        self.verbose = verbose

    def __call__(self, name, arr):
        name = str(name)
        for key in (name, "arg:" + name, "aux:" + name):
            if key in self.param:
                with torch.no_grad():
                    arr.copy_(_as_tensor(self.param[key]).reshape(arr.shape))
                return
        if self.default_init is None:
            raise ValueError(f"no init for {name}")
        self.default_init(InitDesc(name), arr)


@register
class Mixed:
    """The first initializer whose pattern matches the name (``re.match``)."""

    def __init__(self, patterns, initializers):
        self.map = [(re.compile(p), i) for p, i in zip(patterns, initializers)]

    def __call__(self, name, arr):
        for prog, init in self.map:
            if prog.match(str(name)):
                init(InitDesc(str(name)), arr)
                return
        raise ValueError(f"parameter {name} did not match any pattern")
