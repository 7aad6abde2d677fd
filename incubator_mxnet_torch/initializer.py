"""Weight initializers (parity: ``mx.init``), drawing from the port's
explicit per-device generators.

Counterpart of the JAX package's ``initializer.py`` with the same
name-suffix routing: an Initializer is called with a descriptor (the
parameter name) and fills the tensor in place; ``*weight`` goes to the
initializer's own rule, ``*bias``/``*beta`` and the running ``*mean`` to
zero, ``*gamma`` and the running ``*var`` to one.
Random draws are fp32 on the tensor's device, from that device's
generator, then cast (a bf16 parameter gets the rounded fp32 draw).
"""
from __future__ import annotations

import math

import torch

from . import random as _random

__all__ = ["InitDesc", "Initializer", "Zero", "One", "Constant", "Uniform", "Normal",
           "Xavier", "register", "create"]

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
    """Parameter descriptor: the parameter's name, as a str."""


class Initializer:
    def __call__(self, desc, arr):
        name = str(desc)
        with torch.no_grad():
            if name.endswith("weight"):
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
        self.value = value

    def _init_weight(self, _, arr):
        arr.fill_(self.value)


@register
class Uniform(Initializer):
    def __init__(self, scale=0.07):
        self.scale = scale

    def _init_weight(self, _, arr):
        arr.copy_(_random._uniform(-self.scale, self.scale, arr.shape, arr.device))


@register
class Normal(Initializer):
    def __init__(self, sigma=0.01):
        self.sigma = sigma

    def _init_weight(self, _, arr):
        arr.copy_(_random._normal(0.0, self.sigma, arr.shape, arr.device))


@register
class Xavier(Initializer):
    """Parity: ``mx.init.Xavier`` (uniform/gaussian, avg/in/out factor)."""

    def __init__(self, rnd_type="uniform", factor_type="avg", magnitude=3):
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
