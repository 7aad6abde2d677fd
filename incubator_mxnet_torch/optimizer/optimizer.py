"""Optimizer registry, the ``Optimizer`` base, SGD, Adam and ``Updater``.

Counterpart of the JAX package's ``optimizer/optimizer.py`` (MXNet's
``mx.optimizer``): the registry, lr/wd multipliers, per-index update counts
(Adam's ``t``), and ``multi_precision`` fp32 master weights for 16-bit
parameters.  Updates call ``ops/optimizer_ops.py`` and change the weight
and the state tensors in place.  ``aggregate_num`` caps the parameters of
one fused group update (``optimizer/fused.py``, the Trainer's path).  An
optimizer keys its state by parameter index; the caller hands it the
current weight tensor at every update.
"""
from __future__ import annotations

import math
import os
import pickle

import torch

from ..ops import optimizer_ops as K

__all__ = ["Optimizer", "SGD", "Adam", "Updater", "get_updater", "create", "register"]

_REGISTRY = {}


def register(klass):
    _REGISTRY[klass.__name__.lower()] = klass
    return klass


def _default_aggregate_num():
    """The fused-update group cap from ``MXNET_OPTIMIZER_AGGREGATION``, read
    as the JAX package reads it: 0/off/false/no/none keeps the per-tensor
    loop, unset/on/true/yes/auto means 256, an integer caps the parameters
    of one group update (anything else means 256)."""
    v = os.environ.get("MXNET_OPTIMIZER_AGGREGATION", "").strip().lower()
    if v in ("0", "off", "false", "no", "none"):
        return 0
    if v in ("", "on", "true", "yes", "auto"):
        return 256
    try:
        return max(0, int(v))
    except ValueError:
        return 256


def create(name, **kwargs):
    if isinstance(name, Optimizer):
        return name
    try:
        return _REGISTRY[name.lower()](**kwargs)
    except KeyError:
        raise ValueError(f"unknown optimizer {name!r}; registered: {sorted(_REGISTRY)}") from None


class Optimizer:
    """Base optimizer (parity: ``mx.optimizer.Optimizer``)."""

    def __init__(self, rescale_grad=1.0, param_idx2name=None, wd=0.0, clip_gradient=None,
                 learning_rate=0.01, lr_scheduler=None, begin_num_update=0,
                 multi_precision=False, param_dict=None, aggregate_num=None, **kwargs):
        # parameters of one fused group update (gluon.Trainer); <= 1 keeps the
        # per-tensor loop
        self.aggregate_num = (_default_aggregate_num() if aggregate_num is None
                              else max(0, int(aggregate_num)))
        self.rescale_grad = rescale_grad
        self.lr = learning_rate
        self.lr_scheduler = lr_scheduler
        if lr_scheduler is not None:
            self.lr_scheduler.base_lr = learning_rate
        self.wd = wd
        self.clip_gradient = clip_gradient if clip_gradient is not None else math.inf
        self.begin_num_update = begin_num_update
        self.num_update = begin_num_update
        self._index_update_count = {}
        self.multi_precision = multi_precision
        self.idx2name = dict(param_idx2name or {})
        self.param_dict = param_dict or {}
        self.lr_mult = {}
        self.wd_mult = {}

    # -- lr/wd ----------------------------------------------------------
    def set_learning_rate(self, lr):
        if self.lr_scheduler is not None:
            raise UserWarning("LRScheduler of the optimizer has already been defined.")
        self.lr = lr

    @property
    def learning_rate(self):
        if self.lr_scheduler is not None:
            return self.lr_scheduler(self.num_update)
        return self.lr

    def set_lr_mult(self, args_lr_mult):
        self.lr_mult = dict(args_lr_mult)

    def set_wd_mult(self, args_wd_mult):
        """No weight decay on names other than ``*_weight``/``*_gamma``
        unless given, as in MXNet."""
        self.wd_mult = {n: 0.0 for n in self.idx2name.values()
                        if not (n.endswith("_weight") or n.endswith("_gamma"))}
        self.wd_mult.update(args_wd_mult)

    def _update_count(self, index):
        if index not in self._index_update_count:
            self._index_update_count[index] = self.begin_num_update
        self._index_update_count[index] += 1
        self.num_update = max(self._index_update_count[index], self.num_update)

    def _mult(self, index, attr, table):
        param = self.param_dict.get(index)
        if param is not None:
            return getattr(param, attr, 1.0)
        if index in table:
            return table[index]
        if index in self.idx2name:
            return table.get(self.idx2name[index], 1.0)
        return 1.0

    def _get_lr(self, index):
        return self.learning_rate * self._mult(index, "lr_mult", self.lr_mult)

    def _get_wd(self, index):
        return self.wd * self._mult(index, "wd_mult", self.wd_mult)

    # -- state ----------------------------------------------------------
    def create_state(self, index, weight):
        return None

    def _use_mp(self, weight):
        return self.multi_precision and weight.dtype in (torch.float16, torch.bfloat16)

    def create_state_multi_precision(self, index, weight):
        """For a 16-bit weight under ``multi_precision``: ``(state, w32)``
        with ``w32`` an fp32 copy of the weight; else ``create_state``."""
        if self._use_mp(weight):
            w32 = weight.detach().to(torch.float32, copy=True)
            return self.create_state(index, w32), w32
        return self.create_state(index, weight)

    def update(self, index, weight, grad, state):
        raise NotImplementedError

    def update_multi_precision(self, index, weight, grad, state):
        if self._use_mp(weight):
            self._update_mp(index, weight, grad, state)
        else:
            self.update(index, weight, grad, state)

    def _update_mp(self, index, weight, grad, state):
        inner, w32 = state
        self.update(index, w32, grad, inner)
        with torch.no_grad():
            weight.copy_(w32)

    def _hyper(self, index):
        self._update_count(index)
        return (self._get_lr(index), self._get_wd(index), self.rescale_grad,
                self.clip_gradient)


def _zeros32(weight):
    return torch.zeros(weight.shape, dtype=torch.float32, device=weight.device)


@register
class SGD(Optimizer):
    """SGD with optional momentum and multi-precision (``sgd_update``,
    ``sgd_mom_update``, ``mp_sgd_update``, ``mp_sgd_mom_update``)."""

    def __init__(self, momentum=0.0, lazy_update=True, **kwargs):
        super().__init__(**kwargs)  # lazy_update: row_sparse only; the port has none
        self.momentum = momentum

    def create_state(self, index, weight):
        return None if self.momentum == 0.0 else _zeros32(weight)

    def update(self, index, weight, grad, state):
        lr, wd, rescale, clip = self._hyper(index)
        if state is None:
            K.sgd_update(weight, grad, lr, wd, rescale, clip)
        else:
            K.sgd_mom_update(weight, grad, state, lr, wd, rescale, clip, self.momentum)

    def _update_mp(self, index, weight, grad, state):
        mom, w32 = state
        lr, wd, rescale, clip = self._hyper(index)
        if mom is None:
            K.mp_sgd_update(weight, grad, w32, lr, wd, rescale, clip)
        else:
            K.mp_sgd_mom_update(weight, grad, mom, w32, lr, wd, rescale, clip, self.momentum)


@register
class Adam(Optimizer):
    """Adam (``adam_update``, ``mp_adam_update``); ``t`` is the parameter's
    own update count."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999, epsilon=1e-8,
                 lazy_update=True, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)  # lazy_update: as SGD's
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def create_state(self, index, weight):
        return _zeros32(weight), _zeros32(weight)

    def update(self, index, weight, grad, state):
        lr, wd, rescale, clip = self._hyper(index)
        mean, var = state
        K.adam_update(weight, grad, mean, var, lr, wd, rescale, clip, self.beta1, self.beta2,
                      self.epsilon, self._index_update_count[index])

    def _update_mp(self, index, weight, grad, state):
        (mean, var), w32 = state
        lr, wd, rescale, clip = self._hyper(index)
        K.mp_adam_update(weight, grad, mean, var, w32, lr, wd, rescale, clip, self.beta1,
                         self.beta2, self.epsilon, self._index_update_count[index])


class Updater:
    """Applies an optimizer by index, creating each index's state on first
    use (parity: ``mx.optimizer.get_updater``)."""

    def __init__(self, optimizer):
        self.optimizer = optimizer
        self.states = {}

    def __call__(self, index, grad, weight):
        if index not in self.states:
            self.states[index] = self.optimizer.create_state_multi_precision(index, weight)
        self.optimizer.update_multi_precision(index, weight, grad, self.states[index])

    def get_states(self, dump_optimizer=False):
        return pickle.dumps((self.states, self.optimizer) if dump_optimizer else self.states)

    def set_states(self, states):
        obj = pickle.loads(states)
        if isinstance(obj, tuple):
            self.states, self.optimizer = obj
        else:
            self.states = obj


def get_updater(optimizer):
    return Updater(optimizer)
