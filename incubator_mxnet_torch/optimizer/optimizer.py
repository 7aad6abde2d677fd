"""Optimizer registry, the ``Optimizer`` base, the optimizers and ``Updater``.

Counterpart of the JAX package's ``optimizer/optimizer.py`` (MXNet's
``mx.optimizer``): the registry, lr/wd multipliers, per-index update counts
(Adam's ``t``), and ``multi_precision`` fp32 master weights for 16-bit
parameters.  Updates call ``ops/optimizer_ops.py`` and change the weight
and the state tensors in place.  ``aggregate_num`` caps the parameters of
one fused group update (``optimizer/fused.py``, the Trainer's path).  An
optimizer keys its state by parameter index; the caller hands it the
current weight tensor at every update.

The optimizers are the JAX package's eighteen: SGD, NAG, Adam, AdamW,
AdaGrad, AdaDelta, RMSProp (plain and centered), Ftrl, Signum, LAMB,
Nadam, FTML, SGLD, DCASGD, Adamax, LBSGD, LARS and GroupAdaGrad, with the
same ``create`` names.  ``multi_precision`` follows the JAX package's base
``_update_mp`` (the update on the fp32 master copy, then the 16-bit weight
from it) where a class does not override it: SGD and Adam do, and AdamW
inherits Adam's, so AdamW's mp update is Adam's ``mp_adam_update``.
SGLD draws its noise from the device's generator (``random.get_generator``).
"""
from __future__ import annotations

import math
import os
import pickle

import numpy as np
import torch

from ..ops import optimizer_ops as K

__all__ = ["Optimizer", "SGD", "NAG", "Adam", "AdamW", "AdaGrad", "AdaDelta", "RMSProp", "Ftrl",
           "Signum", "LAMB", "Nadam", "FTML", "SGLD", "DCASGD", "Adamax", "LBSGD", "LARS",
           "GroupAdaGrad", "Updater", "get_updater", "create", "register"]

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

    def _lazy_for(self, index):
        """Whether parameter ``index`` takes the lazy update (SGD's and
        Adam's ``lazy_update`` and a ``row_sparse`` parameter): only the
        rows its gradient touches move, their state too."""
        p = self.param_dict.get(index)
        return (getattr(self, "lazy_update", False)
                and getattr(p, "stype", "default") == "row_sparse")

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
        super().__init__(**kwargs)
        self.momentum = momentum
        self.lazy_update = lazy_update

    def create_state(self, index, weight):
        return None if self.momentum == 0.0 else _zeros32(weight)

    def update(self, index, weight, grad, state):
        lr, wd, rescale, clip = self._hyper(index)
        lazy = self._lazy_for(index)
        if state is None:
            (K.sgd_lazy_update if lazy else K.sgd_update)(weight, grad, lr, wd, rescale, clip)
        else:
            (K.sgd_mom_lazy_update if lazy else K.sgd_mom_update)(
                weight, grad, state, lr, wd, rescale, clip, self.momentum)

    def _update_mp(self, index, weight, grad, state):
        mom, w32 = state
        lr, wd, rescale, clip = self._hyper(index)
        if mom is None:
            K.mp_sgd_update(weight, grad, w32, lr, wd, rescale, clip)
        else:
            (K.mp_sgd_mom_lazy_update if self._lazy_for(index) else K.mp_sgd_mom_update)(
                weight, grad, mom, w32, lr, wd, rescale, clip, self.momentum)


@register
class Adam(Optimizer):
    """Adam (``adam_update``, ``mp_adam_update``); ``t`` is the parameter's
    own update count."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999, epsilon=1e-8,
                 lazy_update=True, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon
        self.lazy_update = lazy_update

    def create_state(self, index, weight):
        return _zeros32(weight), _zeros32(weight)

    def update(self, index, weight, grad, state):
        lr, wd, rescale, clip = self._hyper(index)
        mean, var = state
        (K.adam_lazy_update if self._lazy_for(index) else K.adam_update)(
            weight, grad, mean, var, lr, wd, rescale, clip, self.beta1, self.beta2,
            self.epsilon, self._index_update_count[index])

    def _update_mp(self, index, weight, grad, state):
        (mean, var), w32 = state
        lr, wd, rescale, clip = self._hyper(index)
        K.mp_adam_update(weight, grad, mean, var, w32, lr, wd, rescale, clip, self.beta1,
                         self.beta2, self.epsilon, self._index_update_count[index])


@register
class NAG(Optimizer):
    """Nesterov momentum (``nag_mom_update``; ``sgd_update`` without
    momentum).  Its mp update is the base one, on the fp32 master copy."""

    def __init__(self, momentum=0.0, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum

    def create_state(self, index, weight):
        return None if self.momentum == 0.0 else _zeros32(weight)

    def update(self, index, weight, grad, state):
        lr, wd, rescale, clip = self._hyper(index)
        if state is None:
            K.sgd_update(weight, grad, lr, wd, rescale, clip)
        else:
            K.nag_mom_update(weight, grad, state, lr, wd, rescale, clip, self.momentum)


@register
class AdamW(Adam):
    """Adam with decoupled weight decay (``adamw_update``); ``eta`` scales
    the whole step.  Under ``multi_precision`` it inherits Adam's
    ``mp_adam_update``, as in the JAX package."""

    def __init__(self, eta=1.0, **kwargs):
        super().__init__(**kwargs)
        self.eta = eta

    def update(self, index, weight, grad, state):
        lr, wd, rescale, clip = self._hyper(index)
        mean, var = state
        K.adamw_update(weight, grad, mean, var, lr, wd, self.eta, rescale, clip, self.beta1,
                       self.beta2, self.epsilon, self._index_update_count[index])


@register
class AdaGrad(Optimizer):
    def __init__(self, eps=1e-7, **kwargs):
        super().__init__(**kwargs)
        self.float_stable_eps = eps

    def create_state(self, index, weight):
        return _zeros32(weight)

    def update(self, index, weight, grad, state):
        lr, wd, rescale, clip = self._hyper(index)
        K.adagrad_update(weight, grad, state, lr, wd, rescale, clip, self.float_stable_eps)


@register
class AdaDelta(Optimizer):
    def __init__(self, rho=0.90, epsilon=1e-5, **kwargs):
        super().__init__(**kwargs)
        self.rho, self.epsilon = rho, epsilon

    def create_state(self, index, weight):
        return _zeros32(weight), _zeros32(weight)

    def update(self, index, weight, grad, state):
        _, wd, rescale, clip = self._hyper(index)
        acc_g, acc_d = state
        K.adadelta_update(weight, grad, acc_g, acc_d, wd, rescale, clip, self.rho, self.epsilon)


@register
class RMSProp(Optimizer):
    """RMSProp (``rmsprop_update``), or with ``centered=True`` Graves'
    form (``rmspropalex_update``: n, g_avg and delta states)."""

    def __init__(self, learning_rate=0.001, rho=0.9, momentum=0.9, epsilon=1e-8,
                 centered=False, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.rho, self.momentum, self.epsilon, self.centered = rho, momentum, epsilon, centered

    def create_state(self, index, weight):
        if self.centered:
            return tuple(_zeros32(weight) for _ in range(3))
        return _zeros32(weight)

    def update(self, index, weight, grad, state):
        lr, wd, rescale, clip = self._hyper(index)
        if self.centered:
            n, g_avg, delta = state
            K.rmspropalex_update(weight, grad, n, g_avg, delta, lr, wd, rescale, clip, self.rho,
                                 self.momentum, self.epsilon)
        else:
            K.rmsprop_update(weight, grad, state, lr, wd, rescale, clip, self.rho, self.epsilon)


@register
class Ftrl(Optimizer):
    def __init__(self, lamda1=0.01, learning_rate=0.1, beta=1, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.lamda1, self.beta = lamda1, beta

    def create_state(self, index, weight):
        return _zeros32(weight), _zeros32(weight)

    def update(self, index, weight, grad, state):
        lr, wd, rescale, clip = self._hyper(index)
        z, n = state
        K.ftrl_update(weight, grad, z, n, lr, wd, rescale, clip, self.lamda1, self.beta)


@register
class Signum(Optimizer):
    def __init__(self, learning_rate=0.01, momentum=0.9, wd_lh=0.0, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum, self.wd_lh = momentum, wd_lh

    def create_state(self, index, weight):
        return _zeros32(weight)

    def update(self, index, weight, grad, state):
        lr, wd, rescale, clip = self._hyper(index)
        K.signum_update(weight, grad, state, lr, wd, rescale, clip, self.momentum, self.wd_lh)


@register
class LAMB(Optimizer):
    """Layer-wise adaptive moments for large-batch BERT
    (``lamb_update_phase1`` then ``lamb_update_phase2``: each parameter's
    own trust ratio ‖w‖/‖r‖, clipped to [lower_bound, upper_bound])."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999, epsilon=1e-6,
                 lower_bound=None, upper_bound=None, bias_correction=True, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon
        self.lower_bound = lower_bound if lower_bound is not None else 0.0
        self.upper_bound = upper_bound if upper_bound is not None else math.inf
        self.bias_correction = bias_correction

    def create_state(self, index, weight):
        return _zeros32(weight), _zeros32(weight)

    def update(self, index, weight, grad, state):
        lr, wd, rescale, clip = self._hyper(index)
        mean, var = state
        r = K.lamb_update_phase1(weight, grad, mean, var, wd, rescale, clip, self.beta1,
                                 self.beta2, self.epsilon, self._index_update_count[index],
                                 self.bias_correction)
        K.lamb_update_phase2(weight, r, lr, self.lower_bound, self.upper_bound)


@register
class Nadam(Optimizer):
    """Nesterov Adam; the momentum schedule's running product is a 0-d fp32
    state, as in the JAX package."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999, epsilon=1e-8,
                 schedule_decay=0.004, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon
        self.schedule_decay = schedule_decay

    def create_state(self, index, weight):
        return (_zeros32(weight), _zeros32(weight),
                torch.ones((), dtype=torch.float32, device=weight.device))

    def update(self, index, weight, grad, state):
        lr, wd, rescale, clip = self._hyper(index)
        mean, var, sched = state
        K.nadam_update(weight, grad, mean, var, sched, lr, wd, rescale, clip, self.beta1,
                       self.beta2, self.epsilon, self._index_update_count[index],
                       self.schedule_decay)


@register
class FTML(Optimizer):
    """Follow the Moving Leader (``ftml_update``: d, v and z states)."""

    def __init__(self, learning_rate=0.0025, beta1=0.6, beta2=0.999, epsilon=1e-8, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def create_state(self, index, weight):
        return tuple(_zeros32(weight) for _ in range(3))

    def update(self, index, weight, grad, state):
        lr, wd, rescale, clip = self._hyper(index)
        d, v, z = state
        K.ftml_update(weight, grad, d, v, z, lr, wd, rescale, clip, self.beta1, self.beta2,
                      self.epsilon, self._index_update_count[index])


@register
class SGLD(Optimizer):
    """Stochastic Gradient Langevin Dynamics: SGD with N(0, lr) noise, drawn
    from the weight's device's generator (``random.get_generator``), so
    ``mx.random.seed`` makes a run repeatable."""

    def create_state(self, index, weight):
        return None

    def update(self, index, weight, grad, state):
        from ..random import get_generator

        lr, wd, rescale, clip = self._hyper(index)
        noise = torch.randn(weight.shape, dtype=torch.float32, device=weight.device,
                            generator=get_generator(weight.device))
        K.sgld_update(weight, grad, lr, wd, rescale, clip, noise)


@register
class DCASGD(Optimizer):
    """Delay-compensated asynchronous SGD: momentum and the previous weight
    (fp32) as states."""

    def __init__(self, momentum=0.0, lamda=0.04, **kwargs):
        super().__init__(**kwargs)
        self.momentum, self.lamda = momentum, lamda

    def create_state(self, index, weight):
        return _zeros32(weight), weight.detach().to(torch.float32, copy=True)

    def update(self, index, weight, grad, state):
        lr, wd, rescale, clip = self._hyper(index)
        mom, prev = state
        K.dcasgd_update(weight, grad, mom, prev, lr, wd, rescale, clip, self.momentum,
                        self.lamda)


@register
class Adamax(Optimizer):
    """AdaMax, Adam's infinity-norm form; the rate is divided by
    1 − beta1^t before the update, as the reference folds it in."""

    def __init__(self, learning_rate=0.002, beta1=0.9, beta2=0.999, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2 = beta1, beta2

    def create_state(self, index, weight):
        return _zeros32(weight), _zeros32(weight)

    def update(self, index, weight, grad, state):
        lr, wd, rescale, clip = self._hyper(index)
        t = self._index_update_count[index]
        mean, inf_norm = state
        K.adamax_update(weight, grad, mean, inf_norm, lr / (1.0 - self.beta1 ** t), wd, rescale,
                        clip, self.beta1, self.beta2)


def _lars_trust(weight, grad, wd, eta, eps, rescale_grad):
    """eta·‖w‖ / (‖g‖ + wd·‖w‖ + eps) in fp32, 1 where either norm is 0
    (LARS, and LBSGD's 'lars' warm-up)."""
    f = np.float32
    w_norm = torch.linalg.vector_norm(weight.float())
    g_norm = torch.linalg.vector_norm(grad.float() * float(f(rescale_grad)))
    ratio = float(f(eta)) * w_norm / (g_norm + float(f(wd)) * w_norm + float(f(eps)))
    return torch.where((w_norm > 0) & (g_norm > 0), ratio, torch.ones_like(ratio))


def _sgd_with_rate(weight, grad, state, lr, wd, rescale, clip, momentum):
    """SGD (with momentum when ``state`` holds it) at a rate that is a 0-d
    fp32 tensor (a trust ratio times lr), read on the host."""
    lr = float(lr)
    if state is None:
        K.sgd_update(weight, grad, lr, wd, rescale, clip)
    else:
        K.sgd_mom_update(weight, grad, state, lr, wd, rescale, clip, momentum)


@register
class LBSGD(Optimizer):
    """Large-batch SGD: the rate ramps from lr to lr·batch_scale over the
    warm-up ('linear', 'power2', 'sqrt'), or each layer's rate is scaled by
    the LARS trust ratio ('lars').  ``begin_epoch``/``num_epochs`` are taken
    for the reference's signature and change nothing, as in the JAX
    package."""

    def __init__(self, momentum=0.0, multi_precision=False, warmup_strategy="linear",
                 warmup_epochs=5, batch_scale=1, updates_per_epoch=32, begin_epoch=0,
                 num_epochs=60, **kwargs):
        super().__init__(multi_precision=multi_precision, **kwargs)
        self.momentum = momentum
        self.warmup_strategy = warmup_strategy
        self.warmup_epochs = warmup_epochs
        self.batch_scale = max(1.0, float(batch_scale))
        self.updates_per_epoch = max(1, updates_per_epoch)
        self.lars_eta = 0.001
        self.lars_eps = 1e-9

    def create_state(self, index, weight):
        return None if self.momentum == 0.0 else _zeros32(weight)

    def _warmup_scale(self, t):
        """1 → batch_scale over the warm-up window, shaped by the strategy
        (fp32, as the JAX package computes it); 1 when batch_scale <= 1."""
        if self.batch_scale <= 1.0:
            return np.float32(1.0)
        f = np.float32
        total = self.warmup_epochs * self.updates_per_epoch
        frac = min(f(t) / f(total), f(1.0))
        if self.warmup_strategy == "power2":
            frac = frac * frac
        elif self.warmup_strategy == "sqrt":
            frac = np.sqrt(frac)
        return f(1.0) + f(self.batch_scale - 1.0) * frac

    def update(self, index, weight, grad, state):
        lr, wd, rescale, clip = self._hyper(index)
        t = self._index_update_count[index]
        if self.warmup_strategy == "lars":
            rate = np.float32(lr) * np.float32(
                _lars_trust(weight, grad, wd, self.lars_eta, self.lars_eps, rescale).item())
        else:
            rate = np.float32(lr) * self._warmup_scale(t)
        _sgd_with_rate(weight, grad, state, np.float32(rate), wd, rescale, clip, self.momentum)


@register
class LARS(Optimizer):
    """Layerwise-adaptive-rate SGD: each layer's rate scaled by
    eta·‖w‖ / (‖g‖ + wd·‖w‖ + eps) (the plain rate where a norm is 0)."""

    def __init__(self, momentum=0.0, eta=0.001, epsilon=1e-8, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        self.eta = eta
        self.epsilon = epsilon

    def create_state(self, index, weight):
        return None if self.momentum == 0.0 else _zeros32(weight)

    def update(self, index, weight, grad, state):
        lr, wd, rescale, clip = self._hyper(index)
        rate = np.float32(lr) * np.float32(
            _lars_trust(weight, grad, wd, self.eta, self.epsilon, rescale).item())
        _sgd_with_rate(weight, grad, state, rate, wd, rescale, clip, self.momentum)


@register
class GroupAdaGrad(Optimizer):
    """AdaGrad with one statistic a row (embedding tables): the state has
    the weight's first dimension and ones after it.  It takes no weight
    decay."""

    def __init__(self, learning_rate=0.01, eps=1e-5, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.float_stable_eps = eps

    def create_state(self, index, weight):
        return torch.zeros((weight.shape[0],) + (1,) * (weight.dim() - 1), dtype=torch.float32,
                           device=weight.device)

    def update(self, index, weight, grad, state):
        lr, wd, rescale, clip = self._hyper(index)
        if wd != 0.0:
            raise ValueError("GroupAdaGrad takes no weight decay (wd must be 0)")
        K.group_adagrad_update(weight, grad, state, lr, rescale, clip, self.float_stable_eps)


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
