"""Gluon Trainer on one device (parity: MXNet's ``gluon.Trainer``).

Counterpart of the JAX package's ``gluon/trainer.py`` for a single
device: ``step(batch_size)`` runs ``allreduce_grads`` (nothing to reduce
on one device) and then the optimizer on every parameter with a
gradient, with ``rescale_grad = scale / batch_size``; ``save_states`` /
``load_states`` keep the optimizer state and the per-parameter update
counts (Adam's ``t``).  The update is the per-tensor loop; the fused
group update and distributed kvstores are later slices of the port.

The optimizer state is keyed by parameter index, and each step fetches
``param.data()`` and ``param.grad()`` afresh, so a ``cast`` between
steps (which makes new tensors) is seen.
"""
from __future__ import annotations

import os
import pickle
import warnings

import torch

from .. import optimizer as opt_mod
from .parameter import Parameter, ParameterDict

__all__ = ["Trainer"]


class Trainer:
    """``update_on_kvstore`` is taken for MXNet's signature; one device has
    no kvstore to update on."""

    def __init__(self, params, optimizer, optimizer_params=None, kvstore="device",
                 compression_params=None, update_on_kvstore=None):
        if isinstance(params, (dict, ParameterDict)):
            params = list(params.values())
        if not isinstance(params, (list, tuple)):
            raise ValueError("First argument must be a list or dict of Parameters")
        for p in params:
            if not isinstance(p, Parameter):
                raise ValueError(
                    f"First argument must be a list or dict of Parameters, got {type(p)}")
        if kvstore not in (None, "device") or compression_params is not None:
            raise NotImplementedError(
                f"kvstore={kvstore!r}, compression_params={compression_params!r}: this "
                "Trainer runs on one device (kvstore None or 'device'); other kvstores "
                "and gradient compression come with the multi-GPU slice of the port")
        self._params = list(params)
        optimizer_params = dict(optimizer_params or {})
        self._scale = float(optimizer_params.get("rescale_grad", 1.0))
        self._init_optimizer(optimizer, optimizer_params)
        self._states = {}
        self._last_scale_set = None  # the last rescale_grad this trainer wrote
        self._grad_versions = {}     # index -> grad_version at its last update

    def _init_optimizer(self, optimizer, optimizer_params):
        param_dict = dict(enumerate(self._params))
        if isinstance(optimizer, opt_mod.Optimizer):
            if optimizer_params and list(optimizer_params) != ["rescale_grad"]:
                raise ValueError(
                    "optimizer_params must be None if optimizer is an Optimizer instance")
            self._optimizer = optimizer
            self._optimizer.param_dict = param_dict
        else:
            self._optimizer = opt_mod.create(optimizer, param_dict=param_dict,
                                             **optimizer_params)

    @property
    def learning_rate(self):
        return self._optimizer.learning_rate

    @property
    def optimizer(self):
        return self._optimizer

    def set_learning_rate(self, lr):
        self._optimizer.set_learning_rate(lr)

    def _check_and_rescale_grad(self, scale):
        """Set ``optimizer.rescale_grad`` for this step, warning when a
        value set by hand is about to be overwritten."""
        expected = self._last_scale_set if self._last_scale_set is not None else self._scale
        if self._optimizer.rescale_grad != expected:
            warnings.warn(
                "Optimizer.rescale_grad was changed outside Trainer.step; "
                "Trainer recomputes it as trainer._scale/batch_size every "
                "step, overriding your value. Construct the Trainer with "
                "optimizer_params={'rescale_grad': ...} instead.",
                UserWarning, stacklevel=3)
        self._optimizer.rescale_grad = scale
        self._last_scale_set = scale

    def step(self, batch_size, ignore_stale_grad=False):
        """Gradient reduction, then the optimizer update with
        ``rescale_grad = scale / batch_size``."""
        self._check_and_rescale_grad(self._scale / batch_size)
        stale = self._stale_indices() if ignore_stale_grad else frozenset()
        self.allreduce_grads()
        self._update(ignore_stale_grad, stale)

    def allreduce_grads(self):
        """Nothing to reduce: the gradients of one device are already whole."""

    def update(self, batch_size, ignore_stale_grad=False):
        """The optimizer update alone (gradients already reduced)."""
        self._check_and_rescale_grad(self._scale / batch_size)
        self._update(ignore_stale_grad,
                     self._stale_indices() if ignore_stale_grad else frozenset())

    def _stale_indices(self):
        """Parameters whose gradient no backward has written since their
        last update."""
        return {i for i, p in enumerate(self._params)
                if p.grad_req != "null" and p._data is not None
                and self._grad_versions.get(i) == p.grad_version}

    def _update(self, ignore_stale_grad=False, stale=frozenset()):
        for i, p in enumerate(self._params):
            if p.grad_req == "null" or p._data is None:
                continue
            if ignore_stale_grad and i in stale:
                continue
            weight = p.data()
            if i not in self._states:
                self._states[i] = self._optimizer.create_state_multi_precision(i, weight)
            self._optimizer.update_multi_precision(i, weight, p.grad(), self._states[i])
        for i, p in enumerate(self._params):
            if p.grad_req != "null" and p._data is not None:
                self._grad_versions[i] = p.grad_version

    def save_states(self, fname):
        """Optimizer state and per-index update counts (Adam's ``t``
        resumes where it was), written atomically."""
        payload = {
            "states": {i: _to_numpy(st) for i, st in self._states.items()},
            "num_update": self._optimizer.num_update,
            "update_counts": dict(self._optimizer._index_update_count),
        }
        tmp = f"{fname}.tmp{os.getpid()}"
        with open(tmp, "wb") as f:
            pickle.dump(payload, f)
        os.replace(tmp, fname)

    def load_states(self, fname):
        with open(fname, "rb") as f:
            payload = pickle.load(f)
        for i, st in payload["states"].items():
            if i not in self._states:
                self._states[i] = self._optimizer.create_state_multi_precision(
                    i, self._params[i].data())
            _copy_into(self._states[i], st)
        num_update = payload["num_update"]
        self._optimizer._index_update_count = dict(payload["update_counts"])
        self._optimizer.num_update = num_update
        self._optimizer.begin_num_update = num_update


def _to_numpy(st):
    if st is None:
        return None
    if isinstance(st, torch.Tensor):
        return st.detach().cpu().numpy()
    return type(st)(_to_numpy(s) for s in st)


@torch.no_grad()
def _copy_into(st, data):
    if st is None or data is None:
        return
    if isinstance(st, torch.Tensor):
        st.copy_(torch.from_numpy(data))
        return
    for s, d in zip(st, data):
        _copy_into(s, d)
