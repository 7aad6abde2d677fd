"""Gluon Trainer on one device (parity: MXNet's ``gluon.Trainer``).

Counterpart of the JAX package's ``gluon/trainer.py`` for a single
device: ``step(batch_size)`` runs ``allreduce_grads`` (nothing to reduce
on one device) and then the optimizer on every parameter with a
gradient, with ``rescale_grad = scale / batch_size``; ``save_states`` /
``load_states`` keep the optimizer state and the per-parameter update
counts (Adam's ``t``).  The update goes through the fused group update
(``optimizer/fused.py``: on the card one launch of the multi-tensor
kernel per group of up to ``optimizer.aggregate_num`` parameters), and
only what it leaves (an optimizer with no fused variant, or
``aggregate_num`` <= 1) takes the per-tensor loop.  Distributed kvstores
are a later slice of the port.

The optimizer state is keyed by parameter index, and each step fetches
``param.data()`` and ``param.grad()`` afresh, so a ``cast`` between
steps (which makes new tensors) is seen.

``fold_step`` / ``fold_steps`` / ``fold_eval`` build the step fold
(``gluon/step_fold.py``): a whole training step, or a window of K, or an
evaluation pass, as one CUDA-graph replay on the card; ``MXNET_STEP_FOLD=1``
makes ``step`` replay its optimizer tail (``step_fold.fold_update``).

``step`` and ``update`` close a step of the profiler's telemetry
(``profiler.step_boundary``, in a ``finally``); with the profiler armed
they record ``trainer.allreduce`` and ``trainer.update`` spans.
"""
from __future__ import annotations

import os
import pickle
import warnings
import weakref

import torch

from .. import optimizer as opt_mod
from .. import profiler as _profiler
from ..optimizer import fused as _fused
from . import step_fold as _sf
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
        self._fold = None            # weakref to the last StepProgram built

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
        try:
            if _profiler._active:
                with _profiler.span("trainer.allreduce", "trainer"):
                    self.allreduce_grads()
                with _profiler.span("trainer.update", "trainer"):
                    self._update(ignore_stale_grad, stale)
            else:
                self.allreduce_grads()
                self._update(ignore_stale_grad, stale)
        finally:
            # the step every span since the previous boundary belongs to;
            # in a finally, so that a step that raised bills its partial
            # time to itself, not to the next one
            _profiler.step_boundary()

    def fold_step(self, loss_fn, block=None, keep_grads=False):
        """The folded training step of this trainer: a
        :class:`~.step_fold.StepProgram` whose call ``program(*batch)`` runs
        forward, ``loss_fn(*batch)``, backward and the fused optimizer update
        as one CUDA-graph replay on the card (after one eager warm-up call
        and one capture) and returns a copy of the loss.  ``loss_fn`` calls
        the Block(s) whose Parameters this trainer owns.  ``keep_grads=True``
        guarantees each Parameter's gradient after the call, as after
        ``backward``; with ``False`` (the reference's default) the program
        promises nothing about the gradients.  The port keeps them in the
        Parameters' buffers either way, and both values give the same
        parameters and optimizer states.  Escape hatches
        (``MXNET_STEP_FOLD=0``, ``block`` with ``_step_fold_opt_out``,
        ``grad_req='add'``, an optimizer with no fused update, a capture
        failure) fall back to the eager path with a warning, never an
        error."""
        sp = _sf.StepProgram(self, loss_fn, block=block)
        self._fold = weakref.ref(sp)
        return sp

    def fold_steps(self, loss_fn, k=None, block=None, keep_grads=False, donate_window=False):
        """The K-step fold: like :meth:`fold_step`, but each call takes a
        ``[K, batch, ...]`` window stacked by the caller and runs its K
        logical steps as one replay of K captured step bodies, returning the
        ``[K, ...]`` losses; ``k`` defaults to ``MXNET_STEP_FOLD_K`` (K=1 is
        :meth:`fold_step`'s program).  ``program.step_one(*batch)`` runs one
        step off the window boundary; ``save_states`` refuses until the
        window is whole again.  ``keep_grads`` as in :meth:`fold_step`.
        ``donate_window`` is accepted and donates nothing: the program
        copies each window into its graph's static input buffers, so the
        caller's window stays valid whatever its value."""
        sp = _sf.StepProgram(self, loss_fn, block=block, k=k)
        self._fold = weakref.ref(sp)
        return sp

    def fold_eval(self, loss_fn, block=None, k=None):
        """The folded evaluation pass: an :class:`~.step_fold.EvalProgram`
        whose call runs the forward-only loss of a batch (or a ``[K, ...]``
        window) with training off as one replay, summing it on the card;
        ``program.result()`` reads the mean once."""
        return _sf.EvalProgram(self, loss_fn, block=block, k=k)

    def allreduce_grads(self):
        """Nothing to reduce: the gradients of one device are already whole."""

    def close(self):
        """Release what the trainer holds for distributed training: on one
        device there is nothing to release.  Idempotent."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def update(self, batch_size, ignore_stale_grad=False):
        """The optimizer update alone (gradients already reduced)."""
        self._check_and_rescale_grad(self._scale / batch_size)
        stale = self._stale_indices() if ignore_stale_grad else frozenset()
        try:
            if _profiler._active:
                with _profiler.span("trainer.update", "trainer"):
                    self._update(ignore_stale_grad, stale)
            else:
                self._update(ignore_stale_grad, stale)
        finally:
            _profiler.step_boundary()

    def _stale_indices(self):
        """Parameters whose gradient no backward has written since their
        last update."""
        return {i for i, p in enumerate(self._params)
                if p.grad_req != "null" and p._data is not None
                and self._grad_versions.get(i) == p.grad_version}

    def _update(self, ignore_stale_grad=False, stale=frozenset()):
        items = []
        for i, p in enumerate(self._params):
            if p.grad_req == "null" or p._data is None:
                continue
            if ignore_stale_grad and i in stale:
                continue
            weight = p.data()
            if i not in self._states:
                self._states[i] = self._optimizer.create_state_multi_precision(i, weight)
            items.append((i, weight, p.grad()))
        # the fused group update (MXNET_STEP_FOLD=1: all its groups as one
        # CUDA-graph replay); what it leaves takes the per-tensor loop
        updater = _sf.fold_update if _sf.step_fast_path() else _fused.fused_update
        for i, weight, grad in updater(self._optimizer, items, self._states):
            self._optimizer.update_multi_precision(i, weight, grad, self._states[i])
        for i, p in enumerate(self._params):
            if p.grad_req != "null" and p._data is not None:
                self._grad_versions[i] = p.grad_version

    def save_states(self, fname):
        """Optimizer state and per-index update counts (Adam's ``t``
        resumes where it was), written atomically.  Refused while a K-step
        fold is off its window boundary (``program.window_pos != 0``): such
        a state is no point that K-step windows ever reach."""
        fold = self._fold() if self._fold is not None else None
        if fold is not None:
            if fold.window_pos != 0:
                raise RuntimeError(
                    f"save_states refused mid-window: the K-step fold is {fold.window_pos} "
                    f"step(s) past a K boundary (k={fold.k}); checkpoints land on K "
                    "boundaries only: finish the window with step_one, or save before "
                    "stepping off the boundary")
            fold.sync()
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
