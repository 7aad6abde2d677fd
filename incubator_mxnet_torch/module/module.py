"""Module — symbolic training over a bound Executor.

Counterpart of the JAX package's ``module/module.py`` (parity target:
[U:python/mxnet/module/module.py] + ``DataParallelExecutorGroup``,
[U:python/mxnet/module/executor_group.py]).  One executor on the first
context of ``context`` runs the graph; a data-parallel run goes through a
``dist`` kvstore (push and pull of every gradient), as in the JAX package.

By design the default context is ``gpu(0)``: the port's entry points run on
the card unless the caller asks for the CPU (the JAX package defaults to
the CPU).  ``update`` follows the JAX package: one optimizer call a
parameter, ``update_multi_precision`` on the bound weight's tensor, which
it writes in place (every bucket of a ``BucketingModule`` holds that
NDArray), so a Module step launches no multi-tensor kernel.  The gradient
is not rescaled by the batch size unless ``optimizer_params`` says so
(``rescale_grad``), as in the JAX package.  Optimizer states are saved as
the JAX package saves them: a pickle of numpy trees keyed by parameter
name, so a ``.states`` file crosses between the packages.
"""
from __future__ import annotations

import logging

import numpy as _np
import torch

from .. import initializer as init_mod
from .. import optimizer as opt_mod
from ..context import gpu
from ..executor import Executor
from ..io.io import DataDesc
from ..model import save_checkpoint, load_checkpoint
from .base_module import BaseModule

__all__ = ["Module"]


def _norm_shapes(shapes):
    if shapes is None:
        return []
    out = []
    for s in shapes:
        if isinstance(s, DataDesc):
            out.append(s)
        else:
            name, shape = s[0], s[1]
            dtype = s[2] if len(s) > 2 else _np.float32
            out.append(DataDesc(name, shape, dtype))
    return out


class Module(BaseModule):
    def __init__(self, symbol, data_names=("data",), label_names=("softmax_label",),
                 logger=logging, context=gpu(0), work_load_list=None,
                 fixed_param_names=None, state_names=None):
        super().__init__(logger)
        self.symbol = symbol
        self._data_names = list(data_names)
        self._label_names = list(label_names or [])
        if context is None:  # BucketingModule's and FeedForward's default
            context = gpu(0)
        self._context = context if isinstance(context, (list, tuple)) else [context]
        self._fixed_param_names = set(fixed_param_names or [])

        arg_names = symbol.list_arguments()
        input_names = set(self._data_names) | set(self._label_names)
        self._param_names = [n for n in arg_names if n not in input_names]
        self._aux_names = symbol.list_auxiliary_states()

        self._exec = None
        self._optimizer = None
        self._updater_states = {}
        self._kvstore = None
        self._kv_dist = False
        self._data_shapes = None
        self._label_shapes = None

    # ------------------------------------------------------------------
    @property
    def data_names(self):
        return self._data_names

    @property
    def label_names(self):
        return self._label_names

    @property
    def output_names(self):
        return self.symbol.list_outputs()

    @property
    def data_shapes(self):
        return self._data_shapes

    @property
    def label_shapes(self):
        return self._label_shapes

    @property
    def output_shapes(self):
        assert self.binded
        return list(zip(self.output_names,
                        [o.shape for o in self._exec.outputs])) if self._exec.outputs else None

    # ------------------------------------------------------------------
    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        if self.binded and not force_rebind:
            return
        data_shapes = _norm_shapes(data_shapes)
        label_shapes = _norm_shapes(label_shapes)
        self._data_shapes = data_shapes
        self._label_shapes = label_shapes
        self.for_training = for_training

        shape_kwargs = {d.name: d.shape for d in data_shapes + label_shapes}
        type_kwargs = {d.name: d.dtype for d in data_shapes + label_shapes}

        req = {}
        for n in self.symbol.list_arguments():
            if n in self._data_names:
                req[n] = "write" if inputs_need_grad else "null"
            elif n in self._label_names or n in self._fixed_param_names:
                req[n] = "null"
            else:
                req[n] = grad_req if for_training else "null"

        ex = Executor.simple_bind(self.symbol, self._context[0],
                                  grad_req=req, type_dict=type_kwargs,
                                  **shape_kwargs)
        if shared_module is not None and shared_module._exec is not None:
            ex.copy_params_from(
                {k: v for k, v in shared_module._exec.arg_dict.items()
                 if k in shared_module._param_names},
                shared_module._exec.aux_dict, allow_extra_params=True)
        self._exec = ex
        self.binded = True

    # ------------------------------------------------------------------
    def init_params(self, initializer=None, arg_params=None, aux_params=None,
                    allow_missing=False, force_init=False, allow_extra=False):
        assert self.binded, "call bind before init_params"
        if self.params_initialized and not force_init:
            return
        if arg_params is None and hasattr(self, "_preloaded_params"):
            arg_params, aux_params = self._preloaded_params  # Module.load path
        initializer = initializer or init_mod.Uniform(0.01)
        if isinstance(initializer, str):
            initializer = init_mod.create(initializer)

        # per-variable attrs (e.g. __init__ = Initializer.dumps() set via
        # sym.var(init=...)) must reach the initializer through InitDesc,
        # as the reference does
        var_attrs = {n.name: dict(n.attrs) for n in self.symbol._topo()
                     if n.op is None and n.attrs}

        for name in self._param_names:
            arr = self._exec.arg_dict[name]
            if arg_params is not None and name in arg_params:
                _fill(arr, arg_params[name])
            else:
                if arg_params is not None and not allow_missing:
                    raise RuntimeError(f"param {name} missing from arg_params")
                initializer(init_mod.InitDesc(name, var_attrs.get(name)), arr._data)
                arr._version += 1
        for name in self._aux_names:
            arr = self._exec.aux_dict[name]
            if aux_params is not None and name in aux_params:
                _fill(arr, aux_params[name])
            else:
                initializer(init_mod.InitDesc(name), arr._data)
                arr._version += 1
        self.params_initialized = True

    def get_params(self):
        assert self.binded and self.params_initialized
        arg_params = {n: self._exec.arg_dict[n].copy() for n in self._param_names}
        aux_params = {n: self._exec.aux_dict[n].copy() for n in self._aux_names}
        return arg_params, aux_params

    def set_params(self, arg_params, aux_params, allow_missing=False,
                   force_init=True, allow_extra=False):
        self.init_params(initializer=None, arg_params=arg_params,
                         aux_params=aux_params, allow_missing=allow_missing,
                         force_init=force_init)

    # ------------------------------------------------------------------
    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        assert self.binded and self.params_initialized
        if self.optimizer_initialized and not force_init:
            return
        if isinstance(optimizer, opt_mod.Optimizer):
            self._optimizer = optimizer
        else:
            self._optimizer = opt_mod.create(optimizer, **dict(optimizer_params))
        from ..kvstore import create as kv_create
        self._kvstore = kv_create(kvstore) if isinstance(kvstore, str) else kvstore
        # dist stores own the update: gradients go through push/pull (the
        # reference's kvstore data path — for dist_sync an allreduce + the
        # store-side updater, for dist_async the parameter server applies
        # each push on arrival).  Local stores keep the in-process fast
        # path: update() applies the optimizer directly.
        self._kv_dist = (self._kvstore is not None
                         and str(getattr(self._kvstore, "type", "")).startswith("dist"))
        if self._kv_dist:
            self._kvstore.set_optimizer(self._optimizer)
            self._kv_inited = set()
        self._updater_states = {}
        if hasattr(self, "_preloaded_opt_states"):  # Module.load(..., load_optimizer_states=True)
            device = self._context[0].device
            for i, s in self._preloaded_opt_states.items():
                if isinstance(i, int):
                    # legacy checkpoint keyed by position: remap to the name
                    # keying update() uses, or the state would be silently
                    # dropped and momentum/Adam moments reset on resume
                    i = self._param_names[i]
                self._updater_states[i] = _tree_tensor(s, device)
            del self._preloaded_opt_states
        self.optimizer_initialized = True

    # ------------------------------------------------------------------
    def forward(self, data_batch, is_train=None):
        assert self.binded and self.params_initialized
        if is_train is None:
            is_train = self.for_training
        feeds = {}
        for name, arr in zip(self._data_names, data_batch.data):
            feeds[name] = arr
        if data_batch.label is not None:
            for name, arr in zip(self._label_names, data_batch.label):
                # graphs without a loss head have no label input; skip it
                if name in self._exec.arg_dict:
                    feeds[name] = arr
        self._exec.forward(is_train=is_train, **feeds)

    def backward(self, out_grads=None):
        assert self.binded and self.params_initialized
        self._exec.backward(out_grads=out_grads)

    def update(self):
        """Apply one optimizer step a parameter, in place on the bound
        weight's tensor (dist stores: push the gradient, pull the weight)."""
        assert self.optimizer_initialized
        opt = self._optimizer
        if self._kv_dist:
            kv = self._kvstore
            for name in self._param_names:
                if name in self._fixed_param_names:
                    continue
                grad = self._exec.grad_dict.get(name)
                if grad is None:
                    continue
                weight = self._exec.arg_dict[name]
                if name not in self._kv_inited:
                    kv.init(name, weight)
                    self._kv_inited.add(name)
                kv.push(name, grad)
                kv.pull(name, out=weight)
            return
        for name in self._param_names:
            if name in self._fixed_param_names:
                continue
            grad = self._exec.grad_dict.get(name)
            if grad is None:
                continue
            weight = self._exec.arg_dict[name]
            # keyed by parameter NAME, not position: BucketingModule shares
            # these states across buckets whose list_arguments order can
            # differ — positional keys would silently apply momentum to the
            # wrong parameter (and lr_mult/wd_mult lookups are by name).
            if name not in self._updater_states:
                self._updater_states[name] = opt.create_state_multi_precision(
                    name, weight._data)
            opt.update_multi_precision(name, weight._data, grad._data,
                                       self._updater_states[name])
            weight._version += 1

    def get_outputs(self, merge_multi_context=True):
        assert self.binded
        return self._exec.outputs

    def get_input_grads(self, merge_multi_context=True):
        assert self.binded
        return [self._exec.grad_dict.get(n) for n in self._data_names]

    def update_metric(self, eval_metric, labels):
        eval_metric.update(labels, self.get_outputs())

    # ------------------------------------------------------------------
    def save_checkpoint(self, prefix, epoch, save_optimizer_states=False):
        arg_params, aux_params = self.get_params()
        save_checkpoint(prefix, epoch, self.symbol, arg_params, aux_params)
        if save_optimizer_states:
            import pickle
            flat = {i: s for i, s in self._updater_states.items()}
            with open(f"{prefix}-{epoch:04d}.states", "wb") as f:
                pickle.dump(
                    {i: _tree_numpy(s) for i, s in flat.items()}, f)

    @staticmethod
    def load(prefix, epoch, load_optimizer_states=False, **kwargs):
        sym, arg_params, aux_params = load_checkpoint(prefix, epoch)
        mod = Module(sym, **kwargs)
        mod._preloaded_params = (arg_params, aux_params)
        if load_optimizer_states:
            import pickle
            with open(f"{prefix}-{epoch:04d}.states", "rb") as f:
                mod._preloaded_opt_states = pickle.load(f)
        return mod

    def reshape(self, data_shapes, label_shapes=None):
        assert self.binded
        self.bind(data_shapes, label_shapes, for_training=self.for_training,
                  force_rebind=True, shared_module=self)


def _fill(arr, src):
    """Give the bound NDArray ``arr`` a copy of ``src`` (NDArray, tensor or
    array-like) on its device, in its dtype."""
    t = getattr(src, "_data", src)
    if not isinstance(t, torch.Tensor):
        t = torch.from_numpy(_np.ascontiguousarray(_np.asarray(t)))
    arr._data = t.detach().to(device=arr._data.device, dtype=arr._data.dtype, copy=True)
    arr._version += 1


def _tree_numpy(state):
    """An optimizer state (tensors, tuples of them, None) as numpy arrays:
    the JAX package's ``.states`` form."""
    if state is None:
        return None
    if isinstance(state, torch.Tensor):
        return state.detach().cpu().numpy()
    if isinstance(state, (list, tuple)):
        return tuple(_tree_numpy(s) for s in state)
    return state


def _tree_tensor(state, device):
    """The ``.states`` form back as tensors on ``device``."""
    if state is None:
        return None
    if isinstance(state, _np.ndarray):
        return torch.from_numpy(_np.array(state)).to(device)
    if isinstance(state, (list, tuple)):
        return tuple(_tree_tensor(s, device) for s in state)
    return state
