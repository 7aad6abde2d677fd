"""BucketingModule — variable-length training, a Module a bucket.

Counterpart of the JAX package's ``module/bucketing_module.py`` (parity
target: [U:python/mxnet/module/bucketing_module.py]).  The reference
rebinds shared-memory executors a sequence-length bucket; here each bucket
is a Module whose executor holds the default bucket's weight, gradient and
aux NDArrays by object (the executor reads them by name at every forward,
and the optimizer writes each weight's tensor in place), and shares its
optimizer, states and store.  With a ``dist_*`` store every bucket pushes
and pulls through it; the JAX package's non-default buckets update locally.
"""
from __future__ import annotations

import logging

from .base_module import BaseModule
from .module import Module

__all__ = ["BucketingModule"]


class BucketingModule(BaseModule):
    def __init__(self, sym_gen, default_bucket_key=None, logger=logging,
                 context=None, fixed_param_names=None):
        super().__init__(logger)
        assert default_bucket_key is not None
        self._sym_gen = sym_gen
        self._default_bucket_key = default_bucket_key
        self._context = context
        self._fixed_param_names = fixed_param_names
        self._buckets = {}
        self._curr_module = None
        self._curr_bucket_key = None
        self._opt_config = None

    @property
    def symbol(self):
        return self._curr_module.symbol if self._curr_module else None

    @symbol.setter
    def symbol(self, v):  # BaseModule.__init__ assigns None
        pass

    def _gen_module(self, bucket_key):
        if bucket_key in self._buckets:
            return self._buckets[bucket_key]
        sym, data_names, label_names = self._sym_gen(bucket_key)
        mod = Module(sym, data_names=data_names, label_names=label_names,
                     logger=self.logger, context=self._context,
                     fixed_param_names=self._fixed_param_names)
        self._buckets[bucket_key] = mod
        return mod

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        self.for_training = for_training
        mod = self._gen_module(self._default_bucket_key)
        mod.bind(data_shapes, label_shapes, for_training, inputs_need_grad,
                 force_rebind, None, grad_req)
        self._curr_module = mod
        self._curr_bucket_key = self._default_bucket_key
        self.binded = True

    def init_params(self, **kwargs):
        assert self.binded
        self._curr_module.init_params(**kwargs)
        self.params_initialized = True

    def init_optimizer(self, **kwargs):
        assert self.binded and self.params_initialized
        self._opt_config = kwargs
        self._curr_module.init_optimizer(**kwargs)
        self.optimizer_initialized = True

    def _switch_bucket(self, bucket_key, data_shapes, label_shapes):
        master = self._buckets[self._default_bucket_key]
        mod = self._gen_module(bucket_key)
        if not mod.binded:
            mod.bind(data_shapes, label_shapes, self.for_training,
                     shared_module=master)
            # share parameter NDArrays with the master module so every
            # bucket trains the same weights (the reference's shared-memory
            # executor-group rebind)
            for name in master._param_names:
                mod._exec.arg_dict[name] = master._exec.arg_dict[name]
                if name in master._exec.grad_dict:
                    mod._exec.grad_dict[name] = master._exec.grad_dict[name]
            for name in master._aux_names:
                mod._exec.aux_dict[name] = master._exec.aux_dict[name]
            mod.params_initialized = True
            if self._opt_config is not None:
                mod._optimizer = master._optimizer
                mod._updater_states = master._updater_states
                mod._kvstore = master._kvstore
                # a dist store owns the update in every bucket: the same
                # push/pull path, the keys initialised once
                mod._kv_dist = master._kv_dist
                if master._kv_dist:
                    mod._kv_inited = master._kv_inited
                mod.optimizer_initialized = True
        self._curr_module = mod
        self._curr_bucket_key = bucket_key

    def forward(self, data_batch, is_train=None):
        key = data_batch.bucket_key
        if key is None:
            key = self._default_bucket_key
        if key != self._curr_bucket_key:
            self._switch_bucket(key, data_batch.provide_data,
                                data_batch.provide_label)
        self._curr_module.forward(data_batch, is_train)

    def backward(self, out_grads=None):
        self._curr_module.backward(out_grads)

    def update(self):
        self._curr_module.update()

    def get_outputs(self, merge_multi_context=True):
        return self._curr_module.get_outputs(merge_multi_context)

    def get_params(self):
        return self._buckets[self._default_bucket_key].get_params()

    def set_params(self, arg_params, aux_params, **kwargs):
        self._buckets[self._default_bucket_key].set_params(arg_params, aux_params, **kwargs)
        self.params_initialized = True

    def update_metric(self, eval_metric, labels):
        self._curr_module.update_metric(eval_metric, labels)

    def save_checkpoint(self, prefix, epoch, save_optimizer_states=False):
        self._buckets[self._default_bucket_key].save_checkpoint(
            prefix, epoch, save_optimizer_states)
