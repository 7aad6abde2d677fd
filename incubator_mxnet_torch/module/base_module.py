"""BaseModule — the legacy symbolic training loop.

Counterpart of the JAX package's ``module/base_module.py`` (parity target:
[U:python/mxnet/module/base_module.py]: ``fit``/``score``/``predict`` over
DataIter batches).  The heavy lifting (executor binding, the optimizer)
lives in :class:`Module`.  ``predict`` keeps its outputs on the module's
device.
"""
from __future__ import annotations

import logging
import time

import torch

from .. import metric as metric_mod
from ..ndarray.ndarray import _wrap

__all__ = ["BaseModule"]


def _as_metric(m):
    if isinstance(m, metric_mod.EvalMetric):
        return m
    return metric_mod.create(m)


class BaseModule:
    def __init__(self, logger=logging):
        self.logger = logger
        self.binded = False
        self.for_training = False
        self.params_initialized = False
        self.optimizer_initialized = False
        self.symbol = None

    # -- subclass contract ----------------------------------------------
    def bind(self, *args, **kwargs):
        raise NotImplementedError

    def init_params(self, *args, **kwargs):
        raise NotImplementedError

    def init_optimizer(self, *args, **kwargs):
        raise NotImplementedError

    def forward(self, data_batch, is_train=None):
        raise NotImplementedError

    def backward(self, out_grads=None):
        raise NotImplementedError

    def update(self):
        raise NotImplementedError

    def get_outputs(self):
        raise NotImplementedError

    def get_params(self):
        raise NotImplementedError

    def update_metric(self, eval_metric, labels):
        raise NotImplementedError

    # -- convenience ------------------------------------------------------
    def forward_backward(self, data_batch):
        self.forward(data_batch, is_train=True)
        self.backward()

    def score(self, eval_data, eval_metric, num_batch=None, reset=True,
              epoch=0, batch_end_callback=None):
        assert self.binded and self.params_initialized
        eval_metric = _as_metric(eval_metric)
        if reset:
            eval_data.reset()
        eval_metric.reset()
        for nbatch, batch in enumerate(eval_data):
            if num_batch is not None and nbatch == num_batch:
                break
            self.forward(batch, is_train=False)
            self.update_metric(eval_metric, batch.label)
            if batch_end_callback is not None:
                for cb in _as_list(batch_end_callback):
                    cb(BatchEndParam(epoch, nbatch, eval_metric, locals()))
        return eval_metric.get_name_value()

    def predict(self, eval_data, num_batch=None, merge_batches=True,
                reset=True, always_output_list=False):
        assert self.binded and self.params_initialized
        if reset:
            eval_data.reset()
        outputs = []
        for nbatch, batch in enumerate(eval_data):
            if num_batch is not None and nbatch == num_batch:
                break
            self.forward(batch, is_train=False)
            pad = batch.pad or 0
            outs = [_wrap(o._data[: o.shape[0] - pad].clone(), o.context)
                    for o in self.get_outputs()]
            outputs.append(outs)
        if not outputs:
            return []
        if merge_batches:
            num_out = len(outputs[0])
            merged = [_wrap(torch.cat([b[i]._data for b in outputs]), outputs[0][i].context)
                      for i in range(num_out)]
            if num_out == 1 and not always_output_list:
                return merged[0]
            return merged
        return outputs

    def fit(self, train_data, eval_data=None, eval_metric="acc",
            epoch_end_callback=None, batch_end_callback=None,
            kvstore="local", optimizer="sgd",
            optimizer_params=(("learning_rate", 0.01),),
            eval_end_callback=None, eval_batch_end_callback=None,
            initializer=None, arg_params=None, aux_params=None,
            allow_missing=False, force_rebind=False, force_init=False,
            begin_epoch=0, num_epoch=None, validation_metric=None,
            monitor=None):
        """The canonical fit loop (parity: ``BaseModule.fit`` —
        [U:python/mxnet/module/base_module.py])."""
        assert num_epoch is not None, "num_epoch required for fit"
        from ..initializer import Uniform
        initializer = initializer or Uniform(0.01)

        self.bind(data_shapes=train_data.provide_data,
                  label_shapes=train_data.provide_label,
                  for_training=True, force_rebind=force_rebind)
        self.init_params(initializer=initializer, arg_params=arg_params,
                         aux_params=aux_params, allow_missing=allow_missing,
                         force_init=force_init)
        self.init_optimizer(kvstore=kvstore, optimizer=optimizer,
                            optimizer_params=optimizer_params)

        eval_metric = _as_metric(eval_metric)
        validation_metric = _as_metric(validation_metric) if validation_metric else eval_metric

        for epoch in range(begin_epoch, num_epoch):
            tic = time.time()
            eval_metric.reset()
            nbatch = 0
            for batch in train_data:
                self.forward_backward(batch)
                self.update()
                self.update_metric(eval_metric, batch.label)
                if batch_end_callback is not None:
                    for cb in _as_list(batch_end_callback):
                        cb(BatchEndParam(epoch, nbatch, eval_metric, locals()))
                nbatch += 1
            for name, val in eval_metric.get_name_value():
                self.logger.info("Epoch[%d] Train-%s=%f", epoch, name, val)
            self.logger.info("Epoch[%d] Time cost=%.3f", epoch, time.time() - tic)
            if epoch_end_callback is not None:
                arg_params, aux_params = self.get_params()
                for cb in _as_list(epoch_end_callback):
                    cb(epoch, self.symbol, arg_params, aux_params)
            if eval_data is not None:
                res = self.score(eval_data, validation_metric,
                                 epoch=epoch,
                                 batch_end_callback=eval_batch_end_callback)
                for name, val in res:
                    self.logger.info("Epoch[%d] Validation-%s=%f", epoch, name, val)
            train_data.reset()


class BatchEndParam:
    def __init__(self, epoch, nbatch, eval_metric, locals_):
        self.epoch = epoch
        self.nbatch = nbatch
        self.eval_metric = eval_metric
        self.locals = locals_


def _as_list(x):
    return x if isinstance(x, (list, tuple)) else [x]
