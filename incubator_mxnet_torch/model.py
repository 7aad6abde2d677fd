"""Checkpoint save/load helpers and ``FeedForward`` (parity:
[U:python/mxnet/model.py]).

Counterpart of the JAX package's ``model.py``: ``save_checkpoint`` and
``load_checkpoint`` write and read ``prefix-symbol.json`` and
``prefix-NNNN.params`` an epoch, the params file in the port's format
(``ndarray/utils.py``) with the reference's ``arg:``/``aux:`` key prefixes,
which either package reads.  ``FeedForward`` is the pre-Module training
wrapper, a thin shim over ``mx.mod.Module``.
"""
from __future__ import annotations

import numpy as _np

from .ndarray.utils import save as _nd_save, load as _nd_load

__all__ = ["save_checkpoint", "load_checkpoint", "BatchEndParam"]

import collections

BatchEndParam = collections.namedtuple(
    "BatchEndParam", ["epoch", "nbatch", "eval_metric", "locals"]
)


def save_checkpoint(prefix, epoch, symbol, arg_params, aux_params, remove_amp_cast=True):
    """Parity: ``mx.model.save_checkpoint``."""
    if symbol is not None:
        with open(f"{prefix}-symbol.json", "w") as f:
            f.write(symbol.tojson(remove_amp_cast=remove_amp_cast) if hasattr(symbol, "tojson") else "{}")
    save_dict = {f"arg:{k}": v for k, v in (arg_params or {}).items()}
    save_dict.update({f"aux:{k}": v for k, v in (aux_params or {}).items()})
    _nd_save(f"{prefix}-{epoch:04d}.params", save_dict)


def load_checkpoint(prefix, epoch):
    """Parity: ``mx.model.load_checkpoint`` — returns (symbol, arg_params,
    aux_params), the arrays on the CPU context."""
    import os

    symbol = None
    sym_file = f"{prefix}-symbol.json"
    if os.path.exists(sym_file):
        from . import symbol as _sym_mod

        symbol = _sym_mod.load(sym_file) if hasattr(_sym_mod, "load") else None
    from .context import cpu

    save_dict = _nd_load(f"{prefix}-{epoch:04d}.params", ctx=cpu())
    arg_params, aux_params = {}, {}
    for k, v in save_dict.items():
        tp, _, name = k.partition(":")
        if tp == "arg":
            arg_params[name] = v
        elif tp == "aux":
            aux_params[name] = v
        else:
            arg_params[k] = v
    return symbol, arg_params, aux_params


class FeedForward:
    """The pre-Module training wrapper (parity: [U:python/mxnet/model.py]
    FeedForward — deprecated upstream since 0.x but still shipped; kept
    for script compatibility).  Thin shim over ``mx.mod.Module``: fit on
    arrays/DataIters, predict, score, save/load checkpoints."""

    def __init__(self, symbol, ctx=None, num_epoch=None, epoch_size=None,
                 optimizer="sgd", initializer=None, numpy_batch_size=128,
                 arg_params=None, aux_params=None, begin_epoch=0, **kwargs):
        self.symbol = symbol
        self.ctx = ctx
        self.num_epoch = num_epoch
        self.optimizer = optimizer
        self.initializer = initializer
        self.numpy_batch_size = numpy_batch_size
        self.arg_params = arg_params
        self.aux_params = aux_params
        self.begin_epoch = begin_epoch
        self.epoch_size = epoch_size
        # every remaining kwarg is an optimizer hyperparameter (the
        # reference forwards them all — beta1/epsilon/gamma1/...)
        self._optimizer_params = dict(kwargs)
        self._module = None

    def _as_iter(self, X, y=None, shuffle=False):
        from . import io as io_mod
        from .io.io import DataIter

        if isinstance(X, DataIter):
            return X
        n = X.shape[0] if hasattr(X, "shape") else len(X)
        bs = min(self.numpy_batch_size, n)
        return io_mod.NDArrayIter(X, y, bs, shuffle=shuffle,
                                  last_batch_handle="pad")

    def fit(self, X, y=None, eval_data=None, eval_metric="acc",
            batch_end_callback=None, epoch_end_callback=None, logger=None):
        import logging

        from . import module as module_mod
        from . import io as io_mod

        it = self._as_iter(X, y, shuffle=True)
        if self.epoch_size is not None:
            it = io_mod.ResizeIter(it, self.epoch_size)
        num_epoch = (self.num_epoch if self.num_epoch is not None
                     else self.begin_epoch + 1)
        if num_epoch <= self.begin_epoch:
            logging.getLogger(__name__).warning(
                "FeedForward.fit: num_epoch (%d) <= begin_epoch (%d) — "
                "no epochs will run (num_epoch counts TOTAL epochs; pass "
                "num_epoch > begin_epoch to resume training)",
                num_epoch, self.begin_epoch)
        data_names = tuple(d.name for d in it.provide_data)
        label_names = tuple(d.name for d in it.provide_label)
        self._module = module_mod.Module(self.symbol, data_names=data_names,
                                         label_names=label_names,
                                         context=self.ctx)
        self._module.fit(
            it, eval_data=eval_data, eval_metric=eval_metric,
            optimizer=self.optimizer, optimizer_params=self._optimizer_params,
            initializer=self.initializer, arg_params=self.arg_params,
            aux_params=self.aux_params, begin_epoch=self.begin_epoch,
            num_epoch=num_epoch,
            batch_end_callback=batch_end_callback,
            epoch_end_callback=epoch_end_callback)
        self.arg_params, self.aux_params = self._module.get_params()
        return self

    def _inference_module(self, it):
        from . import module as module_mod

        if self._module is not None and self._module.binded:
            return self._module
        mod = module_mod.Module(self.symbol,
                                data_names=tuple(d.name for d in it.provide_data),
                                label_names=(), context=self.ctx)
        mod.bind(data_shapes=it.provide_data, for_training=False)
        # loss-head label variables (e.g. softmax_label) are arguments
        # of the saved symbol but are inputs, not params — inference
        # ignores them, so let them default
        mod.set_params(self.arg_params or {}, self.aux_params or {},
                       allow_missing=True)
        self._module = mod
        return mod

    def predict(self, X, num_batch=None):
        it = self._as_iter(X)
        return self._inference_module(it).predict(it, num_batch=num_batch).asnumpy()

    def score(self, X, y=None, eval_metric="acc"):
        from . import metric as metric_mod
        from .io.io import DataIter

        m = metric_mod.create(eval_metric)
        if isinstance(X, DataIter):
            it = X
            return dict(self._inference_module(it).score(it, m))
        # array inputs: metric over pad-stripped predictions — exact, no
        # double-counted wrap samples
        preds = self.predict(X)
        m.update([_np.asarray(y)], [preds])
        return dict([m.get()] if not isinstance(m.get()[0], list)
                    else zip(*m.get()))

    def save(self, prefix, epoch=None):
        save_checkpoint(prefix, epoch if epoch is not None else
                        (self.num_epoch or 0), self.symbol,
                        self.arg_params or {}, self.aux_params or {})

    @staticmethod
    def load(prefix, epoch, ctx=None, **kwargs):
        sym, arg_params, aux_params = load_checkpoint(prefix, epoch)
        return FeedForward(sym, ctx=ctx, arg_params=arg_params,
                           aux_params=aux_params, begin_epoch=epoch, **kwargs)

    @staticmethod
    def create(symbol, X, y=None, ctx=None, num_epoch=1, **kwargs):
        m = FeedForward(symbol, ctx=ctx, num_epoch=num_epoch, **kwargs)
        m.fit(X, y)
        return m


__all__.append("FeedForward")
