"""Training callbacks (parity: [U:python/mxnet/callback.py]):
Speedometer throughput logging, checkpointing, validation-metric logging.

Counterpart of the JAX package's ``callback.py``.  ``Speedometer``'s rate
is wall-clock time between two of its log lines: on the card it includes
the metric's host copy of every batch."""
from __future__ import annotations

import logging
import time

__all__ = ["Speedometer", "do_checkpoint", "module_checkpoint", "log_train_metric", "ProgressBar", "LogValidationMetricsCallback"]


class Speedometer:
    """Logs samples/sec every ``frequent`` batches (parity:
    ``mx.callback.Speedometer``)."""

    def __init__(self, batch_size, frequent=50, auto_reset=True):
        self.batch_size = batch_size
        self.frequent = frequent
        self.auto_reset = auto_reset
        self.init = False
        self.tic = 0
        self.last_count = 0

    def __call__(self, param):
        count = param.nbatch
        if self.last_count > count:
            self.init = False
        self.last_count = count
        if self.init:
            if count % self.frequent == 0:
                speed = self.frequent * self.batch_size / (time.time() - self.tic)
                if param.eval_metric is not None:
                    name_value = param.eval_metric.get_name_value()
                    if self.auto_reset:
                        param.eval_metric.reset()
                    msg = "Epoch[%d] Batch [%d]\tSpeed: %.2f samples/sec\t%s" % (
                        param.epoch,
                        count,
                        speed,
                        "\t".join(f"{n}={v:f}" for n, v in name_value),
                    )
                else:
                    msg = "Iter[%d] Batch [%d]\tSpeed: %.2f samples/sec" % (param.epoch, count, speed)
                logging.info(msg)
                self.tic = time.time()
        else:
            self.init = True
            self.tic = time.time()


def do_checkpoint(prefix, period=1):
    """Epoch-end checkpoint callback (parity: ``mx.callback.do_checkpoint``)."""
    period = int(max(1, period))

    def _callback(iter_no, sym, arg, aux):
        if (iter_no + 1) % period == 0:
            from .model import save_checkpoint

            save_checkpoint(prefix, iter_no + 1, sym, arg, aux)

    return _callback


def log_train_metric(period, auto_reset=False):
    def _callback(param):
        if param.nbatch % period == 0 and param.eval_metric is not None:
            name_value = param.eval_metric.get_name_value()
            logging.info(
                "Iter[%d] Batch[%d] Train-%s",
                param.epoch,
                param.nbatch,
                "\t".join(f"{n}={v:f}" for n, v in name_value),
            )
            if auto_reset:
                param.eval_metric.reset()

    return _callback


class ProgressBar:
    def __init__(self, total, length=80):
        self.bar_len = length
        self.total = total

    def __call__(self, param):
        count = param.nbatch
        filled_len = int(round(self.bar_len * count / float(self.total)))
        percents = int(round(100.0 * count / float(self.total)))
        prog_bar = "=" * filled_len + "-" * (self.bar_len - filled_len)
        logging.info("[%s] %s%s\r", prog_bar, percents, "%")


class LogValidationMetricsCallback:
    def __call__(self, param):
        if param.eval_metric is None:
            return
        for name, value in param.eval_metric.get_name_value():
            logging.info("Epoch[%d] Validation-%s=%f", param.epoch, name, value)


def module_checkpoint(mod, prefix, period=1, save_optimizer_states=False):
    """Epoch-end callback saving a Module's checkpoint (parity:
    ``mx.callback.module_checkpoint``)."""
    period = int(max(1, period))

    def _callback(iter_no, sym=None, arg=None, aux=None):
        if (iter_no + 1) % period == 0:
            mod.save_checkpoint(prefix, iter_no + 1,
                                save_optimizer_states=save_optimizer_states)

    return _callback
