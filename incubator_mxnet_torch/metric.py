"""Evaluation metrics (parity: [U:python/mxnet/metric.py]).

Counterpart of the JAX package's ``metric.py``: the same registry and
``EvalMetric`` classes.  ``update()`` takes NDArrays, tensors or numpy
arrays and accumulates on the host, as the reference does: each update
copies the outputs and labels to the host, one synchronisation with the
card a batch.
"""
from __future__ import annotations

import numpy as _np
import torch

from .ndarray.ndarray import NDArray

__all__ = [
    "EvalMetric",
    "Accuracy",
    "TopKAccuracy",
    "F1",
    "MCC",
    "PCC",
    "MAE",
    "MSE",
    "RMSE",
    "CrossEntropy",
    "NegativeLogLikelihood",
    "Perplexity",
    "PearsonCorrelation",
    "Loss",
    "CompositeEvalMetric",
    "CustomMetric",
    "create",
    "np",
]

_REGISTRY = {}


def register(klass):
    _REGISTRY[klass.__name__.lower()] = klass
    return klass


def create(metric, *args, **kwargs):
    if callable(metric):
        return CustomMetric(metric, *args, **kwargs)
    if isinstance(metric, EvalMetric):
        return metric
    if isinstance(metric, (list, tuple)):
        composite = CompositeEvalMetric()
        for m in metric:
            composite.add(create(m, *args, **kwargs))
        return composite
    name = metric.lower()
    aliases = {"acc": "accuracy", "ce": "crossentropy", "nll_loss": "negativeloglikelihood",
               "top_k_accuracy": "topkaccuracy", "top_k_acc": "topkaccuracy"}
    name = aliases.get(name, name)
    return _REGISTRY[name](*args, **kwargs)


def _to_np(x):
    if isinstance(x, NDArray):
        return x.asnumpy()
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return (x.float() if x.dtype == torch.bfloat16 else x).cpu().numpy()
    return _np.asarray(x)


class EvalMetric:
    def __init__(self, name, output_names=None, label_names=None, **kwargs):
        self.name = name
        self.output_names = output_names
        self.label_names = label_names
        self._kwargs = kwargs
        self.reset()

    def reset(self):
        self.num_inst = 0
        self.sum_metric = 0.0

    def update(self, labels, preds):
        raise NotImplementedError

    def update_dict(self, label, pred):
        lab = list(label.values()) if self.label_names is None else [label[n] for n in self.label_names]
        prd = list(pred.values()) if self.output_names is None else [pred[n] for n in self.output_names]
        self.update(lab, prd)

    def get(self):
        if self.num_inst == 0:
            return (self.name, float("nan"))
        return (self.name, self.sum_metric / self.num_inst)

    def get_name_value(self):
        name, value = self.get()
        if not isinstance(name, list):
            name = [name]
        if not isinstance(value, list):
            value = [value]
        return list(zip(name, value))

    def __str__(self):
        return f"EvalMetric: {dict(self.get_name_value())}"


def _as_list(x):
    return x if isinstance(x, (list, tuple)) else [x]


@register
class Accuracy(EvalMetric):
    def __init__(self, axis=1, name="accuracy", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)
        self.axis = axis

    def update(self, labels, preds):
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            pred = _to_np(pred)
            label = _to_np(label)
            if pred.ndim > label.ndim:
                pred = pred.argmax(axis=self.axis)
            pred = pred.astype("int32").reshape(-1)
            label = label.astype("int32").reshape(-1)
            self.sum_metric += float((pred == label).sum())
            self.num_inst += len(label)


@register
class TopKAccuracy(EvalMetric):
    def __init__(self, top_k=1, name="top_k_accuracy", output_names=None, label_names=None):
        super().__init__(f"{name}_{top_k}", output_names, label_names)
        self.top_k = top_k

    def update(self, labels, preds):
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            pred = _to_np(pred)
            label = _to_np(label).astype("int32").reshape(-1)
            topk = _np.argsort(-pred, axis=-1)[:, : self.top_k]
            self.sum_metric += float((topk == label[:, None]).any(axis=1).sum())
            self.num_inst += len(label)


class _BinaryStats(EvalMetric):
    """Shared binary confusion-matrix accumulation (F1/MCC base).  Labels
    must be binary — multi-class input raises, matching the reference."""

    def __init__(self, name, output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)
        self.reset_stats()

    def reset_stats(self):
        self.tp = self.fp = self.fn = self.tn = 0.0

    def reset(self):
        super().reset()
        if hasattr(self, "tp"):
            self.reset_stats()

    def update(self, labels, preds):
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            pred = _to_np(pred)
            label = _to_np(label).reshape(-1).astype("int32")
            if pred.ndim > 1:
                pred = pred.argmax(axis=-1)
            pred = pred.reshape(-1).astype("int32")
            if ((label < 0) | (label > 1)).any() or ((pred < 0) | (pred > 1)).any():
                raise ValueError(
                    f"{type(self).__name__} requires binary labels/predictions")
            self.tp += float(((pred == 1) & (label == 1)).sum())
            self.fp += float(((pred == 1) & (label == 0)).sum())
            self.fn += float(((pred == 0) & (label == 1)).sum())
            self.tn += float(((pred == 0) & (label == 0)).sum())
            self.num_inst += 1


@register
class F1(_BinaryStats):
    def __init__(self, name="f1", output_names=None, label_names=None, average="macro"):
        super().__init__(name, output_names, label_names)
        self.average = average

    def get(self):
        prec = self.tp / max(self.tp + self.fp, 1e-12)
        rec = self.tp / max(self.tp + self.fn, 1e-12)
        f1 = 2 * prec * rec / max(prec + rec, 1e-12)
        return (self.name, f1 if self.num_inst else float("nan"))


@register
class MCC(_BinaryStats):
    """Matthews correlation coefficient for binary classification (parity:
    ``mx.metric.MCC``): (tp·tn − fp·fn) / √((tp+fp)(tp+fn)(tn+fp)(tn+fn));
    0 when any denominator factor is 0, the reference convention."""

    def __init__(self, name="mcc", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def get(self):
        if not self.num_inst:
            return (self.name, float("nan"))
        denom = ((self.tp + self.fp) * (self.tp + self.fn)
                 * (self.tn + self.fp) * (self.tn + self.fn))
        if denom == 0:
            return (self.name, 0.0)
        return (self.name,
                (self.tp * self.tn - self.fp * self.fn) / _np.sqrt(denom))


@register
class PCC(EvalMetric):
    """Multiclass Pearson correlation coefficient over a running k x k
    confusion matrix (parity: ``mx.metric.PCC`` — the R_k statistic;
    reduces to MCC for binary problems)."""

    def __init__(self, name="pcc", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def reset(self):
        super().reset()
        self._cm = _np.zeros((0, 0), dtype=_np.float64)

    def _grow(self, k):
        if k > self._cm.shape[0]:
            cm = _np.zeros((k, k), dtype=_np.float64)
            old = self._cm.shape[0]
            cm[:old, :old] = self._cm
            self._cm = cm

    def update(self, labels, preds):
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            label, pred = _to_np(label), _to_np(pred)
            if pred.ndim > 1 and pred.shape[-1] > 1:
                pred = pred.argmax(-1)
            pred = pred.reshape(-1)
            if _np.issubdtype(pred.dtype, _np.floating):
                if pred.size and 0.0 <= pred.min() and pred.max() <= 1.0:
                    pred = (pred >= 0.5)  # binary probabilities
                else:
                    pred = _np.rint(pred)
            label = label.reshape(-1).astype(_np.int64)
            pred = pred.astype(_np.int64)
            if label.size and (label.min() < 0 or pred.min() < 0):
                raise ValueError(
                    "PCC: negative class index (mask out ignore labels "
                    "before updating)")
            k = int(max(label.max(initial=0), pred.max(initial=0))) + 1
            self._grow(k)
            _np.add.at(self._cm, (label, pred), 1.0)
            self.num_inst += label.size

    def get(self):
        if not self.num_inst:
            return (self.name, float("nan"))
        cm = self._cm
        s = cm.sum()
        c = _np.trace(cm)
        t = cm.sum(axis=1)  # true-class counts
        p = cm.sum(axis=0)  # predicted-class counts
        cov_yy = s * s - (p * p).sum()
        cov_xx = s * s - (t * t).sum()
        if cov_yy == 0 or cov_xx == 0:
            return (self.name, 0.0)
        return (self.name, float((c * s - (t * p).sum())
                                 / _np.sqrt(cov_xx * cov_yy)))


@register
class MAE(EvalMetric):
    def __init__(self, name="mae", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def update(self, labels, preds):
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            label, pred = _to_np(label), _to_np(pred)
            self.sum_metric += float(_np.abs(label.reshape(pred.shape) - pred).mean())
            self.num_inst += 1


@register
class MSE(EvalMetric):
    def __init__(self, name="mse", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def update(self, labels, preds):
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            label, pred = _to_np(label), _to_np(pred)
            self.sum_metric += float(((label.reshape(pred.shape) - pred) ** 2).mean())
            self.num_inst += 1


@register
class RMSE(MSE):
    def __init__(self, name="rmse", output_names=None, label_names=None):
        EvalMetric.__init__(self, name, output_names, label_names)

    def get(self):
        if self.num_inst == 0:
            return (self.name, float("nan"))
        return (self.name, float(_np.sqrt(self.sum_metric / self.num_inst)))


@register
class CrossEntropy(EvalMetric):
    def __init__(self, eps=1e-12, name="cross-entropy", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)
        self.eps = eps

    def update(self, labels, preds):
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            label = _to_np(label).astype("int32").reshape(-1)
            pred = _to_np(pred)
            prob = pred[_np.arange(label.shape[0]), label]
            self.sum_metric += float((-_np.log(prob + self.eps)).sum())
            self.num_inst += label.shape[0]


@register
class NegativeLogLikelihood(CrossEntropy):
    def __init__(self, eps=1e-12, name="nll-loss", output_names=None, label_names=None):
        EvalMetric.__init__(self, name, output_names, label_names)
        self.eps = eps


@register
class Perplexity(CrossEntropy):
    def __init__(self, ignore_label=None, axis=-1, name="perplexity", output_names=None, label_names=None):
        EvalMetric.__init__(self, name, output_names, label_names)
        self.eps = 1e-12
        self.ignore_label = ignore_label
        self.axis = axis

    def update(self, labels, preds):
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            label = _to_np(label).astype("int32").reshape(-1)
            pred = _to_np(pred).reshape(label.shape[0], -1)
            prob = pred[_np.arange(label.shape[0]), label]
            if self.ignore_label is not None:
                ignore = label == self.ignore_label
                prob = _np.where(ignore, 1.0, prob)
                self.num_inst += int((~ignore).sum())
            else:
                self.num_inst += label.shape[0]
            self.sum_metric += float((-_np.log(prob + self.eps)).sum())

    def get(self):
        if self.num_inst == 0:
            return (self.name, float("nan"))
        return (self.name, float(_np.exp(self.sum_metric / self.num_inst)))


@register
class PearsonCorrelation(EvalMetric):
    def __init__(self, name="pearsonr", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def update(self, labels, preds):
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            label, pred = _to_np(label).reshape(-1), _to_np(pred).reshape(-1)
            self.sum_metric += float(_np.corrcoef(label, pred)[0, 1])
            self.num_inst += 1


@register
class Loss(EvalMetric):
    def __init__(self, name="loss", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def update(self, _, preds):
        for pred in _as_list(preds):
            loss = _to_np(pred)
            self.sum_metric += float(loss.sum())
            self.num_inst += loss.size


class CompositeEvalMetric(EvalMetric):
    def __init__(self, metrics=None, name="composite", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)
        self.metrics = [create(m) for m in (metrics or [])]

    def add(self, metric):
        self.metrics.append(create(metric))

    def update(self, labels, preds):
        for m in self.metrics:
            m.update(labels, preds)

    def reset(self):
        for m in getattr(self, "metrics", []):
            m.reset()

    def get(self):
        names, values = [], []
        for m in self.metrics:
            n, v = m.get()
            names.extend(n if isinstance(n, list) else [n])
            values.extend(v if isinstance(v, list) else [v])
        return (names, values)


class CustomMetric(EvalMetric):
    def __init__(self, feval, name="custom", allow_extra_outputs=False, output_names=None, label_names=None):
        super().__init__(f"custom({name})", output_names, label_names)
        self._feval = feval

    def update(self, labels, preds):
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            val = self._feval(_to_np(label), _to_np(pred))
            if isinstance(val, tuple):
                s, n = val
                self.sum_metric += s
                self.num_inst += n
            else:
                self.sum_metric += val
                self.num_inst += 1


np = CustomMetric  # legacy alias: mx.metric.np wraps a numpy feval
