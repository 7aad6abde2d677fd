"""Loss blocks (parity: MXNet's ``gluon.loss``).

Counterpart of the JAX package's ``gluon/loss.py``, with its losses and
their semantics: HybridBlocks returning a per-sample loss vector (the
batch axis kept; ``PoissonNLLLoss`` the mean), scaled by ``weight`` and
``sample_weight``.
"""
from __future__ import annotations

import numpy as _np
import torch

from .block import HybridBlock

__all__ = ["Loss", "L2Loss", "L1Loss", "SigmoidBinaryCrossEntropyLoss", "SigmoidBCELoss",
           "SoftmaxCrossEntropyLoss", "SoftmaxCELoss", "KLDivLoss", "HuberLoss", "HingeLoss",
           "SquaredHingeLoss", "LogisticLoss", "TripletLoss", "PoissonNLLLoss",
           "CosineEmbeddingLoss", "CTCLoss", "SDMLLoss"]


def _apply_weighting(F, loss, weight=None, sample_weight=None):
    if sample_weight is not None:
        loss = F.broadcast_mul(loss, sample_weight)
    if weight is not None:
        loss = loss * weight
    return loss


def _reshape_like(x, y):
    return x.reshape(y.shape)


class Loss(HybridBlock):
    def __init__(self, weight, batch_axis, **kwargs):
        super().__init__(**kwargs)
        self._weight = weight
        self._batch_axis = batch_axis

    def __repr__(self):
        return f"{self.__class__.__name__}(batch_axis={self._batch_axis}, w={self._weight})"

    def hybrid_forward(self, F, x, *args, **kwargs):
        raise NotImplementedError


class L2Loss(Loss):
    """``weight / 2 · (label − pred)²``, averaged over all but the batch
    axis."""

    def __init__(self, weight=1.0, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        label = _reshape_like(label, pred)
        loss = F.square(label - pred)
        loss = _apply_weighting(F, loss, self._weight / 2, sample_weight)
        return F.mean(loss, axis=self._batch_axis, exclude=True)


class SoftmaxCrossEntropyLoss(Loss):
    """Cross-entropy of ``log_softmax(pred)`` against integer labels
    (``sparse_label``) or a label distribution."""

    def __init__(self, axis=-1, sparse_label=True, from_logits=False, weight=None,
                 batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._axis = axis
        self._sparse_label = sparse_label
        self._from_logits = from_logits

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        if not self._from_logits:
            pred = F.log_softmax(pred, axis=self._axis)
        if self._sparse_label:
            loss = -F.pick(pred, label, axis=self._axis, keepdims=True)
        else:
            label = _reshape_like(label, pred)
            loss = -F.sum(pred * label, axis=self._axis, keepdims=True)
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return F.mean(loss, axis=self._batch_axis, exclude=True)


SoftmaxCELoss = SoftmaxCrossEntropyLoss


class L1Loss(Loss):
    def __init__(self, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        label = _reshape_like(label, pred)
        loss = F.abs(label - pred)
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return F.mean(loss, axis=self._batch_axis, exclude=True)


class SigmoidBinaryCrossEntropyLoss(Loss):
    def __init__(self, from_sigmoid=False, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._from_sigmoid = from_sigmoid

    def hybrid_forward(self, F, pred, label, sample_weight=None, pos_weight=None):
        label = _reshape_like(label, pred)
        if not self._from_sigmoid:
            if pos_weight is None:
                loss = F.relu(pred) - pred * label + F.Activation(-F.abs(pred), act_type="softrelu")
            else:
                log_weight = 1 + F.broadcast_mul(pos_weight - 1, label)
                loss = pred - pred * label + log_weight * (
                    F.Activation(-F.abs(pred), act_type="softrelu") + F.relu(-pred)
                )
        else:
            eps = 1e-12
            if pos_weight is None:
                loss = -(F.log(pred + eps) * label + F.log(1.0 - pred + eps) * (1.0 - label))
            else:
                loss = -(
                    F.broadcast_mul(F.log(pred + eps) * label, pos_weight)
                    + F.log(1.0 - pred + eps) * (1.0 - label)
                )
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return F.mean(loss, axis=self._batch_axis, exclude=True)


SigmoidBCELoss = SigmoidBinaryCrossEntropyLoss


class KLDivLoss(Loss):
    def __init__(self, from_logits=True, axis=-1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._from_logits = from_logits
        self._axis = axis

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        if not self._from_logits:
            pred = F.log_softmax(pred, axis=self._axis)
        loss = label * (F.log(label + 1e-12) - pred)
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return F.mean(loss, axis=self._batch_axis, exclude=True)


class HuberLoss(Loss):
    def __init__(self, rho=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._rho = rho

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        label = _reshape_like(label, pred)
        loss = F.abs(label - pred)
        loss = F.where(
            loss > self._rho, loss - 0.5 * self._rho, (0.5 / self._rho) * F.square(loss)
        )
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return F.mean(loss, axis=self._batch_axis, exclude=True)


class HingeLoss(Loss):
    def __init__(self, margin=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        label = _reshape_like(label, pred)
        loss = F.relu(self._margin - pred * label)
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return F.mean(loss, axis=self._batch_axis, exclude=True)


class SquaredHingeLoss(Loss):
    def __init__(self, margin=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        label = _reshape_like(label, pred)
        loss = F.square(F.relu(self._margin - pred * label))
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return F.mean(loss, axis=self._batch_axis, exclude=True)


class LogisticLoss(Loss):
    def __init__(self, weight=None, batch_axis=0, label_format="signed", **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._label_format = label_format

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        label = _reshape_like(label, pred)
        if self._label_format == "signed":
            label = (label + 1.0) / 2.0
        loss = F.relu(pred) - pred * label + F.Activation(-F.abs(pred), act_type="softrelu")
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return F.mean(loss, axis=self._batch_axis, exclude=True)


class TripletLoss(Loss):
    def __init__(self, margin=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def hybrid_forward(self, F, pred, positive, negative, sample_weight=None):
        positive = _reshape_like(positive, pred)
        negative = _reshape_like(negative, pred)
        loss = F.sum(F.square(positive - pred) - F.square(negative - pred), axis=self._batch_axis, exclude=True)
        loss = F.relu(loss + self._margin)
        return _apply_weighting(F, loss, self._weight, sample_weight)


class SDMLLoss(Loss):
    """Smoothed deep metric learning loss (parity: ``gluon.loss.SDMLLoss``,
    1.6+): paired batches (x1[i] ~ x2[i]) — cross-entropy between the
    row-softmax of negative pairwise L2 distances and a label-smoothed
    identity, so each x1[i] should be closest to its own x2[i] among the
    batch."""

    def __init__(self, smoothing_parameter=0.3, weight=1.0, batch_axis=0,
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._smoothing = smoothing_parameter

    def hybrid_forward(self, F, x1, x2):
        n = x1.shape[0]
        if n < 2:
            raise ValueError("SDMLLoss needs batch size >= 2 (in-batch "
                             "negatives)")
        # pairwise squared L2: [N, N]
        a = F.expand_dims(x1, axis=1)   # [N, 1, D]
        b = F.expand_dims(x2, axis=0)   # [1, N, D]
        dist = F.sum(F.square(F.broadcast_sub(a, b)), axis=2)
        logp = F.log_softmax(-dist, axis=1)
        eye = F.one_hot(F.arange(0, n, ctx=x1.device), depth=n)
        labels = (eye * (1.0 - self._smoothing)
                  + (1.0 - eye) * (self._smoothing / (n - 1)))
        loss = -F.sum(labels * logp, axis=1)
        return _apply_weighting(F, loss, self._weight, None)


class PoissonNLLLoss(Loss):
    def __init__(self, weight=None, from_logits=True, batch_axis=0, compute_full=False, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._from_logits = from_logits
        self._compute_full = compute_full

    def hybrid_forward(self, F, pred, target, sample_weight=None, epsilon=1e-08):
        target = _reshape_like(target, pred)
        if self._from_logits:
            loss = F.exp(pred) - target * pred
        else:
            loss = pred - target * F.log(pred + epsilon)
        if self._compute_full:
            stirling = target * F.log(target + epsilon) - target + 0.5 * F.log(2 * target * _np.pi + epsilon)
            stirling = F.where(target <= 1.0, F.zeros_like(target), stirling)
            loss = loss + stirling
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return F.mean(loss)


class CosineEmbeddingLoss(Loss):
    def __init__(self, weight=None, batch_axis=0, margin=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def hybrid_forward(self, F, input1, input2, label, sample_weight=None):
        input1 = input1.reshape((input1.shape[0], -1))
        input2 = input2.reshape((input2.shape[0], -1))
        cos = F.sum(input1 * input2, axis=1) / (
            F.norm(input1, axis=1) * F.norm(input2, axis=1) + 1e-12
        )
        label = label.reshape((-1,))
        loss = F.where(label == 1, 1.0 - cos, F.relu(cos - self._margin))
        return _apply_weighting(F, loss, self._weight, sample_weight)


class CTCLoss(Loss):
    """Connectionist temporal classification, layout ``'NTC'`` (default) or
    ``'TNC'``, blank label 0.  The JAX package's own trellis (not the
    ``CTCLoss`` op's): probabilities clamped at 1e-30 before the log, -1e30
    for log 0, the recursion one frame at a time under autograd (a position
    no path reaches takes no gradient: the JAX package's is NaN there).  The
    last frame is ``pred_lengths - 1`` when given, else T-1; the last extended
    position is ``2·label_lengths`` when given, else S-1 of the padded
    labels (the padding counts as labels)."""

    def __init__(self, layout="NTC", label_layout="NT", weight=None, **kwargs):
        super().__init__(weight, 0, **kwargs)
        self._layout = layout
        self._label_layout = label_layout

    def hybrid_forward(self, F, pred, label, pred_lengths=None, label_lengths=None,
                       sample_weight=None):
        p = pred.permute(1, 0, 2) if self._layout == "NTC" else pred
        T, B, C = p.shape
        e = torch.exp(p - p.amax(-1, keepdim=True))
        logp = torch.log((e / e.sum(-1, keepdim=True)).clamp_min(1e-30))
        S = 2 * label.shape[1] + 1
        dev = p.device
        ext = torch.zeros((B, S), dtype=torch.long, device=dev)
        ext[:, 1::2] = label.to(torch.long)
        neg = torch.tensor(-1e30, device=dev, dtype=logp.dtype)
        zero = torch.zeros((), device=dev, dtype=logp.dtype)
        fill = lambda n: neg.expand(B, n)  # noqa: E731
        same = torch.cat([torch.zeros((B, 2), dtype=torch.bool, device=dev),
                          ext[:, 2:] == ext[:, :-2]], 1)
        alpha = torch.cat([logp[0].gather(1, ext[:, :2]), fill(S - 2)], 1)
        alphas = [alpha]
        for t in range(1, T):
            a1 = torch.cat([fill(1), alpha[:, :-1]], 1)
            a2 = torch.where(same, neg, torch.cat([fill(2), alpha[:, :-2]], 1))
            m = torch.maximum(torch.maximum(alpha, a1), a2)
            m_safe = torch.where(m == neg, zero, m)
            summed = torch.exp(alpha - m_safe) + torch.exp(a1 - m_safe) + torch.exp(a2 - m_safe)
            # a position no path reaches keeps -1e30; its log(1) keeps the
            # masked branch's gradient 0 (log(0) made it 0/0 = NaN)
            summed = torch.where(m == neg, torch.ones_like(summed), summed)
            new = torch.where(m == neg, neg, m_safe + torch.log(summed))
            alpha = new + logp[t].gather(1, ext)
            alphas.append(alpha)
        alphas = torch.stack(alphas)
        bidx = torch.arange(B, device=dev)
        t_last = (torch.full((B,), T - 1, dtype=torch.long, device=dev) if pred_lengths is None
                  else pred_lengths.to(torch.long) - 1)
        last_s = (torch.full((B,), S - 1, dtype=torch.long, device=dev) if label_lengths is None
                  else (2 * label_lengths).to(torch.long))
        alpha_t = alphas[t_last, bidx]
        loss = -torch.logaddexp(alpha_t[bidx, last_s], alpha_t[bidx, (last_s - 1).clamp_min(0)])
        return _apply_weighting(F, loss, self._weight, sample_weight)
