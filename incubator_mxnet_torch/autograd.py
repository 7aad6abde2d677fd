"""Autograd of the port: MXNet's recording scopes and ``backward`` over
PyTorch's autograd.

Counterpart of the JAX package's ``autograd.py``.  There, a tape records
each op's vjp; here PyTorch records the graph, and these scopes decide when
it does: ``record()`` turns PyTorch's grad mode on (and Blocks run with it
off outside ``record()``, as MXNet runs a network off the tape), ``pause()``
turns it off.  The training flag that Dropout reads travels with the
scopes, as in MXNet: ``record()`` trains unless ``train_mode=False``.

Gradients land in each Parameter's own buffer with MXNet's ``grad_req``
semantics (``gluon/parameter.py``), whether the backward is started by
``backward(heads)`` here or by PyTorch's ``Tensor.backward``.
"""
from __future__ import annotations

import contextlib
import threading

import torch

__all__ = ["record", "pause", "train_mode", "predict_mode", "is_recording", "is_training",
           "set_recording", "set_training", "backward", "Function"]

_tls = threading.local()


def is_recording():
    return getattr(_tls, "recording", False)


def is_training():
    return getattr(_tls, "training", False)


def set_recording(is_record):
    """Set the recording flag (and PyTorch's grad mode with it); returns
    the previous flag."""
    prev = is_recording()
    _tls.recording = bool(is_record)
    torch.set_grad_enabled(bool(is_record))
    return prev


def set_training(train_mode_):
    """Set the training flag; returns the previous one."""
    prev = is_training()
    _tls.training = bool(train_mode_)
    return prev


@contextlib.contextmanager
def _scope(recording, training):
    prev_r, prev_t, prev_grad = is_recording(), is_training(), torch.is_grad_enabled()
    if recording is not None:
        _tls.recording = recording
        torch.set_grad_enabled(recording)
    if training is not None:
        _tls.training = training
    try:
        yield
    finally:
        _tls.recording, _tls.training = prev_r, prev_t
        torch.set_grad_enabled(prev_grad)


def record(train_mode=True):
    """Scope in which Blocks and ops are recorded for ``backward``."""
    return _scope(True, train_mode)


def pause(train_mode=False):
    """Scope in which recording is suspended (metrics, say)."""
    return _scope(False, train_mode)


def train_mode():
    return _scope(None, True)


def predict_mode():
    return _scope(None, False)


def backward(heads, head_grads=None, retain_graph=False, train_mode=True):
    """Back-propagate from ``heads`` (a tensor or a list), seeding each
    with ``head_grads`` or, as MXNet does, with ones, so a per-sample loss
    vector needs no ``.sum()``.  Gradients land in the Parameters' buffers
    by their ``grad_req``."""
    if isinstance(heads, torch.Tensor):
        heads = [heads]
    if head_grads is None:
        head_grads = [None] * len(heads)
    elif isinstance(head_grads, torch.Tensor):
        head_grads = [head_grads]
    if len(heads) != len(head_grads):
        raise ValueError("heads and head_grads length mismatch")
    for h in heads:
        if not h.requires_grad:
            raise ValueError(
                "cannot differentiate a head that is not part of the recorded "
                "graph; compute it inside autograd.record() from Parameters")
    seeds = [torch.ones_like(h) if g is None else g for h, g in zip(heads, head_grads)]
    torch.autograd.backward(heads, seeds, retain_graph=retain_graph)


class _Bridge(torch.autograd.Function):
    """Runs a user ``Function``'s forward and backward inside PyTorch's
    graph, with recording paused in both."""

    @staticmethod
    def forward(ctx, func, *inputs):
        ctx.func = func
        with pause():
            outputs = func.forward(*inputs)
        return tuple(outputs) if isinstance(outputs, list) else outputs

    @staticmethod
    def backward(ctx, *output_grads):
        with pause():
            grads = ctx.func.backward(*output_grads)
        if not isinstance(grads, (tuple, list)):
            grads = (grads,)
        return (None, *grads)


class Function:
    """Customizable differentiable function (parity: ``mx.autograd.Function``).

    Subclass and implement ``forward(self, *inputs)`` and
    ``backward(self, *output_grads)`` on tensors; recording is paused inside
    both.  ``backward`` returns one gradient (or None) per input."""

    def __init__(self):
        self._saved = None

    def save_for_backward(self, *args):
        self._saved = args

    @property
    def saved_tensors(self):
        return self._saved

    def forward(self, *inputs):
        raise NotImplementedError

    def backward(self, *output_grads):
        raise NotImplementedError

    def __call__(self, *inputs):
        if is_recording() and any(isinstance(x, torch.Tensor) and x.requires_grad
                                  for x in inputs):
            out = _Bridge.apply(self, *inputs)
            return out if isinstance(out, torch.Tensor) else list(out)
        with pause():
            out = self.forward(*inputs)
        return out if not isinstance(out, tuple) else list(out)
