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
``backward(heads)`` here or by PyTorch's ``Tensor.backward``.  ``grad``
returns gradients without touching those buffers, and with
``create_graph=True`` returns them differentiable, on PyTorch's own
``create_graph``: higher-order gradients.  The attention kernels have no
double backward: on the card a differentiable gradient through them raises
(``ops/attention.py``), on the CPU it goes through the plain attention.

``backward(grad_ready_hook=hook)`` calls ``hook(leaf)`` once for each leaf
the moment its gradient is final and written to its buffer, while the rest
of the backward runs: PyTorch runs a leaf's gradient accumulation once,
after every contribution to it, and the port's own hook that moves the
gradient into the buffer (``Parameter._take_grad``,
``NDArray._take_grad``) then calls :func:`_grad_ready`.  ``leaf`` is the
Parameter's tensor (``param.data()``) or the ``attach_grad`` NDArray.
``Trainer.backward`` launches each gradient bucket's all-reduce from it.
"""
from __future__ import annotations

import contextlib
import threading

import torch

__all__ = ["record", "pause", "train_mode", "predict_mode", "is_recording", "is_training",
           "set_recording", "set_training", "backward", "grad", "mark_variables", "Function"]

_tls = threading.local()
# the grad_ready_hook of each backward in flight (the hooks run on
# PyTorch's backward threads, so the list is the process's, not a thread's)
_ready_hooks = []


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


def _tensor(x):
    return getattr(x, "_data", x)  # an NDArray's tensor, or the tensor itself


def backward(heads, head_grads=None, retain_graph=False, train_mode=True,
             grad_ready_hook=None):
    """Back-propagate from ``heads`` (a tensor or NDArray, or a list), seeding
    each with ``head_grads`` or, as MXNet does, with ones, so a per-sample
    loss vector needs no ``.sum()``.  Gradients land in the Parameters'
    buffers (and attached NDArrays' ``grad``) by their ``grad_req``.
    ``grad_ready_hook(leaf)`` is called for each leaf as soon as its
    gradient is final and written (see the module doc), while the backward
    goes on; an exception it raises ends the backward and propagates."""
    if not isinstance(heads, (list, tuple)):
        heads = [heads]
    if head_grads is None:
        head_grads = [None] * len(heads)
    elif not isinstance(head_grads, (list, tuple)):
        head_grads = [head_grads]
    heads = [_tensor(h) for h in heads]
    head_grads = [None if g is None else _tensor(g) for g in head_grads]
    if len(heads) != len(head_grads):
        raise ValueError("heads and head_grads length mismatch")
    for h in heads:
        if not h.requires_grad:
            raise ValueError(
                "cannot differentiate a head that is not part of the recorded "
                "graph; compute it inside autograd.record() from Parameters")
    seeds = [torch.ones_like(h) if g is None else g for h, g in zip(heads, head_grads)]
    if grad_ready_hook is None:
        torch.autograd.backward(heads, seeds, retain_graph=retain_graph)
        return
    _ready_hooks.append(grad_ready_hook)
    try:
        torch.autograd.backward(heads, seeds, retain_graph=retain_graph)
    finally:
        _ready_hooks.remove(grad_ready_hook)


def _grad_ready(leaf):
    """A leaf's gradient is final and in its buffer: call the readiness
    hook of each backward in flight."""
    for hook in tuple(_ready_hooks):
        hook(leaf)


def grad(heads, variables, head_grads=None, retain_graph=None, create_graph=False,
         train_mode=True):
    """Gradients of ``heads`` with respect to ``variables`` (parity:
    ``mx.autograd.grad``), seeded with ``head_grads`` or ones, returned
    instead of written to any gradient buffer.  ``variables`` is one array
    or a list: NDArrays (``attach_grad``) or tensors that require a
    gradient; a variable the heads do not reach gets zeros.  An NDArray in
    gives an NDArray out.  ``create_graph=True`` records the backward, so
    the gradients can be differentiated again; ``retain_graph`` defaults to
    ``create_graph``.  ``train_mode`` is the reference's (Dropout reads the
    flag in the forward, which has run)."""
    single = not isinstance(variables, (list, tuple))
    variables = [variables] if single else list(variables)
    tensors = [_tensor(v) for v in variables]
    for v, t in zip(variables, tensors):
        if not (isinstance(t, torch.Tensor) and t.requires_grad):
            raise ValueError(
                "variables passed to autograd.grad must be part of the recorded graph: "
                "attach_grad() (or mark_variables) before recording, or Parameters' data()")
    if not isinstance(heads, (list, tuple)):
        heads = [heads]
    if head_grads is None:
        head_grads = [None] * len(heads)
    elif not isinstance(head_grads, (list, tuple)):
        head_grads = [head_grads]
    heads = [_tensor(h) for h in heads]
    if len(heads) != len(head_grads):
        raise ValueError("heads and head_grads length mismatch")
    for h in heads:
        if not h.requires_grad:
            raise ValueError("cannot differentiate a head that is not part of the recorded "
                             "graph")
    seeds = [torch.ones_like(h) if g is None else _tensor(g) for h, g in zip(heads, head_grads)]
    keep = create_graph if retain_graph is None else bool(retain_graph)
    with _scope(bool(create_graph), train_mode):
        got = torch.autograd.grad(heads, tensors, seeds, retain_graph=keep,
                                  create_graph=bool(create_graph), allow_unused=True)
    out = []
    for v, t, g in zip(variables, tensors, got):
        g = torch.zeros_like(t) if g is None else g
        if v is not t:  # an NDArray: the currency rule
            from .ndarray.ndarray import _wrap
            g = _wrap(g, getattr(v, "_ctx", None))
        out.append(g)
    return out[0] if single else out


def mark_variables(variables, gradients, grad_reqs="write"):
    """Make each NDArray of ``variables`` a leaf of the graph whose gradient
    a backward writes (``"write"``), adds (``"add"``) or skips (``"null"``)
    into the NDArray of ``gradients`` given for it (parity:
    ``mx.autograd.mark_variables``, the legacy form of ``attach_grad``)."""
    if isinstance(grad_reqs, str):
        grad_reqs = [grad_reqs] * len(variables)
    for v, g, req in zip(variables, gradients, grad_reqs):
        v.attach_grad(req)
        v._grad = g


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
