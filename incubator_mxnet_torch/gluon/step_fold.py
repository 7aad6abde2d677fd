"""One CUDA-graph replay per training step: the Gluon step fold.

Counterpart of the JAX package's ``gluon/step_fold.py``.  There a whole
training step (forward, loss, backward, the fused optimizer tail) is one
compiled, donated-buffer program; here it is one replay of a CUDA graph
(``torch.cuda.CUDAGraph``), which issues the step's hundreds of kernels
with no Python dispatch between them:

* :class:`StepProgram` (``Trainer.fold_step(loss_fn)``): the first call
  (or any call while a parameter is still deferred) runs one eager step on
  a side stream, as capture needs; the next call captures the step body
  (forward, loss, ``autograd.backward``, one ``group_apply`` a fused
  group) into a graph on the program's own memory pool and replays it; each
  call after that copies the batch into the program's static buffers,
  refreshes the optimizer's per-step values on the card and replays.
  Capture does not execute, so every call is exactly one logical step and
  N calls follow the trajectory of N eager steps.  The K-step form
  (``Trainer.fold_steps(loss_fn, k)``) captures K step bodies into one
  graph over a ``[K, batch, ...]`` window.  On CPU tensors there is
  nothing to capture: the program runs the same body directly, its plain
  version (``captured`` is False).
* :class:`EvalProgram` (``Trainer.fold_eval``): the forward-only loss,
  training off, summed into a device fp32 register that ``result()`` reads
  once per evaluation pass.
* :func:`fold_update`: the ``MXNET_STEP_FOLD=1`` path inside
  ``Trainer.step``: the launches of every fused group captured into one
  graph per (group set, pointers) and replayed after refreshing their
  values.

What makes a replay right: the optimizer's per-step values (lr, wd, Adam's
bias-corrected rate, rescale = scale/batch_size) reach the multi-tensor
kernel through device memory, which the host fills before each replay
(``ops/multi_tensor.py``); the dropout generator of the device
(``random.get_generator``) is registered with each graph, so a replay
draws fresh masks and advances the generator as an eager step does; and
the gradient bookkeeping that the parameters' backward hook does in Python
(``Parameter._grad_version``) is done by the program for each replayed
step.  A graph holds the addresses of every parameter, gradient, optimizer
state and batch buffer, so its cache key holds them too: a ``cast``,
``set_data`` on an uninitialized parameter or anything that makes new
tensors recaptures instead of replaying stale pointers (``load_states``
copies in place and keeps the graph).

Escape hatches, as in the JAX package: ``MXNET_STEP_FOLD=0``, a block with
``_step_fold_opt_out = True``, a parameter with ``grad_req="add"``, an
optimizer with no fused update, and any capture failure fall back to the
eager record/backward/step path for good, with one warning; so does a
Trainer whose optimizer runs on its kvstore (``update_on_kvstore``, the
JAX package's ``async-PS`` label: the optimizer is the store's); a call
while a parameter is deferred runs one eager step.  Each eager step of a
program counts in the profiler's ``step_fold_fallback`` under its label
(``FALLBACK_LABELS``, ``profiler.incr_labeled``).  The JAX package's
``naive-engine`` label has no counterpart: the port has no engine switch.
A Trainer whose kvstore has more than one worker does not fold at all
(``Trainer.fold_step`` raises, naming ROADMAP §1 item 6b).

The profiler sees the fold as the JAX package's does: a folded call counts
in ``step_fold_call`` (``fold_eval_call`` for evaluation), records a
``trainer.step_fold`` span when the profiler is armed and closes one
telemetry step (``step_boundary``), one a call however many steps its
window holds; the build of a program (the capture on the card, the first
call of a signature on the CPU) reports to ``record_compile`` under
``gluon.step_fold``, after which the program arms the compile guard.
"""
from __future__ import annotations

import contextlib
import gc
import os
import warnings
from time import perf_counter as _perf

import numpy as np
import torch

from .. import autograd
from .. import profiler as _profiler
from ..ops import multi_tensor as _mt
from ..ops import optimizer_ops as _K
from ..optimizer import fused as _fused
from ..random import get_generator

__all__ = ["StepProgram", "EvalProgram", "fold_update", "fold_enabled", "step_fast_path",
           "fold_k", "FALLBACK_LABELS"]

FALLBACK_LABELS = ("env-off", "block-opt-out", "grad-req-add", "unsupported-optimizer",
                   "async-PS", "capture-failure", "deferred-init")


def fold_enabled():
    """Whether ``Trainer.fold_step`` folds (default yes; ``MXNET_STEP_FOLD=0``
    is the escape hatch: the program still works, on the eager path)."""
    return os.environ.get("MXNET_STEP_FOLD", "1") != "0"


def fold_k(default=1):
    """The fold width K of ``Trainer.fold_steps`` / ``fold_eval`` when the
    caller passes none: ``MXNET_STEP_FOLD_K``, default 1 (K=1 is the
    single-step program)."""
    try:
        k = int(os.environ.get("MXNET_STEP_FOLD_K", "") or default)
    except ValueError:
        k = default
    return max(1, k)


def step_fast_path():
    """Whether ``Trainer.step`` routes its optimizer tail through
    :func:`fold_update` (opt-in: ``MXNET_STEP_FOLD=1`` exactly)."""
    return os.environ.get("MXNET_STEP_FOLD") == "1"


def _opted_out(block):
    return block is not None and any(getattr(m, "_step_fold_opt_out", False)
                                     for m in block.modules())


def _as_tensor(x):
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))


def _device_of(params):
    """The one device of the initialized parameters (None when they span
    more than one)."""
    devices = {p._data.device for p in params if p._data is not None}
    return devices.pop() if len(devices) == 1 else None


# A capture forbids unsafe CUDA calls (allocations, synchronizations) from
# this thread only: an input pipeline's threads (io.DataPipeline's pinned
# staging and copy stream, the native decode pool) go on staging batches on
# their own streams while a step is captured.
_CAPTURE_MODE = "thread_local"


@contextlib.contextmanager
def _graph_capture(graph, **kw):
    """``torch.cuda.graph(graph, ...)`` with Python's cyclic collector run
    first and paused inside: a dead reference cycle holding an earlier
    program's ``CUDAGraph`` (a Block, a program) collected mid-capture
    resets that graph, which a capture forbids, and the capture is
    invalidated (PyTorch's own collect before a capture is off by
    default)."""
    gc.collect()
    enabled = gc.isenabled()
    gc.disable()
    try:
        with torch.cuda.graph(graph, capture_error_mode=_CAPTURE_MODE, **kw):
            yield
    finally:
        if enabled:
            gc.enable()


def _side_stream_run(fn):
    """``fn()`` on a side stream that waits for, and is waited for by, the
    current one: the warm-up PyTorch's capture asks for."""
    cur = torch.cuda.current_stream()
    side = torch.cuda.Stream()
    side.wait_stream(cur)
    with torch.cuda.stream(side):
        out = fn()
    cur.wait_stream(side)
    return out


def _stage(host_rows, device_rows):
    """Copy host values into a graph's device buffer on the current stream,
    through pinned memory (the caching host allocator keeps the pinned
    buffer until the copy has run)."""
    device_rows.copy_(torch.from_numpy(host_rows).pin_memory(), non_blocking=True)


class _Tail:
    """The fused optimizer tail of a set of parameters: their groups
    (``fused.plan_groups``) and, per logical step, the values of each group
    as the host computes them (every count bumped first, then lr, wd and t,
    as the JAX package's fold and the fused update do)."""

    def __init__(self, optimizer, items, states):
        self.opt = optimizer
        groups, self.rest = _fused.plan_groups(optimizer, items, states)
        self.groups = [(step, [i for i, _, _, _ in m], [w for _, w, _, _ in m],
                        [g for _, _, g, _ in m], [flat for _, _, _, flat in m])
                       for (step, _, _), m in groups.items()]
        self.indices = [i for _, idx, _, _, _ in self.groups for i in idx]
        self.sizes = None  # device values of each group, known after the first step

    def signature(self):
        """The groups and every pointer their launches read."""
        return tuple((step.__name__, tuple(idx),
                      tuple((w.data_ptr(), w.numel(), w.dtype, g.data_ptr(),
                             tuple(s.data_ptr() for s in flat))
                            for w, g, flat in zip(ws, gs, flats)))
                     for step, idx, ws, gs, flats in self.groups)

    def values(self):
        """One logical step's values: ``(per_group, rows)``, ``per_group`` the
        (lrs, wds, ts) of each group, ``rows`` the fp32 values the kernel
        reads from device memory, all groups after one another."""
        opt = self.opt
        for i in self.indices:
            opt._update_count(i)
        lr = {i: opt._get_lr(i) for i in self.indices}
        wd = {i: opt._get_wd(i) for i in self.indices}
        t = {i: opt._index_update_count[i] for i in self.indices}
        scalars = _fused._scalars(opt)
        per_group, rows = [], []
        for step, idx, _, _, _ in self.groups:
            vals = ([lr[i] for i in idx], [wd[i] for i in idx], [t[i] for i in idx])
            per_group.append(vals)
            rows.append(_K.group_rows(step, *vals, scalars))
        self.sizes = [len(r) for r in rows]
        return per_group, np.concatenate(rows).astype(np.float32)

    def layout(self):
        """Placeholder values of the right lengths for a capture, which runs
        nothing and so reads none (no count moves): ``(per_group, n)``, n
        the device values of a step."""
        scalars = _fused._scalars(self.opt)
        per_group = [([0.0] * len(idx), [0.0] * len(idx), [1] * len(idx))
                     for _, idx, _, _, _ in self.groups]
        self.sizes = [len(_K.group_rows(step, *vals, scalars))
                      for (step, _, _, _, _), vals in zip(self.groups, per_group)]
        return per_group, sum(self.sizes)

    def scratch(self):
        """The buffers a capture owns for its groups' launches: LAMB's
        partial norms (``multi_tensor.lamb_scratch``) for a LAMB group on the
        card, None for the others."""
        return [_mt.lamb_scratch(ws) if step.variant == "lamb" and ws[0].is_cuda else None
                for step, _, ws, _, _ in self.groups]

    def apply(self, per_group, device_rows=None, scratch=None):
        """One ``group_apply`` a group: on the card the kernel reads
        ``device_rows`` (a graph's buffer) when given, and LAMB writes its
        partial norms to ``scratch`` (:meth:`scratch`) when given."""
        scalars = _fused._scalars(self.opt)
        scratch = scratch or [None] * len(self.groups)
        offset = 0
        for (step, _, ws, gs, flats), vals, n, buf in zip(self.groups, per_group, self.sizes,
                                                          scratch):
            rows = None if device_rows is None else device_rows[offset:offset + n]
            _K.group_apply(step, ws, gs, flats, *vals, scalars, device_rows=rows, scratch=buf)
            offset += n


class _CounterViews(type):
    """``StepProgram.calls`` and ``EvalProgram.calls`` (the profiler's
    ``step_fold_call`` and ``fold_eval_call``) and ``.fallbacks`` (each
    label of ``step_fold_fallback``) read the profiler's declared
    counters."""

    @property
    def calls(cls):
        return _profiler.counters()[cls._CALLS_COUNTER]

    @property
    def fallbacks(cls):
        got = _profiler.counter_labels("step_fold_fallback")
        return {label: got.get(label, 0) for label in FALLBACK_LABELS}


class StepProgram(metaclass=_CounterViews):
    """The folded training step of one ``(Trainer, loss_fn)`` pair.

    ``loss_fn(*batch) -> loss`` computes the loss from the batch, calling
    the Block(s) whose Parameters the Trainer owns.  Calling the program
    runs forward, loss, backward and the fused optimizer update and
    returns a copy of the loss (the ``[K, ...]`` losses of a window).
    Built by ``Trainer.fold_step`` / ``fold_steps``.

    Counters, over every program: ``calls`` counts folded calls and
    ``fallbacks`` each eager step by label (views of the profiler's
    ``step_fold_call`` and ``step_fold_fallback``), ``replays`` and
    ``captures`` the graphs' replays and captures."""

    _CALLS_COUNTER = "step_fold_call"
    _SPAN = "trainer.step_fold"   # the span of a folded call
    _SITE = "gluon.step_fold"     # the compile registry's site of a build
    replays = 0
    captures = 0

    def __init__(self, trainer, loss_fn, block=None, keep_grads=False, k=None,
                 donate_window=False):
        """``keep_grads`` and ``donate_window`` mean what they mean in
        ``Trainer.fold_steps``: the gradients stay in the Parameters'
        buffers either way, and no window is donated (each is copied into
        the graph's static inputs)."""
        self._trainer = trainer
        self._loss_fn = loss_fn
        self._k = max(1, int(k if k is not None else fold_k()))
        self._cache = {}        # key -> {"graph", "batch", "rows", "loss"} once captured
        self._pool = None       # the memory pool of this program's graphs
        self._fallback_reason = None
        self._fallback_label = None
        self._warned = False
        self._captured = False
        self._logical_steps = 0
        self._window_pos = 0    # steps since the last window boundary (step_one moves it)
        self._guard_armed = False
        if not fold_enabled():
            self._fallback_reason, self._fallback_label = "MXNET_STEP_FOLD=0", "env-off"
        elif _opted_out(block):
            self._fallback_reason = "block opt-out (_step_fold_opt_out)"
            self._fallback_label = "block-opt-out"

    # -- public surface ------------------------------------------------------
    @property
    def folded(self):
        """False once the program has fallen back to the eager path for good
        (reason in ``fallback_reason``)."""
        return self._fallback_reason is None

    @property
    def fallback_reason(self):
        return self._fallback_reason

    @property
    def captured(self):
        """Whether the last call was a replay of a captured CUDA graph (False
        on the CPU, where the body runs directly, and on an eager call)."""
        return self._captured

    @property
    def k(self):
        return self._k

    @property
    def logical_steps(self):
        """Logical training steps this program has run (folded or eager)."""
        return self._logical_steps

    @property
    def window_pos(self):
        """Logical steps since the last window boundary (``0 <= pos < k``):
        only ``step_one`` moves it, and ``Trainer.save_states`` refuses
        while it is not 0."""
        return self._window_pos

    def __call__(self, *batch, batch_size=None):
        batch = [_as_tensor(b) for b in batch]
        if self._k > 1:
            return self._window_call(batch, batch_size)
        if batch_size is None:
            batch_size = batch[0].shape[0]
        out = self._call(batch, batch_size, None)
        self._logical_steps += 1
        return out

    def step_one(self, *batch, batch_size=None):
        """One logical step on a K>1 program, as a window of one; moves the
        window cursor off the K boundary until further ``step_one`` calls
        complete the window.  On a K=1 program this is ``__call__``."""
        if self._k == 1:
            return self(*batch, batch_size=batch_size)
        batch = [_as_tensor(b) for b in batch]
        if batch_size is None:
            batch_size = batch[0].shape[0]
        pos = self._window_pos
        out = self(*[b[None] for b in batch], batch_size=batch_size)
        self._window_pos = (pos + 1) % self._k
        return out[0]

    def sync(self):
        """Write fold-held state back into the Parameters and the Trainer:
        nothing to do, since every step updates them in place (the JAX
        package's multi-process fold holds registers; the port has none
        yet).  ``Trainer.save_states`` calls it."""

    def invalidate(self):
        """Drop the captured graphs: the next call warms up and captures
        again from the live Parameters."""
        self._cache.clear()

    # -- dispatch ------------------------------------------------------------
    def _window_call(self, batch, batch_size):
        if batch[0].dim() < 2:
            raise ValueError(f"fold_steps(k={self._k}) expects stacked [k, batch, ...] windows; "
                             f"got shape {tuple(batch[0].shape)}: use step_one() for a single "
                             "unstacked batch")
        kw = int(batch[0].shape[0])
        if any(int(b.shape[0]) != kw for b in batch):
            raise ValueError(f"window leading dims disagree: {[tuple(b.shape) for b in batch]}")
        if batch_size is None:
            batch_size = batch[0].shape[1]
        out = self._call(batch, batch_size, kw)
        self._logical_steps += kw
        self._window_pos = 0
        return out

    def _call(self, batch, batch_size, kw):
        self._captured = False
        if self._fallback_reason is not None or any(p._data is None
                                                    for p in self._trainer._params):
            return self._eager(batch, batch_size, kw)
        return self._folded(batch, batch_size, kw)

    def _note_fallback(self, reason, label):
        self._fallback_reason, self._fallback_label = reason, label
        self._cache.clear()
        if not self._warned:
            self._warned = True
            warnings.warn(f"step fold disabled ({reason}); running the eager "
                          "record/backward/step path instead", UserWarning, stacklevel=4)

    def _eager_step(self, batch, batch_size):
        """The unfused reference step: record, backward, ``Trainer.step``."""
        _profiler.incr_labeled("step_fold_fallback", self._fallback_label or "deferred-init")
        with autograd.record():
            loss = self._loss_fn(*batch)
        autograd.backward(loss)
        self._trainer.step(batch_size)
        return loss.detach()

    def _eager(self, batch, batch_size, kw):
        if kw is None:
            return self._eager_step(batch, batch_size)
        return torch.stack([self._eager_step([b[j] for b in batch], batch_size)
                            for j in range(kw)])

    # -- the folded step -----------------------------------------------------
    def _touched(self):
        """(index, Parameter) of every parameter the step updates, with its
        optimizer state made; None after noting a fallback."""
        tr = self._trainer
        touched = []
        for i, p in enumerate(tr._params):
            if p.grad_req == "null" or p._data is None:
                continue
            if p.grad_req != "write":
                self._note_fallback(f"{p.name} has grad_req={p.grad_req!r} (the fold needs "
                                    "'write')", "grad-req-add")
                return None
            if i not in tr._states:
                tr._states[i] = tr._optimizer.create_state_multi_precision(i, p.data())
            touched.append((i, p))
        return touched

    def _folded(self, batch, batch_size, kw):
        tr = self._trainer
        tr._check_and_rescale_grad(tr._scale / batch_size)
        if tr._on_store():
            self._note_fallback("the optimizer runs on the kvstore (update_on_kvstore)",
                                "async-PS")
            return self._eager(batch, batch_size, kw)
        touched = self._touched()
        if touched is None:
            return self._eager(batch, batch_size, kw)
        tail = _Tail(tr._optimizer, [(i, p.data(), p.grad()) for i, p in touched], tr._states)
        if tail.rest or not tail.groups:
            names = [tr._params[i].name for i, _, _ in tail.rest][:3]
            self._note_fallback(f"no fused kernels for {type(tr._optimizer).__name__} on "
                                f"{names or 'these params'} (lazy/sparse or unsupported)",
                                "unsupported-optimizer")
            return self._eager(batch, batch_size, kw)
        device = _device_of(tr._params)
        if device is None or device.type not in ("cpu", "cuda"):
            self._note_fallback("parameters on more than one device, or not on the CPU or a "
                                "CUDA card", "capture-failure")
            return self._eager(batch, batch_size, kw)
        t0 = _perf() if _profiler._active else None
        done = False
        try:
            if device.type == "cpu":
                out, built_ms = self._on_cpu(batch, kw, tail, device)
            else:
                out, built_ms = self._on_card(batch, kw, touched, tail, device)
            done = True
        finally:
            if not done:  # a call that raised closes its own step
                _profiler.step_boundary()
        if out is None:  # a capture failure: nothing of the step has run
            return self._eager(batch, batch_size, kw)
        try:
            for i, p in touched:  # the freshness snapshot of Trainer._update
                tr._grad_versions[i] = p.grad_version
            if t0 is not None:
                _profiler.record_span(self._SPAN, "trainer", t0,
                                      args={"params": len(touched), "k": kw or 1})
            _profiler.incr("step_fold_call")
            if built_ms is not None:
                self._record_build(batch, kw, tail, built_ms)
        finally:
            _profiler.step_boundary()  # one a call, however many steps it holds
        if not self._guard_armed and (device.type == "cpu" or self._captured):
            self._guard_armed = True
            _profiler.arm_compile_guard(self._SITE)
        return out

    def _record_build(self, batch, kw, tail, wall_ms):
        """Report a build of this program to the compile registry; a window
        of another width than K (``step_one``) is a declared warm-up, which
        the armed guard does not judge."""
        sig = {"__program__": "step_fold" if kw is None else f"step_fold_k[{kw}]",
               "params": _profiler.sig_static(len(tail.indices)),
               "groups": _profiler.sig_static([step.__name__ for step, *_ in tail.groups])}
        for i, b in enumerate(batch):
            sig[f"in{i}"] = _profiler.sig_array(b)
        if kw is not None and kw != self._k:
            with _profiler.compile_guard_paused():
                _profiler.record_compile(self._SITE, sig, wall_ms)
        else:
            _profiler.record_compile(self._SITE, sig, wall_ms)

    @staticmethod
    def _row(batch, j, kw):
        return batch if kw is None else [b[j] for b in batch]

    def _run(self, batch, kw, tail):
        """The step bodies of a call run directly, each on its own values:
        the loss (the ``[kw, ...]`` losses of a window)."""
        losses = [self._body(self._row(batch, j, kw), tail, tail.values()[0])
                  for j in range(1 if kw is None else kw)]
        return losses[0] if kw is None else torch.stack(losses)

    def _body(self, batch, tail, per_group, device_rows=None, scratch=None):
        """One logical step: forward and loss recorded, the backward (the
        parameters' hooks move each gradient into its buffer), one
        ``group_apply`` a fused group.  Returns the loss, detached."""
        with autograd.record():
            loss = self._loss_fn(*batch)
        autograd.backward(loss)
        tail.apply(per_group, device_rows, scratch)
        return loss.detach()

    def _key(self, batch, kw, tail, device):
        tr = self._trainer
        return (tuple((tuple(b.shape), b.dtype, b.device) for b in batch), kw, tail.signature(),
                tuple(p._data.data_ptr() for p in tr._params if p._data is not None),
                id(get_generator(device)))

    def _on_cpu(self, batch, kw, tail, device):
        """The step bodies run directly; the first call of a signature is
        its program's build.  Returns ``(loss, build ms or None)``."""
        key = self._key(batch, kw, tail, device)
        built = key not in self._cache
        self._cache[key] = {}
        tb = _perf()
        out = self._run(batch, kw, tail)
        return out, ((_perf() - tb) * 1e3 if built else None)

    def _on_card(self, batch, kw, touched, tail, device):
        """Warm up, capture or replay; returns ``(loss copy, capture ms or
        None)``, the loss None after a capture failure (nothing of the
        step has run)."""
        steps = 1 if kw is None else kw
        key = self._key(batch, kw, tail, device)
        entry = self._cache.get(key)
        if entry is None:  # warm-up: the bodies run eagerly, on a side stream
            self._cache[key] = {}
            return _side_stream_run(lambda: self._run(batch, kw, tail)), None
        built_ms = None
        if "graph" not in entry:
            tc = _perf()
            try:
                entry.update(self._capture(batch, kw, touched, tail, device))
            except Exception as e:  # noqa: BLE001 -- the documented capture-failure fallback
                self._note_fallback(f"capture failed: {e!r:.200}", "capture-failure")
                return None, None
            built_ms = (_perf() - tc) * 1e3
            StepProgram.captures += 1
        rows = [tail.values()[1] for _ in range(steps)]
        for static, b in zip(entry["batch"], batch):
            static.copy_(b, non_blocking=True)
        _stage(np.stack(rows), entry["rows"])
        entry["graph"].replay()
        StepProgram.replays += 1
        for _, p in touched:  # the hooks did not run: one write a logical step
            p._grad_version += steps
        self._captured = True
        return entry["loss"].clone(), built_ms

    def _capture(self, batch, kw, touched, tail, device):
        """Capture ``kw or 1`` step bodies into one graph on the program's
        pool, reading the batch from static buffers and the optimizer's
        values from one device buffer of ``[steps, values]``."""
        steps = 1 if kw is None else kw
        per_group, n = tail.layout()
        static = [torch.empty_like(b, device=device) for b in batch]
        rows = torch.zeros(steps, n, dtype=torch.float32, device=device)
        scratch = tail.scratch()
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(get_generator(device))
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        versions = [p._grad_version for _, p in touched]
        try:
            with _graph_capture(graph, pool=self._pool):
                losses = [self._body(self._row(static, j, kw), tail, per_group, rows[j],
                                     scratch) for j in range(steps)]
                loss = losses[0] if kw is None else torch.stack(losses)
        finally:  # capture ran the hooks without running the step
            for (_, p), v in zip(touched, versions):
                p._grad_version = v
        return {"graph": graph, "batch": static, "rows": rows, "loss": loss,
                "scratch": scratch}


class EvalProgram(metaclass=_CounterViews):
    """The folded evaluation pass (``Trainer.fold_eval(loss_fn, k)``): the
    forward-only loss of a batch (or of a ``[K, batch, ...]`` window) with
    training off (BatchNorm reads its running statistics, dropout is the
    identity), summed into a device fp32 register; :meth:`result` reads it
    once.  On the card the first call per batch signature runs eagerly on a
    side stream, the next captures one graph and replays it, each later
    one replays.  ``EvalProgram.calls`` counts folded calls (a view of the
    profiler's ``fold_eval_call``), ``replays`` the replays; fallbacks count
    in ``step_fold_fallback``.  A folded call closes one telemetry step and
    records a ``trainer.fold_eval`` span; a build reports to
    ``record_compile`` under ``gluon.fold_eval`` as a declared warm-up."""

    _CALLS_COUNTER = "fold_eval_call"
    replays = 0

    def __init__(self, trainer, loss_fn, block=None, k=None):
        self._trainer = trainer
        self._loss_fn = loss_fn
        self._k = max(1, int(k if k is not None else fold_k()))
        self._cache = {}
        self._pool = None
        self._acc = None          # the fp32 register, on the parameters' device
        self._host_sum = 0.0      # the eager path's contribution
        self._count = 0           # loss elements summed since the last reset
        self._fallback_reason = self._fallback_label = None
        self._warned = False
        self._guard_armed = False
        if not fold_enabled():
            self._fallback_reason, self._fallback_label = "MXNET_STEP_FOLD=0", "env-off"
        elif _opted_out(block):
            self._fallback_reason = "block opt-out (_step_fold_opt_out)"
            self._fallback_label = "block-opt-out"

    @property
    def folded(self):
        return self._fallback_reason is None

    @property
    def fallback_reason(self):
        return self._fallback_reason

    @property
    def k(self):
        return self._k

    @property
    def count(self):
        """Loss elements summed since the last ``result(reset=True)``."""
        return self._count

    def _rows(self, batch):
        if self._k == 1:
            return [batch]
        if batch[0].dim() < 2 or any(b.shape[0] != batch[0].shape[0] for b in batch):
            raise ValueError(f"fold_eval(k={self._k}) expects stacked [k, batch, ...] windows; "
                             f"got {[tuple(b.shape) for b in batch]}")
        return [[b[j] for b in batch] for j in range(batch[0].shape[0])]

    def _sum(self, rows):
        """The summed fp32 loss of the rows and their element count."""
        total, count = None, 0
        with autograd.pause(train_mode=False):
            for row in rows:
                loss = self._loss_fn(*row)
                s = loss.float().sum()
                total = s if total is None else total + s
                count += loss.numel()
        return total, count

    def __call__(self, *batch):
        batch = [_as_tensor(b) for b in batch]
        rows = self._rows(batch)
        tr = self._trainer
        device = _device_of(tr._params)
        if (self._fallback_reason is not None or device is None
                or any(p._data is None for p in tr._params)):
            _profiler.incr_labeled("step_fold_fallback", self._fallback_label or "deferred-init")
            total, count = self._sum(rows)
            self._host_sum += float(total)
            self._count += count
            return
        if self._acc is None:
            self._acc = torch.zeros((), dtype=torch.float32, device=device)
        key = (tuple((tuple(b.shape), b.dtype, b.device) for b in batch),
               tuple(p._data.data_ptr() for p in tr._params if p._data is not None),
               id(get_generator(device)))
        t0 = _perf() if _profiler._active else None
        built_ms = None
        try:
            built_ms = self._dispatch(batch, rows, key, device)
            if built_ms is False:  # a capture failure: the eager pass ran instead
                return
            if t0 is not None:
                _profiler.record_span("trainer.fold_eval", "trainer", t0,
                                      args={"params": len(tr._params), "k": len(rows)})
            _profiler.incr("fold_eval_call")
            if built_ms is not None:
                # every eval build is a declared warm-up: registered, not judged
                with _profiler.compile_guard_paused():
                    _profiler.record_compile(
                        "gluon.fold_eval",
                        {"__program__": "fold_eval" if self._k == 1
                         else f"fold_eval_k[{len(rows)}]",
                         **{f"in{i}": _profiler.sig_array(b) for i, b in enumerate(batch)}},
                        built_ms)
        finally:
            if built_ms is not False:
                _profiler.step_boundary()
        if not self._guard_armed and (device.type != "cuda" or "graph" in self._cache[key]):
            self._guard_armed = True
            _profiler.arm_compile_guard("gluon.fold_eval")

    def _dispatch(self, batch, rows, key, device):
        """One folded call: the sum directly on the CPU (the first call of a
        signature its build), else warm-up, capture or replay.  Returns the
        build ms, None without a build, False after a capture failure."""
        if device.type != "cuda":
            built = key not in self._cache
            self._cache[key] = {}
            tb = _perf()
            total, count = self._sum(rows)
            self._acc += total
            self._count += count
            return (_perf() - tb) * 1e3 if built else None
        entry = self._cache.get(key)
        if entry is None:  # warm-up: eager, on a side stream
            self._cache[key] = entry = {}

            def warm():
                total, count = self._sum(rows)
                self._acc += total
                return count

            entry["count"] = _side_stream_run(warm)
            self._count += entry["count"]
            return None
        built_ms = None
        if "graph" not in entry:
            tc = _perf()
            try:
                entry.update(self._capture(batch, device))
            except Exception as e:  # noqa: BLE001 -- the documented capture-failure fallback
                self._fallback_reason = f"capture failed: {e!r:.200}"
                self._fallback_label = "capture-failure"
                self._cache.clear()
                if not self._warned:
                    self._warned = True
                    warnings.warn(f"eval fold disabled ({self._fallback_reason}); running the "
                                  "eager forward instead", UserWarning, stacklevel=3)
                self(*batch)
                return False
            built_ms = (_perf() - tc) * 1e3
        for static, b in zip(entry["batch"], batch):
            static.copy_(b, non_blocking=True)
        entry["graph"].replay()
        EvalProgram.replays += 1
        self._count += entry["count"]
        return built_ms

    def _capture(self, batch, device):
        static = [torch.empty_like(b, device=device) for b in batch]
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(get_generator(device))
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        with _graph_capture(graph, pool=self._pool):
            total, _ = self._sum(self._rows(static))
            self._acc.add_(total)
        return {"graph": graph, "batch": static}

    def result(self, reset=True):
        """Mean loss over every element summed since the last reset: the one
        read of the register an evaluation pass makes."""
        total = self._host_sum + (float(self._acc) if self._acc is not None else 0.0)
        count = self._count
        if reset:
            if self._acc is not None:
                self._acc.zero_()  # in place: the graphs keep its address
            self._host_sum, self._count = 0.0, 0
        return total / max(1, count)


# -- MXNET_STEP_FOLD=1: the optimizer tail of Trainer.step as one replay ------

_TAILS = {}      # (group set, pointers) -> {"graph", "rows"} once captured
_MAX_TAILS = 64


def fold_update(optimizer, items, states):
    """:func:`optimizer.fused.fused_update`'s twin for the
    ``MXNET_STEP_FOLD=1`` path of ``Trainer.step``: every fused group's
    launches are one CUDA-graph replay (the first call for a set of groups
    and pointers runs eagerly, the next captures); returns the items the
    caller must update per tensor, as ``fused_update`` does.  On the CPU
    each group takes ``group_apply``'s plain version.  Counters:
    ``fold_update.calls`` (folded tails), ``.params``, ``.fallback_params``,
    ``.captures`` and ``.replays``; a call also counts once in the
    profiler's ``fused_step_call`` (its parameters in
    ``fused_step_params``), records one ``fused.group_apply`` span when the
    profiler is armed, and a capture reports to ``record_compile`` under
    ``gluon.step_fold``."""
    agg = int(getattr(optimizer, "aggregate_num", 0) or 0)
    if agg <= 1 or not items:
        return items
    tail = _Tail(optimizer, items, states)
    if not tail.groups:
        return tail.rest
    devices = {w.device for _, _, ws, _, _ in tail.groups for w in ws}
    device = devices.pop() if len(devices) == 1 else None
    fold_update.calls += 1
    fold_update.params += len(tail.indices)
    fold_update.fallback_params += len(tail.rest)
    t0 = _perf() if _profiler._active else None
    built_ms = _fold_tail(tail, device)
    if t0 is not None:
        _profiler.record_span("fused.group_apply", "optimizer", t0,
                              args={"params": len(tail.indices), "groups": len(tail.groups),
                                    "folded": True})
    _profiler.incr("fused_step_call")
    _profiler.incr("fused_step_params", len(tail.indices))
    if tail.rest:
        _profiler.incr("fused_step_fallback_params", len(tail.rest))
    if built_ms is not None:
        sig = {"__program__": "update_tail",
               "groups": _profiler.sig_static([(step.__name__, len(idx))
                                               for step, idx, _, _, _ in tail.groups])}
        for k, w in enumerate(w for _, _, ws, _, _ in tail.groups for w in ws):
            sig[f"w{k}"] = _profiler.sig_array(w)
        _profiler.record_compile("gluon.step_fold", sig, built_ms)
    return tail.rest


def _fold_tail(tail, device):
    """Run one fused tail: its groups' plain versions on the CPU; on the
    card eagerly at the first sight of these groups and pointers, captured
    at the next, replayed after that.  Returns the capture's ms, or None."""
    if device is None or device.type != "cuda":
        tail.apply(tail.values()[0])
        return None
    key = tail.signature()
    entry = _TAILS.get(key)
    if entry is None:  # first sight of these groups and pointers: eager
        _TAILS[key] = {}
        while len(_TAILS) > _MAX_TAILS:
            _TAILS.pop(next(iter(_TAILS)))
        tail.apply(tail.values()[0])
        return None
    built_ms = None
    if "graph" not in entry:
        tc = _perf()
        per_group, n = tail.layout()
        rows = torch.zeros(n, dtype=torch.float32, device=device)
        scratch = tail.scratch()
        graph = torch.cuda.CUDAGraph()
        with _graph_capture(graph):
            tail.apply(per_group, rows, scratch)
        entry.update(graph=graph, rows=rows, scratch=scratch)
        fold_update.captures += 1
        built_ms = (_perf() - tc) * 1e3
    _stage(tail.values()[1], entry["rows"])
    entry["graph"].replay()
    fold_update.replays += 1
    return built_ms


fold_update.calls = 0
fold_update.params = 0
fold_update.fallback_params = 0
fold_update.captures = 0
fold_update.replays = 0
