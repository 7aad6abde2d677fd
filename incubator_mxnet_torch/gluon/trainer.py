"""Gluon Trainer (parity: MXNet's ``gluon.Trainer``).

Counterpart of the JAX package's ``gluon/trainer.py``:
``step(batch_size)`` runs ``allreduce_grads`` and then the optimizer on
every parameter with a gradient, with ``rescale_grad = scale /
batch_size``; ``save_states`` / ``load_states`` keep the optimizer state
and the per-parameter update counts (Adam's ``t``).  The update goes
through the fused group update (``optimizer/fused.py``: on the card one
launch of the multi-tensor kernel per group of up to
``optimizer.aggregate_num`` parameters), and only what it leaves (an
optimizer with no fused variant, or ``aggregate_num`` <= 1) takes the
per-tensor loop.

The kvstore (``kvstore=`` a name or a ``KVStore``; made at the first step,
as in the JAX package): against a store of more than one worker
(``'dist_sync'`` over a process group) ``allreduce_grads`` sums the
gradients over the workers as size-capped flat buckets
(``kvstore.bucketed_pushpull``), or key by key for a store that cannot
bucket.  One worker has nothing to reduce, whatever its store.
``backward(loss)`` overlaps that exchange with the backward: each bucket's
all-reduce is launched asynchronously from the gradient-readiness hook
(``autograd.backward(grad_ready_hook=)``) as soon as its last gradient is
written, and ``allreduce_grads`` waits on those launches and reduces the
rest from the same plan.  ``update_on_kvstore=True`` runs the optimizer on
the store (``set_optimizer``): each step pushes every gradient and pulls
the updated weight, and the optimizer state is the store's
(``save_states`` writes ``save_optimizer_states``).  The Trainer registers
its weights with the store only then (a copy of every weight that no step
reads would cost a model's size on the card).  Gradient compression
(``compression_params``) waits in ROADMAP §1 item 6b.

The optimizer state is keyed by parameter index, and each step fetches
``param.data()`` and ``param.grad()`` afresh, so a ``cast`` between
steps (which makes new tensors) is seen.

``fold_step`` / ``fold_steps`` / ``fold_eval`` build the step fold
(``gluon/step_fold.py``): a whole training step, or a window of K, or an
evaluation pass, as one CUDA-graph replay on the card; ``MXNET_STEP_FOLD=1``
makes ``step`` replay its optimizer tail (``step_fold.fold_update``).  A
fold against a store of more than one worker raises: the multi-process
fold (the JAX package's ``_build_dist``) waits in ROADMAP §1 item 6b.

``step`` and ``update`` close a step of the profiler's telemetry
(``profiler.step_boundary``, in a ``finally``); with the profiler armed
they record ``trainer.allreduce`` and ``trainer.update`` spans.
"""
from __future__ import annotations

import os
import pickle
import warnings
import weakref

import torch

from .. import optimizer as opt_mod
from .. import profiler as _profiler
from ..optimizer import fused as _fused
from . import step_fold as _sf
from .parameter import Parameter, ParameterDict

__all__ = ["Trainer"]


class Trainer:
    """The imperative training loop's optimizer step (see the module doc)."""

    def __init__(self, params, optimizer, optimizer_params=None, kvstore="device",
                 compression_params=None, update_on_kvstore=None):
        if isinstance(params, (dict, ParameterDict)):
            params = list(params.values())
        if not isinstance(params, (list, tuple)):
            raise ValueError("First argument must be a list or dict of Parameters")
        for p in params:
            if not isinstance(p, Parameter):
                raise ValueError(
                    f"First argument must be a list or dict of Parameters, got {type(p)}")
        if compression_params is not None:
            raise NotImplementedError(
                f"compression_params={compression_params!r}: gradient compression waits in "
                "ROADMAP §1 item 6b (comm/compression.py and comm/ring.py)")
        self._params = list(params)
        self._kvstore_type = kvstore
        self._kvstore = None
        self._kv_initialized = False
        self._update_on_kvstore = bool(update_on_kvstore)
        self._overlap = None         # Trainer.backward's bucket plan and launches
        optimizer_params = dict(optimizer_params or {})
        self._scale = float(optimizer_params.get("rescale_grad", 1.0))
        self._init_optimizer(optimizer, optimizer_params)
        self._states = {}
        self._last_scale_set = None  # the last rescale_grad this trainer wrote
        self._grad_versions = {}     # index -> grad_version at its last update
        self._fold = None            # weakref to the last StepProgram built

    def _init_optimizer(self, optimizer, optimizer_params):
        param_dict = dict(enumerate(self._params))
        if isinstance(optimizer, opt_mod.Optimizer):
            if optimizer_params and list(optimizer_params) != ["rescale_grad"]:
                raise ValueError(
                    "optimizer_params must be None if optimizer is an Optimizer instance")
            self._optimizer = optimizer
            self._optimizer.param_dict = param_dict
        else:
            self._optimizer = opt_mod.create(optimizer, param_dict=param_dict,
                                             **optimizer_params)

    def _init_kvstore(self):
        """Make the store at the first step (a name or the object given);
        under ``update_on_kvstore`` register the weights and the optimizer
        with it; pin the rank of a multi-worker run for the profiler."""
        from .. import kvstore as kv_mod

        kv = (kv_mod.create(self._kvstore_type) if isinstance(self._kvstore_type, str)
              else self._kvstore_type)
        if kv is not None:
            if self._update_on_kvstore:
                for i, p in enumerate(self._params):
                    if p._data is not None:
                        kv.init(i, p.data())
                kv.set_optimizer(self._optimizer)
            if kv.num_workers > 1:
                _profiler.set_process_info(rank=kv.rank)
        self._kvstore = kv
        self._kv_initialized = True

    def _on_store(self):
        return self._update_on_kvstore and self._kvstore is not None

    def _reduces(self):
        """Whether the store sums over more than this one worker."""
        return self._kvstore is not None and self._kvstore.num_workers > 1

    @property
    def learning_rate(self):
        return self._optimizer.learning_rate

    @property
    def optimizer(self):
        return self._optimizer

    def set_learning_rate(self, lr):
        self._optimizer.set_learning_rate(lr)

    def _check_and_rescale_grad(self, scale):
        """Set ``optimizer.rescale_grad`` for this step, warning when a
        value set by hand is about to be overwritten."""
        expected = self._last_scale_set if self._last_scale_set is not None else self._scale
        if self._optimizer.rescale_grad != expected:
            warnings.warn(
                "Optimizer.rescale_grad was changed outside Trainer.step; "
                "Trainer recomputes it as trainer._scale/batch_size every "
                "step, overriding your value. Construct the Trainer with "
                "optimizer_params={'rescale_grad': ...} instead.",
                UserWarning, stacklevel=3)
        self._optimizer.rescale_grad = scale
        self._last_scale_set = scale

    def step(self, batch_size, ignore_stale_grad=False):
        """Gradient reduction, then the optimizer update with
        ``rescale_grad = scale / batch_size``."""
        if not self._kv_initialized:
            self._init_kvstore()
        self._check_and_rescale_grad(self._scale / batch_size)
        # staleness is judged before the all-reduce writes every gradient
        stale = self._stale_indices() if ignore_stale_grad else frozenset()
        try:
            if self._on_store():
                with _profiler.span("trainer.update", "trainer"):
                    self._update_on_store(ignore_stale_grad, stale)
            elif _profiler._active:
                with _profiler.span("trainer.allreduce", "trainer"):
                    self.allreduce_grads()
                with _profiler.span("trainer.update", "trainer"):
                    self._update(ignore_stale_grad, stale)
            else:
                self.allreduce_grads()
                self._update(ignore_stale_grad, stale)
        finally:
            # the step every span since the previous boundary belongs to;
            # in a finally, so that a step that raised bills its partial
            # time to itself, not to the next one
            _profiler.step_boundary()

    def fold_step(self, loss_fn, block=None, keep_grads=False):
        """The folded training step of this trainer: a
        :class:`~.step_fold.StepProgram` whose call ``program(*batch)`` runs
        forward, ``loss_fn(*batch)``, backward and the fused optimizer update
        as one CUDA-graph replay on the card (after one eager warm-up call
        and one capture) and returns a copy of the loss.  ``loss_fn`` calls
        the Block(s) whose Parameters this trainer owns.  ``keep_grads=True``
        guarantees each Parameter's gradient after the call, as after
        ``backward``; with ``False`` (the reference's default) the program
        promises nothing about the gradients.  The port keeps them in the
        Parameters' buffers either way, and both values give the same
        parameters and optimizer states.  Escape hatches
        (``MXNET_STEP_FOLD=0``, ``block`` with ``_step_fold_opt_out``,
        ``grad_req='add'``, an optimizer with no fused update, a capture
        failure) fall back to the eager path with a warning, never an
        error."""
        self._check_foldable()
        sp = _sf.StepProgram(self, loss_fn, block=block, keep_grads=keep_grads)
        self._fold = weakref.ref(sp)
        return sp

    def _check_foldable(self):
        """The JAX fold's kvstore routing: a store of more than one worker
        folds there in a multi-process program, which the port has not."""
        if not self._kv_initialized:
            self._init_kvstore()
        if self._reduces():
            raise NotImplementedError(
                f"fold_step/fold_steps against kvstore {self._kvstore.type!r} of "
                f"{self._kvstore.num_workers} workers: the multi-process fold waits in "
                "ROADMAP §1 item 6b; use trainer.backward(loss) and trainer.step, or "
                "parallel.SPMDTrainer")

    def fold_steps(self, loss_fn, k=None, block=None, keep_grads=False, donate_window=False):
        """The K-step fold: like :meth:`fold_step`, but each call takes a
        ``[K, batch, ...]`` window stacked by the caller and runs its K
        logical steps as one replay of K captured step bodies, returning the
        ``[K, ...]`` losses; ``k`` defaults to ``MXNET_STEP_FOLD_K`` (K=1 is
        :meth:`fold_step`'s program).  ``program.step_one(*batch)`` runs one
        step off the window boundary; ``save_states`` refuses until the
        window is whole again.  ``keep_grads`` as in :meth:`fold_step`.
        ``donate_window`` is accepted and donates nothing: the program
        copies each window into its graph's static input buffers, so the
        caller's window stays valid whatever its value."""
        self._check_foldable()
        sp = _sf.StepProgram(self, loss_fn, block=block, keep_grads=keep_grads, k=k,
                             donate_window=donate_window)
        self._fold = weakref.ref(sp)
        return sp

    def fold_eval(self, loss_fn, block=None, k=None):
        """The folded evaluation pass: an :class:`~.step_fold.EvalProgram`
        whose call runs the forward-only loss of a batch (or a ``[K, ...]``
        window) with training off as one replay, summing it on the card;
        ``program.result()`` reads the mean once."""
        return _sf.EvalProgram(self, loss_fn, block=block, k=k)

    def backward(self, loss, head_grads=None):
        """The backward of ``loss`` with the gradient exchange overlapped:
        each size-capped bucket's all-reduce is launched asynchronously from
        the grad-readiness hook as soon as every gradient in it is final,
        while the rest of the backward runs; the next ``step`` (its
        ``allreduce_grads``) waits on the launches and reduces what is left
        from the same plan.

        A plain ``autograd.backward`` (and the following step aggregates as
        usual) without a store of more than one worker that buckets, with
        ``MXNET_ALLREDUCE_OVERLAP=0``, or when a parameter has
        ``grad_req='add'`` (a running sum must not be sent early).  A
        failure on the wire raises out of this call with the failed
        bucket's gradients untouched; the step must then be abandoned on
        every worker."""
        from .. import autograd as _ag
        from .. import kvstore as kv_mod

        if not self._kv_initialized:
            self._init_kvstore()
        heads = loss if isinstance(loss, (list, tuple)) else [loss]
        kv = self._kvstore
        pairs = [(i, p) for i, p in enumerate(self._params)
                 if p.grad_req != "null" and p._data is not None]
        overlap = (os.environ.get("MXNET_ALLREDUCE_OVERLAP", "1") != "0"
                   and self._reduces() and not self._on_store() and len(pairs) > 1
                   and kv_mod.bucket_bytes() > 0 and kv.supports_grad_bucketing()
                   and all(p.grad_req == "write" for _, p in pairs))
        self._drop_overlap()
        if not overlap:
            _ag.backward(heads, head_grads)
            return
        items = [(i, p.grad()) for i, p in pairs]
        _, buckets = kv_mod.plan_buckets(items, names=[p.name for _, p in pairs],
                                         epoch=kv.membership_epoch())
        pos_of = {id(p._data): n for n, (_, p) in enumerate(pairs)}
        bucket_of, remaining = {}, []
        for b, bucket in enumerate(buckets):
            remaining.append(len(bucket["positions"]))
            for pos in bucket["positions"]:
                bucket_of[pos] = b
        # b -> (handle, the members' gradient versions at launch): step()
        # tells this plan from a stale one (an abandoned step followed by a
        # plain backward must reduce everything again)
        launched = {}
        self._overlap = {"buckets": buckets, "items": items, "pairs": pairs,
                         "launched": launched}

        def on_ready(leaf):
            pos = pos_of.get(id(leaf))
            if pos is None:
                return  # a leaf this trainer does not own
            b = bucket_of[pos]
            remaining[b] -= 1
            if remaining[b] == 0:
                versions = tuple(pairs[q][1]._grad_version for q in buckets[b]["positions"])
                launched[b] = (kv_mod.launch_bucket(kv, buckets[b], items), versions)
                _profiler.incr("allreduce_overlap_launched")

        try:
            _ag.backward(heads, head_grads, grad_ready_hook=on_ready)
        except BaseException:
            self._drop_overlap()
            raise

    def _drop_overlap(self):
        """Forget the overlap plan; its launched collectives are waited for
        (their peers' are in flight) and their results dropped."""
        plan, self._overlap = self._overlap, None
        if plan is None:
            return
        for handle, _ in plan["launched"].values():
            if handle["work"] is not None:
                try:
                    handle["work"].wait()
                except RuntimeError:
                    pass  # the step is abandoned; the error was raised where it happened

    def allreduce_grads(self):
        """Sum the gradients over the store's workers: size-capped flat
        buckets against a store that buckets (``kvstore.bucketed_pushpull``),
        else one ``pushpull`` a parameter.  The buckets that
        ``Trainer.backward`` launched are waited for and written, and the
        rest are reduced from the same plan, unless a backward has written
        their gradients since (the plan is then stale and everything is
        reduced anew).  One worker has nothing to reduce."""
        from .. import kvstore as kv_mod

        if not self._kv_initialized:
            self._init_kvstore()
        if self._on_store():
            raise RuntimeError("allreduce_grads() when parameters are updated on the kvstore "
                               "is not supported (update_on_kvstore=True)")
        plan = self._overlap
        if plan is not None:
            launched = plan["launched"]
            fresh = all(tuple(plan["pairs"][q][1]._grad_version
                              for q in plan["buckets"][b]["positions"]) == versions
                        for b, (_, versions) in launched.items())
            if fresh:
                self._overlap = None
                for b, bucket in enumerate(plan["buckets"]):
                    if b in launched:
                        kv_mod.finish_bucket(launched[b][0])
                    else:
                        kv_mod.execute_bucket(self._kvstore, bucket, plan["items"], None, None)
                return
            self._drop_overlap()
        if not self._reduces():
            return
        kv = self._kvstore
        pairs = [(i, p) for i, p in enumerate(self._params)
                 if p.grad_req != "null" and p._data is not None]
        if not pairs:
            return
        if len(pairs) > 1 and kv_mod.bucket_bytes() > 0 and kv.supports_grad_bucketing():
            kv_mod.bucketed_pushpull(kv, [(i, p.grad()) for i, p in pairs],
                                     names=[p.name for _, p in pairs])
            return
        for i, p in pairs:
            kv.pushpull(i, p.grad(), out=p.grad())

    def _update_on_store(self, ignore_stale_grad=False, stale=frozenset()):
        """``update_on_kvstore``: push each gradient, the store's optimizer
        updates its copy of the weight, pull that into the parameter."""
        for i, p in enumerate(self._params):
            if p.grad_req == "null" or p._data is None or (ignore_stale_grad and i in stale):
                continue
            self._kvstore.pushpull(i, p.grad(), out=p.data())
        for i, p in enumerate(self._params):
            if p.grad_req != "null" and p._data is not None:
                self._grad_versions[i] = p.grad_version

    def close(self):
        """Release what the trainer holds for distributed training: the
        store's ``close`` where it has one (a store object given to the
        constructor too, before any step made it current).  Idempotent."""
        kv = self._kvstore
        if kv is None and not isinstance(self._kvstore_type, str):
            kv = self._kvstore_type
        if kv is not None and hasattr(kv, "close"):
            kv.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def update(self, batch_size, ignore_stale_grad=False):
        """The optimizer update alone (gradients already reduced)."""
        if not self._kv_initialized:
            self._init_kvstore()
        if self._on_store():
            raise RuntimeError("update() when parameters are updated on the kvstore is not "
                               "supported (update_on_kvstore=True)")
        self._check_and_rescale_grad(self._scale / batch_size)
        stale = self._stale_indices() if ignore_stale_grad else frozenset()
        try:
            if _profiler._active:
                with _profiler.span("trainer.update", "trainer"):
                    self._update(ignore_stale_grad, stale)
            else:
                self._update(ignore_stale_grad, stale)
        finally:
            _profiler.step_boundary()

    def _stale_indices(self):
        """Parameters whose gradient no backward has written since their
        last update."""
        return {i for i, p in enumerate(self._params)
                if p.grad_req != "null" and p._data is not None
                and self._grad_versions.get(i) == p.grad_version}

    def _update(self, ignore_stale_grad=False, stale=frozenset()):
        items = []
        for i, p in enumerate(self._params):
            if p.grad_req == "null" or p._data is None:
                continue
            if ignore_stale_grad and i in stale:
                continue
            weight = p.data()
            if i not in self._states:
                self._states[i] = self._optimizer.create_state_multi_precision(i, weight)
            items.append((i, weight, p.grad()))
        # the fused group update (MXNET_STEP_FOLD=1: all its groups as one
        # CUDA-graph replay); what it leaves takes the per-tensor loop
        updater = _sf.fold_update if _sf.step_fast_path() else _fused.fused_update
        for i, weight, grad in updater(self._optimizer, items, self._states):
            self._optimizer.update_multi_precision(i, weight, grad, self._states[i])
        for i, p in enumerate(self._params):
            if p.grad_req != "null" and p._data is not None:
                self._grad_versions[i] = p.grad_version

    def save_states(self, fname):
        """Optimizer state and per-index update counts (Adam's ``t``
        resumes where it was), written atomically.  Refused while a K-step
        fold is off its window boundary (``program.window_pos != 0``): such
        a state is no point that K-step windows ever reach."""
        fold = self._fold() if self._fold is not None else None
        if fold is not None:
            if fold.window_pos != 0:
                raise RuntimeError(
                    f"save_states refused mid-window: the K-step fold is {fold.window_pos} "
                    f"step(s) past a K boundary (k={fold.k}); checkpoints land on K "
                    "boundaries only: finish the window with step_one, or save before "
                    "stepping off the boundary")
            fold.sync()
        if self._on_store():
            self._kvstore.save_optimizer_states(fname)
            return
        payload = {
            "states": {i: _to_numpy(st) for i, st in self._states.items()},
            "num_update": self._optimizer.num_update,
            "update_counts": dict(self._optimizer._index_update_count),
        }
        tmp = f"{fname}.tmp{os.getpid()}"
        with open(tmp, "wb") as f:
            pickle.dump(payload, f)
        os.replace(tmp, fname)

    def load_states(self, fname):
        if not self._kv_initialized:
            self._init_kvstore()
        if self._on_store():
            self._kvstore.load_optimizer_states(fname)
            return
        with open(fname, "rb") as f:
            payload = pickle.load(f)
        for i, st in payload["states"].items():
            if i not in self._states:
                self._states[i] = self._optimizer.create_state_multi_precision(
                    i, self._params[i].data())
            _copy_into(self._states[i], st)
        num_update = payload["num_update"]
        self._optimizer._index_update_count = dict(payload["update_counts"])
        self._optimizer.num_update = num_update
        self._optimizer.begin_num_update = num_update


def _to_numpy(st):
    if st is None:
        return None
    if isinstance(st, torch.Tensor):
        return st.detach().cpu().numpy()
    return type(st)(_to_numpy(s) for s in st)


@torch.no_grad()
def _copy_into(st, data):
    if st is None or data is None:
        return
    if isinstance(st, torch.Tensor):
        st.copy_(torch.from_numpy(data))
        return
    for s, d in zip(st, data):
        _copy_into(s, d)
