"""SPMDTrainer: a Gluon block, a loss and an optimizer as one data-parallel
training step.

Counterpart of the JAX package's ``parallel/trainer.py`` (pure data
parallelism).  There the step is one compiled SPMD program over a mesh of
devices: the forward and the loss over the global batch, its gradient,
the psum XLA derives from the shardings, and the optimizer.  Here one
process drives one card, the mesh's dp axis is the ``torch.distributed``
world (``parallel/mesh.py``), and each rank passes its own rows of the
global batch:

* at world 1 the step is the step fold's CUDA-graph replay
  (``gluon/step_fold.py``: warm-up, capture, replay, the per-step values
  through device memory, the dropout generator registered with the graph),
  so one replay holds forward, backward and the optimizer tail, and no
  collective is launched; on CPU tensors the same body runs directly;
* at world > 1 a collective cannot be captured over gloo (and the
  multi-process capture on NCCL waits in ROADMAP §1 item 6b), so the step
  runs forward and backward with each size-capped gradient bucket summed
  over the ranks as soon as its gradients are final (``Trainer.backward``
  against a ``dist_sync`` store on the mesh's group), then the optimizer
  tail; the build record says why (``fallback_reason``, ``record_compile``).
  BatchNorm normalizes by the global batch's statistics there, as the JAX
  package's one program over the global batch does (``ops/bn.py``
  ``global_batch``), and the returned loss is the global batch's mean.

In both, the optimizer tail is the fused group update on the hand-written
multi-tensor kernel (``optimizer/fused.py``), with the JAX trainer's
schedule: ``batch_size`` is the global batch (local rows x world),
``rescale_grad / batch_size`` scales the summed gradient, and ``t`` and the
learning rate follow the optimizer's scheduler, one count a step.  The
loss differentiated is the sum over the local rows, so the summed
gradients are those of the global batch's sum.  Parameters are the
block's own, updated in place (``sync_to_block`` has nothing to copy), and
are broadcast from rank 0 when the trainer is built, so every rank starts
equal.

Not in this slice, each raising and naming its ROADMAP §1 item:
``compression=`` or ``MXNET_GRAD_COMPRESS`` (6b), ``stages=``/``pipeline=``
(8), ``sp_axis=`` and rules that place a parameter anywhere but replicated
(6b).
"""
from __future__ import annotations

import os
import pickle
import weakref
from time import perf_counter as _perf

import numpy as np
import torch
import torch.distributed as dist

from .. import autograd
from .. import kvstore as _kv
from .. import optimizer as opt_mod
from .. import profiler as _profiler
from ..base import register_jit_cache_owner
from ..gluon import step_fold as _sf
from ..gluon.parameter import ParameterDict
from ..gluon.trainer import Trainer, _copy_into
from ..ndarray.ndarray import NDArray
from ..ops import bn as _bn
from .mesh import Mesh, current_mesh, make_mesh
from .sharding import ShardingRules, default_rules

__all__ = ["SPMDTrainer"]

_OFF = (None, False, "off", "", "0", "none")


def _release_spmd_memory(param_bytes, state_bytes):
    """weakref.finalize hook: a collected trainer's parameters and states
    leave the device-memory ledger."""
    _profiler.track_memory("spmd.params", "params").free(param_bytes)
    _profiler.track_memory("spmd.optimizer_state", "optimizer_state").free(state_bytes)


def _nbytes(st):
    if st is None:
        return 0
    if isinstance(st, torch.Tensor):
        return st.numel() * st.element_size()
    return sum(_nbytes(s) for s in st)


def _state_tree(st):
    """An optimizer state as the JAX trainer pickles it: numpy leaves in
    tuples."""
    if st is None:
        return None
    if isinstance(st, torch.Tensor):
        return st.detach().cpu().numpy()
    return tuple(_state_tree(s) for s in st)


def _compile_sig(arrays, program, n_params):
    """The JAX trainer's compile-registry signature of a step build."""
    sig = {"__program__": program, "label": _profiler.sig_array(arrays[-1]),
           "params": _profiler.sig_static(n_params)}
    for i, a in enumerate(arrays[:-1]):
        sig[f"input{i}"] = _profiler.sig_array(a)
    return sig


class _SPMDProgram(_sf.StepProgram):
    """The world-1 step (or window) as the step fold's program, reported
    under the JAX trainer's names: the ``spmd.step`` span and compile
    site."""

    _SPAN = "spmd.step"
    _SITE = "spmd.step"

    def window(self, *batch, batch_size):
        """A ``[kw, batch, ...]`` window as kw logical steps, whatever the
        program's K (a K=1 program's call would read it as one batch)."""
        return self._window_call([_sf._as_tensor(b) for b in batch], batch_size)

    def _record_build(self, batch, kw, tail, wall_ms):
        program = "step" if kw is None else f"step_window[{kw}]"
        sig = _compile_sig(batch, program, len(self._trainer._params))
        if kw is not None and kw != self._k:  # a tail width: a declared warm-up
            with _profiler.compile_guard_paused():
                _profiler.record_compile(self._SITE, sig, wall_ms)
        else:
            _profiler.record_compile(self._SITE, sig, wall_ms)


class SPMDTrainer:
    """Compile a Gluon block + loss + optimizer into one data-parallel
    training step (see the module doc).

    ``block`` is initialized and materialized (one forward has run);
    ``loss_fn(outputs, label)`` gives the per-sample loss; ``optimizer`` a
    name (with ``optimizer_params``) or an ``Optimizer``; ``mesh`` defaults
    to the ambient ``mesh_scope``, else the world over the device of the
    block's parameters; ``rules`` must replicate every parameter;
    ``donate`` is accepted (the step updates in place, which is what
    donation gives the JAX trainer)."""

    def __init__(self, block, loss_fn, optimizer, optimizer_params=None, mesh=None,
                 rules: ShardingRules | None = None, sp_axis: int | None = None,
                 donate: bool = True, stages=None, pipeline=None, compression=None):
        if stages is not None or pipeline:
            raise NotImplementedError(
                "SPMDTrainer(stages=, pipeline=): pipeline parallelism waits in ROADMAP §1 "
                "item 8")
        if sp_axis is not None:
            raise NotImplementedError(
                f"SPMDTrainer(sp_axis={sp_axis}): sequence parallelism waits in ROADMAP §1 "
                "item 6b")
        env = os.environ.get("MXNET_GRAD_COMPRESS", "off")
        if compression not in _OFF or str(env).lower() not in _OFF:
            raise NotImplementedError(
                f"SPMDTrainer(compression={compression!r}) / MXNET_GRAD_COMPRESS={env!r}: "
                "gradient compression waits in ROADMAP §1 item 6b")
        self._block = block
        self._loss_fn = loss_fn
        if isinstance(optimizer, opt_mod.Optimizer):
            self._optimizer = optimizer
        else:
            self._optimizer = opt_mod.create(optimizer, **(optimizer_params or {}))
        params = block.collect_params()
        if isinstance(params, (dict, ParameterDict)):
            params = list(params.values())
        params.sort(key=lambda p: p.name)
        for p in params:
            if p._data is None:
                raise ValueError(
                    f"Parameter {p.name} is not materialized (deferred init?). "
                    "Run one eager forward pass before building SPMDTrainer.")
        self._mesh = mesh or current_mesh() or make_mesh(
            devices=[params[0].data().device] * _world_size())
        self._rules = rules or default_rules()
        for p in params:
            spec = self._rules.spec_for(p.name, p.shape, self._mesh)
            if not spec.replicated:
                raise NotImplementedError(
                    f"SPMDTrainer: rules place {p.name} by {spec!r}; tensor and fsdp "
                    "placement wait in ROADMAP §1 item 6b (pure data parallelism replicates "
                    "every parameter)")
            if p.data().device != self._mesh.device:
                raise ValueError(f"Parameter {p.name} lives on {p.data().device}, the mesh's "
                                 f"rank on {self._mesh.device}: initialize the block there")
        self._params = params
        self._trainable_idx = [i for i, p in enumerate(params) if p.grad_req != "null"]
        world = self._mesh.world
        if world > 1:
            # every rank starts from rank 0's values (the JAX trainer's
            # device_put onto the mesh); the states below copy them
            with torch.no_grad():
                for p in params:
                    self._mesh.broadcast(p.data().detach())
        store = (_kv.KVStoreDist("dist_sync", group=self._mesh.group) if world > 1 else None)
        self._trainer = Trainer(params, self._optimizer,
                                {"rescale_grad": self._optimizer.rescale_grad}, kvstore=store)
        for i in self._trainable_idx:
            self._trainer._states[i] = self._optimizer.create_state_multi_precision(
                i, params[i].data())
        # BatchNorm's statistics and the loss travel on a group of their
        # own, so they never interleave with the gradient buckets' launches
        self._aux = (Mesh(self._mesh.shape, self._mesh.device, group=dist.new_group(),
                          rank=self._mesh.rank) if world > 1 else None)
        self._programs = {}
        self._window_k = None   # step_window's steady width (the first seen)
        self._built = set()     # signatures the world > 1 step has run
        self._fallback_reason = None if world == 1 else (
            f"world {world} over {self._mesh.backend}: a collective cannot be captured in a "
            "CUDA graph over gloo, and the multi-process capture on NCCL waits in ROADMAP §1 "
            "item 6b; forward/backward, the bucketed all-reduce and the optimizer tail run "
            "as separate launches")
        pb = sum(p.data().numel() * p.data().element_size() for p in params)
        sb = sum(_nbytes(self._trainer._states[i]) for i in self._trainable_idx)
        _profiler.track_memory("spmd.params", "params").alloc(pb)
        _profiler.track_memory("spmd.optimizer_state", "optimizer_state").alloc(sb)
        self._mem_finalizer = weakref.finalize(self, _release_spmd_memory, pb, sb)
        register_jit_cache_owner(self)
        if world > 1:
            _profiler.set_process_info(rank=self._mesh.rank)

    def _invalidate_jit_cache(self):
        self._programs.clear()

    # ------------------------------------------------------------------
    @property
    def mesh(self):
        return self._mesh

    @property
    def optimizer(self):
        return self._optimizer

    @property
    def num_update(self):
        return self._optimizer.num_update

    @property
    def fallback_reason(self):
        """Why a step is not one CUDA-graph replay (None at world 1)."""
        return self._fallback_reason

    def learning_rate(self):
        opt = self._optimizer
        if opt.lr_scheduler is not None:
            return float(opt.lr_scheduler(opt.num_update))
        return float(opt.lr)

    # ------------------------------------------------------------------
    def shard_batch(self, *arrays):
        """Stage batch arrays (numpy, NDArray or tensors: this rank's rows of
        the global batch) on the rank's device; a tensor already there is
        used as it is.  Returns tensors."""
        out = []
        for a in arrays:
            t = a._data if isinstance(a, NDArray) else a
            if isinstance(t, torch.Tensor) and t.device == self._mesh.device:
                out.append(t)  # already staged: no host work
                continue
            t0 = _perf() if _profiler._active else None
            if not isinstance(t, torch.Tensor):
                t = torch.as_tensor(np.asarray(t))
            out.append(t.to(self._mesh.device))
            if t0 is not None:
                _profiler.record_span("spmd.shard_batch", "trainer", t0,
                                      args={"bytes": t.numel() * t.element_size()})
        return tuple(out)

    def shard_window(self, *arrays):
        """:meth:`shard_batch` for ``[K, batch, ...]`` windows: every rank
        holds the K axis whole and its own rows of each step's batch."""
        return self.shard_batch(*arrays)

    def _loss(self, *arrays):
        return self._loss_fn(self._block(*arrays[:-1]), arrays[-1])

    def _program(self, k):
        key = "step" if k is None else "window"
        prog = self._programs.get(key)
        if prog is None:
            prog = self._programs[key] = _SPMDProgram(self._trainer, self._loss,
                                                      block=self._block, k=k)
        return prog

    @staticmethod
    def _mean(loss):
        return NDArray(loss.detach().float().mean())

    # ------------------------------------------------------------------
    def step(self, data, label, batch_size=None):
        """One training step; returns the global batch's mean loss (a
        scalar NDArray).  ``batch_size`` defaults to the global batch (axis
        0 of this rank's rows times the world)."""
        inputs = data if isinstance(data, (list, tuple)) else (data,)
        arrays = self.shard_batch(*inputs, label)
        if batch_size is None:
            batch_size = arrays[0].shape[0] * self._mesh.world
        if self._mesh.world == 1:
            return self._mean(self._program(None)(*arrays, batch_size=batch_size))
        return self._dist_step(arrays, batch_size, "step")

    def step_bulk(self, data, label, k, batch_size=None):
        """``k`` steps on the same batch, with the schedule (``t``, learning
        rate, dropout draws) of ``k`` calls of :meth:`step`; at world 1 one
        replay of ``k`` captured step bodies.  Returns the last step's mean
        loss."""
        if k < 1:
            raise ValueError(f"step_bulk needs k >= 1, got {k}")
        inputs = data if isinstance(data, (list, tuple)) else (data,)
        arrays = self.shard_batch(*inputs, label)
        if batch_size is None:
            batch_size = arrays[0].shape[0] * self._mesh.world
        if self._mesh.world == 1:
            window = [a.unsqueeze(0).expand(k, *a.shape) for a in arrays]
            return self._window(window, batch_size)
        for _ in range(k):
            loss = self._dist_step(arrays, batch_size, f"step_bulk[{k}]")
        return loss

    def step_window(self, data, label, batch_size=None):
        """K steps over the K rows of a ``[K, batch, ...]`` window, each as
        :meth:`step` on that row; at world 1 one replay.  The first K seen is
        the steady width; a shorter tail is its own program, built once as a
        declared warm-up.  Returns the last step's mean loss."""
        inputs = data if isinstance(data, (list, tuple)) else (data,)
        arrays = self.shard_window(*inputs, label)
        if arrays[0].ndim < 2:
            raise ValueError("step_window expects stacked [k, batch, ...] windows; got "
                             f"{tuple(arrays[0].shape)}")
        if batch_size is None:
            batch_size = arrays[0].shape[1] * self._mesh.world
        if self._mesh.world == 1:
            return self._window(arrays, batch_size)
        for j in range(arrays[0].shape[0]):
            loss = self._dist_step([a[j] for a in arrays], batch_size,
                                   f"step_window[{arrays[0].shape[0]}]")
        return loss

    def _window(self, arrays, batch_size):
        if self._window_k is None:
            self._window_k = int(arrays[0].shape[0])
        losses = self._program(self._window_k).window(*arrays, batch_size=batch_size)
        return self._mean(losses[-1])

    def _dist_step(self, arrays, batch_size, program):
        """One step at world > 1: forward and backward with BatchNorm over
        the global batch and each gradient bucket's all-reduce launched as
        its gradients are final, then the remaining buckets and the fused
        optimizer tail; the loss summed over the ranks."""
        tr = self._trainer
        sig = (program, tuple((tuple(a.shape), a.dtype) for a in arrays))
        tw = _perf()
        try:
            tr._check_and_rescale_grad(tr._scale / batch_size)
            with _bn.global_batch(self._aux):
                with autograd.record():
                    loss = self._loss(*arrays)
                tr.backward(loss)
            tr.allreduce_grads()
            tr._update()
            total = loss.detach().float().sum().reshape(1)
            self._aux.all_reduce(total)
            if sig not in self._built:
                self._built.add(sig)
                build = _compile_sig(arrays, program, len(self._params))
                build["fallback_reason"] = _profiler.sig_static(self._fallback_reason)
                _profiler.record_compile("spmd.step", build, (_perf() - tw) * 1e3)
            if _profiler._active:
                _profiler.record_span("spmd.step", "trainer", tw,
                                      args={"world": self._mesh.world})
        finally:
            _profiler.step_boundary()
        return NDArray((total / (arrays[0].shape[0] * self._mesh.world)).reshape(()))

    # ------------------------------------------------------------------
    def sync_to_block(self):
        """Make the block's Parameters current before ``save_parameters`` or
        eager use: they are the trainer's own, updated in place by every
        step, so there is nothing to copy."""

    def save_states(self, fname):
        """The optimizer states, one a trainable parameter in name order,
        and ``num_update``: the JAX trainer's pickle of numpy trees, so a
        file of either package loads into the other.  Written atomically."""
        payload = {"states": [_state_tree(self._trainer._states[i])
                              for i in self._trainable_idx],
                   "num_update": int(self.num_update)}
        tmp = f"{fname}.tmp{os.getpid()}"
        with open(tmp, "wb") as f:
            pickle.dump(payload, f)
        os.replace(tmp, fname)

    def load_states(self, fname):
        with open(fname, "rb") as f:
            payload = pickle.load(f)
        for slot, i in enumerate(self._trainable_idx):
            _copy_into(self._trainer._states[i], payload["states"][slot])
        t = int(payload["num_update"])
        opt = self._optimizer
        opt._index_update_count = {i: t for i in self._trainable_idx}
        opt.num_update = t


def _world_size():
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
