"""Executor — runs a bound Symbol graph as a walk over tensors.

Counterpart of the JAX package's ``executor.py`` (parity target:
``GraphExecutor``, [U:src/executor/graph_executor.cc], and its Python
wrapper, [U:python/mxnet/executor.py]).  Where the JAX package jits one
program per input signature, the port builds one *plan* per signature: the
graph's topological order resolved once to op callables, their static
attributes and the slots each reads, with every intermediate dropped after
its last reader.  A forward runs the plan's steps in order through the
port's ops, so on CUDA tensors it reaches the same hand-written kernels as
the Gluon path.  A plan's build reports to ``profiler.record_compile`` as a
JAX compile does, so ``Predictor.is_warm``, ``compile_stats`` and the
serving tier's "no miss after warm-up" keep their meaning.

BatchNorm's auxiliary states: the op returns batch statistics, and a
training forward blends them into the moving statistics after the walk
(the reference mutates aux arrays inside the op kernel).

Training (the JAX package differentiates the same program): a training
forward records PyTorch's graph from a fresh ``detach().requires_grad_()``
view of every floating argument whose ``grad_req`` is not ``"null"``, so
the optimizer's in-place update of a bound weight never touches a leaf that
requires grad.  ``backward`` differentiates that graph and frees it (the
activations leave the device before the optimizer's update).  A second
``backward``, or one after an inference forward (or none), walks the graph
again in training mode over the bound arrays, as the JAX package's
recompute does: from the generator state the last training forward
started from (the same dropout masks; after an inference forward, from the
state it finds) and without moving the BatchNorm statistics a second time.
Gradients land in the bound gradient NDArrays, which stay the same objects
(a caller's ``args_grad`` and ``BucketingModule``'s buckets hold them):
``write`` gives one a new tensor in its dtype, ``add`` accumulates.

The ops that draw (``Dropout``, and ``RNN``'s dropout between layers) get
the walk's mode and, in training, the context's generator.  The JAX
package's executor gives ``RNN`` no key, so there a graph's ``RNN(p=...)``
trains without that dropout; the reference applies it.
"""
from __future__ import annotations

import weakref as _weakref
from time import perf_counter as _perf

import numpy as _np
import torch

from . import autograd
from . import profiler as _profiler
from .base import as_torch_dtype
from .context import current_context
from .ndarray.ndarray import NDArray, _from_host, _wrap
from .ops.registry import get_op
from .random import get_generator
from .symbol.infer import takes_ctx, takes_key

__all__ = ["Executor"]


def _release_executor_memory(nbytes):
    """weakref.finalize hook: a collected executor's bound arrays leave
    the device-memory ledger (module-level — must not reference self)."""
    _profiler.track_memory("executor.bound", "params").free(nbytes)


def _tensor(v, device, dtype=None):
    """``v`` (NDArray, tensor or array-like) as a tensor on ``device``, in
    ``dtype`` (by default an array-like's own, 64-bit types as 32-bit)."""
    if isinstance(v, NDArray):
        v = v._data
    if not isinstance(v, torch.Tensor):
        if dtype is None:
            return _from_host(v, None, device)
        v = torch.from_numpy(_np.ascontiguousarray(v))
    return v.to(device=device, dtype=dtype)


def _as_ndarray(v, ctx):
    """An NDArray on ``ctx``: an NDArray already there is kept as it is
    (bound arrays are shared by object), anything else is copied there."""
    if isinstance(v, NDArray) and v._data.device == ctx.device:
        return v
    t = _tensor(v, ctx.device, v._data.dtype if isinstance(v, NDArray) else None)
    return _wrap(t, ctx)


class _Plan:
    """One signature's graph walk: ``steps`` of (fn, attrs, input slots,
    slot, slots to free after), the variable slots, the output slots and,
    in training, the BatchNorm aux updates and the slots of the ops that
    draw from a generator (``Dropout``, ``RNN``), which get the ``key``
    their walk is given."""

    __slots__ = ("n_slots", "var_slots", "steps", "outputs", "bn_updates", "keyed")

    def __init__(self, symbol, ctx, training):
        topo = symbol._topo()
        slot = {id(n): i for i, n in enumerate(topo)}
        self.n_slots = len(topo)
        self.var_slots = [(slot[id(n)], n.name) for n in topo if n.op is None]
        self.outputs = [(slot[id(n)], idx) for n, idx in symbol._outputs]
        keep = {s for s, _ in self.outputs}
        last_use = {}
        for i, node in enumerate(topo):
            for src, _ in node.inputs:
                last_use[slot[id(src)]] = i
        frees = {}
        for s, i in last_use.items():
            if s not in keep:
                frees.setdefault(i, []).append(s)
        self.steps = []
        self.bn_updates = []
        self.keyed = set()
        for i, node in enumerate(topo):
            if node.op is None:
                continue
            fn = get_op(node.op).fn
            attrs = {k: v for k, v in node.attrs.items() if not k.startswith("__")}
            if "ctx" not in attrs and takes_ctx(fn):
                attrs["ctx"] = ctx
            if takes_key(fn):
                attrs["training"] = training
                if training:
                    self.keyed.add(i)
            ins = tuple((slot[id(src)], idx) for src, idx in node.inputs)
            self.steps.append((fn, attrs, ins, i, tuple(frees.get(i, ()))))
            if (node.op == "BatchNorm" and training
                    and not attrs.get("use_global_stats", False)):
                momentum = attrs.get("momentum", 0.9)
                names = node.attrs.get("__input_names__") or []
                for (src, _), pname in zip(node.inputs, names):
                    if pname in ("moving_mean", "moving_var"):
                        stat = 1 if pname == "moving_mean" else 2
                        self.bn_updates.append((src.name, i, stat, momentum))

    def run(self, arrays, key=None):
        """Outputs and aux updates of one walk over ``arrays`` (name →
        tensor), the keyed ops drawing from ``key``."""
        values = [None] * self.n_slots
        for s, name in self.var_slots:
            values[s] = (arrays[name],)
        bn_out = {}
        bn_slots = {i for _, i, _, _ in self.bn_updates}
        for fn, attrs, ins, s, frees in self.steps:
            if s in self.keyed:
                attrs = {**attrs, "key": key}
            out = fn(*[values[j][k] for j, k in ins], **attrs)
            values[s] = out if isinstance(out, tuple) else (out,)
            if s in bn_slots:
                bn_out[s] = values[s]
            for j in frees:
                values[j] = None
        updates = {}
        for name, s, stat, momentum in self.bn_updates:
            updates[name] = momentum * arrays[name] + (1 - momentum) * bn_out[s][stat]
        return [values[s][idx] for s, idx in self.outputs], updates


class Executor:
    def __init__(self, symbol, ctx=None, args=None, args_grad=None,
                 grad_req="write", aux_states=None):
        self._symbol = symbol
        self._ctx = ctx or current_context()
        self.outputs = []

        arg_names = symbol.list_arguments()
        aux_names = symbol.list_auxiliary_states()

        if isinstance(args, (list, tuple)):
            args = dict(zip(arg_names, args))
        args = {k: _as_ndarray(v, self._ctx) for k, v in (args or {}).items()}
        if isinstance(aux_states, (list, tuple)):
            aux_states = dict(zip(aux_names, aux_states))
        aux_states = {k: _as_ndarray(v, self._ctx) for k, v in (aux_states or {}).items()}

        self._arg_dict = args
        self._aux_dict = aux_states

        # grad_req: str | list | dict  → per-arg dict
        if isinstance(grad_req, str):
            grad_req = {n: grad_req for n in arg_names}
        elif isinstance(grad_req, (list, tuple)):
            grad_req = dict(zip(arg_names, grad_req))
        self._grad_req = {n: grad_req.get(n, "null") for n in arg_names}

        if isinstance(args_grad, (list, tuple)):
            args_grad = dict(zip(arg_names, args_grad))
        self._grad_dict = {k: _as_ndarray(v, self._ctx)
                           for k, v in (args_grad or {}).items() if v is not None}
        for n in arg_names:
            if self._grad_req[n] != "null" and n not in self._grad_dict and n in args:
                self._grad_dict[n] = _wrap(torch.zeros_like(args[n]._data), self._ctx)

        self._fwd_cache = {}
        # the last training forward's recorded outputs and leaves, and the
        # generator state it started from (backward's recompute draws the
        # same dropout masks from it; None after an inference forward, whose
        # backward draws from the state it finds)
        self._graph = None
        self._rng_state = None
        # compile-registry site label; the Predictor relabels its executors
        # "predictor.forward" and the serving tier overrides both with a
        # profiler.compile_site scope ("serving.warmup"/"serving.dispatch")
        self._compile_site = "executor.forward"
        # device-memory ledger: the bound arg/aux arrays, released at GC.
        # A Predictor immediately calls _release_memory(): its executors
        # share the predictor-accounted parameter store by object.
        nb = sum(_profiler.array_nbytes(v)
                 for d in (self._arg_dict, self._aux_dict, self._grad_dict) for v in d.values())
        _profiler.track_memory("executor.bound", "params").alloc(nb)
        self._mem_finalizer = _weakref.finalize(self, _release_executor_memory, nb)

    def _release_memory(self):
        """Drop this executor's ledger row early (idempotent)."""
        self._mem_finalizer()

    # ------------------------------------------------------------------
    @classmethod
    def simple_bind(cls, symbol, ctx=None, grad_req="write", type_dict=None,
                    **shapes):
        """Infer all shapes from the given input shapes and allocate zeroed
        arg/aux/grad arrays on ``ctx`` (parity: ``Symbol.simple_bind``; the
        user then fills params)."""
        ctx = ctx or current_context()
        arg_shapes, _, aux_shapes = symbol.infer_shape(**shapes)
        arg_dtypes, _, aux_dtypes = symbol.infer_type(
            **{k: tuple(v) for k, v in shapes.items()})
        type_dict = type_dict or {}

        def zeros(shape, dtype):
            return _wrap(torch.zeros(shape, dtype=as_torch_dtype(dtype), device=ctx.device),
                         ctx)

        args, auxs = {}, {}
        for name, shape, dt in zip(symbol.list_arguments(), arg_shapes, arg_dtypes):
            if shape is None:
                raise ValueError(f"simple_bind: could not infer shape of {name!r}")
            args[name] = zeros(shape, type_dict.get(name, dt or "float32"))
        for name, shape, dt in zip(symbol.list_auxiliary_states(), aux_shapes, aux_dtypes):
            auxs[name] = zeros(shape, type_dict.get(name, dt or "float32"))
        return cls(symbol, ctx, args=args, grad_req=grad_req, aux_states=auxs)

    # ------------------------------------------------------------------
    @property
    def arg_dict(self):
        return self._arg_dict

    @property
    def grad_dict(self):
        return self._grad_dict

    @property
    def aux_dict(self):
        return self._aux_dict

    @property
    def arg_arrays(self):
        return [self._arg_dict[n] for n in self._symbol.list_arguments()]

    @property
    def grad_arrays(self):
        return [self._grad_dict.get(n) for n in self._symbol.list_arguments()]

    @property
    def aux_arrays(self):
        return [self._aux_dict[n] for n in self._symbol.list_auxiliary_states()]

    # ------------------------------------------------------------------
    def _collect_inputs(self):
        arrays = {}
        for d in (self._arg_dict, self._aux_dict):
            for k, v in d.items():
                arrays[k] = v._data
        return arrays

    def _signature(self, arrays):
        return tuple(sorted((k, tuple(v.shape), v.dtype) for k, v in arrays.items()))

    def _compile_signature(self, arrays, program):
        """Compile-registry signature: every bound array by NAME, so a
        rebuild attributes the exact drifted input or parameter."""
        sig = {"__program__": program}
        for k in sorted(arrays):
            sig[k] = _profiler.sig_array(arrays[k])
        return sig

    # ------------------------------------------------------------------
    def forward(self, is_train=False, **kwargs):
        """Run the graph (under ``torch.inference_mode()`` unless
        ``is_train``) and return the outputs as NDArrays on the executor's
        context.  Keyword arguments replace bound arguments first.  A
        training forward records the graph ``backward`` differentiates."""
        for k, v in kwargs.items():
            if k not in self._arg_dict:
                raise ValueError(
                    f"forward: {k!r} is not an argument of this executor "
                    f"(arguments: {sorted(self._arg_dict)})")
            arg = self._arg_dict[k]
            arg._data = _tensor(v, arg._data.device, arg._data.dtype)
            arg._version += 1
        self._graph = None  # the last forward's activations go first
        arrays = self._collect_inputs()
        training = bool(is_train)
        plan, sig, tc = self._plan(arrays, training)
        self._rng_state = None
        try:
            if training:
                gen = get_generator(self._ctx.device)
                self._rng_state = gen.get_state()
                outs, aux_updates, self._graph = self._run_train(plan, arrays, gen)
            else:
                with torch.inference_mode(), autograd._scope(False, False):
                    outs, aux_updates = plan.run(arrays)
        except Exception:
            if tc is not None:  # a plan that never ran is not a warm one
                del self._fwd_cache[sig]
            raise
        if tc is not None:
            _profiler.record_compile(
                self._compile_site,
                self._compile_signature(arrays, "fwd_train" if training else "fwd"),
                (_perf() - tc) * 1e3)
        self.outputs = [_wrap(o.detach(), self._ctx) for o in outs]
        for name, new in aux_updates.items():
            self._aux_dict[name]._data = new.detach()
            self._aux_dict[name]._version += 1
        return self.outputs

    def _wrt(self, arrays):
        """The arguments to differentiate: ``grad_req`` not ``"null"``, of a
        floating dtype."""
        return [n for n, r in self._grad_req.items()
                if r != "null" and n in arrays and arrays[n].is_floating_point()]

    def _plan(self, arrays, training):
        """``(plan, signature, build start)`` of ``arrays``' signature; the
        plan is built on a miss, and the start is None on a hit."""
        sig = (self._signature(arrays), training)
        plan = self._fwd_cache.get(sig)
        if plan is not None:
            return plan, sig, None
        tc = _perf()
        plan = self._fwd_cache[sig] = _Plan(self._symbol, self._ctx, training)
        return plan, sig, tc

    def _run_train(self, plan, arrays, gen):
        """One training walk, its keyed ops drawing from ``gen``; with
        arguments to differentiate it records the graph from fresh leaves:
        ``(outputs, aux updates, (outputs, leaves))``, else ``(outputs, aux
        updates, None)``."""
        wrt = self._wrt(arrays)
        if not wrt:
            with torch.no_grad(), autograd._scope(False, True):
                outs, aux_updates = plan.run(arrays, gen)
            return outs, aux_updates, None
        leaves = {n: arrays[n].detach().requires_grad_() for n in wrt}
        with autograd._scope(True, True):
            outs, aux_updates = plan.run({**arrays, **leaves}, gen)
        return outs, aux_updates, (outs, leaves)

    def backward(self, out_grads=None, is_train=True):
        """Gradients of the outputs, seeded with ``out_grads`` (ones by
        default, cast to each output's dtype), with respect to every
        argument whose ``grad_req`` is not ``"null"``, into ``grad_dict``.
        The loss heads (``SoftmaxOutput``, ``LinearRegressionOutput``)
        ignore their seed, as in the reference."""
        if not any(r != "null" for r in self._grad_req.values()):
            return
        graph, self._graph = self._graph, None
        if graph is None:  # a second backward, or after an inference forward: walk again
            arrays = self._collect_inputs()
            plan = self._plan(arrays, True)[0]
            gen = get_generator(self._ctx.device)
            now = gen.get_state()
            if self._rng_state is not None:
                gen.set_state(self._rng_state)
            try:
                _, _, graph = self._run_train(plan, arrays, gen)
            finally:
                gen.set_state(now)
            if graph is None:
                return
        outs, leaves = graph
        if out_grads is None:
            seeds = [None] * len(outs)
        else:
            if isinstance(out_grads, (NDArray, torch.Tensor)):
                out_grads = [out_grads]
            seeds = [_tensor(g, o.device, o.dtype) for g, o in zip(out_grads, outs)]
        heads, head_grads = [], []
        for o, g in zip(outs, seeds):
            if o.requires_grad:
                heads.append(o)
                head_grads.append(torch.ones_like(o) if g is None else g)
        names = list(leaves)
        grads = [None] * len(names)
        if heads:
            with torch.enable_grad():
                grads = torch.autograd.grad(heads, [leaves[n] for n in names], head_grads,
                                            allow_unused=True)
        for name, g in zip(names, grads):
            if g is None:
                g = torch.zeros_like(leaves[name])
            tgt = self._grad_dict.get(name)
            if tgt is None:
                tgt = self._grad_dict[name] = _wrap(torch.zeros_like(g), self._ctx)
            if self._grad_req[name] == "add":
                tgt._data = tgt._data + g
            else:
                tgt._data = g.to(tgt._data.dtype)
            tgt._version += 1

    # ------------------------------------------------------------------
    def copy_params_from(self, arg_params, aux_params=None,
                         allow_extra_params=False):
        for store, params, what in ((self._arg_dict, arg_params, "argument"),
                                    (self._aux_dict, aux_params, "aux state")):
            for k, v in (params or {}).items():
                if k in store:
                    store[k]._data = _tensor(v, store[k]._data.device, store[k]._data.dtype)
                    store[k]._version += 1
                elif not allow_extra_params:
                    raise ValueError(f"unknown {what} {k!r}")

    def reshape(self, partial_shaping=False, allow_up_sizing=False, **new_shapes):
        """Rebind with new input shapes, sharing the weights and their
        gradient arrays by object (the bucketing primitive: a new signature
        gets its own plan at its first forward)."""
        args = dict(self._arg_dict)
        grads = {k: v for k, v in self._grad_dict.items() if k not in new_shapes}
        for k, shape in new_shapes.items():
            if k in args:
                old = args[k]._data
                args[k] = _wrap(torch.zeros(tuple(shape), dtype=old.dtype, device=old.device),
                                self._ctx)
        return Executor(self._symbol, self._ctx, args=args, args_grad=grads,
                        grad_req=self._grad_req, aux_states=dict(self._aux_dict))
