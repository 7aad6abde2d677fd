"""``mx.predictor`` — standalone inference API.

Counterpart of the JAX package's ``predictor.py`` (parity:
[U:src/c_api/c_predict_api.cc], ``MXPredCreate`` / SetInput / Forward /
GetOutput): load a ``-symbol.json`` + ``.params`` checkpoint and run
forward only, on the card unless ``dev_type="cpu"`` is given (where the
JAX package defaults to the CPU).

The predictor is the binding substrate of the serving tier
(``incubator_mxnet_torch/serving``): parameters are placed on the device
ONCE and **shared by object across every shape bind** — ``reshape(new_shapes)``
swaps the active input-shape signature, reusing both the parameter tensors
and any executor (and its plans) previously bound for that signature.  A
shape-bucketed server therefore holds one copy of the weights however many
(batch, length) buckets it serves, and switching buckets costs a dict
lookup, not a device copy or a plan build.

A ``Predictor`` is NOT thread-safe (``reshape``/``set_input``/``forward``
mutate the active executor): concurrent callers must serialize, which is
exactly what ``serving.InferenceServer``'s single scheduler thread does.
:class:`StatefulExecutor` is the generation tier's substrate: named
programs over one dict of device tensors that they update in place.
"""
from __future__ import annotations

import json as _json
import time as _time
import weakref as _weakref

import numpy as _np
import torch

from . import profiler
from .base import as_torch_dtype

__all__ = ["Predictor", "StatefulExecutor", "load_checkpoint"]


def _release_predictor_memory(cell):
    """weakref.finalize hook for a predictor's ledger share (mutable cell:
    late-bound zero-filled parameters grow it after construction)."""
    profiler.track_memory("predictor.params", "params").free(cell[0])
    cell[0] = 0


def _split_param_key(name):
    """Split a checkpoint key into (kind, bare_name).

    Only the literal ``arg:`` / ``aux:`` prefixes of the reference
    checkpoint format are stripped; any other colon is part of the
    parameter's own name.  ``kind`` is ``"arg"``, ``"aux"`` or ``None``
    (unprefixed — classified against the symbol's argument/aux lists by the
    caller), so prefixed and unprefixed checkpoints load identically."""
    if name.startswith("arg:"):
        return "arg", name[4:]
    if name.startswith("aux:"):
        return "aux", name[4:]
    return None, name


def load_checkpoint(symbol_file, param_file):
    """Load a (symbol, params) checkpoint into ``(symbol, arg_params,
    aux_params)`` NDArray dicts with the ``arg:``/``aux:`` prefixes
    resolved (unprefixed keys are classified against the symbol's
    argument/aux lists).  A params file is read onto the CPU; the
    :class:`Predictor` moves it to its device once."""
    from . import symbol as sym_mod
    from .context import cpu
    from .ndarray import utils as nd_utils
    from .ndarray.ndarray import NDArray, _wrap, array

    sym = sym_mod.load(symbol_file) if isinstance(symbol_file, str) else symbol_file
    loaded = nd_utils.load(param_file, ctx=cpu()) if isinstance(param_file, str) \
        else param_file
    arg_names = set(sym.list_arguments())
    aux_names = set(sym.list_auxiliary_states())
    args, auxs = {}, {}
    for k, v in loaded.items():
        kind, name = _split_param_key(k)
        if kind is None:
            kind = "aux" if name in aux_names and name not in arg_names else "arg"
        if isinstance(v, NDArray):
            nd = v
        elif isinstance(v, torch.Tensor):  # a Parameter's data(), say
            nd = _wrap(v.detach())
        else:
            nd = array(_np.asarray(v), ctx=cpu())
        (auxs if kind == "aux" else args)[name] = nd
    return sym, args, auxs


class _Program:
    """A bound program and the input signatures it has been called at (its
    "builds": ``profiler.jit_cache_size`` counts them)."""

    __slots__ = ("fn", "donate_state", "signatures")

    def __init__(self, fn, donate_state):
        self.fn, self.donate_state = fn, bool(donate_state)
        self.signatures = set()


class StatefulExecutor:
    """Bind step programs over one shared dict of device tensors.

    Counterpart of the JAX package's ``StatefulExecutor``.  The decode loop
    of the generation tier (``serving/generation.py``) is a stateful
    workload: every iteration reads the KV cache and writes its next
    position.  Programs are plain functions ``fn(state, inputs) ->
    (outputs, new_state)``, where ``new_state`` carries every state key.
    A program updates the state tensors in place (``index_put_``,
    ``copy_``) and returns them: that is this port's form of the
    reference's donation, so steady-state memory holds one copy of the
    state.  With ``donate_state=False`` the program gets copies and the
    tensors it was handed stay as they were.

    ``run(program, **inputs)``: numpy arrays of one or more dimensions
    (token ids, positions) go to the state's device before the call;
    numpy scalars and Python numbers stay on the host (a slot index, a
    prompt length), so a program can shape views by them; tensors pass as
    they are.  A program does no host synchronization itself.  The first
    call of a program at a new input signature (the shapes and dtypes of
    the state and the inputs) is its build, as a jit trace is the
    reference's: it is reported through ``profiler.record_compile`` under
    this executor's site, counts in ``compile_stats()``, and after
    ``profiler.arm_compile_guard`` raises in the guard's raise mode, after
    the state is rebound.

    Not thread-safe, as :class:`Predictor`: one scheduler thread owns all
    the calls.
    """

    def __init__(self, state, name="stateful", compile_site=None, device=None):
        self._state = dict(state or {})
        self._name = str(name)
        self._site = compile_site or f"executor.{self._name}"
        self._programs = {}
        self._calls = {}
        self._compiles = 0
        if device is None:
            device = next((v.device for v in self._state.values()
                           if isinstance(v, torch.Tensor)), None)
        self._device = device

    @property
    def state(self):
        """The live state dict (read-only by convention)."""
        return self._state

    def add_program(self, name, fn, donate_state=True):
        """Register ``fn(state, inputs) -> (outputs, new_state)`` under
        ``name``."""
        if name in self._programs:
            raise ValueError(f"program {name!r} already bound")
        self._programs[name] = _Program(fn, donate_state)
        self._calls[name] = 0
        return self

    def _signature(self, program, inputs):
        sig = {"__program__": program}
        for k, v in self._state.items():
            sig[f"state:{k}"] = profiler.sig_array(v)
        for k, v in (inputs or {}).items():
            sig[k] = profiler.sig_array(v) if hasattr(v, "shape") else profiler.sig_static(v)
        return sig

    def _staged(self, v):
        if isinstance(v, _np.ndarray) and v.ndim > 0:
            t = torch.from_numpy(_np.ascontiguousarray(v))
            return t if self._device is None else t.to(self._device, non_blocking=True)
        return v

    def run(self, program, **inputs):
        """Call ``program`` on the current state; rebind the returned state;
        return the outputs.  A call at a signature the program has not seen
        is reported to the compile registry."""
        prog = self._programs[program]
        sig = self._signature(program, inputs)
        key = _json.dumps(sig, sort_keys=True, default=str)
        state = (self._state if prog.donate_state
                 else {k: v.clone() for k, v in self._state.items()})
        t0 = _time.perf_counter()
        try:
            outputs, new_state = prog.fn(state, {k: self._staged(v) for k, v in inputs.items()})
        except Exception as e:
            # the stateful dispatch (a decode step, a KV-cache insert) is an
            # OOM choke point: one postmortem naming the top ledger owners
            profiler.maybe_oom_postmortem(e, f"{self._site}:{program}")
            raise
        wall_ms = (_time.perf_counter() - t0) * 1e3
        missing = set(self._state) - set(new_state)
        if missing:
            raise RuntimeError(
                f"program {program!r} dropped state keys {sorted(missing)}; every program "
                "must return the full state")
        self._state = dict(new_state)
        self._calls[program] += 1
        if key not in prog.signatures:
            prog.signatures.add(key)
            self._compiles += 1
            profiler.record_compile(self._site, sig, wall_ms, fn=prog.fn)
        return outputs

    def is_warm(self, program):
        """True when ``program`` has been built at one signature at least."""
        return profiler.jit_cache_size(self._programs[program]) > 0

    def compile_stats(self):
        """``{"programs", "entries", "compiles", "calls"}``: the generation
        harness compares it around a traffic run to prove no program was
        built after warm-up."""
        entries = sum(profiler.jit_cache_size(p) for p in self._programs.values())
        return {"programs": len(self._programs), "entries": entries,
                "compiles": self._compiles, "calls": dict(self._calls)}


class Predictor:
    """forward-only executor over (symbol json, params file).

    Parameters
    ----------
    symbol_file : path to ``*-symbol.json`` (or a Symbol instance)
    param_file : path to ``.params``/``.npz`` (or a dict of NDArrays,
        keys optionally ``arg:``/``aux:``-prefixed)
    input_shapes : dict name -> shape of the initially bound signature
    dev_type, dev_id : the device (``"gpu"``, the card, by default; with no
        card that raises, ``"cpu"`` selects the CPU)
    """

    def __init__(self, symbol_file, param_file, input_shapes, dev_type="gpu",
                 dev_id=0):
        from . import context as ctx_mod
        from .ndarray.ndarray import _wrap

        self._ctx = ctx_mod.Context(dev_type, dev_id)
        device = self._ctx.device  # raises here with no card
        self._sym, args, auxs = load_checkpoint(symbol_file, param_file)
        # the one device copy: NDArrays already on the device are shared
        self._arg_store, self._aux_store = (
            {k: v if v._data.device == device else _wrap(v._data.to(device), self._ctx)
             for k, v in store.items()} for store in (args, auxs))
        self._input_shapes = {k: tuple(v) for k, v in input_shapes.items()}
        self._exe_cache = {}   # shape signature -> Executor (its plans ride along)
        self._outputs = None
        # device-memory ledger: the shared parameter store is accounted
        # ONCE here (executors share it by object, so their own bound-
        # array accounting is released in _executor_for); freed on
        # close() or GC, whichever first
        self._mem_cell = [sum(profiler.array_nbytes(nd)
                              for store in (self._arg_store, self._aux_store)
                              for nd in store.values())]
        profiler.track_memory("predictor.params", "params").alloc(self._mem_cell[0])
        self._mem_finalizer = _weakref.finalize(self, _release_predictor_memory,
                                                self._mem_cell)
        self._exe = self._executor_for(self._input_shapes)

    def close(self):
        """Release this predictor's share of the device-memory ledger (the
        tensors themselves are freed by GC as usual).  Idempotent; also
        runs at GC through ``weakref.finalize``."""
        self._mem_finalizer()

    @staticmethod
    def _sig(shapes):
        return tuple(sorted((k, tuple(v)) for k, v in shapes.items()))

    def _zeros(self, shape, dtype):
        from .ndarray.ndarray import _wrap

        return _wrap(torch.zeros(tuple(shape), dtype=as_torch_dtype(dtype),
                                 device=self._ctx.device), self._ctx)

    def _executor_for(self, shapes):
        """Executor bound for ``shapes``, from the cache when this
        signature was seen before.  A fresh bind allocates ONLY the input
        placeholders — parameters/aux states are the shared store tensors,
        so the device copy made at construction is the only one ever."""
        from .executor import Executor

        sig = self._sig(shapes)
        exe = self._exe_cache.get(sig)
        if exe is not None:
            return exe
        arg_shapes, _, aux_shapes = self._sym.infer_shape(**shapes)
        arg_dtypes, _, aux_dtypes = self._sym.infer_type(
            **{k: tuple(v) for k, v in shapes.items()})

        args = {}
        for name, shp, dt in zip(self._sym.list_arguments(), arg_shapes, arg_dtypes):
            if name in shapes:
                args[name] = self._zeros(shapes[name], dt or "float32")
                continue
            nd = self._arg_store.get(name)
            if nd is None:
                # parameter absent from the checkpoint: bind zeros, but
                # STORE them so later binds share the same tensor
                if shp is None:
                    raise ValueError(
                        f"predictor: cannot infer shape of unbound parameter {name!r}")
                nd = self._arg_store[name] = self._zeros(shp, dt or "float32")
                self._mem_account(nd)
            elif shp is not None and tuple(nd.shape) != tuple(shp):
                raise ValueError(
                    f"predictor: parameter {name!r} has shape {tuple(nd.shape)} but the "
                    f"graph needs {tuple(shp)} for inputs {dict(shapes)} — shape-dependent "
                    f"parameters cannot be shared across binds")
            args[name] = nd
        auxs = {}
        for name, shp, dt in zip(self._sym.list_auxiliary_states(), aux_shapes, aux_dtypes):
            nd = self._aux_store.get(name)
            if nd is None:
                nd = self._aux_store[name] = self._zeros(shp if shp is not None else (1,),
                                                         dt or "float32")
                self._mem_account(nd)
            auxs[name] = nd
        exe = Executor(self._sym, self._ctx, args=args, grad_req="null", aux_states=auxs)
        # compile-registry attribution: a plan built by a predictor bind
        # reports as the predictor's (the serving tier further overrides
        # through profiler.compile_site)
        exe._compile_site = "predictor.forward"
        # the executor's bound arrays ARE the shared store this predictor
        # already accounted: drop the executor's own ledger row
        exe._release_memory()
        self._exe_cache[sig] = exe
        return exe

    def _mem_account(self, nd):
        n = profiler.array_nbytes(nd)
        if n:
            self._mem_cell[0] += n
            profiler.track_memory("predictor.params", "params").alloc(n)

    def reshape(self, new_shapes):
        """Rebind for a new input-shape signature, sharing the parameter
        tensors (no device copy).  A signature seen before reuses its
        executor — and therefore its built plan — outright.  Returns
        ``self`` (the c_predict ``MXPredReshape`` contract)."""
        new_shapes = {k: tuple(v) for k, v in new_shapes.items()}
        unknown = set(new_shapes) - set(self._input_shapes)
        if unknown:
            raise KeyError(f"unknown input(s) {sorted(unknown)!r}; "
                           f"inputs are {sorted(self._input_shapes)}")
        shapes = dict(self._input_shapes)
        shapes.update(new_shapes)
        self._exe = self._executor_for(shapes)
        self._input_shapes = shapes
        self._outputs = None
        return self

    def is_warm(self, shapes=None):
        """True when the given (default: current) signature has a bound
        executor whose forward plan is already built — a ``forward`` there
        builds nothing.  The serving tier's bucket hit/miss accounting
        reads this."""
        shapes = dict(self._input_shapes) if shapes is None else \
            {k: tuple(v) for k, v in shapes.items()}
        exe = self._exe_cache.get(self._sig(shapes))
        return exe is not None and len(exe._fwd_cache) > 0

    def compile_stats(self):
        """{"executors": bound signatures, "fwd_entries": built forward
        plans across them} — diffed around a traffic run to prove zero
        post-warmup builds."""
        return {
            "executors": len(self._exe_cache),
            "fwd_entries": sum(len(e._fwd_cache) for e in self._exe_cache.values()),
        }

    # -- c_predict-style surface ----------------------------------------
    def set_input(self, name, value):
        """``MXPredSetInput``: ``value`` (numpy, tensor or NDArray) copied
        into the bound input, in its dtype, on its device."""
        from .executor import _tensor

        if name not in self._input_shapes:
            raise KeyError(f"unknown input {name!r}")
        arg = self._exe.arg_dict[name]
        t = _tensor(value, arg._data.device, arg._data.dtype)
        if tuple(t.shape) != tuple(arg._data.shape):
            t = t.broadcast_to(arg._data.shape).clone()
        arg._data = t
        arg._version += 1

    def forward(self):
        """``MXPredForward`` — runs the bound plan (is_train=False)."""
        self._outputs = self._exe.forward(is_train=False)
        return self

    def get_output(self, index=0):
        """``MXPredGetOutput`` — numpy copy of output ``index`` (bf16 as
        float32 of the same values)."""
        if self._outputs is None:
            raise RuntimeError("call forward() first")
        return self._outputs[index].asnumpy()

    def num_outputs(self):
        """How many outputs the bound graph produces (the serving tier
        sizes its per-output unpadding spec from this)."""
        return len(self._sym._outputs)

    def get_outputs(self):
        """Numpy copies of ALL outputs of the last ``forward()``."""
        if self._outputs is None:
            raise RuntimeError("call forward() first")
        return [o.asnumpy() for o in self._outputs]

    def predict(self, **inputs):
        """Convenience: set all inputs, forward, return output 0."""
        for k, v in inputs.items():
            self.set_input(k, v)
        return self.forward().get_output(0)
