"""``mx.sym``: the symbolic front end.

Counterpart of the JAX package's ``symbol/symbol.py`` (parity target:
[U:python/mxnet/symbol/symbol.py] over the nnvm graph IR).  A Symbol is a
small pure-Python DAG over the SAME op registry that ``mx.nd`` dispatches
to: there is no second operator implementation.  ``bind``/``simple_bind``
give an ``Executor`` that walks the graph over tensors, through the port's
ops and so through its kernels on the card.

Reference behaviors kept:
* auto-created parameter variables (``sym.FullyConnected(data, num_hidden=10,
  name='fc1')`` creates ``fc1_weight``/``fc1_bias``),
* ``list_arguments`` / ``list_auxiliary_states`` split by the
  moving-stat naming convention,
* ``infer_shape`` with partial inputs (param shapes derived from data
  shapes),
* JSON (de)serialization in the JAX package's format, byte for byte,
  ``__getitem__`` output selection, ``Group``.
"""
from __future__ import annotations

import functools
import inspect
import json
import threading

from ..ops.registry import get_op, list_ops
from .. import attribute as _attr_mod
from .. import name as _name_mod

__all__ = ["Symbol", "Variable", "var", "Group", "load", "load_json", "zeros", "ones"]

_tls = threading.local()


def _name_counters():
    if not hasattr(_tls, "sym_counters"):
        _tls.sym_counters = {}
    return _tls.sym_counters


def _auto_name(hint):
    c = _name_counters()
    idx = c.get(hint, 0)
    c[hint] = idx + 1
    return f"{hint}{idx}"


def _reset_naming():  # test helper
    _tls.sym_counters = {}


def _dunder(k):
    """Normalize a user-attr key to single-dunder storage form.  Accepts
    both bare keys ('ctx_group') and reference-style pre-wrapped keys
    ('__ctx_group__') without double-wrapping."""
    if k.startswith("__") and k.endswith("__") and len(k) > 4:
        return k
    return f"__{k}__"


# Aux-state naming convention (parity: BatchNorm's auxiliary moving stats
# are not trainable arguments — [U:src/operator/nn/batch_norm.cc]).
AUX_SUFFIXES = ("moving_mean", "moving_var", "running_mean", "running_var")


def is_aux_name(name: str) -> bool:
    return name.endswith(AUX_SUFFIXES)


# Ops whose trailing tensor params are optional-but-autocreated unless a
# flag disables them.
_OPTIONAL_TENSOR = {
    "FullyConnected": {"bias": "no_bias"},
    "fully_connected": {"bias": "no_bias"},
    "Convolution": {"bias": "no_bias"},
    "Deconvolution": {"bias": "no_bias"},
    # flag None: optional tensor with no gate attr — simply omitted from the
    # node when the caller doesn't pass it (the op fn's own default applies,
    # e.g. RNN synthesizes zero initial states)
    "RNN": {"state": None, "state_cell": None},
}

# Ops whose SYMBOL carries multiple outputs (attrs -> count): the node's
# fn returns a tuple and each element is addressable as sym[i] / by the
# executor (MXNet's sym.split contract).  Ops not listed keep the default
# single primary output even when the fn returns a tuple (e.g. BatchNorm's
# (out, mean, var) — the extra entries are layer-internal).
def _truthy(v):
    """One acceptance set for stringly-typed boolean attrs (symbol JSON
    round-trips stringify them)."""
    return v in (True, 1, "1", "True", "true")


def _split_v2_outputs(a):
    spec = a.get("indices_or_sections", 1)
    return int(spec) if isinstance(spec, int) else len(tuple(spec)) + 1


_MULTI_OUTPUT = {
    "split": lambda a: int(a.get("num_outputs", 1)),
    "SliceChannel": lambda a: int(a.get("num_outputs", 1)),
    "split_v2": _split_v2_outputs,
    "RNN": lambda a: ((3 if a.get("mode", "lstm") == "lstm" else 2)
                      if _truthy(a.get("state_outputs")) else 1),
}

# Explicit tensor-input lists for ops where signature inspection is not
# enough.  Everything else: parameters without a default are tensor inputs
# — unless the caller passed them as non-Symbol kwargs (static attrs), see
# ``_apply_op``.
_TENSOR_PARAMS = {
    "BatchNorm": ("data", "gamma", "beta", "moving_mean", "moving_var"),
    "Dropout": ("data",),
    # shape/axis/reps/... are required static attrs, never tensor inputs
    "Reshape": ("data",),
    "reshape": ("data",),
    "expand_dims": ("data",),
    "tile": ("data",),
    "broadcast_to": ("data",),
    "slice_axis": ("data",),
    "slice": ("data",),
    "transpose": ("data",),
    "repeat": ("data",),
    "flip": ("data",),
    # num_outputs/depth are required static attrs, never tensor inputs
    "split": ("x",),
    "SliceChannel": ("x",),
    "one_hot": ("indices",),
}


# Ops whose function is a torch builtin (``torch.tanh`` and the like) have
# no inspectable signature; the JAX package's functions for the same names
# take one tensor ``x`` — except ``negative``, whose JAX function is
# variadic — so the same graph records the same ``__input_names__``.
_BUILTIN_VARIADIC = frozenset({"negative"})


def _signature(fn):
    """``inspect.signature(fn)``, or None for a builtin without one."""
    try:
        return inspect.signature(fn)
    except (TypeError, ValueError):
        return None


@functools.lru_cache(maxsize=None)
def _flag_default(fn, flag):
    """Default value of an optional-tensor gate flag (e.g. no_bias) from
    the op's own signature (cached: graph-construction hot path)."""
    sig = _signature(fn)
    p = sig.parameters.get(flag) if sig is not None else None
    return bool(p.default) if p is not None and p.default is not inspect.Parameter.empty else False


def _tensor_params(opname, fn):
    """Tensor-input parameter names, or None for variadic ops (``*args``
    like concat/add_n/stack, which take any number of tensor inputs)."""
    if opname in _TENSOR_PARAMS:
        return list(_TENSOR_PARAMS[opname])
    sig = _signature(fn)
    if sig is None:
        return None if opname in _BUILTIN_VARIADIC else ["x"]
    names = []
    for p in sig.parameters.values():
        if p.kind == p.VAR_POSITIONAL:
            return None  # variadic
        if p.kind == p.VAR_KEYWORD:
            break
        if p.default is inspect.Parameter.empty:
            names.append(p.name)
        else:
            break
    extra = _OPTIONAL_TENSOR.get(opname)
    if extra:
        names.extend(extra)
    return names


class _Node:
    """One graph node: a Variable (op is None) or an op application."""

    __slots__ = ("op", "name", "inputs", "attrs")

    def __init__(self, op, name, inputs=(), attrs=None):
        self.op = op                  # registry op name, or None for Variable
        self.name = name
        self.inputs = list(inputs)    # list of (_Node, out_index)
        self.attrs = dict(attrs or {})  # static (non-tensor) op kwargs


class Symbol:
    """A handle to one or more graph outputs."""

    __slots__ = ("_outputs",)

    def __init__(self, outputs):
        self._outputs = list(outputs)  # list of (_Node, int)

    # -- introspection --------------------------------------------------
    @property
    def name(self):
        if len(self._outputs) == 1:
            return self._outputs[0][0].name
        return None

    def _topo(self):
        seen, order = set(), []

        def visit(node):
            if id(node) in seen:
                return
            seen.add(id(node))
            for n, _ in node.inputs:
                visit(n)
            order.append(node)

        for n, _ in self._outputs:
            visit(n)
        return order

    def list_arguments(self):
        return [n.name for n in self._topo()
                if n.op is None and not is_aux_name(n.name)]

    def list_auxiliary_states(self):
        return [n.name for n in self._topo()
                if n.op is None and is_aux_name(n.name)]

    def list_outputs(self):
        out = []
        for node, idx in self._outputs:
            if node.op is None:
                out.append(node.name)
            else:
                out.append(f"{node.name}_output" if idx == 0 else f"{node.name}_output{idx}")
        return out

    def list_inputs(self):
        return [n.name for n in self._topo() if n.op is None]

    def attr(self, key):
        """This symbol's attribute ``key`` (set via ``AttrScope``, the
        ``attr=`` kwarg of Variable, or lr_mult/wd_mult), or None.
        Parity: ``Symbol.attr`` ([U:python/mxnet/symbol/symbol.py])."""
        k = _dunder(key)
        if k in _TYPED_DUNDER:
            return None
        return self._outputs[0][0].attrs.get(k)

    def attr_dict(self):
        """``{node_name: {key: value}}`` over every node that carries
        user-level attributes (dunder-stored, string-valued; static op
        kwargs and internal typed attrs excluded).
        Parity: ``Symbol.attr_dict``."""
        out = {}
        for node in self._topo():
            d = {k[2:-2]: v for k, v in node.attrs.items()
                 if k.startswith("__") and k.endswith("__")
                 and k not in _TYPED_DUNDER}
            if d:
                out[node.name] = d
        return out

    def get_internals(self):
        """Symbol over every node's primary output (parity:
        ``Symbol.get_internals`` — used to tap intermediate features)."""
        return Symbol([(n, 0) for n in self._topo()])

    def __getitem__(self, idx):
        if isinstance(idx, str):
            names = self.list_outputs()
            idx = names.index(idx)
        return Symbol([self._outputs[idx]])

    def __len__(self):
        return len(self._outputs)

    def __iter__(self):
        return (Symbol([o]) for o in self._outputs)

    def __repr__(self):
        names = ", ".join(self.list_outputs())
        return f"<Symbol {names}>"

    # -- arithmetic sugar ------------------------------------------------
    def __add__(self, other):
        return _binary("broadcast_add", "_plus_scalar", self, other)

    def __radd__(self, other):
        return _binary("broadcast_add", "_plus_scalar", self, other)

    def __sub__(self, other):
        return _binary("broadcast_sub", "_minus_scalar", self, other)

    def __rsub__(self, other):
        return _binary("broadcast_sub", "_rminus_scalar", self, other, swap=True)

    def __mul__(self, other):
        return _binary("broadcast_mul", "_mul_scalar", self, other)

    def __rmul__(self, other):
        return _binary("broadcast_mul", "_mul_scalar", self, other)

    def __truediv__(self, other):
        return _binary("broadcast_div", "_div_scalar", self, other)

    def __rtruediv__(self, other):
        return _binary("broadcast_div", "_rdiv_scalar", self, other, swap=True)

    def __pow__(self, other):
        return _binary("broadcast_power", "_power_scalar", self, other)

    def __mod__(self, other):
        return _binary("broadcast_mod", "_mod_scalar", self, other)

    def __rmod__(self, other):
        return _binary("broadcast_mod", "_rmod_scalar", self, other, swap=True)

    # comparisons build graph nodes returning the reference's 1.0/0.0
    # float masks (NOT Python bools); non-numeric operands defer to
    # Python's protocol (`sym == None` stays False, not a graph node)
    @staticmethod
    def _comparable(other):
        import numbers

        return isinstance(other, (Symbol, numbers.Number))

    def __eq__(self, other):
        if not self._comparable(other):
            return NotImplemented
        return _binary("broadcast_equal", "_equal_scalar", self, other)

    def __ne__(self, other):
        if not self._comparable(other):
            return NotImplemented
        return _binary("broadcast_not_equal", "_not_equal_scalar", self, other)

    def __gt__(self, other):
        if not self._comparable(other):
            return NotImplemented
        return _binary("broadcast_greater", "_greater_scalar", self, other)

    def __ge__(self, other):
        if not self._comparable(other):
            return NotImplemented
        return _binary("broadcast_greater_equal", "_greater_equal_scalar",
                       self, other)

    def __lt__(self, other):
        if not self._comparable(other):
            return NotImplemented
        return _binary("broadcast_lesser", "_lesser_scalar", self, other)

    def __le__(self, other):
        if not self._comparable(other):
            return NotImplemented
        return _binary("broadcast_lesser_equal", "_lesser_equal_scalar",
                       self, other)

    __hash__ = object.__hash__  # __eq__ is symbolic; keep identity hashing

    def __bool__(self):
        # numpy-style: a graph node has no truth value — this also stops
        # `a in [b]` from silently matching via a truthy __eq__ Symbol
        # (parity: the reference raises NotImplementedForSymbol here)
        raise TypeError(
            "Symbol has no boolean value; comparisons build graph nodes. "
            "Use `is`/`is not` for identity, or evaluate the comparison.")

    def __neg__(self):
        return self * -1.0

    # -- graph ops -------------------------------------------------------
    def infer_shape(self, *args, **kwargs):
        from .infer import infer_shape
        return infer_shape(self, *args, **kwargs)

    def infer_shape_partial(self, *args, **kwargs):
        from .infer import infer_shape
        return infer_shape(self, *args, allow_unknown=True, **kwargs)

    def infer_type(self, **kwargs):
        from .infer import infer_type
        return infer_type(self, **kwargs)

    def eval(self, ctx=None, **kwargs):
        """Eager evaluation with NDArray bindings (parity: ``Symbol.eval``)."""
        from ..executor import Executor
        ex = Executor(self, ctx, args=kwargs, grad_req="null")
        return ex.forward(is_train=False)

    def bind(self, ctx=None, args=None, args_grad=None, grad_req="write",
             aux_states=None, **kwargs):
        from ..executor import Executor
        return Executor(self, ctx, args=args or {}, args_grad=args_grad,
                        grad_req=grad_req, aux_states=aux_states)

    def simple_bind(self, ctx=None, grad_req="write", type_dict=None, **shapes):
        from ..executor import Executor
        return Executor.simple_bind(self, ctx, grad_req=grad_req,
                                    type_dict=type_dict, **shapes)

    # -- serialization ---------------------------------------------------
    def tojson(self, remove_amp_cast=True):
        sym = self
        if remove_amp_cast:
            # the reference contract: checkpoint symbols are cast-free —
            # bypass amp_cast nodes (rewire consumers to their input)
            def deref(entry):
                src, idx = entry
                while src.op == "amp_cast" and src.inputs:
                    src, idx = src.inputs[0]
                return (src, idx)

            mapping = {}
            for n in self._topo():
                if n.op == "amp_cast":
                    continue
                if n.op is None:
                    mapping[id(n)] = n
                    continue
                new_in = []
                for e in n.inputs:
                    src, idx = deref(e)
                    new_in.append((mapping.get(id(src), src), idx))
                mapping[id(n)] = _Node(n.op, n.name, new_in, dict(n.attrs))
            outs = []
            for e in self._outputs:
                src, idx = deref(e)
                outs.append((mapping.get(id(src), src), idx))
            sym = Symbol(outs)
        nodes = sym._topo()
        nid = {id(n): i for i, n in enumerate(nodes)}
        payload = {
            "nodes": [
                {
                    "op": n.op or "null",
                    "name": n.name,
                    "attrs": {k: _attr_str(v) for k, v in n.attrs.items()},
                    "inputs": [[nid[id(src)], idx] for src, idx in n.inputs],
                }
                for n in nodes
            ],
            "arg_nodes": [i for i, n in enumerate(nodes) if n.op is None],
            "heads": [[nid[id(n)], idx] for n, idx in sym._outputs],
            "attrs": {"mxnet_version": ["int", 10700], "format": _FORMAT},
        }
        return json.dumps(payload, indent=2)

    def save(self, fname):
        with open(fname, "w") as f:
            f.write(self.tojson())

    # -- composition ------------------------------------------------------
    def __call__(self, **kwargs):
        """Compose: replace free variables by other symbols (parity:
        ``Symbol.__call__``)."""
        mapping = {}
        for node in self._topo():
            if node.op is None and node.name in kwargs:
                repl = kwargs[node.name]
                mapping[id(node)] = repl._outputs[0]
        if not mapping:
            return self
        memo = {}

        def clone_entry(entry):
            src, idx = entry
            if id(src) in mapping:
                return mapping[id(src)]
            if id(src) in memo:
                return (memo[id(src)], idx)
            new_inputs = [clone_entry(e) for e in src.inputs]
            new = _Node(src.op, src.name, new_inputs, src.attrs)
            memo[id(src)] = new
            return (new, idx)

        return Symbol([clone_entry(e) for e in self._outputs])


# The format tag of the JSON: the JAX package's package name, so a file
# written by either package is the same bytes and loads in the other.
_FORMAT = "incubator_mxnet_" + "tpu"


def _attr_str(v):
    if isinstance(v, (list, tuple)):
        return json.dumps(list(v))
    return json.dumps(v) if not isinstance(v, str) else v


def _parse_attr(s):
    if not isinstance(s, str):
        return s
    try:
        return json.loads(s)
    except (ValueError, TypeError):
        return s


# Internal dunder attrs (graph metadata, hidden from attr()/attr_dict()).
# Only _PARSED_DUNDER carry typed values re-parsed on load; __dtype__/
# __init__ stay strings (an __init__ attr may itself be JSON — the
# Initializer.dumps() format — and must round-trip verbatim).  Every OTHER
# dunder key is a user-level attribute (AttrScope / Variable ``attr=``/
# ``lr_mult=``), string-typed by contract — left verbatim so e.g.
# lr_mult="0.1" round-trips as the string it was set to.
_TYPED_DUNDER = ("__input_names__", "__shape__", "__dtype__", "__init__")
_PARSED_DUNDER = ("__input_names__", "__shape__")


def _parse_loaded_attr(k, v):
    if k.startswith("__") and k.endswith("__") and k not in _PARSED_DUNDER:
        return v
    return _parse_attr(v)


def _binary(broadcast_op, scalar_op, lhs, rhs, swap=False):
    if isinstance(rhs, Symbol):
        return _apply_op(broadcast_op, (lhs, rhs), {})
    attrs = {"scalar": float(rhs)}
    return _apply_op(scalar_op, (lhs,), attrs)


def Variable(name, attr=None, shape=None, lr_mult=None, wd_mult=None,
             dtype=None, init=None, stype=None, **kwargs):
    """Create a symbolic variable (parity: ``mx.sym.Variable``)."""
    attrs = {}
    if shape is not None:
        attrs["__shape__"] = tuple(shape)
    if dtype is not None:
        attrs["__dtype__"] = str(dtype)
    if init is not None:
        # the init consumer (initializer.Initializer.__call__) parses the
        # attr as Initializer.dumps() JSON — store that form
        attrs["__init__"] = init if isinstance(init, str) else init.dumps()
    if lr_mult is not None:
        attrs["__lr_mult__"] = str(lr_mult)
    if wd_mult is not None:
        attrs["__wd_mult__"] = str(wd_mult)
    if stype is not None:
        attrs["__stype__"] = str(stype)
    # reference contract: extra kwargs must be dunder-named attributes
    # (``sym.Variable('w', __ctx_group__='dev1')``); anything else raises
    # rather than being silently dropped
    for k, v in kwargs.items():
        if not (k.startswith("__") and k.endswith("__")):
            raise ValueError(
                f"Variable: unknown kwarg {k!r} — attribute kwargs must be "
                "dunder-named (e.g. __ctx_group__), or use attr={...}")
        if attr and k in attr:
            continue
        attr = dict(attr or {})
        attr[k] = v
    if attr:
        for k, v in attr.items():
            _attr_mod._check_key(k, "Variable attr")
            if not isinstance(v, str):
                raise ValueError(
                    "Variable attr values must be strings (same contract "
                    f"as AttrScope); got {type(v).__name__} for {k!r}")
            attrs[_dunder(k)] = v
    for k, v in _attr_mod.current().get().items():
        attrs.setdefault(_dunder(k), v)
    return Symbol([(_Node(None, name, attrs=attrs), 0)])


var = Variable


def Group(symbols):
    outs = []
    for s in symbols:
        outs.extend(s._outputs)
    return Symbol(outs)


def zeros(shape, dtype="float32", name=None, **kwargs):
    return _apply_op("_sym_zeros", (), {"shape": tuple(shape) if not isinstance(shape, int) else (shape,), "dtype": dtype}, name=name, hint="_zeros")


def ones(shape, dtype="float32", name=None, **kwargs):
    return _apply_op("_sym_ones", (), {"shape": tuple(shape) if not isinstance(shape, int) else (shape,), "dtype": dtype}, name=name, hint="_ones")


def _apply_op(opname, args, kwargs, name=None, hint=None):
    """Build an op node: positional/keyword Symbols are tensor inputs,
    everything else static attrs; missing tensor params are auto-created as
    Variables named ``<node>_<param>``."""
    op = get_op(opname)
    tnames = _tensor_params(opname, op.fn)
    name = _name_mod.current().get(name, hint or opname.lower().lstrip("_"))
    scope_attrs = _attr_mod.current().get()

    if tnames is None:  # variadic op: all positional Symbols are inputs
        inputs, input_names = [], []
        for i, a in enumerate(args):
            if not isinstance(a, Symbol):
                raise TypeError(f"{opname}: positional arg {i} must be a Symbol, got {type(a)}")
            entry = a._outputs
            if len(entry) != 1:
                raise ValueError(f"{opname}: input {i} must be a single-output symbol")
            inputs.append(entry[0])
            input_names.append(f"arg{i}")
        attrs = {k: v for k, v in kwargs.items() if not isinstance(v, Symbol)}
        node = _Node(opname, name, inputs, attrs)
        node.attrs["__input_names__"] = input_names
        for k, v in scope_attrs.items():
            node.attrs.setdefault(_dunder(k), v)
        return Symbol([(node, 0)])

    provided = {}
    for i, a in enumerate(args):
        if isinstance(a, Symbol):
            if i >= len(tnames):
                raise ValueError(f"{opname}: too many tensor inputs")
            provided[tnames[i]] = a
        else:
            raise TypeError(f"{opname}: positional arg {i} must be a Symbol, got {type(a)}")
    attrs = {}
    for k, v in kwargs.items():
        if isinstance(v, Symbol):
            provided[k] = v
        else:
            attrs[k] = v

    inputs, input_names = [], []
    optional = _OPTIONAL_TENSOR.get(opname, {})
    skipped_optional = None
    for t in tnames:
        if t in attrs:
            # supplied as a non-Symbol kwarg → it is a static attr
            # (e.g. reshape(data, shape=(4, 2))), not a tensor input;
            # do NOT auto-create a phantom variable for it.
            continue
        if t in provided:
            if skipped_optional is not None:
                # the executor passes inputs positionally: providing a
                # tensor AFTER an omitted flagless-optional one would bind
                # it to the wrong parameter (e.g. RNN state_cell→state)
                raise ValueError(
                    f"{opname}: {t} provided but earlier optional input "
                    f"{skipped_optional!r} omitted; pass both or neither")
            entry = provided[t]._outputs
            if len(entry) != 1:
                raise ValueError(f"{opname}: input {t} must be a single-output symbol")
            inputs.append(entry[0])
            input_names.append(t)
        else:
            if t in optional:
                flag = optional[t]
                if flag is None:
                    # flagless optional tensor: omitted when not provided
                    skipped_optional = t
                    continue
                if attrs.get(flag, _flag_default(op.fn, flag)):
                    # e.g. no_bias=True — including by the OP'S OWN default
                    # (Deconvolution defaults no_bias=true in the reference,
                    # Convolution false; the signature is the source of truth)
                    continue
            # missing inputs auto-create variables, incl. the MXNet idiom
            # sym.SoftmaxOutput(data, name='softmax') → 'softmax_label';
            # they inherit the active AttrScope (the reference's main use
            # case: per-parameter lr_mult/ctx_group on auto-created weights)
            auto_attrs = {_dunder(k): v for k, v in scope_attrs.items()}
            inputs.append((_Node(None, f"{name}_{t}", attrs=auto_attrs), 0))
            input_names.append(t)

    # pass skipped-optional info through attrs so the executor calls the op
    # with the right arity
    node = _Node(opname, name, inputs, attrs)
    node.attrs["__input_names__"] = input_names
    for k, v in scope_attrs.items():
        node.attrs.setdefault(_dunder(k), v)
    n_out = _MULTI_OUTPUT.get(opname, lambda a: 1)(attrs)
    return Symbol([(node, i) for i in range(n_out)])


def _make_sym_op(opname):
    def sym_op(*args, name=None, **kwargs):
        return _apply_op(opname, args, kwargs, name=name)

    sym_op.__name__ = opname
    sym_op.__qualname__ = f"sym.{opname}"
    op = get_op(opname)
    sym_op.__doc__ = op.fn.__doc__
    return sym_op


# Fluent methods (parity: the reference Symbol's op-backed methods —
# `sym.reshape(...)`, `sym.sum(axis=1)`, ... mirror NDArray's so ported
# scripts keep their chained style).  Bound lazily AFTER the op registry
# is populated; existing class attributes are never overridden.
_FLUENT_METHODS = (
    "reshape", "reshape_like", "flatten", "squeeze", "expand_dims", "tile",
    "pad", "repeat", "flip", "transpose", "swapaxes", "broadcast_to",
    "broadcast_like", "split", "slice", "slice_axis", "slice_like", "take",
    "pick", "one_hot", "sum", "mean", "max", "min", "prod", "nansum",
    "nanprod", "argmax", "argmin", "norm", "clip", "abs", "exp", "log",
    "sqrt", "square", "sign", "round", "floor", "ceil", "sigmoid", "tanh",
    "relu", "softmax", "log_softmax", "sort", "argsort", "topk", "diag",
    "zeros_like", "ones_like",
)


def _make_fluent(opname):
    fn = get_op(opname).fn
    tps = _tensor_params(opname, fn) or ()
    # non-tensor params: everything after the tensor-input slots in
    # signature order (BY POSITION — the _TENSOR_PARAMS table's names are
    # descriptive, not guaranteed to match the fn's parameter spelling).
    # These are the targets for positional attrs, so reference chained
    # forms like sym.reshape((0, -1)) / sym.split(3) work exactly like
    # their NDArray twins.
    sig = _signature(fn)
    _named = ([p.name for p in sig.parameters.values()
               if p.kind not in (p.VAR_POSITIONAL, p.VAR_KEYWORD)]
              if sig is not None else list(tps))
    attr_names = _named[len(tps):]

    # ops whose first attr is a tuple the reference lets callers splat:
    # x.reshape(0, -1), x.transpose(1, 0), x.tile(2, 3) (NDArray.reshape
    # accepts the same splat)
    splat = opname in ("reshape", "transpose", "tile", "broadcast_to")

    def method(self, *args, name=None, **kwargs):
        sym_args = [self]
        rest = list(args)
        while rest and isinstance(rest[0], Symbol):
            sym_args.append(rest.pop(0))
        if (splat and rest and attr_names
                and all(isinstance(v, int) for v in rest)
                and attr_names[0] not in kwargs):
            rest = [tuple(rest)]
        for i, v in enumerate(rest):
            if i >= len(attr_names):
                raise TypeError(f"{opname}: too many positional arguments")
            if attr_names[i] in kwargs:
                raise TypeError(
                    f"{opname}: got multiple values for {attr_names[i]!r}")
            kwargs[attr_names[i]] = v
        return _apply_op(opname, tuple(sym_args), kwargs, name=name)

    method.__name__ = opname
    method.__qualname__ = f"Symbol.{opname}"
    method.__doc__ = f"Fluent form of ``sym.{opname}`` applied to this symbol."
    return method


def _bind_fluent_methods():
    from ..ops.registry import list_ops

    ops = set(list_ops())
    for n in _FLUENT_METHODS:
        if n in ops and not hasattr(Symbol, n):
            setattr(Symbol, n, _make_fluent(n))
    if not hasattr(Symbol, "astype"):
        def astype(self, dtype, name=None):
            return _apply_op("cast", (self,), {"dtype": dtype}, name=name)
        Symbol.astype = astype


# Ops of the JAX package's registry that the port has not ported yet, by
# the JAX file that defines them and the ROADMAP §1 item whose queue they
# wait in: ``mx.sym.<name>`` raises and names the queue.
_QUEUED_OPS = {
    ("ops/moe.py", 8): ("moe_ffn",),
}
_QUEUE_OF = {n: key for key, names in _QUEUED_OPS.items() for n in names}


def _missing_op(name, where="mx.sym"):
    """The AttributeError for an op name the port's registry lacks."""
    queued = _QUEUE_OF.get(name)
    if queued is None:
        return AttributeError(f"{where} has no op {name!r}")
    jax_file, item = queued
    return AttributeError(
        f"{where}.{name} is not ported yet: the JAX package's {jax_file} waits in "
        f"ROADMAP §1 item {item}")


def load_json(json_str):
    payload = json.loads(json_str)
    nodes = []
    for spec in payload["nodes"]:
        attrs = {k: _parse_loaded_attr(k, v) for k, v in spec.get("attrs", {}).items()}
        op = spec["op"]
        node = _Node(None if op == "null" else op, spec["name"], attrs=attrs)
        nodes.append((node, spec.get("inputs", [])))
    for node, inputs in nodes:
        node.inputs = [(nodes[nid][0], idx) for nid, idx in inputs]
    heads = payload["heads"]
    return Symbol([(nodes[nid][0], idx) for nid, idx in heads])


def load(fname):
    with open(fname) as f:
        return load_json(f.read())
