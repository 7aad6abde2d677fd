"""Shape/type inference over a Symbol graph.

Counterpart of the JAX package's ``symbol/infer.py`` (parity target: the
nnvm InferShape/InferType passes, [U:3rdparty/tvm/nnvm/src/pass/infer_shape.cc],
[U:src/executor/infer_graph_attr_pass.cc]).  Per-op output shapes come from
running the SAME function that computes on ``meta`` tensors, which carry a
shape and a dtype and no data: there is no hand-maintained FInferShape
table, and a kernel wrapper given a meta tensor takes its plain version's
shape path (it has no data to launch on).  What does need hand rules is the
*backward* direction the reference gets from its bidirectional pass:
inferring parameter shapes (weight/bias/gamma/...) from the data shape plus
op attrs.  Those rules live in ``PARAM_SHAPE_RULES`` below, as in the JAX
package.
"""
from __future__ import annotations

import inspect

import numpy as _np
import torch

from ..base import as_torch_dtype, dtype_name
from ..ndarray.ndarray import _np_dtype
from ..ops.registry import get_op
from ..ops.rnn_ops import rnn_param_size as _rnn_param_size

__all__ = ["infer_shape", "infer_type", "PARAM_SHAPE_RULES"]

_META = torch.device("meta")


def _conv_weight(data_shape, attrs):
    num_filter = attrs.get("num_filter", 0)
    kernel = tuple(attrs.get("kernel", ()))
    groups = attrs.get("num_group", 1)
    cin = data_shape[1] // groups
    return (num_filter, cin) + kernel


def _deconv_weight(data_shape, attrs):
    num_filter = attrs.get("num_filter", 0)
    kernel = tuple(attrs.get("kernel", ()))
    groups = attrs.get("num_group", 1)
    return (data_shape[1], num_filter // groups) + kernel


def _fc_weight(data_shape, attrs):
    num_hidden = attrs.get("num_hidden", 0)
    if attrs.get("flatten", True):
        in_units = int(_np.prod(data_shape[1:]))
    else:
        in_units = data_shape[-1]
    return (num_hidden, in_units)


def _channel(data_shape, attrs):
    axis = attrs.get("axis", 1) % len(data_shape)
    return (data_shape[axis],)


def _last_dim(data_shape, attrs):
    axis = attrs.get("axis", -1) % len(data_shape)
    return (data_shape[axis],)


# op → {param_name: rule(data_shape, attrs) -> shape}
PARAM_SHAPE_RULES = {
    "FullyConnected": {
        "weight": _fc_weight,
        "bias": lambda d, a: (a.get("num_hidden", 0),),
    },
    "Convolution": {
        "weight": _conv_weight,
        "bias": lambda d, a: (a.get("num_filter", 0),),
    },
    "Deconvolution": {
        "weight": _deconv_weight,
        "bias": lambda d, a: (a.get("num_filter", 0),),
    },
    "BatchNorm": {
        "gamma": _channel, "beta": _channel,
        "moving_mean": _channel, "moving_var": _channel,
    },
    "LayerNorm": {"gamma": _last_dim, "beta": _last_dim},
    "RMSNorm": {"gamma": _last_dim},
    "InstanceNorm": {"gamma": _channel, "beta": _channel},
    "GroupNorm": {"gamma": _channel, "beta": _channel},
    "Embedding": {
        "weight": lambda d, a: (a.get("input_dim", 0), a.get("output_dim", 0)),
    },
    "RNN": {
        "parameters": lambda d, a: (_rnn_param_size(
            a.get("mode", "lstm"), d[2], a.get("state_size", 0),
            a.get("num_layers", 1), a.get("bidirectional", False)),),
        "state": lambda d, a: (
            int(a.get("num_layers", 1)) * (2 if a.get("bidirectional") else 1),
            d[1], int(a.get("state_size", 0))),
        "state_cell": lambda d, a: (
            int(a.get("num_layers", 1)) * (2 if a.get("bidirectional") else 1),
            d[1], int(a.get("state_size", 0))),
    },
    # loss heads: label shape from data shape (the bidirectional-inference
    # direction the reference's InferShape pass provides — lets predict-
    # style binds omit label shapes)
    "SoftmaxOutput": {
        "label": lambda d, a: ((d[0],) + d[2:]) if a.get("multi_output") else d[:-1],
    },
    "LinearRegressionOutput": {"label": lambda d, a: d},
    "MAERegressionOutput": {"label": lambda d, a: d},
    "LogisticRegressionOutput": {"label": lambda d, a: d},
}
PARAM_SHAPE_RULES["fully_connected"] = PARAM_SHAPE_RULES["FullyConnected"]
PARAM_SHAPE_RULES["Softmax"] = PARAM_SHAPE_RULES["SoftmaxOutput"]


def _clean_attrs(attrs):
    return {k: v for k, v in attrs.items() if not k.startswith("__")}


_CAST_WRAPPERS = ("amp_cast", "cast", "Cast")


def _behind_casts(src):
    """Deref a chain of shape-preserving cast wrappers to the underlying
    node (AMP-converted graphs interpose amp_cast between parameter
    variables and their consumers)."""
    while src.op in _CAST_WRAPPERS and src.inputs:
        src = src.inputs[0][0]
    return src


def takes_ctx(fn):
    """Whether an op function takes a ``ctx`` (ops that create a tensor
    from no input: ``_sym_zeros``, the samplers); the graph walkers give
    it theirs (``meta`` here, the executor's context there)."""
    try:
        return "ctx" in inspect.signature(fn).parameters
    except (TypeError, ValueError):
        return False


def takes_key(fn):
    """Whether an op function takes ``training`` and a generator ``key``
    (``Dropout``, ``RNN``, ``RNNFused``): the executor gives it its walk's
    mode and, in training, its context's generator."""
    try:
        params = inspect.signature(fn).parameters
    except (TypeError, ValueError):
        return False
    return "training" in params and "key" in params


def _meta(shape, dtype):
    return torch.empty(tuple(shape), dtype=as_torch_dtype(dtype), device=_META)


def _graph_infer(symbol, shape_hints, dtype_hints, allow_unknown=False):
    """Topo sweeps to fixpoint (cast wrappers over deferred-init variables
    need a second pass: the consumer's rule resolves the var, then the
    wrapper).  Returns (node → tuple of meta tensors, var_name → meta
    tensor)."""
    values = {}   # id(node) -> tuple of meta tensors
    varspec = {}  # var name -> meta tensor
    topo = symbol._topo()

    for node in topo:
        if node.op is None:
            shape = shape_hints.get(node.name, node.attrs.get("__shape__"))
            dtype = dtype_hints.get(node.name, node.attrs.get("__dtype__", "float32"))
            if shape is None:
                values[id(node)] = None  # unknown until a consumer rule fires
            else:
                spec = _meta(shape, dtype)
                values[id(node)] = (spec,)
                varspec[node.name] = spec

    progress = True
    while progress:
        progress = False
        for node in topo:
            if node.op is None or values.get(id(node)) is not None:
                continue

            rules = PARAM_SHAPE_RULES.get(node.op, {})
            input_names = node.attrs.get("__input_names__") or []
            data_spec = None
            if node.inputs:
                first = values.get(id(node.inputs[0][0]))
                if first is not None:
                    data_spec = first[node.inputs[0][1]]
            # derive unknown parameter-variable shapes from the data shape
            # (through any cast wrappers an AMP-converted graph inserted)
            for (src, idx), pname in zip(node.inputs, input_names):
                tgt = _behind_casts(src)
                if values.get(id(tgt)) is None and tgt.op is None:
                    rule = rules.get(pname)
                    if rule is not None and data_spec is not None:
                        shape = tuple(rule(tuple(data_spec.shape), node.attrs))
                        dtype = dtype_hints.get(
                            tgt.name,
                            tgt.attrs.get("__dtype__", dtype_name(data_spec.dtype)))
                        spec = _meta(shape, dtype)
                        values[id(tgt)] = (spec,)
                        varspec[tgt.name] = spec
                        progress = True

            in_specs = []
            missing = False
            for src, idx in node.inputs:
                v = values.get(id(src))
                if v is None:
                    missing = True
                    break
                in_specs.append(v[idx])
            if missing:
                continue  # maybe resolvable next sweep

            op = get_op(node.op)
            attrs = _clean_attrs(node.attrs)
            if "ctx" not in attrs and takes_ctx(op.fn):
                attrs["ctx"] = _META
            with torch.no_grad():
                out = op.fn(*in_specs, **attrs)
            values[id(node)] = (tuple(out) if isinstance(out, (list, tuple))
                                else (out,))
            progress = True

    if not allow_unknown:
        stuck = [n for n in topo
                 if n.op is not None and values.get(id(n)) is None]
        if stuck:
            # report a non-wrapper node (an amp_cast is not actionable —
            # its consumer and the underlying variable are), and name the
            # underlying VARIABLES behind any cast chain
            node = next((n for n in stuck if n.op not in _CAST_WRAPPERS),
                        stuck[0])
            unknown = sorted({_behind_casts(s).name
                              for s, _ in node.inputs
                              if values.get(id(s)) is None})
            raise ValueError(
                f"infer_shape: cannot infer inputs {unknown} of node "
                f"{node.name!r} (op {node.op}); provide their shapes")
    return values, varspec


def infer_shape(symbol, *args, allow_unknown=False, **kwargs):
    """Returns (arg_shapes, out_shapes, aux_shapes) in the order of
    ``list_arguments()`` / ``list_outputs()`` / ``list_auxiliary_states()``
    (parity: ``Symbol.infer_shape``)."""
    if args:
        names = symbol.list_arguments()
        for name, shape in zip(names, args):
            if shape is not None:
                kwargs.setdefault(name, shape)
    shape_hints = {k: tuple(v) for k, v in kwargs.items() if v is not None}
    dtype_hints = {k: "int32" for k in shape_hints
                   if k.endswith(("label", "idx", "indices", "token_ids"))}
    values, varspec = _graph_infer(symbol, shape_hints, dtype_hints,
                                   allow_unknown=allow_unknown)

    def var_shape(name):
        spec = varspec.get(name)
        return tuple(spec.shape) if spec is not None else None

    arg_shapes = [var_shape(n) for n in symbol.list_arguments()]
    aux_shapes = [var_shape(n) for n in symbol.list_auxiliary_states()]
    out_shapes = []
    for node, idx in symbol._outputs:
        v = values.get(id(node))
        out_shapes.append(tuple(v[idx].shape) if v is not None else None)
    return arg_shapes, out_shapes, aux_shapes


def _type_name(v):
    if isinstance(v, str):
        return v
    if isinstance(v, torch.dtype):
        return dtype_name(v)
    return str(_np.dtype(v))


def infer_type(symbol, **kwargs):
    """(arg_dtypes, out_dtypes, aux_dtypes) as numpy dtypes (bf16 by its
    name, which numpy lacks); needs shapes only when the graph has no
    variable shape annotations."""
    shape_hints, dtype_hints = {}, {}
    for k, v in kwargs.items():
        if v is None:
            continue
        if isinstance(v, (tuple, list)):
            shape_hints[k] = tuple(v)
        else:
            dtype_hints[k] = _type_name(v)
    for node in symbol._topo():
        if node.op is None and "__shape__" in node.attrs:
            shape_hints.setdefault(node.name, tuple(node.attrs["__shape__"]))
    values, varspec = _graph_infer(symbol, shape_hints, dtype_hints,
                                   allow_unknown=True)

    def var_dtype(name):
        spec = varspec.get(name)
        return _np_dtype(spec.dtype) if spec is not None else None

    arg_dtypes = [var_dtype(n) for n in symbol.list_arguments()]
    aux_dtypes = [var_dtype(n) for n in symbol.list_auxiliary_states()]
    out_dtypes = []
    for node, idx in symbol._outputs:
        v = values.get(id(node))
        out_dtypes.append(_np_dtype(v[idx].dtype) if v is not None else None)
    return arg_dtypes, out_dtypes, aux_dtypes
