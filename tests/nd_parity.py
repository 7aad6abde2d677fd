"""The harness of the ``mx.nd`` op-table parity tests (not a test file).

A case of ``nd_op_cases`` runs through the JAX package's ``mx.nd`` and the
port's, on the CPU, from the same numpy inputs; values, output dtypes and
(for ops registered ``differentiable``) input gradients are compared.
Bounds: exact for the cases the table marks ``exact`` (ops that only move,
select, compare or index); otherwise 1e-5 relative to the case's largest
|value| in fp32 (the two packages sum and round in other orders), and one
bfloat16 unit (2^-8) for bf16 cases, two (2^-7) for their gradients.  A
gradient is held to 1e-5 too.  Recording runs with ``train_mode=False``
(Dropout is the identity on both sides).
"""
import numpy as np

import incubator_mxnet_tpu as mxj
from incubator_mxnet_tpu.ops import registry as jreg
from incubator_mxnet_tpu.ops import tensor as jtensor
import incubator_mxnet_torch as mx

import nd_op_cases

REL = 1e-5
BF16_REL = 2.0 ** -8

_MODULES = {"tensor": "incubator_mxnet_tpu.ops.tensor", "nn": "incubator_mxnet_tpu.ops.nn",
            "random_ops": "incubator_mxnet_tpu.ops.random_ops",
            "spatial": "incubator_mxnet_tpu.ops.spatial",
            "linalg": "incubator_mxnet_tpu.ops.linalg",
            "quantization": "incubator_mxnet_tpu.ops.quantization",
            "interleaved": "incubator_mxnet_tpu.ops.attention"}


def jax_names(src):
    """Every name the JAX package registers from ``ops/<src>.py`` (the
    unary table's ``jax.numpy`` functions included; for ``interleaved``
    the ``_contrib_interleaved_*`` ops of ``ops/attention.py``)."""
    names = {n for n in jreg.list_ops()
             if getattr(jreg.get_op(n).fn, "__module__", None) == _MODULES[src]}
    if src == "tensor":
        names |= set(jtensor._UNARY)
    if src == "interleaved":
        names = {n for n in names if n.startswith("_contrib_interleaved_")}
    return names


ALL_CASES = nd_op_cases.CASES + nd_op_cases.LIBRARY_CASES


def cases(src):
    return [c for c in ALL_CASES if c.src == src]


def ids(cs):
    return [c.id for c in cs]


def _arrays(case):
    """The positional arrays, then the array keyword arguments."""
    r = nd_op_cases.rng_for(case.id)
    arrays = case.inputs(r)
    return arrays + [v.maker(r) for v in case.kwargs.values() if isinstance(v, nd_op_cases.A)]


def _call(pkg, case, xs):
    names = [k for k, v in case.kwargs.items() if isinstance(v, nd_op_cases.A)]
    npos = len(xs) - len(names)
    kw = dict(case.kwargs, **dict(zip(names, xs[npos:])))
    return _as_list(getattr(pkg.nd, case.op)(*xs[:npos], **kw))


def _make(pkg, arrays, case):
    out = []
    for i, a in enumerate(arrays):
        dt = case.dtypes[i] if case.dtypes else None
        x = pkg.nd.array(a, dtype=a.dtype) if dt is None else pkg.nd.array(a).astype(dt)
        out.append(x)
    return out


def _as_list(out):
    return list(out) if isinstance(out, (list, tuple)) else [out]


def _name(x):
    """MXNet's dtype name of an output of either package."""
    from incubator_mxnet_torch.base import dtype_name

    dt = x.dtype
    return dtype_name(dt) if not hasattr(dt, "name") else dt.name


def _np(x):
    if hasattr(x, "asnumpy"):
        a = x.asnumpy()
    else:  # a tensor: an op given no array argument returns one
        a = x.detach().float().numpy() if str(x.dtype) == "torch.bfloat16" else x.numpy()
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def run_port(case, arrays=None):
    arrays = _arrays(case) if arrays is None else arrays
    with mx.cpu():
        return _call(mx, case, _make(mx, arrays, case))


def run_jax(case, arrays=None):
    arrays = _arrays(case) if arrays is None else arrays
    return _call(mxj, case, _make(mxj, arrays, case))


def _bound(ref, rel):
    finite = np.abs(ref[np.isfinite(ref)]) if ref.size else np.zeros(1)
    return rel * max(float(finite.max()) if finite.size else 0.0, 1e-30)


def assert_close(got, ref, case, rel=None):
    if rel is None:
        rel = BF16_REL if case.dtypes and "bfloat16" in case.dtypes else REL
    assert got.shape == ref.shape, (got.shape, ref.shape)
    if case.card == "exact" and not (case.dtypes and "bfloat16" in case.dtypes):
        np.testing.assert_array_equal(got, ref)
        return
    np.testing.assert_allclose(got.astype(np.float64), ref.astype(np.float64), rtol=rel,
                               atol=_bound(ref.astype(np.float64), rel))


def check_values(case):
    arrays = _arrays(case)
    got, ref = run_port(case, arrays), run_jax(case, arrays)
    assert len(got) == len(ref)
    if arrays:
        assert all(isinstance(g, mx.nd.NDArray) and g.context == mx.cpu() for g in got)
    for g, r in zip(got, ref):
        assert _name(g) == _name(r), (case.id, _name(g), _name(r))
        if case.card != "decomp":
            assert_close(_np(g), _np(r), case)
    if case.card == "decomp":  # reconstruction, and up to sign where it is free
        as64 = lambda outs: [_np(o).astype(np.float64) for o in outs]  # noqa: E731
        ratio = nd_op_cases.decomp_ratio(case, arrays, as64(got), as64(ref),
                                         REL / np.finfo(np.float32).eps)
        assert ratio <= 1.0, (case.id, ratio)


def grad_inputs(case, arrays):
    skip = nd_op_cases.NO_GRAD_INPUTS.get(case.op, ())
    return [i for i, a in enumerate(arrays)
            if i not in skip and (a.dtype.kind == "f")]


def has_grad(case):
    """Differentiable in the JAX registry, with a float input to attach a
    gradient to and a float output."""
    if not jreg.get_op(case.op).differentiable:
        return False
    arrays = _arrays(case)
    if not grad_inputs(case, arrays):
        return False
    return any(np.asarray(_np(o)).dtype.kind == "f" for o in run_port(case, arrays))


def _grads(pkg, case, arrays):
    if pkg is mx:
        with mx.cpu():
            return _grads_on(pkg, case, arrays)
    return _grads_on(pkg, case, arrays)


def _grads_on(pkg, case, arrays):
    xs = _make(pkg, arrays, case)
    idx = grad_inputs(case, arrays)
    for i in idx:
        xs[i].attach_grad()
    with pkg.autograd.record(train_mode=False):
        outs = [o for o in _call(pkg, case, xs) if _np(o).dtype.kind == "f"]
    r = np.random.RandomState(1)
    heads = [pkg.nd.array(np.asarray(r.randn(*o.shape), np.float32)).astype(_name(o))
             for o in outs]
    try:
        pkg.autograd.backward(outs, heads)
    except Exception as exc:  # no output is on the graph: every gradient is zero
        if pkg is mx and not any(o._data.requires_grad for o in outs):
            return [np.zeros(arrays[i].shape, np.float32) for i in idx]
        raise exc
    return [_np(xs[i].grad) for i in idx]


def check_grads(case):
    arrays = _arrays(case)
    got, ref = _grads(mx, case, arrays), _grads(mxj, case, arrays)
    rel = 2 * BF16_REL if case.dtypes and "bfloat16" in case.dtypes else REL
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.astype(np.float64), r.astype(np.float64), rtol=rel,
                                   atol=_bound(r.astype(np.float64), rel))


def check_registry(src):
    """The port's registry holds every name of the JAX file, and the table
    has a case for each."""
    from incubator_mxnet_torch.ops import registry as treg

    names = jax_names(src)
    missing = sorted(n for n in names if n not in treg.list_ops())
    assert not missing, missing
    covered = {c.op for c in ALL_CASES} | {s.op for s in nd_op_cases.SAMPLERS}
    assert names <= covered, sorted(names - covered)
    for n in names:
        assert callable(getattr(mx.nd, n))
        assert treg.get_op(n).differentiable == jreg.get_op(n).differentiable, n

