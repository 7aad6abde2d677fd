"""Dense tensor operators: the port of the JAX package's ``ops/tensor.py``.

Every op of that file, by the same name and with the same parameters:
the ``broadcast_*`` arithmetic, comparison and logic ops and their
aliases, the unary table, the gamma family, ``clip`` and ``cast``, the
reductions with MXNet's ``axis``/``keepdims``/``exclude``, ``argmax`` and
``norm``, the matrix products, the shape ops (MXNet's reshape codes
included), indexing, ordering, the ``_*_scalar`` family, the legacy
``*_0index`` functions and the AMP graph ops; ``zeros`` and ``arange``
(``ndarray/ndarray.py`` there) besides.  Plain PyTorch on the tensor's own
device, as the JAX package leaves these to XLA: no op moves data to the
host or falls back to the CPU.

The JAX semantics kept where PyTorch differs: ``round`` rounds half away
from zero; ``broadcast_mod`` and ``_mod_scalar`` take the divisor's sign
(``torch.remainder``); comparisons return 1/0 in the left operand's dtype;
``argmax``, ``argmin``, ``argsort`` and ``topk`` return float32 indices by
default; a descending ``sort``/``argsort`` is the flip of a stable
ascending sort (ties: the last index first), while ``topk`` breaks ties
by the lower index, as ``lax.top_k`` does, on every device; integer sums
and products keep the input's integer dtype (int32 for bool); a scalar
operand of a ``_*_scalar`` op is first rounded to the data's dtype.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from ..base import as_torch_dtype, dtype_name
from .registry import alias, register


def _device(ctx):
    from ..context import Context, current_context

    if ctx is None:
        ctx = current_context()
    return ctx.device if isinstance(ctx, Context) else torch.device(ctx)


@register("zeros")
def zeros(shape, ctx=None, dtype="float32"):
    if isinstance(shape, int):
        shape = (shape,)
    return torch.zeros(tuple(shape), dtype=as_torch_dtype(dtype), device=_device(ctx))


@register("arange")
def arange(start, stop=None, step=1.0, repeat=1, ctx=None, dtype="float32"):
    if stop is None:
        start, stop = 0, start
    out = torch.arange(start, stop, step, device=_device(ctx)).to(as_torch_dtype(dtype))
    if repeat != 1:
        out = out.repeat_interleave(repeat)
    return out


def _infer_mx_reshape(src, target, reverse=False):
    """MXNet reshape codes 0 (copy), -1 (infer), -2 (copy rest), -3 (merge
    two), -4 (split one); the same rules as the reference's Reshape."""
    src = list(src)
    target = list(target)
    if reverse:
        src, target = src[::-1], target[::-1]
    out = []
    i = j = 0
    while j < len(target):
        t = target[j]
        if t > 0:
            out.append(t)
            i += 1
        elif t == 0:
            if i >= len(src):
                raise ValueError("reshape 0 refers past input rank")
            out.append(src[i])
            i += 1
        elif t == -1:
            out.append(-1)
            i += 1
        elif t == -2:
            out.extend(src[i:])
            i = len(src)
        elif t == -3:
            if i + 1 >= len(src):
                raise ValueError("reshape -3 needs two input dims")
            out.append(src[i] * src[i + 1])
            i += 2
        elif t == -4:
            d = src[i]
            a, b = target[j + 1], target[j + 2]
            if a == -1 and b == -1:
                raise ValueError("reshape -4 with two -1s")
            if a == -1:
                a = d // b
            if b == -1:
                b = d // a
            if a * b != d:
                raise ValueError(f"reshape -4 split {d} != {a}*{b}")
            out.extend([a, b])
            i += 1
            j += 2
        else:
            raise ValueError(f"invalid reshape code {t}")
        j += 1
    total = 1
    for d in src:
        total *= d
    known = 1
    neg = 0
    for d in out:
        if d == -1:
            neg += 1
        else:
            known *= d
    if neg > 1:
        raise ValueError("more than one -1 in reshape")
    if neg == 1:
        out = [total // known if d == -1 else d for d in out]
    if reverse:
        out = out[::-1]
    return tuple(out)


@register("reshape")
def reshape(x, shape, reverse=False):
    return x.reshape(_infer_mx_reshape(x.shape, shape, reverse))


alias("Reshape", "reshape")


@register("flatten")
def flatten(x):
    """To 2-D keeping the batch axis (a 0-d input becomes [1, 1])."""
    if x.ndim == 0:
        return x.reshape(1, 1)
    return x.reshape(x.shape[0], -1)


alias("Flatten", "flatten")




@register("reshape_like")
def reshape_like(lhs, rhs):
    return lhs.reshape(rhs.shape)


# -- broadcasting binary ops ---------------------------------------------------


def _pair(lhs, rhs):
    """Both operands as tensors: a Python scalar becomes a 0-d tensor on
    the other operand's device (filled there, no host copy), which takes
    part in type promotion as the scalar would."""
    if not isinstance(lhs, torch.Tensor):
        lhs = torch.full((), lhs, device=rhs.device)
    elif not isinstance(rhs, torch.Tensor):
        rhs = torch.full((), rhs, device=lhs.device)
    return lhs, rhs


@register("broadcast_add")
def broadcast_add(lhs, rhs):
    return lhs + rhs


@register("broadcast_sub")
def broadcast_sub(lhs, rhs):
    return lhs - rhs


@register("broadcast_mul")
def broadcast_mul(lhs, rhs):
    return lhs * rhs


@register("broadcast_div")
def broadcast_div(lhs, rhs):
    return lhs / rhs


@register("broadcast_mod")
def broadcast_mod(lhs, rhs):
    """``jnp.mod``: the result takes the divisor's sign."""
    return lhs % rhs


@register("broadcast_power")
def broadcast_power(lhs, rhs):
    return lhs ** rhs


@register("broadcast_maximum")
def broadcast_maximum(lhs, rhs):
    return torch.maximum(*_pair(lhs, rhs))


@register("broadcast_minimum")
def broadcast_minimum(lhs, rhs):
    return torch.minimum(*_pair(lhs, rhs))


@register("broadcast_hypot")
def broadcast_hypot(lhs, rhs):
    return torch.hypot(*_pair(lhs, rhs))


def _cmp_dtype(x):
    return x.dtype if isinstance(x, torch.Tensor) else torch.float32


def _make_cmp(name, fn):
    def cmp(lhs, rhs):
        return fn(*_pair(lhs, rhs)).to(_cmp_dtype(lhs))

    cmp.__name__ = name
    register(name, differentiable=False)(cmp)


for _name, _fn in [
    ("broadcast_equal", torch.eq),
    ("broadcast_not_equal", torch.ne),
    ("broadcast_greater", torch.gt),
    ("broadcast_greater_equal", torch.ge),
    ("broadcast_lesser", torch.lt),
    ("broadcast_lesser_equal", torch.le),
    ("broadcast_logical_and", torch.logical_and),
    ("broadcast_logical_or", torch.logical_or),
    ("broadcast_logical_xor", torch.logical_xor),
]:
    _make_cmp(_name, _fn)

for _new, _old in [
    ("elemwise_add", "broadcast_add"),
    ("elemwise_sub", "broadcast_sub"),
    ("elemwise_mul", "broadcast_mul"),
    ("elemwise_div", "broadcast_div"),
    ("add", "broadcast_add"),
    ("subtract", "broadcast_sub"),
    ("multiply", "broadcast_mul"),
    ("divide", "broadcast_div"),
    ("power", "broadcast_power"),
    ("maximum", "broadcast_maximum"),
    ("minimum", "broadcast_minimum"),
    ("equal", "broadcast_equal"),
    ("not_equal", "broadcast_not_equal"),
    ("greater", "broadcast_greater"),
    ("greater_equal", "broadcast_greater_equal"),
    ("lesser", "broadcast_lesser"),
    ("lesser_equal", "broadcast_lesser_equal"),
    ("logical_and", "broadcast_logical_and"),
    ("logical_or", "broadcast_logical_or"),
    ("logical_xor", "broadcast_logical_xor"),
]:
    alias(_new, _old)


# -- unary elementwise ---------------------------------------------------------


def _cbrt(x):
    x = x if x.is_floating_point() else x.float()
    return torch.sign(x) * x.abs().pow(1.0 / 3.0)


_UNARY = {
    "abs": torch.abs,
    "sign": torch.sign,
    "round": lambda x: torch.sign(x) * torch.floor(x.abs() + 0.5),  # half away from zero
    "rint": torch.round,  # half to even
    "ceil": torch.ceil,
    "floor": torch.floor,
    "trunc": torch.trunc,
    "fix": torch.trunc,
    "exp": torch.exp,
    "expm1": torch.expm1,
    "log": torch.log,
    "log10": torch.log10,
    "log2": torch.log2,
    "log1p": torch.log1p,
    "sqrt": torch.sqrt,
    "cbrt": _cbrt,
    "negative": torch.neg,
    "sin": torch.sin,
    "cos": torch.cos,
    "tan": torch.tan,
    "arcsin": torch.asin,
    "arccos": torch.acos,
    "arctan": torch.atan,
    "sinh": torch.sinh,
    "cosh": torch.cosh,
    "tanh": torch.tanh,
    "arcsinh": torch.asinh,
    "arccosh": torch.acosh,
    "arctanh": torch.atanh,
    "degrees": torch.rad2deg,
    "radians": torch.deg2rad,
    "erf": torch.erf,
    "erfinv": torch.erfinv,
    "gammaln": torch.lgamma,
    "logical_not": lambda x: torch.logical_not(x).to(x.dtype),
    "isnan": torch.isnan,
    "isinf": torch.isinf,
    "isfinite": torch.isfinite,
}

for _name, _fn in _UNARY.items():
    register(_name)(_fn)


@register("relu")
def relu(x):
    return torch.relu(x)


@register("sigmoid")
def sigmoid(x):
    return torch.sigmoid(x)


@register("square")
def square(x):
    return torch.square(x)


@register("gamma")
def gamma_fn(x):
    """Γ(x), the gamma function (``gammaln`` is its log), with its sign
    for negative non-integers."""
    mag = torch.exp(torch.lgamma(x))
    neg = (x < 0) & (torch.remainder(torch.floor(x), 2) == 1)
    return torch.where(neg, -mag, mag)


@register("digamma")
def digamma_fn(x):
    return torch.digamma(x)


@register("polygamma")
def polygamma_fn(x, n=0):
    """The n-th derivative of digamma; n=0 is digamma itself."""
    return torch.polygamma(int(n), x)


@register("reciprocal")
def reciprocal(x):
    return 1.0 / x


@register("rsqrt")
def rsqrt(x):
    return torch.rsqrt(x)


@register("rcbrt")
def rcbrt(x):
    return 1.0 / _cbrt(x)


@register("softsign")
def softsign(x):
    return x / (1 + x.abs())


@register("clip")
def clip(x, a_min=None, a_max=None):
    if a_min is None and a_max is None:
        return x
    return torch.clamp(x, a_min, a_max)


@register("cast")
def cast(x, dtype):
    return x.to(as_torch_dtype(dtype))


alias("Cast", "cast")


# -- reductions ----------------------------------------------------------------


def _norm_axis(x, axis, exclude=False):
    """MXNet's reduction axes: int, tuple or None (all); ``exclude`` takes
    every other axis."""
    if axis is None:
        return None
    if isinstance(axis, int):
        axis = (axis,)
    axis = tuple(a % x.ndim for a in axis)
    if exclude:
        axis = tuple(i for i in range(x.ndim) if i not in axis)
    return axis


def _int_result(x, out):
    """Integer sums and products keep the input's dtype (bool gives int32),
    as ``jnp.sum`` does without x64; PyTorch widens them to int64."""
    if x.is_floating_point() or x.is_complex():
        return out
    return out.to(torch.int32 if x.dtype == torch.bool else x.dtype)


def _prod(x, dim=None, keepdim=False):
    if dim is None:
        return torch.prod(x)
    for d in sorted(dim, reverse=True):
        x = torch.prod(x, dim=d, keepdim=keepdim)
    return x


def _nanprod(x, dim=None, keepdim=False):
    return _prod(torch.where(torch.isnan(x), torch.ones_like(x), x), dim, keepdim)


def _mean(x, dim=None, keepdim=False):
    x = x if x.is_floating_point() else x.float()
    return torch.mean(x) if dim is None else torch.mean(x, dim=dim, keepdim=keepdim)


def _all(fn):
    def reduce(x, dim=None, keepdim=False):
        return fn(x) if dim is None else fn(x, dim=dim, keepdim=keepdim)
    return reduce


_REDUCERS = {
    "sum": _all(torch.sum),
    "mean": _mean,
    "prod": _prod,
    "max": _all(torch.amax),
    "min": _all(torch.amin),
    "nansum": _all(torch.nansum),
    "nanprod": _nanprod,
}


def _make_reduce(name, fn):
    def red(x, axis=None, keepdims=False, exclude=False):
        ax = _norm_axis(x, axis, exclude)
        if ax is not None and not ax:  # no axis left to reduce (exclude of every axis)
            return x
        out = fn(x, dim=ax, keepdim=keepdims)
        if ax is None and keepdims:
            out = out.reshape((1,) * x.ndim)
        return _int_result(x, out) if name in ("sum", "prod", "nansum", "nanprod") else out

    red.__name__ = name
    register(name)(red)


for _name, _fn in _REDUCERS.items():
    _make_reduce(_name, _fn)
alias("sum_axis", "sum")
alias("max_axis", "max")
alias("min_axis", "min")


def _arg(fn, x, axis, keepdims):
    if axis is None:
        out = fn(x.reshape(-1))
        return out.reshape((1,) * x.ndim) if keepdims else out
    return fn(x, dim=axis, keepdim=keepdims)


@register("argmax", differentiable=False)
def argmax(x, axis=None, keepdims=False):
    """Index of the first largest entry, as float32."""
    return _arg(torch.argmax, x, axis, keepdims).to(torch.float32)


@register("argmin", differentiable=False)
def argmin(x, axis=None, keepdims=False):
    return _arg(torch.argmin, x, axis, keepdims).to(torch.float32)


@register("norm")
def norm(x, ord=2, axis=None, keepdims=False):
    ax = _norm_axis(x, axis)
    red = _REDUCERS["sum"]
    if ord == 1:
        out = red(x.abs(), dim=ax, keepdim=keepdims)
    elif ord == 2:
        out = torch.sqrt(red(torch.square(x), dim=ax, keepdim=keepdims))
    else:
        raise ValueError(f"unsupported ord {ord}")
    return out.reshape((1,) * x.ndim) if ax is None and keepdims else out


@register("L2Normalization")
def l2_normalization(x, eps=1e-10, mode="instance"):
    if mode == "instance":
        ax = tuple(range(1, x.ndim))
    elif mode == "channel":
        ax = (1,)
    elif mode == "spatial":
        ax = tuple(range(2, x.ndim))
    else:
        raise ValueError(mode)
    return x / torch.sqrt(torch.sum(torch.square(x), dim=ax, keepdim=True) + eps)


# -- matrix products -----------------------------------------------------------


def _reverse_axes(x):
    return x.permute(*reversed(range(x.ndim)))


@register("dot")
def dot(lhs, rhs, transpose_a=False, transpose_b=False):
    """MXNet dot: the last axis of lhs against the first of rhs
    (``transpose_*`` reverses every axis, as ``jnp.transpose``)."""
    if transpose_a:
        lhs = _reverse_axes(lhs)
    if transpose_b:
        rhs = _reverse_axes(rhs)
    if lhs.ndim == 1 and rhs.ndim == 1:
        return torch.dot(lhs, rhs)
    return torch.tensordot(lhs, rhs, dims=([lhs.ndim - 1], [0]))


@register("matmul")
def matmul(lhs, rhs):
    return torch.matmul(lhs, rhs)


@register("batch_dot")
def batch_dot(lhs, rhs, transpose_a=False, transpose_b=False):
    if transpose_a:
        lhs = lhs.transpose(-1, -2)
    if transpose_b:
        rhs = rhs.transpose(-1, -2)
    return torch.matmul(lhs, rhs)


@register("linalg_gemm2")
def linalg_gemm2(a, b, transpose_a=False, transpose_b=False, alpha=1.0):
    if transpose_a:
        a = a.transpose(-1, -2)
    if transpose_b:
        b = b.transpose(-1, -2)
    return alpha * torch.matmul(a, b)


@register("linalg_potrf")
def linalg_potrf(a):
    return torch.linalg.cholesky(a)


@register("linalg_syrk")
def linalg_syrk(a, transpose=False, alpha=1.0):
    if transpose:
        return alpha * torch.matmul(a.transpose(-1, -2), a)
    return alpha * torch.matmul(a, a.transpose(-1, -2))


# -- shape ops -----------------------------------------------------------------


@register("transpose")
def transpose(x, axes=None):
    if not axes:
        return _reverse_axes(x)
    return x.permute(*axes)


@register("swapaxes")
def swapaxes(x, dim1=0, dim2=0):
    return torch.swapaxes(x, dim1, dim2)


alias("SwapAxis", "swapaxes")


@register("expand_dims")
def expand_dims(x, axis):
    if isinstance(axis, int):
        return x.unsqueeze(axis)
    nd = x.ndim + len(axis)
    for a in sorted(a % nd for a in axis):
        x = x.unsqueeze(a)
    return x


@register("squeeze")
def squeeze(x, axis=None):
    return x.squeeze() if axis is None else x.squeeze(axis)


@register("broadcast_to")
def broadcast_to(x, shape):
    """A 0 in ``shape`` keeps that axis."""
    shape = tuple(s if s != 0 else x.shape[i] for i, s in enumerate(shape))
    return torch.broadcast_to(x, shape)


@register("broadcast_like")
def broadcast_like(lhs, rhs):
    return torch.broadcast_to(lhs, rhs.shape)


@register("broadcast_axis")
def broadcast_axis(x, axis=(), size=()):
    if isinstance(axis, int):
        axis = (axis,)
    if isinstance(size, int):
        size = (size,)
    shape = list(x.shape)
    for a, s in zip(axis, size):
        shape[a] = s
    return torch.broadcast_to(x, tuple(shape))


alias("broadcast_axes", "broadcast_axis")


@register("tile")
def tile(x, reps):
    return torch.tile(x, tuple(reps) if not isinstance(reps, int) else (reps,))


@register("repeat")
def repeat(x, repeats, axis=None):
    return torch.repeat_interleave(x, repeats, dim=axis)


@register("flip")
def flip(x, axis):
    return torch.flip(x, (axis,) if isinstance(axis, int) else tuple(axis))


alias("reverse", "flip")


def _edge_index(n, lo, hi, mode, device):
    """Source indices of an axis of length n padded by (lo, hi)."""
    i = torch.arange(-lo, n + hi, device=device)
    if mode == "edge":
        return i.clamp(0, n - 1)
    period = 2 * (n - 1)  # reflect, the edge not repeated
    i = torch.remainder(i, period)
    return torch.where(i >= n, period - i, i)


@register("pad")
def pad(x, mode="constant", pad_width=(), constant_value=0.0):
    """``pad_width`` is MXNet's flat tuple, (before, after) per axis from
    the first; modes ``constant``, ``edge`` and ``reflect``."""
    pw = [(pad_width[2 * i], pad_width[2 * i + 1]) for i in range(len(pad_width) // 2)]
    if mode == "constant":
        flat = []
        for lo, hi in reversed(pw):
            flat += [lo, hi]
        return F.pad(x, flat, value=constant_value)
    if mode not in ("edge", "reflect"):
        raise KeyError(mode)
    for ax, (lo, hi) in enumerate(pw):
        if lo or hi:
            x = torch.index_select(x, ax, _edge_index(x.shape[ax], lo, hi, mode, x.device))
    return x


@register("concat")
def concat(*args, dim=1):
    return torch.cat(args, dim=dim)


alias("Concat", "concat")


@register("stack")
def stack(*args, axis=0):
    return torch.stack(args, dim=axis)


@register("add_n")
def add_n(*args):
    out = args[0]
    for a in args[1:]:
        out = out + a
    return out


alias("ElementWiseSum", "add_n")


def _squeezed(parts, axis, squeeze_axis):
    if squeeze_axis:
        parts = [p.squeeze(axis) for p in parts]
    return tuple(parts)


@register("split")
def split(x, num_outputs, axis=1, squeeze_axis=False):
    if x.shape[axis] % num_outputs:
        raise ValueError(f"split: axis {axis} of size {x.shape[axis]} is not divisible "
                         f"into {num_outputs} parts")
    return _squeezed(torch.tensor_split(x, num_outputs, dim=axis), axis, squeeze_axis)


alias("SliceChannel", "split")


@register("split_v2")
def split_v2(data, indices_or_sections=1, axis=0, squeeze_axis=False):
    """An int is N equal sections, a tuple the split points along ``axis``."""
    if isinstance(indices_or_sections, int):
        spec = int(indices_or_sections)
        if data.shape[axis] % spec:
            raise ValueError(f"split_v2: axis {axis} of size {data.shape[axis]} is not "
                             f"divisible into {spec} sections")
    else:
        spec = [int(i) for i in indices_or_sections]
        if any(i < 0 or i > data.shape[axis] for i in spec) or sorted(spec) != spec:
            raise ValueError(
                f"split_v2 indices {spec} invalid for axis {axis} of "
                f"size {data.shape[axis]} (must be sorted, in range)")
    return _squeezed(torch.tensor_split(data, spec, dim=axis), axis, squeeze_axis)


def _axis_slice(x, ax, b, e, s):
    if s is None or s > 0:
        return x[(slice(None),) * ax + (slice(b, e, s),)]
    start, stop, step = slice(b, e, s).indices(x.shape[ax])
    return torch.index_select(x, ax, torch.arange(start, stop, step, device=x.device))


@register("slice")
def slice_op(x, begin, end, step=None):
    """Python slice semantics per axis, negative steps included."""
    step = step or [None] * len(begin)
    for ax, (b, e, s) in enumerate(zip(begin, end, step)):
        x = _axis_slice(x, ax, b, e, s)
    return x


alias("crop", "slice")


@register("slice_axis")
def slice_axis(x, axis, begin, end):
    return _axis_slice(x, axis % x.ndim, begin, end, None)


@register("slice_like")
def slice_like(x, like, axes=()):
    axes = axes or tuple(range(min(x.ndim, like.ndim)))
    for a in axes:
        x = _axis_slice(x, a % x.ndim, 0, like.shape[a], None)
    return x


# -- indexing ------------------------------------------------------------------


@register("take")
def take(x, indices, axis=0, mode="clip"):
    ax = axis % x.ndim
    idx = indices.long()
    idx = torch.remainder(idx, x.shape[ax]) if mode == "wrap" else idx.clamp(0, x.shape[ax] - 1)
    out = torch.index_select(x, ax, idx.reshape(-1))
    return out.reshape(x.shape[:ax] + idx.shape + x.shape[ax + 1:])


@register("batch_take")
def batch_take(x, indices):
    return x[torch.arange(x.shape[0], device=x.device), indices.long().reshape(-1)]


@register("pick")
def pick(x, index, axis=-1, keepdims=False, mode="clip"):
    """x's entries at ``index`` along ``axis`` (indices clipped to range,
    MXNet's default mode)."""
    idx = index.long().clamp(0, x.shape[axis] - 1).unsqueeze(axis)
    out = torch.take_along_dim(x, idx, dim=axis)
    return out if keepdims else out.squeeze(axis)


@register("gather_nd")
def gather_nd(data, indices):
    """``indices`` (M, ...) indexes the first M axes of ``data``."""
    idx = indices.long()
    return data[tuple(idx[i] for i in range(idx.shape[0]))]


@register("scatter_nd")
def scatter_nd(data, indices, shape):
    idx = indices.long()
    out = torch.zeros(tuple(shape), dtype=data.dtype, device=data.device)
    return out.index_put(tuple(idx[i] for i in range(idx.shape[0])), data)


@register("where")
def where(condition, x, y):
    return torch.where(condition if condition.dtype == torch.bool else condition != 0, x, y)


def _one_hot(indices, depth):
    """float32 one-hot rows; an index outside [0, depth) gives a zero row."""
    return (indices.long().unsqueeze(-1)
            == torch.arange(depth, device=indices.device)).to(torch.float32)


@register("one_hot", differentiable=False)
def one_hot(indices, depth, on_value=1.0, off_value=0.0, dtype="float32"):
    oh = _one_hot(indices, depth)
    return (oh * on_value + (1 - oh) * off_value).to(as_torch_dtype(dtype))


@register("diag")
def diag(x, k=0):
    if x.ndim == 1:
        return torch.diag(x, k)
    return torch.diagonal(x, offset=k, dim1=-2, dim2=-1)


@register("shape_array", differentiable=False)
def shape_array(x):
    return torch.tensor(list(x.shape), dtype=torch.int32, device=x.device)


@register("size_array", differentiable=False)
def size_array(x):
    return torch.tensor([x.numel()], dtype=torch.int32, device=x.device)


@register("zeros_like")
def zeros_like(x):
    return torch.zeros_like(x)


@register("ones_like")
def ones_like(x):
    return torch.ones_like(x)


@register("full_like")
def full_like(x, fill_value=0.0):
    return torch.full_like(x, fill_value)


# -- ordering ------------------------------------------------------------------


@register("sort")
def sort(x, axis=-1, is_ascend=True):
    out = torch.sort(x, dim=axis, stable=True).values
    return out if is_ascend else torch.flip(out, (axis,))


@register("argsort", differentiable=False)
def argsort(x, axis=-1, is_ascend=True, dtype="float32"):
    out = torch.sort(x, dim=axis, stable=True).indices
    if not is_ascend:
        out = torch.flip(out, (axis,))
    return out.to(as_torch_dtype(dtype))


@register("topk", differentiable=False)
def topk(x, axis=-1, k=1, ret_typ="indices", is_ascend=False, dtype="float32"):
    """The k largest (or smallest) entries along ``axis``; among equal
    entries the lower index comes first, on every device (a stable sort,
    not ``torch.topk``, whose order among ties is unspecified on CUDA)."""
    ax = axis % x.ndim
    srt = torch.sort(x, dim=ax, descending=not is_ascend, stable=True)
    vals = srt.values.narrow(ax, 0, k)
    idx = srt.indices.narrow(ax, 0, k)
    if ret_typ == "indices":
        return idx.to(as_torch_dtype(dtype))
    if ret_typ == "value":
        return vals
    if ret_typ == "both":
        return vals, idx.to(as_torch_dtype(dtype))
    if ret_typ == "mask":
        return torch.zeros_like(x).scatter(ax, idx, 1)
    raise ValueError(ret_typ)


# -- misc ----------------------------------------------------------------------


@register("identity")
def identity(x):
    return x


@register("BlockGrad")
def block_grad(x):
    return x.detach()


alias("stop_gradient", "BlockGrad")
alias("make_loss", "identity")


@register("smooth_l1")
def smooth_l1(x, scalar=1.0):
    s2 = scalar * scalar
    return torch.where(x.abs() < 1.0 / s2, 0.5 * s2 * torch.square(x), x.abs() - 0.5 / s2)


@register("hard_sigmoid")
def hard_sigmoid(x, alpha=0.2, beta=0.5):
    return torch.clamp(alpha * x + beta, 0.0, 1.0)


# -- scalar-operand ops --------------------------------------------------------


def _scalar(data, scalar):
    """``data.dtype.type(scalar)``: the scalar rounded to the data's dtype,
    as a Python number (a host value, no device traffic)."""
    if data.dtype == torch.bool:
        return bool(scalar)
    if not data.is_floating_point():
        return int(scalar)
    return torch.tensor(scalar, dtype=data.dtype).item()


@register("_plus_scalar")
def _plus_scalar(data, scalar=0.0):
    return data + _scalar(data, scalar)


@register("_minus_scalar")
def _minus_scalar(data, scalar=0.0):
    return data - _scalar(data, scalar)


@register("_rminus_scalar")
def _rminus_scalar(data, scalar=0.0):
    return _scalar(data, scalar) - data


@register("_mul_scalar")
def _mul_scalar(data, scalar=1.0):
    return data * _scalar(data, scalar)


@register("_div_scalar")
def _div_scalar(data, scalar=1.0):
    return data / _scalar(data, scalar)


@register("_rdiv_scalar")
def _rdiv_scalar(data, scalar=1.0):
    return _scalar(data, scalar) / data


@register("_power_scalar")
def _power_scalar(data, scalar=1.0):
    return data ** _scalar(data, scalar)


@register("_rpower_scalar")
def _rpower_scalar(data, scalar=1.0):
    return _scalar(data, scalar) ** data


@register("_mod_scalar")
def _mod_scalar(data, scalar=1.0):
    return torch.remainder(data, _scalar(data, scalar))


@register("_rmod_scalar")
def _rmod_scalar(data, scalar=1.0):
    # the tensor–tensor form: PyTorch differentiates remainder(scalar, x) in x only so
    return torch.remainder(torch.full_like(data, _scalar(data, scalar)), data)


@register("_maximum_scalar")
def _maximum_scalar(data, scalar=0.0):
    return torch.maximum(data, torch.full_like(data, _scalar(data, scalar)))


@register("_minimum_scalar")
def _minimum_scalar(data, scalar=0.0):
    return torch.minimum(data, torch.full_like(data, _scalar(data, scalar)))


@register("_hypot_scalar")
def _hypot_scalar(data, scalar=0.0):
    return torch.hypot(data, torch.full_like(data, _scalar(data, scalar)))


def _make_cmp_scalar(name, fn):
    """Comparisons return 1/0 in the input's dtype (MXNet's float-mask
    convention, not bool arrays)."""
    def cmp_scalar(data, scalar=0.0):
        return fn(data, torch.full_like(data, _scalar(data, scalar))).to(data.dtype)

    cmp_scalar.__name__ = name.lstrip("_")
    register(name, differentiable=False)(cmp_scalar)


for _name, _fn in [
    ("_equal_scalar", torch.eq),
    ("_not_equal_scalar", torch.ne),
    ("_greater_scalar", torch.gt),
    ("_greater_equal_scalar", torch.ge),
    ("_lesser_scalar", torch.lt),
    ("_lesser_equal_scalar", torch.le),
    ("_logical_and_scalar", torch.logical_and),
    ("_logical_or_scalar", torch.logical_or),
    ("_logical_xor_scalar", torch.logical_xor),
]:
    _make_cmp_scalar(_name, _fn)


@register("_sym_zeros")
def _sym_zeros(shape=(), dtype="float32", ctx=None):
    return torch.zeros(tuple(shape), dtype=as_torch_dtype(dtype), device=_device(ctx))


@register("_sym_ones")
def _sym_ones(shape=(), dtype="float32", ctx=None):
    return torch.ones(tuple(shape), dtype=as_torch_dtype(dtype), device=_device(ctx))


# -- legacy ndarray functions (choose_element_0index is the old pick along
# axis 1) ------------------------------------------------------------------------


@register("choose_element_0index")
def choose_element_0index(lhs, rhs):
    """out[i] = lhs[i, rhs[i]]."""
    return pick(lhs, rhs, axis=1)


@register("fill_element_0index")
def fill_element_0index(lhs, mhs, rhs):
    """lhs with out[i, rhs[i]] = mhs[i] (a new tensor; lhs is unchanged)."""
    idx = rhs.long().clamp(0, lhs.shape[1] - 1)
    return lhs.index_put((torch.arange(lhs.shape[0], device=lhs.device), idx), mhs)


@register("one_hot_encode")
def one_hot_encode(indices, out):
    """The legacy two-operand form: ``out`` supplies the [N, C] shape and
    the dtype."""
    return _one_hot(indices, out.shape[1]).to(out.dtype)


# -- AMP graph ops ---------------------------------------------------------------


@register("amp_cast")
def amp_cast(x, dtype="float32"):
    """Cast a floating input; integer and bool inputs pass unchanged."""
    if not x.is_floating_point():
        return x
    return x.to(as_torch_dtype(dtype))


@register("amp_multicast")
def amp_multicast(*data, num_outputs=0, cast_narrow=False):
    """Every floating operand cast to the widest floating dtype among them
    (f16 with bf16 gives f32), or with ``cast_narrow`` the narrowest."""
    floats = [d.dtype for d in data if d.is_floating_point()]
    if not floats:
        return tuple(data)
    if cast_narrow:
        target = min(floats, key=lambda dt: (dt.itemsize, dtype_name(dt)))
    else:
        target = functools.reduce(torch.promote_types, floats)
    return tuple(d.to(target) if d.is_floating_point() else d for d in data)


@register("_contrib_boolean_mask")
def boolean_mask(data, index, axis=0):
    """The slices of ``data`` along ``axis`` where ``index`` is nonzero."""
    if index.ndim != 1 or index.shape[0] != data.shape[axis]:
        raise ValueError(
            f"boolean_mask: mask shape {tuple(index.shape)} must be 1-D of length "
            f"data.shape[{axis}]={data.shape[axis]}")
    return torch.index_select(data, axis, torch.nonzero(index != 0).reshape(-1))

