"""The op table of the ``mx.nd`` surface: one or more small cases for every
op the JAX package registers in ``ops/tensor.py``, ``ops/nn.py`` and
``ops/random_ops.py``.

numpy only (no JAX, no torch), so that both the CPU parity tests
(``tests/test_torch_nd_ops_*.py``, ``tests/test_torch_nd_random.py``) and
``chip_smoke.py``'s ``nd_surface`` phase on the card read the same cases.

``CASES``: ``Case(id, op, src, inputs, kwargs, card)``.  ``inputs(rng)``
makes the positional array arguments from a ``numpy.random.RandomState``
seeded by the case id (a keyword argument ``A(maker)`` is an array made the
same way, after them); ``dtypes`` optionally names a dtype per input
(``"bfloat16"`` is made from the float32 array).  ``card`` is how the card's
result is held to the port's CPU result for the same inputs:

* ``exact``: the op only moves, selects, compares or indexes (or rounds
  exactly): equal;
* ``ulp``: elementwise arithmetic or a transcendental: within ``ULPS``
  units in the last place of the case's largest |value| in the output dtype;
* ``reduce``: a reduction, a product or a normalization: within
  ``REDUCE_ULPS`` · n ulps of the case's largest |value|, n the number of
  input elements (a summation-order bound).

``SAMPLERS``: ``Sampler(id, op, args, kwargs, moments)`` for the random
ops; ``args(n)`` gives the parameter arrays of a draw of about n values,
``moments`` the true (mean, variance) of each row of the draw.
"""
from __future__ import annotations

import zlib
from collections import namedtuple

import numpy as np

ULPS = 8
REDUCE_ULPS = 4

Case = namedtuple("Case", "id op src inputs kwargs card dtypes")
Case.__new__.__defaults__ = ({}, "ulp", None)

Sampler = namedtuple("Sampler", "id op args kwargs moments")


def rng_for(case_id):
    return np.random.RandomState(zlib.crc32(case_id.encode()) % (2 ** 31))


# -- input makers -----------------------------------------------------------------


def U(*shape, lo=-2.0, hi=2.0):
    return lambda r: r.uniform(lo, hi, shape).astype(np.float32)


def SU(*shape, lo=0.3, hi=2.0):
    """|x| in [lo, hi] with random signs: away from zero."""
    return lambda r: (r.uniform(lo, hi, shape) * r.choice([-1.0, 1.0], shape)).astype(np.float32)


def I(*shape, lo=-2, hi=3):
    """Integer values as float32 (ties, zeros and equal pairs)."""
    return lambda r: r.randint(lo, hi, shape).astype(np.float32)


def IDX(*shape, lo=0, hi=3):
    return lambda r: r.randint(lo, hi, shape).astype(np.int32)


def K(arr, dtype=np.float32):
    return lambda r: np.asarray(arr, dtype=dtype)


class A:
    """A keyword argument that is an array (made like an input)."""

    def __init__(self, maker):
        self.maker = maker


def inputs(*makers):
    return lambda r: [m(r) for m in makers]


def spd(r):
    a = r.uniform(-1, 1, (3, 3))
    return (a @ a.T + 3 * np.eye(3)).astype(np.float32)


# -- ops/tensor.py ----------------------------------------------------------------

_T = []


def t(id_, op, ins, kw=None, card="ulp", dtypes=None):
    _T.append(Case(id_, op, "tensor", ins, kw or {}, card, dtypes))


_BIN = inputs(U(3, 4), U(1, 4))
for name, ins, card in [
    ("broadcast_add", _BIN, "ulp"), ("broadcast_sub", _BIN, "ulp"),
    ("broadcast_mul", _BIN, "ulp"), ("broadcast_div", inputs(U(3, 4), SU(1, 4)), "ulp"),
    ("broadcast_mod", inputs(U(3, 4), SU(1, 4, lo=0.5)), "ulp"),
    ("broadcast_power", inputs(U(3, 4, lo=0.5, hi=2.0), U(1, 4)), "ulp"),
    ("broadcast_maximum", _BIN, "exact"), ("broadcast_minimum", _BIN, "exact"),
    ("broadcast_hypot", _BIN, "ulp"),
]:
    t(name, name, ins, card=card)
for name in ["broadcast_equal", "broadcast_not_equal", "broadcast_greater",
             "broadcast_greater_equal", "broadcast_lesser", "broadcast_lesser_equal",
             "broadcast_logical_and", "broadcast_logical_or", "broadcast_logical_xor"]:
    t(name, name, inputs(I(3, 4), I(1, 4)), card="exact")
for new, old in [
    ("elemwise_add", "broadcast_add"), ("elemwise_sub", "broadcast_sub"),
    ("elemwise_mul", "broadcast_mul"), ("elemwise_div", "broadcast_div"),
    ("add", "broadcast_add"), ("subtract", "broadcast_sub"), ("multiply", "broadcast_mul"),
    ("divide", "broadcast_div"), ("power", "broadcast_power"),
    ("maximum", "broadcast_maximum"), ("minimum", "broadcast_minimum"),
    ("equal", "broadcast_equal"), ("not_equal", "broadcast_not_equal"),
    ("greater", "broadcast_greater"), ("greater_equal", "broadcast_greater_equal"),
    ("lesser", "broadcast_lesser"), ("lesser_equal", "broadcast_lesser_equal"),
    ("logical_and", "broadcast_logical_and"), ("logical_or", "broadcast_logical_or"),
    ("logical_xor", "broadcast_logical_xor"),
]:
    base = next(c for c in _T if c.id == old)
    t(new, new, base.inputs, card=base.card)
t("broadcast_add-bf16", "broadcast_add", _BIN, dtypes=("bfloat16", "bfloat16"))
t("broadcast_add-int", "broadcast_add", inputs(IDX(3, 4, lo=-5, hi=5), IDX(1, 4)),
  card="exact")

_HALVES = lambda r: (r.randint(-10, 11, (3, 4)) / 2).astype(np.float32)  # noqa: E731
_UNARY = {
    "abs": (U(3, 4), "exact"), "sign": (I(3, 4), "exact"), "round": (_HALVES, "exact"),
    "rint": (_HALVES, "exact"), "ceil": (U(3, 4, lo=-3, hi=3), "exact"),
    "floor": (U(3, 4, lo=-3, hi=3), "exact"), "trunc": (U(3, 4, lo=-3, hi=3), "exact"),
    "fix": (U(3, 4, lo=-3, hi=3), "exact"), "exp": (U(3, 4), "ulp"),
    "expm1": (U(3, 4), "ulp"), "log": (U(3, 4, lo=0.1, hi=3), "ulp"),
    "log10": (U(3, 4, lo=0.1, hi=3), "ulp"), "log2": (U(3, 4, lo=0.1, hi=3), "ulp"),
    "log1p": (U(3, 4, lo=-0.5, hi=2), "ulp"), "sqrt": (U(3, 4, lo=0.1, hi=4), "ulp"),
    "cbrt": (SU(3, 4, lo=0.2, hi=3), "ulp"), "negative": (U(3, 4), "exact"),
    "sin": (U(3, 4, lo=-1.2, hi=1.2), "ulp"), "cos": (U(3, 4, lo=-1.2, hi=1.2), "ulp"),
    "tan": (U(3, 4, lo=-1.2, hi=1.2), "ulp"), "arcsin": (U(3, 4, lo=-0.9, hi=0.9), "ulp"),
    "arccos": (U(3, 4, lo=-0.9, hi=0.9), "ulp"), "arctan": (U(3, 4, lo=-3, hi=3), "ulp"),
    "sinh": (U(3, 4), "ulp"), "cosh": (U(3, 4), "ulp"), "tanh": (U(3, 4), "ulp"),
    "arcsinh": (U(3, 4, lo=-3, hi=3), "ulp"), "arccosh": (U(3, 4, lo=1.1, hi=3), "ulp"),
    "arctanh": (U(3, 4, lo=-0.9, hi=0.9), "ulp"), "degrees": (U(3, 4, lo=-3, hi=3), "ulp"),
    "radians": (U(3, 4, lo=-200, hi=200), "ulp"), "erf": (U(3, 4), "ulp"),
    "erfinv": (U(3, 4, lo=-0.9, hi=0.9), "ulp"), "gammaln": (U(3, 4, lo=0.2, hi=4), "ulp"),
    "logical_not": (I(3, 4), "exact"),
    "isnan": (K([[1.0, np.nan, np.inf], [-np.inf, 0.0, -2.5]]), "exact"),
    "isinf": (K([[1.0, np.nan, np.inf], [-np.inf, 0.0, -2.5]]), "exact"),
    "isfinite": (K([[1.0, np.nan, np.inf], [-np.inf, 0.0, -2.5]]), "exact"),
    "square": (U(3, 4), "ulp"), "relu": (SU(3, 4, lo=0.1), "exact"),
    "sigmoid": (U(3, 4), "ulp"), "softsign": (U(3, 4), "ulp"),
    "reciprocal": (SU(3, 4, lo=0.5), "ulp"), "rsqrt": (U(3, 4, lo=0.2, hi=4), "ulp"),
    "rcbrt": (U(3, 4, lo=0.2, hi=3), "ulp"), "digamma": (U(3, 4, lo=0.3, hi=4), "ulp"),
    "gamma": (lambda r: np.concatenate([r.uniform(0.3, 4, (2, 4)),
                                        r.uniform(-1.8, -1.2, (1, 4))]).astype(np.float32),
              "ulp"),
}
for name, (maker, card) in _UNARY.items():
    t(name, name, inputs(maker), card=card)
t("polygamma", "polygamma", inputs(U(3, 4, lo=0.5, hi=4)), {"n": 1})
t("clip", "clip", inputs(SU(3, 4, lo=0.05)), {"a_min": -0.5, "a_max": 0.7}, card="exact")
t("cast", "cast", inputs(U(3, 4)), {"dtype": "float16"}, card="exact")
t("Cast", "Cast", inputs(U(3, 4, lo=-9, hi=9)), {"dtype": "int32"}, card="exact")

_R3 = U(3, 4, 5)
t("sum", "sum", inputs(_R3), {"axis": (0, 2), "keepdims": True}, card="reduce")
t("sum_axis", "sum_axis", inputs(_R3), {"axis": 1}, card="reduce")
t("sum-int", "sum", inputs(IDX(3, 4, lo=-9, hi=9)), {"axis": 1}, card="exact")
t("mean", "mean", inputs(_R3), {"axis": 1, "exclude": True}, card="reduce")
t("prod", "prod", inputs(U(3, 4, 5, lo=0.5, hi=1.5)), {"axis": (1, 2)}, card="reduce")
t("max", "max", inputs(_R3), {"axis": None}, card="exact")
t("max_axis", "max_axis", inputs(_R3), {"axis": 2, "keepdims": True}, card="exact")
t("min", "min", inputs(_R3), {"axis": 0}, card="exact")
t("min_axis", "min_axis", inputs(_R3), {"axis": -1}, card="exact")
_NANS = lambda r: np.where(r.rand(3, 4) < 0.25, np.nan,  # noqa: E731
                           r.uniform(0.5, 1.5, (3, 4))).astype(np.float32)
t("nansum", "nansum", inputs(_NANS), {"axis": 1}, card="reduce")
t("nanprod", "nanprod", inputs(_NANS), {"axis": 0}, card="reduce")
t("argmax", "argmax", inputs(_R3), {"axis": 1}, card="exact")
t("argmin", "argmin", inputs(_R3), {"axis": None, "keepdims": True}, card="exact")
t("norm", "norm", inputs(_R3), {"axis": 1, "keepdims": True}, card="reduce")
t("norm-ord1", "norm", inputs(_R3), {"ord": 1}, card="reduce")
t("L2Normalization", "L2Normalization", inputs(U(2, 3, 4)), card="reduce")
t("L2Normalization-channel", "L2Normalization", inputs(U(2, 3, 4)), {"mode": "channel"},
  card="reduce")

t("dot", "dot", inputs(U(4, 3), U(5, 4)), {"transpose_a": True, "transpose_b": True},
  card="reduce")
t("dot-vec", "dot", inputs(U(6), U(6)), card="reduce")
t("matmul", "matmul", inputs(U(2, 3, 4), U(2, 4, 5)), card="reduce")
t("batch_dot", "batch_dot", inputs(U(2, 3, 4), U(2, 5, 4)), {"transpose_b": True},
  card="reduce")
t("linalg_gemm2", "linalg_gemm2", inputs(U(2, 4, 3), U(2, 4, 5)),
  {"transpose_a": True, "alpha": 0.5}, card="reduce")
t("linalg_potrf", "linalg_potrf", inputs(spd), card="reduce")
t("linalg_syrk", "linalg_syrk", inputs(U(3, 4)), {"alpha": 0.5}, card="reduce")
t("linalg_syrk-t", "linalg_syrk", inputs(U(3, 4)), {"transpose": True}, card="reduce")

_S = U(2, 3, 4)
for name, ins, kw in [
    ("reshape", inputs(_S), {"shape": (0, -1)}),
    ("Reshape", inputs(_S), {"shape": (-3, 0)}),
    ("reshape_like", inputs(_S, U(4, 6)), {}),
    ("flatten", inputs(_S), {}), ("Flatten", inputs(U(2, 3, 2, 2)), {}),
    ("transpose", inputs(_S), {"axes": (1, 0, 2)}),
    ("swapaxes", inputs(_S), {"dim1": 0, "dim2": 2}),
    ("SwapAxis", inputs(_S), {"dim1": 1, "dim2": 2}),
    ("expand_dims", inputs(_S), {"axis": 1}),
    ("squeeze", inputs(U(2, 1, 3, 1)), {"axis": 1}),
    ("broadcast_to", inputs(U(1, 4)), {"shape": (3, 0)}),
    ("broadcast_like", inputs(U(1, 4), U(3, 4)), {}),
    ("broadcast_axis", inputs(U(1, 4, 1)), {"axis": (0, 2), "size": (3, 2)}),
    ("broadcast_axes", inputs(U(1, 4, 1)), {"axis": 2, "size": 5}),
    ("tile", inputs(U(2, 3)), {"reps": (2, 2)}),
    ("repeat", inputs(U(2, 3)), {"repeats": 2, "axis": 1}),
    ("flip", inputs(_S), {"axis": 1}),
    ("reverse", inputs(_S), {"axis": (0, 2)}),
    ("concat", inputs(U(2, 3), U(2, 2), U(2, 1)), {"dim": 1}),
    ("Concat", inputs(U(2, 3), U(1, 3)), {"dim": 0}),
    ("stack", inputs(U(2, 3), U(2, 3), U(2, 3)), {"axis": 1}),
    ("split", inputs(U(2, 6)), {"num_outputs": 3, "axis": 1}),
    ("SliceChannel", inputs(U(3, 2)), {"num_outputs": 3, "axis": 0, "squeeze_axis": True}),
    ("split_v2", inputs(U(4, 6)), {"indices_or_sections": (1, 4), "axis": 1}),
    ("slice", inputs(U(3, 4, 5)), {"begin": (0, 1, None), "end": (3, None, 4),
                                   "step": (2, 1, None)}),
    ("crop", inputs(U(3, 4)), {"begin": (None, 3), "end": (None, 0), "step": (None, -1)}),
    ("slice_axis", inputs(U(3, 4)), {"axis": 1, "begin": 1, "end": None}),
    ("slice_like", inputs(U(3, 4), U(2, 3)), {}),
    ("diag", inputs(U(4, 4)), {"k": 1}),
]:
    t(name, name, ins, kw, card="exact")
t("diag-vec", "diag", inputs(U(3)), {"k": -1}, card="exact")
t("pad", "pad", inputs(U(1, 2, 3, 4)),
  {"mode": "constant", "pad_width": (0, 0, 0, 0, 1, 2, 2, 1), "constant_value": 0.5},
  card="exact")
t("pad-edge", "pad", inputs(U(1, 2, 3, 4)),
  {"mode": "edge", "pad_width": (0, 0, 0, 0, 1, 2, 2, 1)}, card="exact")
t("pad-reflect", "pad", inputs(U(1, 2, 3, 4)),
  {"mode": "reflect", "pad_width": (0, 0, 0, 0, 2, 1, 1, 2)}, card="exact")
t("add_n", "add_n", inputs(U(2, 3), U(2, 3), U(2, 3)))
t("ElementWiseSum", "ElementWiseSum", inputs(U(2, 3), U(2, 3)))

for name, ins, kw in [
    ("take", inputs(U(5, 3), K([[0, 4], [-1, 7]], np.int32)), {}),
    ("take-wrap", inputs(U(3, 5), K([[0, 6], [-1, 2]], np.int32)), {"axis": 1, "mode": "wrap"}),
    ("batch_take", inputs(U(3, 4), K([3, 0, 2], np.int32)), {}),
    ("pick", inputs(U(3, 4), K([3, 0, 2], np.int32)), {"axis": 1}),
    ("gather_nd", inputs(U(3, 4), K([[0, 2, 1, 2, 0], [3, 0, 1, 1, 2]], np.int32)), {}),
    ("scatter_nd", inputs(U(5), K([[0, 2, 1, 2, 0], [3, 0, 1, 1, 2]], np.int32)),
     {"shape": (3, 4)}),
    ("where", inputs(I(3, 4, lo=0, hi=2), U(3, 4), U(3, 4)), {}),
    ("one_hot", inputs(K([0, 4, -1, 2], np.int32)),
     {"depth": 5, "on_value": 2.0, "off_value": -1.0}),
    ("shape_array", inputs(U(2, 3, 4)), {}),
    ("size_array", inputs(U(2, 3, 4)), {}),
    ("zeros_like", inputs(U(2, 3)), {}),
    ("ones_like", inputs(U(2, 3)), {}),
    ("full_like", inputs(U(2, 3)), {"fill_value": 3.5}),
    ("sort", inputs(I(3, 6, lo=0, hi=4)), {"axis": 1}),
    ("sort-desc", inputs(I(3, 6, lo=0, hi=4)), {"axis": 0, "is_ascend": False}),
    ("argsort", inputs(I(3, 6, lo=0, hi=4)), {}),
    ("argsort-desc", inputs(I(3, 6, lo=0, hi=4)), {"is_ascend": False, "dtype": "int32"}),
    ("topk", inputs(I(3, 6, lo=0, hi=4)), {"k": 3}),
    ("topk-value", inputs(I(3, 6, lo=0, hi=4)), {"k": 2, "ret_typ": "value", "axis": 0}),
    ("topk-both", inputs(I(3, 6, lo=0, hi=4)), {"k": 2, "ret_typ": "both",
                                                 "is_ascend": True}),
    ("topk-mask", inputs(I(3, 6, lo=0, hi=4)), {"k": 2, "ret_typ": "mask"}),
    ("identity", inputs(U(2, 3)), {}),
    ("make_loss", inputs(U(2, 3)), {}),
    ("BlockGrad", inputs(U(2, 3)), {}),
    ("stop_gradient", inputs(U(2, 3)), {}),
    ("choose_element_0index", inputs(U(3, 4), K([3, 0, 2], np.int32)), {}),
    ("fill_element_0index", inputs(U(3, 4), U(3), K([3, 0, 2], np.int32)), {}),
    ("one_hot_encode", inputs(K([0, 4, 1, 2], np.int32), U(4, 5)), {}),
    ("amp_cast", inputs(U(2, 3)), {"dtype": "float16"}),
    ("amp_cast-int", inputs(IDX(2, 3)), {"dtype": "float16"}),
    ("amp_multicast", inputs(U(2, 3), K([[1.5, -2.0, 0.25]], np.float16)),
     {"num_outputs": 2}),
    ("amp_multicast-narrow", inputs(U(2, 3), K([[1.5, -2.0, 0.25]], np.float16)),
     {"num_outputs": 2, "cast_narrow": True}),
    ("_contrib_boolean_mask", inputs(U(4, 3), K([1, 0, 2, 0], np.float32)), {}),
]:
    t(name, name.split("-")[0], ins, kw, card="exact")
t("smooth_l1", "smooth_l1", inputs(SU(3, 4, lo=0.05, hi=0.95)), {"scalar": 1.0})
t("smooth_l1-far", "smooth_l1", inputs(SU(3, 4, lo=1.05, hi=3.0)), {"scalar": 1.0})
t("hard_sigmoid", "hard_sigmoid", inputs(U(3, 4, lo=-4, hi=4)))

for name, scalar, maker in [
    ("_plus_scalar", 0.7, U(3, 4)), ("_minus_scalar", 0.7, U(3, 4)),
    ("_rminus_scalar", 0.7, U(3, 4)), ("_mul_scalar", 1.3, U(3, 4)),
    ("_div_scalar", 1.3, U(3, 4)), ("_rdiv_scalar", 1.3, SU(3, 4, lo=0.5)),
    ("_power_scalar", 2.5, U(3, 4, lo=0.2, hi=2)), ("_rpower_scalar", 1.5, U(3, 4)),
    ("_mod_scalar", 0.7, U(3, 4)), ("_rmod_scalar", 1.7, SU(3, 4, lo=0.4)),
    ("_maximum_scalar", 0.3, U(3, 4)), ("_minimum_scalar", 0.3, U(3, 4)),
    ("_hypot_scalar", 1.5, U(3, 4)),
]:
    t(name, name, inputs(maker), {"scalar": scalar},
      card="exact" if name in ("_maximum_scalar", "_minimum_scalar") else "ulp")
for name in ["_equal_scalar", "_not_equal_scalar", "_greater_scalar", "_greater_equal_scalar",
             "_lesser_scalar", "_lesser_equal_scalar", "_logical_and_scalar",
             "_logical_or_scalar", "_logical_xor_scalar"]:
    t(name, name, inputs(I(3, 4)), {"scalar": 1.0}, card="exact")
t("_plus_scalar-int", "_plus_scalar", inputs(IDX(3, 4, lo=-5, hi=5)), {"scalar": 2.7},
  card="exact")
t("_mul_scalar-bf16", "_mul_scalar", inputs(U(3, 4)), {"scalar": 0.1}, dtypes=("bfloat16",))
t("_sym_zeros", "_sym_zeros", inputs(), {"shape": (2, 3)}, card="exact")
t("_sym_ones", "_sym_ones", inputs(), {"shape": (2, 3), "dtype": "int32"}, card="exact")

# -- ops/nn.py --------------------------------------------------------------------

_N = []


def n(id_, op, ins, kw=None, card="reduce", dtypes=None):
    _N.append(Case(id_, op, "nn", ins, kw or {}, card, dtypes))


n("FullyConnected", "FullyConnected", inputs(U(3, 5), U(4, 5), U(4)), {"num_hidden": 4})
n("fully_connected", "fully_connected", inputs(U(2, 3, 2), U(4, 6), U(4)), {"num_hidden": 4})
n("Convolution", "Convolution", inputs(U(2, 3, 6, 6), U(4, 3, 3, 3), U(4)),
  {"kernel": (3, 3), "pad": (1, 1), "num_filter": 4})
n("Deconvolution", "Deconvolution", inputs(U(2, 3, 4, 4), U(3, 2, 3, 3)),
  {"kernel": (3, 3), "stride": (2, 2), "pad": (1, 1), "adj": (1, 1), "num_filter": 2})
n("Deconvolution-target", "Deconvolution", inputs(U(1, 4, 3, 3), U(4, 1, 3, 3), U(2)),
  {"kernel": (3, 3), "stride": (2, 2), "target_shape": (6, 6), "num_filter": 2,
   "num_group": 2, "no_bias": False})
n("Pooling", "Pooling", inputs(U(2, 3, 6, 6)), {"kernel": (2, 2), "stride": (2, 2)},
  card="exact")
n("Pooling-avg-full", "Pooling", inputs(U(2, 3, 5, 5)),
  {"kernel": (3, 3), "stride": (2, 2), "pad": (1, 1), "pool_type": "avg",
   "pooling_convention": "full", "count_include_pad": False})
n("BatchNorm", "BatchNorm", inputs(U(2, 3, 4, 4), U(3), U(3), U(3), U(3, lo=0.5)),
  {"fix_gamma": False})
n("BatchNorm-global", "BatchNorm", inputs(U(2, 3, 5), U(3), U(3), U(3), U(3, lo=0.5)),
  {"fix_gamma": False, "use_global_stats": True})
n("LayerNorm", "LayerNorm", inputs(U(3, 8), U(8), U(8)))
n("GroupNorm", "GroupNorm", inputs(U(2, 4, 3, 3), U(4), U(4)), {"num_groups": 2})
n("InstanceNorm", "InstanceNorm", inputs(U(2, 3, 4, 4), U(3), U(3)))
n("RMSNorm", "RMSNorm", inputs(U(3, 8), U(8)))
n("Activation", "Activation", inputs(U(3, 4)), {"act_type": "gelu"}, card="ulp")
n("Activation-softrelu", "Activation", inputs(U(3, 4)), {"act_type": "softrelu"}, card="ulp")
n("LeakyReLU", "LeakyReLU", inputs(SU(3, 4, lo=0.05)), {"act_type": "elu"}, card="ulp")
n("LeakyReLU-prelu", "LeakyReLU", inputs(SU(2, 3, 4, lo=0.05), U(3)),
  {"act_type": "prelu"}, card="ulp")
n("softmax", "softmax", inputs(U(3, 5)), {"temperature": 2.0})
n("softmax-length", "softmax", inputs(U(2, 5)), {"length": A(K([3, 5], np.int32))})
n("log_softmax", "log_softmax", inputs(U(3, 5)), {"axis": 0})
n("softmin", "softmin", inputs(U(3, 5)))
n("softmax_cross_entropy", "softmax_cross_entropy", inputs(U(4, 5), K([1, 0, 4, 2])))
n("SoftmaxOutput", "SoftmaxOutput", inputs(U(4, 5), K([1, 0, 4, 2])), {"grad_scale": 2.0})
n("SoftmaxOutput-ignore-valid", "SoftmaxOutput", inputs(U(4, 5), K([1, 0, 1, 2])),
  {"use_ignore": True, "ignore_label": 1, "normalization": "valid"})
n("SoftmaxOutput-valid", "SoftmaxOutput", inputs(U(4, 5), K([1, 0, 1, 2])),
  {"normalization": "valid"})
n("SoftmaxOutput-batch-multi", "SoftmaxOutput", inputs(U(2, 3, 4), K([[0, 2, 1, 1],
                                                                      [2, 2, 0, 1]])),
  {"multi_output": True, "normalization": "batch", "grad_scale": 0.5})
n("Softmax", "Softmax", inputs(U(4, 5), K([1, 0, 4, 2])), {"use_ignore": True,
                                                            "ignore_label": 4})
n("LinearRegressionOutput", "LinearRegressionOutput", inputs(U(4, 3), U(4, 3)),
  {"grad_scale": 0.5}, card="exact")
n("MakeLoss", "MakeLoss", inputs(U(3, 4)), card="exact")
n("Dropout", "Dropout", inputs(U(3, 4)), {"p": 0.5}, card="exact")
n("gather_positions", "gather_positions", inputs(U(2, 5, 3), K([[4, 0], [2, 2]], np.int32)),
  card="exact")
n("Embedding", "Embedding", inputs(IDX(2, 3, hi=6), U(6, 4)), {"input_dim": 6,
                                                              "output_dim": 4},
  card="exact")
n("UpSampling", "UpSampling", inputs(U(1, 2, 3, 3)), {"scale": 2}, card="exact")
n("UpSampling-bilinear", "UpSampling", inputs(U(1, 2, 3, 3)),
  {"scale": 2, "sample_type": "bilinear"})
n("SequenceMask", "SequenceMask", inputs(U(4, 2, 3), K([2, 4])),
  {"use_sequence_length": True, "value": -1.0}, card="exact")
n("SequenceMask-axis1", "SequenceMask", inputs(U(2, 4, 3), K([3, 1])),
  {"use_sequence_length": True, "axis": 1}, card="exact")
n("SequenceLast", "SequenceLast", inputs(U(4, 2, 3), K([3, 1])),
  {"use_sequence_length": True}, card="exact")
n("SequenceLast-axis1", "SequenceLast", inputs(U(2, 4, 3), K([2, 4])),
  {"use_sequence_length": True, "axis": 1}, card="exact")
n("SequenceReverse", "SequenceReverse", inputs(U(4, 2, 3), K([3, 2])),
  {"use_sequence_length": True}, card="exact")

CASES = _T + _N

# Inputs that are integer-valued positions, labels or lengths rather than
# data: no gradient is attached to them (every other float input gets one).
NO_GRAD_INPUTS = {
    "softmax_cross_entropy": (1,), "SoftmaxOutput": (1,), "Softmax": (1,),
    "where": (0,), "_contrib_boolean_mask": (1,), "SequenceMask": (1,),
    "SequenceLast": (1,), "SequenceReverse": (1,), "one_hot_encode": (1,),
}

# -- the rest of the op library: ops/spatial.py, ops/linalg.py, ops/quantization.py and
# the interleaved attention ops of ops/attention.py (``LIBRARY_CASES``) -----------------
#
# ``decomp``, a fourth card class: a decomposition, held by its reconstruction (and,
# for syevd, its eigenvectors row by row up to sign) rather than entry by entry.

_L = []


def lib(id_, op, src, ins, kw=None, card="reduce", dtypes=None):
    _L.append(Case(id_, op, src, ins, kw or {}, card, dtypes))


def I8(*shape):
    return lambda r: r.randint(-127, 128, shape).astype(np.int8)


def I32(*shape, lo=-2 ** 20, hi=2 ** 20):
    return lambda r: r.randint(lo, hi, shape).astype(np.int32)


def lower_tri(n, diag=2.0):
    """A well-conditioned lower-triangular matrix."""
    return lambda r: (np.tril(r.uniform(-0.5, 0.5, (n, n))) + diag * np.eye(n)).astype(np.float32)


def well_conditioned(*shape):
    n = shape[-1]
    return lambda r: (r.uniform(-0.5, 0.5, shape) + 2.0 * np.eye(n)).astype(np.float32)


def spd_batch(b, n):
    def make(r):
        a = r.uniform(-1, 1, (b, n, n))
        return (a @ a.transpose(0, 2, 1) + n * np.eye(n)).astype(np.float32)
    return make


def sp(id_, op, ins, kw=None, card="reduce", dtypes=None):
    lib(id_, op, "spatial", ins, kw, card, dtypes)


# layout shuffles and indices
sp("depth_to_space", "depth_to_space", inputs(U(2, 8, 3, 3)), {"block_size": 2}, card="exact")
sp("space_to_depth", "space_to_depth", inputs(U(2, 2, 4, 6)), {"block_size": 2}, card="exact")
sp("unravel_index", "unravel_index", inputs(K([5.0, 17.0, 0.0, 23.0])), {"shape": (2, 3, 4)},
   card="exact")
sp("ravel_multi_index", "ravel_multi_index", inputs(K([[1, 0, 2, 1], [2, 1, 3, 0]])),
   {"shape": (3, 4)}, card="exact")
sp("index_array", "index_array", inputs(U(2, 3)), card="exact")
sp("index_array-axes", "index_array", inputs(U(2, 3, 4)), {"axes": (2, 0)}, card="exact")
sp("index_copy", "index_copy", inputs(U(5, 3), K([0, 3], np.int32), U(2, 3)), card="exact")
sp("arange_like", "arange_like", inputs(U(2, 3)), {"start": 1.0, "step": 0.5, "repeat": 2},
   card="exact")
sp("arange_like-axis", "arange_like", inputs(U(2, 5)), {"start": -2.0, "axis": 1},
   card="exact")
_MASK = K([[1, 1, 0, 1, 0], [0, 0, 0, 0, 0], [1, 0, 1, 1, 1]], np.int32)
sp("masked_softmax", "masked_softmax", inputs(U(3, 5), _MASK), {"temperature": 2.0})
sp("masked_log_softmax", "masked_log_softmax", inputs(U(3, 5), _MASK))
sp("LRN", "LRN", inputs(U(2, 6, 3, 3)), {"nsize": 3, "alpha": 0.01})
# bilinear sampling
sp("BilinearSampler", "BilinearSampler",
   inputs(U(2, 3, 5, 6), U(2, 2, 4, 4, lo=-1.1, hi=1.1)))
sp("GridGenerator", "GridGenerator", inputs(U(2, 6)), {"target_shape": (4, 5)})
sp("GridGenerator-warp", "GridGenerator", inputs(U(2, 2, 4, 5)),
   {"transform_type": "warp", "target_shape": (4, 5)})
sp("SpatialTransformer", "SpatialTransformer", inputs(U(2, 3, 5, 6), U(2, 6, lo=-1, hi=1)),
   {"target_shape": (4, 4)})
sp("_contrib_BilinearResize2D", "_contrib_BilinearResize2D", inputs(U(2, 3, 4, 5)),
   {"height": 7, "width": 3})
sp("_contrib_BilinearResize2D-half", "_contrib_BilinearResize2D", inputs(U(2, 3, 4, 5)),
   {"scale_height": 2.0, "scale_width": 0.5, "align_corners": False})
sp("_contrib_AdaptiveAvgPooling2D", "_contrib_AdaptiveAvgPooling2D", inputs(U(2, 3, 7, 5)),
   {"output_size": (3, 2)})
# ROI ops
_ROIS = K([[0, 1, 1, 6, 5], [1, 0, 2, 7, 7], [0, 3.4, 2.6, 5.5, 7.2]])
sp("ROIPooling", "ROIPooling", inputs(U(2, 3, 8, 8), _ROIS), {"pooled_size": (2, 2)},
   card="exact")
sp("ROIPooling-scale", "ROIPooling", inputs(U(2, 3, 8, 8), _ROIS),
   {"pooled_size": (3, 2), "spatial_scale": 0.5}, card="exact")
sp("_contrib_ROIAlign", "_contrib_ROIAlign", inputs(U(2, 3, 8, 8), _ROIS),
   {"pooled_size": (3, 3), "spatial_scale": 0.5, "sample_ratio": 2})
sp("ROIAlign", "ROIAlign", inputs(U(2, 3, 8, 8), _ROIS),
   {"pooled_size": (2, 2), "sample_ratio": -1, "aligned": True})
# deformable ops
sp("_contrib_DeformableConvolution", "_contrib_DeformableConvolution",
   inputs(U(2, 4, 6, 6), U(2, 18, 4, 4, lo=-1, hi=1), U(5, 4, 3, 3), U(5)),
   {"kernel": (3, 3), "num_filter": 5})
sp("DeformableConvolution", "DeformableConvolution",
   inputs(U(2, 4, 6, 6), U(2, 36, 6, 6, lo=-1, hi=1), U(6, 2, 3, 3)),
   {"kernel": (3, 3), "pad": (1, 1), "num_filter": 6, "num_group": 2,
    "num_deformable_group": 2, "no_bias": True})
_PSROIS = K([[0, 1, 1, 12, 10], [1, 0, 2, 14, 15], [0, 3.4, 2.6, 9.5, 13.2]])
sp("_contrib_DeformablePSROIPooling", "_contrib_DeformablePSROIPooling",
   inputs(U(2, 18, 8, 8), _PSROIS, U(3, 2, 3, 3)),
   {"spatial_scale": 0.5, "output_dim": 2, "group_size": 3, "pooled_size": 3,
    "sample_per_part": 2, "trans_std": 0.1})
sp("DeformablePSROIPooling", "DeformablePSROIPooling", inputs(U(2, 8, 8, 8), _PSROIS),
   {"spatial_scale": 0.5, "output_dim": 2, "group_size": 2, "pooled_size": 4,
    "no_trans": True})
# correlation, im2col / col2im
sp("Correlation", "Correlation", inputs(U(2, 3, 8, 8), U(2, 3, 8, 8)),
   {"max_displacement": 2, "pad_size": 2})
sp("Correlation-k3", "Correlation", inputs(U(2, 3, 9, 9), U(2, 3, 9, 9)),
   {"kernel_size": 3, "max_displacement": 2, "stride1": 2, "stride2": 2, "pad_size": 2,
    "is_multiply": False})
sp("im2col", "im2col", inputs(U(2, 3, 5, 5)),
   {"kernel": (3, 3), "stride": (2, 2), "pad": (1, 1)}, card="exact")
sp("col2im", "col2im", inputs(U(2, 27, 9)),
   {"output_size": (5, 5), "kernel": (3, 3), "stride": (2, 2), "pad": (1, 1)})
# output heads
sp("SVMOutput", "SVMOutput", inputs(U(4, 5), K([1, 0, 4, 2])), {"margin": 0.5},
   card="exact")
sp("SVMOutput-linear", "SVMOutput", inputs(U(4, 5), K([3, 0, 1, 2])),
   {"use_linear": True, "regularization_coefficient": 0.5}, card="exact")
sp("MAERegressionOutput", "MAERegressionOutput", inputs(U(4, 3), U(4, 3)),
   {"grad_scale": 0.5}, card="exact")
sp("LogisticRegressionOutput", "LogisticRegressionOutput",
   inputs(U(4, 3), U(4, 3, lo=0, hi=1)), {"grad_scale": 2.0}, card="ulp")
# CTC
_CTC_LAB = K([[1, 2, 0], [3, 3, 1], [2, 0, 0]])
sp("CTCLoss", "CTCLoss", inputs(U(6, 3, 5), _CTC_LAB))
sp("CTCLoss-last", "CTCLoss", inputs(U(6, 3, 5), K([[0, 1, -1], [2, 2, 0], [1, -1, -1]])),
   {"blank_label": "last"})
sp("CTCLoss-lengths", "CTCLoss", inputs(U(6, 3, 5), _CTC_LAB, K([6, 4, 5]), K([2, 3, 1])),
   {"use_data_lengths": True, "use_label_lengths": True})
sp("CTCLoss-impossible", "CTCLoss", inputs(U(2, 2, 4), K([[1, 2, 3], [1, 1, 0]])))
sp("ctc_loss", "ctc_loss", inputs(U(5, 2, 4), K([[1, 2], [3, 0]])))
sp("_contrib_CTCLoss", "_contrib_CTCLoss", inputs(U(5, 2, 4), K([[0, 2], [1, -1]])),
   {"blank_label": "last"})
sp("_contrib_ctc_loss", "_contrib_ctc_loss", inputs(U(5, 2, 4), K([[1, 3], [2, 2]]),
                                                    K([5, 3])), {"use_data_lengths": True})
sp("Crop", "Crop", inputs(U(2, 3, 6, 7)), {"h_w": (3, 4), "offset": (1, 2)}, card="exact")
sp("Crop-center", "Crop", inputs(U(2, 3, 6, 7)), {"h_w": (3, 4), "center_crop": True},
   card="exact")
sp("Crop-like", "Crop", inputs(U(2, 3, 6, 7), U(1, 1, 4, 5)), card="exact")


def la(id_, op, ins, kw=None, card="reduce"):
    lib(id_, op, "linalg", ins, kw, card)


la("linalg_gemm", "linalg_gemm", inputs(U(2, 3, 4), U(2, 5, 4), U(2, 3, 5)),
   {"transpose_b": True, "alpha": 0.5, "beta": 2.0})
la("linalg_gemm-ta", "linalg_gemm", inputs(U(4, 3), U(4, 2), U(3, 2)), {"transpose_a": True})
la("linalg_potri", "linalg_potri", inputs(lower_tri(3)))
la("linalg_potri-upper", "linalg_potri", inputs(lambda r: lower_tri(4)(r).T.copy()),
   {"lower": False})
la("linalg_trmm", "linalg_trmm", inputs(U(3, 3), U(3, 4)), {"alpha": 2.0})
la("linalg_trmm-right-t", "linalg_trmm", inputs(U(3, 3), U(4, 3)),
   {"transpose": True, "rightside": True, "lower": False})
la("linalg_trsm", "linalg_trsm", inputs(lower_tri(3), U(3, 4)), {"alpha": 0.5})
la("linalg_trsm-right-t", "linalg_trsm", inputs(lower_tri(3), U(4, 3)),
   {"transpose": True, "rightside": True})
la("linalg_trsm-upper", "linalg_trsm", inputs(lambda r: lower_tri(3)(r).T.copy(), U(3, 2)),
   {"lower": False, "transpose": True})
la("linalg_sumlogdiag", "linalg_sumlogdiag", inputs(spd_batch(2, 3)))
la("linalg_extractdiag", "linalg_extractdiag", inputs(U(2, 4, 4)), {"offset": 1},
   card="exact")
la("linalg_makediag", "linalg_makediag", inputs(U(2, 3)), {"offset": -1}, card="exact")
la("linalg_extracttrian", "linalg_extracttrian", inputs(U(4, 4)), card="exact")
la("linalg_extracttrian-upper", "linalg_extracttrian", inputs(U(2, 4, 4)),
   {"offset": 1, "lower": False}, card="exact")
la("linalg_maketrian", "linalg_maketrian", inputs(U(6)), card="exact")
la("linalg_maketrian-upper", "linalg_maketrian", inputs(U(2, 6)),
   {"offset": 1, "lower": False}, card="exact")
la("linalg_gelqf", "linalg_gelqf", inputs(U(3, 5)), card="decomp")
la("linalg_syevd", "linalg_syevd", inputs(spd_batch(2, 4)), card="decomp")
la("linalg_inverse", "linalg_inverse", inputs(well_conditioned(2, 3, 3)))
la("linalg_det", "linalg_det", inputs(well_conditioned(2, 3, 3)))
la("linalg_slogdet", "linalg_slogdet", inputs(well_conditioned(3, 3)))
la("khatri_rao", "khatri_rao", inputs(U(2, 3), U(4, 3), U(2, 3)))
la("moments", "moments", inputs(U(3, 4, 5)), {"axes": (0, 2)})
la("moments-keep", "moments", inputs(U(3, 4, 5)), {"axes": (1,), "keepdims": True})


def qz(id_, op, ins, kw=None, card="exact", dtypes=None):
    lib(id_, op, "quantization", ins, kw, card, dtypes)


_R = K([-1.5]), K([2.0])
qz("quantize_v2", "quantize_v2", inputs(U(3, 4)))
qz("quantize_v2-calib", "quantize_v2", inputs(U(3, 4)),
   {"min_calib_range": -1.5, "max_calib_range": 1.2})
qz("dequantize", "dequantize", inputs(I8(3, 4), *_R), card="ulp")
qz("requantize", "requantize", inputs(I32(3, 4), K([-0.001]), K([0.002])))
qz("requantize-calib", "requantize", inputs(I32(3, 4), K([-0.001]), K([0.002])),
   {"min_calib_range": -500.0, "max_calib_range": 400.0})
qz("quantized_fully_connected", "quantized_fully_connected",
   inputs(I8(3, 5), I8(4, 5), U(4), *_R, K([-0.5]), K([0.25])), {"num_hidden": 4},
   card="ulp")
qz("quantized_fully_connected-flatten", "quantized_fully_connected",
   inputs(I8(2, 3, 2), I8(4, 6), U(4), *_R, K([-0.5]), K([0.25])),
   {"num_hidden": 4, "no_bias": True}, card="ulp")
qz("quantized_conv", "quantized_conv",
   inputs(I8(2, 3, 6, 6), I8(4, 3, 3, 3), U(4), *_R, K([-0.5]), K([0.25])),
   {"kernel": (3, 3), "pad": (1, 1), "num_filter": 4}, card="ulp")
qz("quantized_conv-groups", "quantized_conv",
   inputs(I8(2, 4, 7, 7), I8(6, 2, 3, 3), U(6), *_R, K([-0.5]), K([0.25])),
   {"kernel": (3, 3), "stride": (2, 2), "num_filter": 6, "num_group": 2}, card="ulp")
qz("quantize", "quantize", inputs(U(3, 4), K([-1.0]), K([1.5])))
qz("quantize-int8", "quantize", inputs(U(3, 4), K([-1.0]), K([1.5])), {"out_type": "int8"})


def il(id_, op, ins, kw=None, dtypes=None):
    lib(id_, op, "interleaved", ins, kw, "reduce", dtypes)


_QKV, _ATT = U(5, 2, 2 * 3 * 4), U(2 * 2, 5, 5, lo=0, hi=1)
_Q, _KV, _XATT = U(3, 2, 2 * 4), U(5, 2, 2 * 2 * 4), U(2 * 2, 3, 5, lo=0, hi=1)
for tag, dt in (("", None), ("-bf16", "bfloat16")):
    il("_contrib_interleaved_matmul_selfatt_qk" + tag, "_contrib_interleaved_matmul_selfatt_qk",
       inputs(_QKV), {"heads": 2}, dtypes=dt and (dt,))
    il("_contrib_interleaved_matmul_selfatt_valatt" + tag,
       "_contrib_interleaved_matmul_selfatt_valatt", inputs(_QKV, _ATT), {"heads": 2},
       dtypes=dt and (dt, dt))
    il("_contrib_interleaved_matmul_encdec_qk" + tag, "_contrib_interleaved_matmul_encdec_qk",
       inputs(_Q, _KV), {"heads": 2}, dtypes=dt and (dt, dt))
    il("_contrib_interleaved_matmul_encdec_valatt" + tag,
       "_contrib_interleaved_matmul_encdec_valatt", inputs(_KV, _XATT), {"heads": 2},
       dtypes=dt and (dt, dt))

LIBRARY_CASES = _L

NO_GRAD_INPUTS.update({
    "index_copy": (1,), "masked_softmax": (1,), "masked_log_softmax": (1,),
    "ROIPooling": (1,), "_contrib_ROIAlign": (1,), "ROIAlign": (1,),
    "_contrib_DeformablePSROIPooling": (1,), "DeformablePSROIPooling": (1,),
    "SVMOutput": (1,), "MAERegressionOutput": (1,), "LogisticRegressionOutput": (1,),
    "CTCLoss": (1, 2, 3), "ctc_loss": (1, 2, 3), "_contrib_CTCLoss": (1, 2, 3),
    "_contrib_ctc_loss": (1, 2, 3), "Crop": (1,), "ravel_multi_index": (0,),
    "unravel_index": (0,),
})


def decomp_ratio(case, arrays, got, ref, units):
    """A ``decomp`` case's error over its bound (numpy; 0 is exact, above 1
    fails): ``got`` and ``ref`` the two runs' outputs as float64 arrays,
    ``units`` the bound's ulps of the input's largest |value|.  gelqf:
    L·Q against A, Q·Qᵀ against I, diag(L) ≥ 0 and Q, L against ``ref``;
    syevd: Uᵀ·diag(λ)·U against A, λ against ``ref``'s and U's rows against
    ``ref``'s up to sign."""
    a = np.asarray(arrays[0], np.float64)
    eps = float(np.finfo(np.float32).eps)
    scale = max(float(np.abs(a).max()), 1e-30)

    def over(err, s=scale):
        return float(err) / (units * eps * s)

    if case.op == "linalg_gelqf":
        q, l = got
        if (np.diagonal(l, axis1=-2, axis2=-1) < 0).any():
            return np.inf
        eye = np.eye(q.shape[-2])
        return max(over(np.abs(l @ q - a).max()), over(np.abs(q @ np.swapaxes(q, -1, -2)
                                                               - eye).max(), 1.0),
                   over(np.abs(q - ref[0]).max(), 1.0), over(np.abs(l - ref[1]).max()))
    if case.op == "linalg_syevd":
        u, lam = got
        rec = np.swapaxes(u, -1, -2) @ (lam[..., :, None] * u)
        sign = np.sign((u * ref[0]).sum(-1, keepdims=True))
        return max(over(np.abs(rec - a).max()), over(np.abs(lam - ref[1]).max()),
                   over(np.abs(u * sign - ref[0]).max(), 1.0))
    raise ValueError(f"no decomposition check for {case.op}")


# -- ops/random_ops.py ----------------------------------------------------------------


def _rows(*cols):
    return lambda n: [np.asarray(c, np.float32) for c in cols]


def _gnb_moments(mu, alpha):
    return mu, mu + alpha * mu * mu


def _multinomial_moments(p):
    p = np.asarray(p, np.float64) / np.sum(p)
    i = np.arange(len(p))
    m = float((i * p).sum())
    return m, float((i * i * p).sum() - m * m)


_P = [[0.1, 0.2, 0.3, 0.4, 0.0], [0.5, 0.0, 0.25, 0.25, 0.0]]

SAMPLERS = [
    Sampler("_random_uniform", "_random_uniform", lambda n: [],
            lambda n: {"low": -1.0, "high": 3.0, "shape": (n,)}, [(1.0, 16.0 / 12)]),
    Sampler("_random_normal", "_random_normal", lambda n: [],
            lambda n: {"loc": 0.5, "scale": 2.0, "shape": (n,)}, [(0.5, 4.0)]),
    Sampler("_random_gamma", "_random_gamma", lambda n: [],
            lambda n: {"alpha": 2.5, "beta": 1.5, "shape": (n,)}, [(3.75, 5.625)]),
    Sampler("_random_exponential", "_random_exponential", lambda n: [],
            lambda n: {"lam": 2.0, "shape": (n,)}, [(0.5, 0.25)]),
    Sampler("_random_poisson", "_random_poisson", lambda n: [],
            lambda n: {"lam": 3.5, "shape": (n,)}, [(3.5, 3.5)]),
    Sampler("_random_negative_binomial", "_random_negative_binomial", lambda n: [],
            lambda n: {"k": 3, "p": 0.4, "shape": (n,)}, [(4.5, 11.25)]),
    Sampler("_random_generalized_negative_binomial", "_random_generalized_negative_binomial",
            lambda n: [], lambda n: {"mu": 2.0, "alpha": 0.5, "shape": (n,)},
            [_gnb_moments(2.0, 0.5)]),
    Sampler("_random_randint", "_random_randint", lambda n: [],
            lambda n: {"low": -3, "high": 5, "shape": (n,)}, [(0.5, (64 - 1) / 12.0)]),
    Sampler("_random_uniform_like", "_random_uniform_like",
            lambda n: [np.zeros(n, np.float32)], lambda n: {"low": 2.0, "high": 4.0},
            [(3.0, 4.0 / 12)]),
    Sampler("_random_normal_like", "_random_normal_like",
            lambda n: [np.zeros(n, np.float32)], lambda n: {"loc": -1.0, "scale": 0.5},
            [(-1.0, 0.25)]),
    Sampler("_sample_uniform", "_sample_uniform", _rows([0.0, -2.0], [1.0, 2.0]),
            lambda n: {"shape": (n // 2,)}, [(0.5, 1 / 12.0), (0.0, 16 / 12.0)]),
    Sampler("_sample_normal", "_sample_normal", _rows([0.0, 3.0], [1.0, 0.5]),
            lambda n: {"shape": (n // 2,)}, [(0.0, 1.0), (3.0, 0.25)]),
    Sampler("_sample_gamma", "_sample_gamma", _rows([0.7, 4.0], [2.0, 0.5]),
            lambda n: {"shape": (n // 2,)}, [(1.4, 2.8), (2.0, 1.0)]),
    Sampler("_sample_exponential", "_sample_exponential", _rows([1.0, 4.0]),
            lambda n: {"shape": (n // 2,)}, [(1.0, 1.0), (0.25, 0.0625)]),
    Sampler("_sample_poisson", "_sample_poisson", _rows([1.5, 9.0]),
            lambda n: {"shape": (n // 2,)}, [(1.5, 1.5), (9.0, 9.0)]),
    Sampler("_sample_negative_binomial", "_sample_negative_binomial",
            _rows([2.0, 5.0], [0.5, 0.25]), lambda n: {"shape": (n // 2,)},
            [(2.0, 4.0), (15.0, 60.0)]),
    Sampler("_sample_generalized_negative_binomial", "_sample_generalized_negative_binomial",
            _rows([2.0, 4.0], [0.0, 0.25]), lambda n: {"shape": (n // 2,)},
            [_gnb_moments(2.0, 0.0), _gnb_moments(4.0, 0.25)]),
    Sampler("_sample_multinomial", "_sample_multinomial", lambda n: [np.asarray(_P, np.float32)],
            lambda n: {"shape": (n // 2,)}, [_multinomial_moments(p) for p in _P]),
    Sampler("shuffle", "shuffle", lambda n: [np.arange(n, dtype=np.float32)], lambda n: {},
            None),
]


def displacement(perm):
    """|perm[i] − i| of a permutation of arange(n), the statistic the
    shuffles are compared by (its distribution is that of a uniform random
    permutation's displacements)."""
    perm = np.asarray(perm).reshape(-1)
    return np.abs(perm - np.arange(perm.size))
