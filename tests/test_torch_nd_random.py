"""The port's samplers against the JAX package's, on the CPU.

``ops/random_ops.py`` (every ``_random_*``/``_sample_*`` op and ``shuffle``)
and ``mx.random``: output shapes, dtypes and devices, reproducibility after
``mx.random.seed``, and each sampler against the JAX one in distribution,
``scipy.stats.ks_2samp`` over 10^5 fixed-seed draws from each package
(each row of a ``_sample_*`` draw on its own), p > 1e-3.  Shuffles are
compared by their displacements |perm[i] − i|.  The entry points run on
the current context: on a machine with no card, ``mx.random.uniform``
outside ``with mx.cpu():`` raises, as every entry point does.
"""
import numpy as np
import pytest
import torch
from scipy import stats

import incubator_mxnet_tpu as mxj
import incubator_mxnet_torch as mx

import nd_op_cases as C
import nd_parity as P

N = 100_000
P_MIN = 1e-3
SAMPLERS = {s.id: s for s in C.SAMPLERS}


def _rows(x):
    a = x.asnumpy() if hasattr(x, "asnumpy") else x.numpy()
    a = np.asarray(a, np.float64)
    return a.reshape(-1, a.shape[-1]) if a.ndim > 1 else a.reshape(1, -1)


def _draw(pkg, s, n, seed):
    pkg.random.seed(seed)
    args = [pkg.nd.array(a) for a in s.args(n)]
    return getattr(pkg.nd, s.op)(*args, **s.kwargs(n))


def _port_draw(s, n, seed):
    with mx.cpu():
        return _draw(mx, s, n, seed)


def test_registry_has_every_name_of_the_jax_file():
    P.check_registry("random_ops")
    assert set(SAMPLERS) == P.jax_names("random_ops")


@pytest.mark.parametrize("sid", sorted(SAMPLERS))
def test_sampler_matches_jax_in_distribution(sid):
    s = SAMPLERS[sid]
    n = 2 * N if s.moments and len(s.moments) == 2 else N
    got, ref = _port_draw(s, n, 3), _draw(mxj, s, n, 3)
    if s.moments is None:  # shuffle: a permutation, compared by displacement
        g, r = _rows(got)[0], _rows(ref)[0]
        assert np.array_equal(np.sort(g), np.arange(N))
        got_rows, ref_rows = [C.displacement(g)], [C.displacement(r)]
    else:
        got_rows, ref_rows = _rows(got), _rows(ref)
    assert len(got_rows) == len(ref_rows)
    for g, r in zip(got_rows, ref_rows):
        assert g.size >= N and r.size >= N
        assert stats.ks_2samp(g, r).pvalue > P_MIN


@pytest.mark.parametrize("sid", sorted(SAMPLERS))
def test_sampler_shape_dtype_device_and_seed(sid):
    s = SAMPLERS[sid]
    a, b, c = _port_draw(s, 8, 5), _port_draw(s, 8, 5), _port_draw(s, 8, 6)
    ref = _draw(mxj, s, 8, 5)
    for x, y in ((a, ref),):
        xs, ys = (x if isinstance(x, list) else [x]), (y if isinstance(y, list) else [y])
        for u, v in zip(xs, ys):
            assert tuple(u.shape) == tuple(v.shape)
            assert P._name(u) == P._name(v)
    first = a[0] if isinstance(a, list) else a
    data = first._data if isinstance(first, mx.nd.NDArray) else first
    assert data.device == torch.device("cpu")
    flat = [P._np(x) for x in (a if isinstance(a, list) else [a])]
    assert all(np.array_equal(u, P._np(v)) for u, v in zip(flat, b if isinstance(b, list) else [b]))
    assert not all(np.array_equal(u, P._np(v)) for u, v in zip(flat, c if isinstance(c, list) else [c]))


def test_samplers_draw_from_the_port_generator_not_the_global_one():
    with mx.cpu():
        mx.random.seed(9)
        want = mx.nd._random_normal(shape=(6,))
        mx.random.seed(9)
        torch.manual_seed(1234)
        torch.randn(10)  # PyTorch's global stream moves; the port's does not
        got = mx.nd._random_normal(shape=(6,))
        gen = torch.Generator().manual_seed(9)
        key = mx.nd._random_normal(shape=(6,), key=gen)
    assert torch.equal(got, want) and torch.equal(key, want)


# -- mx.random --------------------------------------------------------------------

RANDOM = [
    ("uniform", dict(low=-1.0, high=2.0)), ("normal", dict(loc=1.0, scale=0.5)),
    ("gamma", dict(alpha=2.0, beta=0.5)), ("exponential", dict(scale=2.0)),
    ("poisson", dict(lam=4.0)), ("negative_binomial", dict(k=3, p=0.3)),
    ("generalized_negative_binomial", dict(mu=3.0, alpha=0.4)),
    ("randint", dict(low=-4, high=6)),
]


def _jax_poisson(lam, shape):
    """The JAX package's ``mx.random.poisson`` raises under its default
    ``rbg`` PRNG (``jax.random.poisson`` takes threefry keys only); its
    registered ``_random_poisson`` op, which folds the key into a threefry
    one, draws the same distribution."""
    return mxj.nd._random_poisson(lam=lam, shape=shape)


@pytest.mark.parametrize("name,kw", RANDOM, ids=[r[0] for r in RANDOM])
def test_mx_random_matches_jax(name, kw):
    mx.random.seed(2)
    mxj.random.seed(2)
    with mx.cpu():
        got = getattr(mx.random, name)(shape=(N,), **kw)
    ref = (_jax_poisson if name == "poisson" else getattr(mxj.random, name))(shape=(N,), **kw)
    assert isinstance(got, mx.nd.NDArray) and got.context == mx.cpu()
    assert P._name(got) == P._name(ref) and got.shape == ref.shape
    assert stats.ks_2samp(got.asnumpy(), ref.asnumpy()).pvalue > P_MIN


def test_mx_random_randn_multinomial_shuffle():
    mx.random.seed(4)
    mxj.random.seed(4)
    with mx.cpu():
        g = mx.random.randn(N)
        probs = mx.nd.array([0.2, 0.5, 0.3])
        m, logp = mx.random.multinomial(probs, shape=(N,), get_prob=True)
        rows = mx.random.multinomial(mx.nd.array([[0.2, 0.8], [1.0, 0.0]]), shape=(5,))
        perm = mx.random.shuffle(mx.nd.arange(N))
    r = mxj.random.randn(N)
    rm = mxj.random.multinomial(mxj.nd.array([0.2, 0.5, 0.3]), shape=(N,))
    rperm = mxj.random.shuffle(mxj.nd.arange(N))
    assert stats.ks_2samp(g.asnumpy(), r.asnumpy()).pvalue > P_MIN
    assert m.dtype == np.int32 and m.shape == (N,)
    assert stats.ks_2samp(m.asnumpy(), rm.asnumpy()).pvalue > P_MIN
    np.testing.assert_allclose(logp.asnumpy(), np.log(np.array([0.2, 0.5, 0.3]))[m.asnumpy()],
                               rtol=1e-6)
    assert rows.shape == (2, 5) and (rows.asnumpy()[1] == 0).all()
    assert np.array_equal(np.sort(perm.asnumpy()), np.arange(N))
    assert stats.ks_2samp(C.displacement(perm.asnumpy()),
                          C.displacement(rperm.asnumpy())).pvalue > P_MIN


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")


@pytest.mark.parametrize("name", ["uniform", "normal"])
def test_default_context_is_the_card(name, no_card):
    """Outside ``with mx.cpu():`` the current context is the card, which
    this machine lacks: the call raises rather than draw on the CPU."""
    with pytest.raises(mx.MXNetError, match="CUDA device"):
        getattr(mx.random, name)(shape=(2,))


@pytest.mark.parametrize("name", ["uniform", "normal"])
def test_cpu_context_draws_on_the_cpu(name):
    with mx.cpu():
        x = getattr(mx.random, name)(shape=(2,), dtype="float16")
    assert isinstance(x, mx.nd.NDArray) and x.context == mx.cpu()
    assert x.dtype == np.float16 and x.shape == (2,)
    out = mx.nd.zeros((3,), ctx=mx.cpu())
    y = getattr(mx.random, name)(shape=(3,), out=out)
    assert y is out and out.context == mx.cpu() and out.asnumpy().any()
    with mx.cpu():
        legacy = getattr(mx.nd, f"random_{name}")(shape=(2,))
    assert isinstance(legacy, mx.nd.NDArray)
