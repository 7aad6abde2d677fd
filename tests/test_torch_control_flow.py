"""``nd.contrib.foreach``, ``while_loop`` and ``cond`` in the port against
the JAX package, on the CPU, fp32 within 1e-5 (values) and 1e-4
(gradients).

* Values and the gradients of the explicit inputs (``data``,
  ``init_states``, ``loop_vars``) under ``autograd.record``, eager in both
  packages.
* Closure gradients: the port's eager loop gives the arrays a body closes
  over their gradients (the reference's behaviour); the JAX package gives
  them only under ``hybridize``, so they are held to a hybridized JAX
  block's parameter gradients (ROADMAP §3, differences by design).
* ``while_loop``: the masked form (per-step outputs: rows past the stop
  are zeros, loop variables frozen) and the early exit (no outputs, no
  tape).  ``cond`` both ways.
"""
import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as mxj
import incubator_mxnet_torch as mx

VAL = dict(rtol=1e-5, atol=1e-5)
GRAD = dict(rtol=1e-4, atol=1e-4)

R = np.random.RandomState(0)
X = R.randn(5, 3, 4).astype(np.float32)
H0 = R.randn(3, 4).astype(np.float32)
C0 = R.randn(3, 4).astype(np.float32)
W = (R.randn(4, 4) * 0.5).astype(np.float32)
U = (R.randn(4, 4) * 0.5).astype(np.float32)


def _arrays(pkg, *xs, grad=True):
    out = []
    for x in xs:
        a = pkg.nd.array(x, ctx=pkg.cpu())
        if grad:
            a.attach_grad()
        out.append(a)
    return out


def _np(a):
    return a.asnumpy()


def _foreach(pkg, w, u):
    x, h0, c0 = _arrays(pkg, X, H0, C0)

    def body(xt, states):
        h, c = states
        hn = pkg.nd.tanh(pkg.nd.dot(xt, w) + pkg.nd.dot(h, u)) + 0.5 * c
        return [hn, hn * 2.0], [hn, c * 0.9]

    with pkg.autograd.record():
        outs, states = pkg.nd.contrib.foreach(body, x, [h0, c0])
        loss = (outs[0] * 1.5).sum() + outs[1].sum() + (states[0] * states[1]).sum()
    loss.backward()
    return outs, states, (x, h0, c0)


def test_foreach_values_and_input_gradients():
    jw, ju = _arrays(mxj, W, U, grad=False)
    tw, tu = _arrays(mx, W, U, grad=False)
    jo, js, jin = _foreach(mxj, jw, ju)
    with mx.cpu():
        to, ts, tin = _foreach(mx, tw, tu)
    for a, b in zip(to + ts, jo + js):
        np.testing.assert_allclose(_np(a), _np(b), **VAL)
    for a, b in zip(tin, jin):
        np.testing.assert_allclose(_np(a.grad), _np(b.grad), **GRAD)


class _JaxScan(mxj.gluon.HybridBlock):
    def __init__(self, **kw):
        super().__init__(**kw)
        with self.name_scope():
            self.w = self.params.get("w", shape=(4, 4))
            self.u = self.params.get("u", shape=(4, 4))

    def hybrid_forward(self, F, x, h0, w, u):
        def body(xt, h):
            hn = F.tanh(F.dot(xt, w) + F.dot(h, u))
            return hn, hn

        outs, h = F.contrib.foreach(body, x, h0)
        return outs.sum() + (h * h).sum()


class _PortScan(mx.gluon.HybridBlock):
    def __init__(self, **kw):
        super().__init__(**kw)
        with self.name_scope():
            self.w = self.params.get("w", shape=(4, 4))
            self.u = self.params.get("u", shape=(4, 4))

    def hybrid_forward(self, F, x, h0, w, u):
        def body(xt, h):
            hn = F.tanh(F.dot(xt, w) + F.dot(h, u))
            return hn, hn

        outs, h = F.contrib.foreach(body, x, h0)
        return outs.sum() + (h * h).sum()


def test_foreach_closure_gradients_equal_the_jax_hybridized_ones():
    j = _JaxScan()
    j.initialize()
    j.w.set_data(mxj.nd.array(W))
    j.u.set_data(mxj.nd.array(U))
    j.hybridize()
    t = _PortScan()
    t.initialize(ctx=mx.cpu())
    t.w.set_data(torch.from_numpy(W))
    t.u.set_data(torch.from_numpy(U))
    with mxj.autograd.record():
        jl = j(mxj.nd.array(X), mxj.nd.array(H0))
    jl.backward()
    with mx.autograd.record():
        tl = t(torch.from_numpy(X), torch.from_numpy(H0))
    mx.autograd.backward(tl)
    np.testing.assert_allclose(tl.item(), float(jl.asnumpy()), **VAL)
    for name in ("w", "u"):
        got = getattr(t, name).grad().numpy()
        want = getattr(j, name).grad().asnumpy()
        assert np.abs(want).max() > 0
        np.testing.assert_allclose(got, want, **GRAD)


def _while(pkg, stop, outputs=True, record=True):
    i0, s0 = _arrays(pkg, np.array([0.0], np.float32), np.array([1.0, 2.0], np.float32))

    def cond_fn(i, s):
        return i < stop

    def func(i, s):
        s2 = s * 1.5 + i
        return ([s2 * 2.0] if outputs else []), [i + 1, s2]

    if record:
        with pkg.autograd.record():
            outs, (i, s) = pkg.nd.contrib.while_loop(cond_fn, func, [i0, s0],
                                                     max_iterations=6)
            loss = s.sum() + (outs.sum() if outputs else 0.0)
        loss.backward()
    else:
        outs, (i, s) = pkg.nd.contrib.while_loop(cond_fn, func, [i0, s0], max_iterations=6)
    return outs, i, s, s0


@pytest.mark.parametrize("stop", [3.0, 10.0, 0.0])
def test_while_loop_masked_form(stop):
    jo, ji, js, js0 = _while(mxj, stop)
    with mx.cpu():
        to, ti, ts, ts0 = _while(mx, stop)
    assert to.shape == (6, 2)
    np.testing.assert_allclose(_np(to), _np(jo), **VAL)
    done = int(min(stop, 6))
    assert (_np(to)[done:] == 0).all()
    np.testing.assert_allclose(_np(ti), _np(ji), **VAL)
    np.testing.assert_allclose(_np(ts), _np(js), **VAL)
    np.testing.assert_allclose(_np(ts0.grad), _np(js0.grad), **GRAD)


@pytest.mark.parametrize("stop", [3.0, 10.0])
def test_while_loop_early_exit(stop):
    _, ji, js, _ = _while(mxj, stop, outputs=False, record=False)
    with mx.cpu():
        to, ti, ts, _ = _while(mx, stop, outputs=False, record=False)
    assert to == []
    np.testing.assert_allclose(_np(ti), _np(ji), **VAL)
    np.testing.assert_allclose(_np(ts), _np(js), **VAL)


def test_while_loop_requires_max_iterations():
    with pytest.raises(ValueError, match="max_iterations"):
        mx.nd.contrib.while_loop(lambda i: i < 3, lambda i: ([], [i + 1]), [torch.zeros(1)])


@pytest.mark.parametrize("flag", [1.0, 0.0])
def test_cond_both_ways(flag):
    a, b = R.randn(3).astype(np.float32), R.randn(3).astype(np.float32)

    def run(pkg):
        x, y = pkg.nd.array(a, ctx=pkg.cpu()), pkg.nd.array(b, ctx=pkg.cpu())
        p = pkg.nd.array(np.array([flag], np.float32), ctx=pkg.cpu())
        return pkg.nd.contrib.cond(p, lambda: [x * y, x + 1.0], lambda: [x - y, y * 2.0])

    with mx.cpu():
        got = run(mx)
    want = run(mxj)
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), _np(w), **VAL)


def test_cond_closure_gradient_reaches_the_taken_branch():
    x = mx.nd.array(np.array([1.0, 2.0], np.float32), ctx=mx.cpu())
    x.attach_grad()
    p = mx.nd.array(np.array([1.0], np.float32), ctx=mx.cpu())
    with mx.autograd.record():
        out = mx.nd.contrib.cond(p, lambda: x * 3.0, lambda: x * 5.0)
    out.backward()
    assert x.grad.asnumpy().tolist() == [3.0, 3.0]
