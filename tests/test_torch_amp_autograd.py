"""Dynamic loss scaling and ``autograd.grad`` of the port against the JAX
package, on the CPU.

``amp.LossScaler``/``scale_loss``/``init_trainer``/``unscale`` drive the
same small network with the same seeded weights and batches in both
packages, with overflows forced by the loss scale: the loss-scale sequence
is equal, a skipped step changes no weight, state or update count, and the
weights agree to fp32 tolerance.  ``autograd.grad`` is held to the JAX one
to first and second order, the second through the plain attention on the
CPU; on the card the attention kernels refuse a second order, which a
``cuda`` test checks.
"""
import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as mxj
import incubator_mxnet_torch as mx
from incubator_mxnet_torch.convert import load_numpy_params

FP32_TOL = dict(rtol=1e-5, atol=1e-6)


def _nets(seed=0):
    """A 2-layer MLP in each package with the same weights."""
    mxj.random.seed(seed)
    j = mxj.gluon.nn.HybridSequential()
    with j.name_scope():
        j.add(mxj.gluon.nn.Dense(16, activation="relu"), mxj.gluon.nn.Dense(3))
    j.initialize()
    j(mxj.nd.zeros((1, 8)))
    t = mx.gluon.nn.HybridSequential()
    with t.name_scope():
        t.add(mx.gluon.nn.Dense(16, activation="relu"), mx.gluon.nn.Dense(3))
    t.initialize(ctx=mx.cpu())
    load_numpy_params(t, {k: p.data().asnumpy() for k, p in j._collect_params_with_prefix().items()})
    return j, t


def _batches(n, seed=1):
    rng = np.random.RandomState(seed)
    return [(rng.randn(4, 8).astype(np.float32), rng.randn(4, 3).astype(np.float32))
            for _ in range(n)]


def test_loss_scaler_schedule_matches_jax():
    t, j = mx.amp.LossScaler(init_scale=8.0, scale_window=3), mxj.amp.LossScaler(
        init_scale=8.0, scale_window=3)
    for overflow in (False, False, False, True, False, True, True, True, True, False):
        t.update_scale(overflow)
        j.update_scale(overflow)
        assert t.loss_scale == j.loss_scale
    assert t.loss_scale == 1.0  # never below 1


@pytest.mark.parametrize("bad", [None, float("nan"), float("inf"), -float("inf"), 1e30])
def test_has_overflow_reads_non_finite_counts(bad):
    """Parameters, NDArrays with gradients and tensors; a huge finite
    gradient (whose square would be inf) is no overflow."""
    _, t = _nets()
    params = list(t.collect_params().values())
    for p in params:
        p.grad().fill_(0.5)
    if bad is not None:
        params[2].grad()[0] = bad
    scaler = mx.amp.LossScaler()
    want = bad is not None and not np.isfinite(bad)
    assert scaler.has_overflow(params) == want
    x = mx.nd.array(np.ones(3, np.float32), ctx=mx.cpu())
    x.attach_grad()
    with mx.autograd.record():
        y = (x * (bad if bad is not None else 1.0)).sum()
    y.backward()
    assert scaler.has_overflow([x]) == want
    assert not scaler.has_overflow([torch.zeros(2)])  # no gradient at all


def _amp_run(pkg, net, batches, force):
    """SGD steps through init_trainer; at the steps in ``force`` the scale
    is set to 2**200 so the scaled loss overflows.  Returns (scales after
    each step, weights after each step, update counts)."""
    tr = pkg.gluon.Trainer(net.collect_params(), "sgd",
                           {"learning_rate": 0.1, "momentum": 0.9})
    pkg.amp.init_trainer(tr)
    assert pkg.amp.init_trainer(tr) is tr  # idempotent
    loss_fn = pkg.gluon.loss.L2Loss()
    scales, weights = [], []
    for k, (x, y) in enumerate(batches):
        if k in force:
            tr._amp_loss_scaler.loss_scale = 2.0 ** 200
        xs = pkg.nd.array(x) if pkg is mxj else torch.from_numpy(x)
        ys = pkg.nd.array(y) if pkg is mxj else torch.from_numpy(y)
        with pkg.autograd.record():
            loss = loss_fn(net(xs), ys)
            with pkg.amp.scale_loss(loss, tr) as scaled:
                pass
        pkg.autograd.backward(scaled)
        tr.step(4)
        scales.append(tr._amp_loss_scaler.loss_scale)
        weights.append([np.asarray(p.data().asnumpy() if pkg is mxj else
                                   p.data().detach().numpy(), np.float32).copy()
                        for p in net.collect_params().values()])
    return scales, weights, dict(tr._optimizer._index_update_count)


def test_init_trainer_skips_overflows_as_jax_does():
    """The scale sequence (halving on each forced overflow, doubling after
    a window) is the JAX one; a skipped step leaves every weight bit for bit
    and the update counts where they were; weights match JAX."""
    j, t = _nets()
    batches = _batches(6)
    force = {2, 3}
    js, jw, jc = _amp_run(mxj, j, batches, force)
    ts, tw, tc = _amp_run(mx, t, batches, force)
    assert ts == js and tc == jc
    assert ts[2] == 2.0 ** 199 and ts[3] == 2.0 ** 199
    for k in force:
        assert all(np.array_equal(a, b) for a, b in zip(tw[k], tw[k - 1]))
    for a, b in zip(tw[-1], jw[-1]):
        np.testing.assert_allclose(a, b, **FP32_TOL)


def test_unscale_divides_once():
    _, t = _nets()
    tr = mx.gluon.Trainer(t.collect_params(), "sgd", {"learning_rate": 0.1})
    mx.amp.init_trainer(tr)
    tr._amp_loss_scaler.loss_scale = 4.0
    x, y = (torch.from_numpy(a) for a in _batches(1)[0])
    with mx.autograd.record():
        loss = mx.gluon.loss.L2Loss()(t(x), y)
    with mx.amp.scale_loss(loss, tr) as scaled:
        mx.autograd.backward(scaled)
    grads = [p.grad().clone() for p in t.collect_params().values()]
    mx.amp.unscale(tr)
    for g, p in zip(grads, t.collect_params().values()):
        torch.testing.assert_close(p.grad(), g / 4.0)
    before = [p.data().clone() for p in t.collect_params().values()]
    tr.step(4)
    for b, g, p in zip(before, grads, t.collect_params().values()):
        torch.testing.assert_close(p.data(), b - 0.1 * (g / 4.0) / 4)


def test_op_lists_and_convert_hybrid_block():
    assert mx.amp.list_lp16_ops() == mxj.amp.list_lp16_ops()
    assert mx.amp.list_fp32_ops() == mxj.amp.list_fp32_ops()
    _, t = _nets()
    assert mx.amp.convert_hybrid_block(t, "bfloat16") is t
    assert all(p.data().dtype == torch.bfloat16 for p in t.collect_params().values())


# -- autograd.grad and mark_variables ---------------------------------------------------


def _xs(seed=2):
    return np.random.RandomState(seed).randn(3, 4).astype(np.float32)


def test_grad_first_order_matches_jax_and_leaves_the_buffers():
    x = _xs()
    t = mx.nd.array(x, ctx=mx.cpu())
    t.attach_grad()
    j = mxj.nd.array(x)
    j.attach_grad()
    outs = []
    for pkg, v in ((mx, t), (mxj, j)):
        with pkg.autograd.record():
            y = (pkg.nd.tanh(v) * v).sum()
        outs.append(pkg.autograd.grad(y, [v])[0])
    assert isinstance(outs[0], mx.nd.NDArray)
    np.testing.assert_allclose(outs[0].asnumpy(), outs[1].asnumpy(), **FP32_TOL)
    assert float(np.abs(t.grad.asnumpy()).max()) == 0.0  # grad() wrote no buffer


def test_grad_second_order_matches_jax():
    """d/dx of sum((d/dx sum(x³·w))²): grad with create_graph=True, then a
    backward through it, against the JAX package."""
    x, w = _xs(), _xs(3)
    got = []
    for pkg, arr in ((mx, lambda a: mx.nd.array(a, ctx=mx.cpu())), (mxj, mxj.nd.array)):
        v, c = arr(x), arr(w)
        v.attach_grad()
        with pkg.autograd.record():
            y = (v * v * v * c).sum()
            (g,) = pkg.autograd.grad(y, [v], create_graph=True)
            z = (g * g).sum()
        z.backward()
        got.append((g.asnumpy(), v.grad.asnumpy()))
    for a, b in zip(*got):
        np.testing.assert_allclose(a, b, **FP32_TOL)
    np.testing.assert_allclose(got[0][1], 2 * (3 * x * x * w) * 6 * x * w, rtol=1e-5)


def test_second_order_through_attention_on_the_cpu_matches_jax():
    """The attention op's gradient, differentiated again: on the CPU the
    port recomputes the plain attention under PyTorch's autograd, as the
    JAX package differentiates its plain attention twice."""
    rng = np.random.RandomState(4)
    q, k, v = (rng.randn(2, 5, 8).astype(np.float32) * 0.5 for _ in range(3))
    got = []
    for pkg, arr in ((mx, lambda a: mx.nd.array(a, ctx=mx.cpu())), (mxj, mxj.nd.array)):
        qs, ks, vs = arr(q), arr(k), arr(v)
        for a in (qs, ks, vs):
            a.attach_grad()
        with pkg.autograd.record():
            o = pkg.nd.fused_attention(qs, ks, vs, num_heads=2)
            gq, gk = pkg.autograd.grad((o * o).sum(), [qs, ks], create_graph=True)
            z = (gq * gq).sum() + (gk * gk).sum()
        z.backward()
        got.append([x.asnumpy() for x in (gq, gk, qs.grad, ks.grad, vs.grad)])
    for a, b in zip(*got):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
def test_second_order_through_the_kernels_raises_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA CUDA card")
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn(2, 128, 64, device="cuda", generator=gen, dtype=torch.bfloat16)
               .requires_grad_() for _ in range(3))
    with mx.autograd.record():
        o = mx.nd.fused_attention(q, k, v, num_heads=1)
        with pytest.raises(RuntimeError, match="double backward"):
            mx.autograd.grad(o.float().sum(), [q], create_graph=True)
        (g,) = mx.autograd.grad(o.float().sum(), [q])
    assert g.shape == q.shape


def test_mark_variables_matches_jax():
    x = _xs()
    res = []
    for pkg, arr in ((mx, lambda a: mx.nd.array(a, ctx=mx.cpu())), (mxj, mxj.nd.array)):
        v, buf = arr(x), arr(np.ones_like(x))
        pkg.autograd.mark_variables([v], [buf], grad_reqs="add")
        for _ in range(2):
            with pkg.autograd.record():
                y = (v * v).sum()
            y.backward()
        res.append(v.grad.asnumpy())
    np.testing.assert_allclose(res[0], res[1], **FP32_TOL)
    np.testing.assert_allclose(res[0], 1 + 4 * x, rtol=1e-6)


def test_grad_refuses_unmarked_variables():
    x = mx.nd.array(_xs(), ctx=mx.cpu())
    with mx.autograd.record():
        y = (x * 2).sum()
    with pytest.raises(ValueError, match="attach_grad"):
        mx.autograd.grad(y, [x])
