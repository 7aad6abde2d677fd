"""Training in the PyTorch port against the JAX package, on the CPU: the
losses, Dropout in training, MXNet's ``grad_req`` semantics, ``autograd``
scopes and ``Function``, and three ``gluon.Trainer`` steps of the tiny BERT
(test_transformer.py's: vocab 128, units 32, hidden 64, 2 layers, 2 heads,
dropout 0) from the same parameters, carried across by structural key.
"""
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import incubator_mxnet_tpu as mxj
from incubator_mxnet_tpu.gluon.model_zoo import bert as jbert
from incubator_mxnet_tpu.ops import nn as jnn
import incubator_mxnet_torch as mx
from incubator_mxnet_torch.convert import load_numpy_params
from incubator_mxnet_torch.gluon import nn
from incubator_mxnet_torch.gluon.model_zoo import bert as tbert
from incubator_mxnet_torch.ops import nn as tnn

ROOT = Path(__file__).resolve().parents[1]
CFG = dict(vocab_size=128, units=32, hidden_size=64, num_layers=2, num_heads=2,
           max_length=64, dropout=0.0)
# fp32 losses and their gradients: the same fp32 arithmetic in another
# summation order.
FP32_TOL = dict(rtol=1e-5, atol=1e-6)
# Three Adam steps of the tiny BERT: the fp32 forward and backward through 2
# post-LN layers agree to ~1e-6 relative; Adam divides each gradient by its
# own running RMS, which amplifies the difference where a gradient is
# small.  Losses to 1e-5, parameters to 1e-4 relative / 1e-5 absolute
# (lr = 1e-3: a hundredth of one step's size).
LOSS_TOL = dict(rtol=1e-5, atol=1e-5)
PARAM_TOL = dict(rtol=1e-4, atol=1e-5)
LR, B, S, P = 1e-3, 3, 16, 5


def _batch(seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, 128, (B, S)).astype(np.int32),
            rng.randint(0, 2, (B, S)).astype(np.int32),
            rng.randint(0, S, (B, P)).astype(np.int32),
            rng.randint(0, 128, (B, P)).astype(np.int32))


@pytest.fixture(scope="module")
def jax_run():
    """The JAX tiny BERTForPretrain, built once: its initial parameters, and
    the per-step losses and final parameters of three Trainer steps."""
    mxj.random.seed(0)
    jnet = jbert.BERTForPretrain(jbert.BERTModel(**CFG), vocab_size=128)
    jnet.initialize()
    jnet(mxj.nd.zeros((1, 4), dtype="int32"))  # materialize deferred shapes
    start = {k: p.data().asnumpy() for k, p in jnet._collect_params_with_prefix().items()}
    trainer = mxj.gluon.Trainer(jnet.collect_params(), "adam", {"learning_rate": LR})
    loss_fn = mxj.gluon.loss.SoftmaxCrossEntropyLoss()
    ids, types, pos, labels = (mxj.nd.array(a, dtype="int32") for a in _batch())
    losses = []
    for _ in range(3):
        with mxj.autograd.record():
            mlm, _ = jnet(ids, types, pos)
            loss = loss_fn(mlm.reshape((-1, 128)), labels.reshape((-1,)))
        loss.backward()
        trainer.step(B)
        losses.append(loss.asnumpy())
    final = {k: p.data().asnumpy() for k, p in jnet._collect_params_with_prefix().items()}
    return start, losses, final


def _port_net(arrays):
    net = tbert.BERTForPretrain(tbert.BERTModel(**CFG), vocab_size=128)
    net.initialize(ctx=mx.cpu())
    load_numpy_params(net, arrays)
    return net


def test_trainer_steps_match_jax(jax_run):
    start, jlosses, jfinal = jax_run
    net = _port_net(start)
    trainer = mx.gluon.Trainer(net.collect_params(), "adam", {"learning_rate": LR})
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    ids, types, pos, labels = (torch.from_numpy(a) for a in _batch())
    for step in range(3):
        with mx.autograd.record():
            mlm, _ = net(ids, types, pos)
            loss = loss_fn(mlm.reshape(-1, 128), labels.reshape(-1))
        mx.autograd.backward(loss)
        trainer.step(B)
        np.testing.assert_allclose(loss.detach().numpy(), jlosses[step], err_msg=f"step {step}",
                                   **LOSS_TOL)
    final = {k: p.data().detach().numpy() for k, p in net._collect_params_with_prefix().items()}
    assert trainer.optimizer._index_update_count[0] == 3
    assert final.keys() == jfinal.keys()
    for key, ref in jfinal.items():
        np.testing.assert_allclose(final[key], ref, err_msg=key, **PARAM_TOL)


def test_save_and_load_states_keep_adam_t(jax_run, tmp_path):
    start = jax_run[0]
    net = _port_net(start)
    params = net.collect_params()
    trainer = mx.gluon.Trainer(params, "adam", {"learning_rate": LR})
    ids, types, pos, labels = (torch.from_numpy(a) for a in _batch(1))

    def step(tr):
        with mx.autograd.record():
            mlm, _ = net(ids, types, pos)
            loss = tnn.streaming_softmax_ce(mlm, labels).mean(-1)
        mx.autograd.backward(loss)
        tr.step(B)

    step(trainer)
    step(trainer)
    fname = tmp_path / "trainer.states"
    trainer.save_states(str(fname))
    restored = mx.gluon.Trainer(params, "adam", {"learning_rate": LR})
    restored.load_states(str(fname))
    assert restored.optimizer._index_update_count == trainer.optimizer._index_update_count
    assert restored.optimizer.num_update == 2
    for i, st in trainer._states.items():
        for a, b in zip(st, restored._states[i]):
            assert torch.equal(a, b)
    step(restored)
    assert set(restored.optimizer._index_update_count.values()) == {3}


def test_streaming_softmax_ce_matches_jax():
    rng = np.random.RandomState(2)
    logits = rng.randn(4, 5, 37).astype(np.float32) * 3
    labels = rng.randint(0, 37, (4, 5)).astype(np.int32)
    w = rng.randn(4, 5).astype(np.float32)
    ref, ref_g = jax.value_and_grad(
        lambda x: (jnn.streaming_softmax_ce(x, jnp.asarray(labels)) * w).sum())(
        jnp.asarray(logits))
    x = torch.from_numpy(logits).requires_grad_()
    out = (tnn.streaming_softmax_ce(x, torch.from_numpy(labels)) * torch.from_numpy(w)).sum()
    out.backward()
    np.testing.assert_allclose(out.item(), float(ref), **FP32_TOL)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(ref_g), **FP32_TOL)
    np.testing.assert_allclose(
        tnn.softmax_cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels)).item(),
        float(jnn.softmax_cross_entropy(jnp.asarray(logits), jnp.asarray(labels))), **FP32_TOL)


@pytest.mark.parametrize("axis", [-1, 1])
def test_softmax_and_log_softmax_match_jax(axis):
    rng = np.random.RandomState(3)
    x = rng.randn(3, 6, 9).astype(np.float32)
    for name in ("softmax", "log_softmax"):
        ref = getattr(jnn, name)(jnp.asarray(x), axis=axis, temperature=2.0)
        got = getattr(tnn, name)(torch.from_numpy(x), axis=axis, temperature=2.0)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), err_msg=name, **FP32_TOL)
    length = np.array([2, 9, 5], np.int32)
    ref = jnn.softmax(jnp.asarray(x[:, 0]), axis=-1, length=jnp.asarray(length))
    got = tnn.softmax(torch.from_numpy(x[:, 0]), axis=-1, length=torch.from_numpy(length))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **FP32_TOL)


@pytest.mark.parametrize("sparse", [True, False])
def test_softmax_ce_loss_and_l2_loss_match_jax(sparse):
    rng = np.random.RandomState(4)
    pred = rng.randn(6, 10).astype(np.float32)
    label = (rng.randint(0, 10, (6,)).astype(np.float32) if sparse
             else np.abs(rng.randn(6, 10)).astype(np.float32))
    sw = rng.rand(6, 1).astype(np.float32)
    jl = mxj.gluon.loss.SoftmaxCrossEntropyLoss(sparse_label=sparse, weight=0.7)
    tl = mx.gluon.loss.SoftmaxCrossEntropyLoss(sparse_label=sparse, weight=0.7)
    ref = jl(mxj.nd.array(pred), mxj.nd.array(label), mxj.nd.array(sw)).asnumpy()
    got = tl(torch.from_numpy(pred), torch.from_numpy(label), torch.from_numpy(sw))
    assert got.shape == (6,)
    np.testing.assert_allclose(got.numpy(), ref, **FP32_TOL)
    target = rng.randn(6, 10).astype(np.float32)
    ref = mxj.gluon.loss.L2Loss()(mxj.nd.array(pred), mxj.nd.array(target)).asnumpy()
    got = mx.gluon.loss.L2Loss()(torch.from_numpy(pred), torch.from_numpy(target))
    np.testing.assert_allclose(got.numpy(), ref, **FP32_TOL)


def test_tensor_ops_match_jax():
    from incubator_mxnet_tpu.ops import tensor as jt
    from incubator_mxnet_torch.ops import tensor as tt

    rng = np.random.RandomState(5)
    x = rng.randn(3, 4, 5).astype(np.float32)
    idx = rng.randint(-2, 7, (3, 5)).astype(np.int32)  # out of range: clipped
    for kw in (dict(axis=1), dict(axis=(0, 2), keepdims=True), dict(axis=1, exclude=True),
               dict()):
        for name in ("sum", "mean"):
            ref = mxj.nd.__getattr__(name)(mxj.nd.array(x), **kw).asnumpy()
            got = mx.nd.__getattr__(name)(torch.from_numpy(x), **kw)
            np.testing.assert_allclose(got.numpy(), ref, err_msg=f"{name} {kw}", **FP32_TOL)
    for keepdims in (False, True):
        ref = jt.pick(jnp.asarray(x), jnp.asarray(idx), axis=1, keepdims=keepdims)
        got = tt.pick(torch.from_numpy(x), torch.from_numpy(idx), axis=1, keepdims=keepdims)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref))
    np.testing.assert_allclose(mx.nd.square(torch.from_numpy(x)).numpy(), x * x)
    np.testing.assert_allclose(mx.nd.broadcast_mul(torch.from_numpy(x),
                                                   torch.from_numpy(x[:1])).numpy(), x * x[:1])


def test_dropout_in_training():
    """Keep probability exactly 1 - p (within 4 sigma over 200k draws), kept
    values scaled by 1/(1 - p), the same mask after the same seed, a shared
    mask along ``axes``; drawn from the port's generator, not torch's."""
    p, n = 0.1, 200_000
    x = torch.ones(n)
    mx.random.seed(42)
    torch.manual_seed(0)
    with mx.autograd.train_mode():
        a = tnn.dropout(x, p=p)
        torch.manual_seed(1)  # the global generator plays no part
        mx.random.seed(42)
        b = tnn.dropout(x, p=p)
        c = tnn.dropout(x, p=p)
        shared = tnn.dropout(torch.ones(8, 50), p=0.5, axes=(0,))
    kept = a != 0
    frac = kept.float().mean().item()
    assert abs(frac - (1 - p)) <= 4 * np.sqrt(p * (1 - p) / n)
    assert torch.equal(a[kept], torch.full_like(a[kept], 1 / (1 - p)))
    assert torch.equal(a, b) and not torch.equal(b, c)
    assert not kept.all()
    assert torch.equal(shared, shared[:1].expand_as(shared))
    with mx.autograd.predict_mode():
        assert tnn.dropout(x, p=p, mode="always").eq(0).any()


@pytest.mark.parametrize("how", ["mx.autograd.backward", "Tensor.backward"])
def test_grad_req_write_overwrites_and_add_accumulates(how):
    def backward(loss):
        if how == "mx.autograd.backward":
            mx.autograd.backward(loss)  # ones as the head gradient, as MXNet
        else:
            loss.sum().backward()

    mx.random.seed(0)
    net = nn.Dense(3, in_units=4)
    net.initialize(ctx=mx.cpu())
    x = torch.from_numpy(np.random.RandomState(6).randn(2, 4).astype(np.float32))
    for _ in range(2):
        with mx.autograd.record():
            y = net(x)
        backward(y)
    w = net.weight
    one = x.sum(0).expand(3, 4)  # d(sum y)/dW
    torch.testing.assert_close(w.grad(), one)
    assert w.data().grad is None  # moved into the Parameter's own buffer
    w.grad_req = "add"
    w.zero_grad()
    for _ in range(2):
        with mx.autograd.record():
            y = net(x)
        backward(y)
    torch.testing.assert_close(w.grad(), 2 * one)
    w.grad_req = "null"
    with pytest.raises(RuntimeError, match="grad_req='null'"):
        w.grad()
    assert not w.data().requires_grad


def test_inference_holds_no_gradient_buffers():
    """A buffer appears at the first backward (or at grad(), as zeros), so
    a network that only runs inference holds none; a cast starts anew."""
    net = nn.Dense(3, in_units=4)
    net.initialize(ctx=mx.cpu())
    x = torch.ones(2, 4)
    net(x)
    w, b = net.weight, net.bias
    assert w._grad is None and b._grad is None
    assert torch.equal(b.grad(), torch.zeros(3))
    with mx.autograd.record():
        y = net(x)
    mx.autograd.backward(y)
    assert w._grad is not None and w.grad_version == 1
    net.cast("bfloat16")
    assert w._grad is None and w.grad().dtype == torch.bfloat16


def test_record_scopes_and_function():
    assert not mx.autograd.is_recording() and not mx.autograd.is_training()
    with mx.autograd.record():
        assert mx.autograd.is_recording() and mx.autograd.is_training()
        assert torch.is_grad_enabled()
        with mx.autograd.pause():
            assert not mx.autograd.is_recording() and not torch.is_grad_enabled()
        with mx.autograd.predict_mode():
            assert mx.autograd.is_recording() and not mx.autograd.is_training()
    with mx.autograd.record(train_mode=False):
        assert not mx.autograd.is_training()
    assert mx.autograd.set_training(True) is False
    assert mx.autograd.set_training(False) is True

    class Scale(mx.autograd.Function):
        def forward(self, x):
            assert not mx.autograd.is_recording()
            return x * 3

        def backward(self, dy):
            return dy * 3

    p = mx.gluon.Parameter("p", shape=(4,))
    p.initialize(init=mx.init.One(), ctx=mx.cpu())
    with mx.autograd.record():
        y = Scale()(p.data())
    mx.autograd.backward(y, torch.full((4,), 2.0))
    torch.testing.assert_close(p.grad(), torch.full((4,), 6.0))
    with pytest.raises(ValueError, match="recorded graph"):
        mx.autograd.backward(torch.ones(2))


def test_blocks_record_only_inside_record_and_predict_mode_drops_nothing():
    mx.random.seed(0)
    net = tbert.BERTModel(**dict(CFG, dropout=0.5))
    net.initialize(ctx=mx.cpu())
    ids = torch.from_numpy(_batch()[0])
    seq, _ = net(ids)
    assert seq.grad_fn is None
    with mx.autograd.record():
        a, _ = net(ids)
        with mx.autograd.predict_mode():
            b, _ = net(ids)
        c, _ = net(ids)
    assert a.grad_fn is not None and b.grad_fn is not None
    torch.testing.assert_close(b.detach(), seq)  # identity dropout, same as inference
    assert not torch.equal(a, c)                  # dropout, fresh masks


def test_trainer_runs_on_one_device_only():
    """One process: every store the port has sums nothing across workers,
    and a step with one is the step without; the tiers of later slices
    raise, naming their ROADMAP items."""
    net = nn.Dense(2, in_units=2)
    net.initialize(ctx=mx.cpu())
    for kv in ("dist_sync", "local", "device", mx.kv.create("local")):
        tr = mx.gluon.Trainer(net.collect_params(), "sgd", {"learning_rate": 0.0}, kvstore=kv)
        with mx.autograd.record():
            y = net(torch.ones(1, 2))
        tr.backward(y)
        tr.step(1)
        assert tr._kvstore.num_workers == 1
    with pytest.raises(NotImplementedError, match="ROADMAP §1 item 6b"):
        mx.gluon.Trainer(net.collect_params(), "sgd", compression_params={"type": "2bit"})
    with pytest.raises(NotImplementedError, match="ROADMAP §1 item 9"):
        mx.gluon.Trainer(net.collect_params(), "sgd", kvstore="dist_async").step(1)
    tr = mx.gluon.Trainer(net.collect_params(), "sgd", {"learning_rate": 0.1}, kvstore=None)
    with mx.autograd.record():
        y = net(torch.ones(1, 2))
    mx.autograd.backward(y)
    before = net.weight.data().detach().clone()
    tr.step(1)
    torch.testing.assert_close(net.weight.data().detach(), before - 0.1)


def test_chip_smoke_cpu_rehearsal_trains():
    """chip_smoke.py's slice, train, rtc_train, nd_surface, timing, serve,
    generation and io phases on the CPU plain path."""
    proc = subprocess.run([sys.executable, "chip_smoke.py", "--cpu-rehearsal"], cwd=ROOT,
                          capture_output=True, text=True, timeout=300,
                          env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert proc.returncode == 0, proc.stderr + proc.stdout[-4000:]
    assert '"phase": "train"' in proc.stdout and '"ok": true' in proc.stdout
    assert '"phase": "rtc_train"' in proc.stdout
    assert '"part": "op_table", "failed": [], "ok": true' in proc.stdout  # nd_surface
    assert re.search(r'"phase": "generation", "phase_s": [0-9.e-]+, "ok": true', proc.stdout)
    assert re.search(r'"phase": "io", "phase_s": [0-9.e-]+, "failed": \[\], "ok": true', proc.stdout)
    assert '"ok": true, "device"' not in proc.stdout
