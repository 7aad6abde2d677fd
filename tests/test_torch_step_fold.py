"""The PyTorch port's step fold (``gluon/step_fold.py``) against the JAX
package's, on the CPU, and its own contract.

On CPU tensors the port's programs run their step body directly (there is
no CUDA graph to capture), so a folded step there is the plain version of
the replay: these tests hold it against the JAX package's folded step,
K-step window and folded eval from the same parameters (carried across by
structural key) and the same numpy inputs, and against the port's own
eager record/backward/step path bit for bit.  Two nets: a Dense + BatchNorm
+ Dropout(0) MLP with SGD-momentum, and a 2-layer, 64-unit BERT with Adam
(``multi_precision=True``; its weights are fp32, so the update is Adam's).
The card's capture and replay are held against eager steps by the ``cuda``
tests below, which skip here, and by ``chip_smoke.py``.
"""
import math
import os
import tempfile

import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as mxj
from incubator_mxnet_tpu import profiler as jprofiler
from incubator_mxnet_tpu.gluon.model_zoo import bert as jbert
import incubator_mxnet_torch as mx
from incubator_mxnet_torch.convert import load_numpy_params
from incubator_mxnet_torch.gluon import nn
from incubator_mxnet_torch.gluon import step_fold
from incubator_mxnet_torch.gluon.model_zoo import bert as tbert
from incubator_mxnet_torch.ops import multi_tensor as mt
from incubator_mxnet_torch.ops import optimizer_ops as tops
from incubator_mxnet_torch.optimizer import fused

# Port against the JAX package: fp32 on both sides, the same arithmetic in
# another summation order (and XLA's fusion of the folded program), so
# values agree to 1e-5 relative; the absolute term covers values near 0
# (BatchNorm's running mean starts at 0, a bias after one small step).
TOL = dict(rtol=1e-5, atol=1e-6)
# BERT's parameters after Adam steps: Adam divides each gradient by its own
# running RMS, which turns fp32 rounding noise into a step of up to lr
# where the exact gradient is 0 (the key third of the QKV bias: softmax is
# blind to a shift of all keys), so there 1e-5 relative cannot hold (~3e-6
# absolute on values near 0 is what the run shows).  As
# test_torch_training.py's three tiny-BERT Trainer steps: 1e-4 relative,
# 1e-5 absolute, a hundredth of one step at lr 1e-3.  Losses, the MLP and
# the eval stay at TOL.
ADAM_PARAM_TOL = dict(rtol=1e-4, atol=1e-5)
STEPS = 3
MLP_B = 8
BERT_CFG = dict(vocab_size=128, units=64, hidden_size=128, num_layers=2, num_heads=2,
                max_length=64, dropout=0.0)
BERT_B, BERT_S, BERT_P = 3, 16, 5


@pytest.fixture(autouse=True)
def _fresh_guard():
    """The JAX fold arms the process-wide compile guard after its first
    step; a JAX net built afterwards must not trip it."""
    jprofiler.disarm_compile_guard()
    yield
    jprofiler.disarm_compile_guard()


def _mlp_batches():
    rng = np.random.RandomState(0)
    return [(rng.rand(MLP_B, 6).astype(np.float32), rng.rand(MLP_B, 4).astype(np.float32))
            for _ in range(2)]


def _bert_batches():
    rng = np.random.RandomState(1)
    return [(rng.randint(0, 128, (BERT_B, BERT_S)).astype(np.int32),
             rng.randint(0, 2, (BERT_B, BERT_S)).astype(np.int32),
             rng.randint(0, BERT_S, (BERT_B, BERT_P)).astype(np.int32),
             rng.randint(0, 128, (BERT_B, BERT_P)).astype(np.int32)) for _ in range(2)]


def _jax_mlp():
    mxj.random.seed(7)
    net = mxj.gluon.nn.HybridSequential()
    # no bias before BatchNorm: its gradient would be ~0 (BN cancels shifts)
    net.add(mxj.gluon.nn.Dense(16, activation="relu", use_bias=False),
            mxj.gluon.nn.BatchNorm(), mxj.gluon.nn.Dropout(0.0), mxj.gluon.nn.Dense(4))
    net.initialize()
    net.hybridize()
    net(mxj.nd.array(_mlp_batches()[0][0]))  # materialize deferred shapes
    return net


def _port_mlp():
    net = nn.HybridSequential()
    with net.name_scope():
        net.add(nn.Dense(16, activation="relu", use_bias=False), nn.BatchNorm(),
                nn.Dropout(0.0), nn.Dense(4))
    return net


def _jax_bert():
    mxj.random.seed(0)
    net = jbert.BERTForPretrain(jbert.BERTModel(**BERT_CFG), vocab_size=128)
    net.initialize()
    net(mxj.nd.zeros((1, 4), dtype="int32"))
    return net


def _port_bert():
    return tbert.BERTForPretrain(tbert.BERTModel(**BERT_CFG), vocab_size=128)


MODELS = {
    "mlp": dict(jax_net=_jax_mlp, port_net=_port_mlp, batches=_mlp_batches,
                opt=("sgd", {"learning_rate": 0.05, "momentum": 0.9}),
                jax_loss=lambda net: (lambda a, b: mxj.gluon.loss.L2Loss()(net(a), b)),
                port_loss=lambda net: (lambda a, b: mx.gluon.loss.L2Loss()(net(a), b)),
                param_tol=TOL),
    "bert": dict(jax_net=_jax_bert, port_net=_port_bert, batches=_bert_batches,
                 opt=("adam", {"learning_rate": 1e-3, "multi_precision": True}),
                 jax_loss=lambda net: (lambda ids, types, pos, labels:
                                       mxj.gluon.loss.SoftmaxCrossEntropyLoss()(
                                           net(ids, types, pos)[0].reshape((-1, 128)),
                                           labels.reshape((-1,)))),
                 port_loss=lambda net: (lambda ids, types, pos, labels:
                                        mx.gluon.loss.SoftmaxCrossEntropyLoss()(
                                            net(ids, types, pos)[0].reshape(-1, 128),
                                            labels.reshape(-1))),
                 param_tol=ADAM_PARAM_TOL),
}


def _jax_params(net):
    return {k: p.data().asnumpy() for k, p in net._collect_params_with_prefix().items()}


def _jax_trainer(net, model):
    name, args = model["opt"]
    return mxj.gluon.Trainer(net.collect_params(), name, dict(args), kvstore=None)


def _window(batches):
    return [np.stack(parts) for parts in zip(*batches)]


@pytest.fixture(scope="module", params=sorted(MODELS))
def jax_ref(request):
    """One JAX net per model, run once: its starting parameters; the losses
    and parameters after STEPS ``fold_step`` calls; after two ``fold_steps``
    windows of k=2 on a fresh copy; and the ``fold_eval`` mean over both
    batches after the windows."""
    model = MODELS[request.param]
    batches = model["batches"]()
    jprofiler.disarm_compile_guard()
    net = model["jax_net"]()
    start = _jax_params(net)
    prog = _jax_trainer(net, model).fold_step(model["jax_loss"](net), block=net)
    losses = [prog(*[mxj.nd.array(a, dtype=a.dtype.name) for a in batches[0]]).asnumpy()
              for _ in range(STEPS)]
    after_steps = _jax_params(net)
    jprofiler.disarm_compile_guard()
    net = model["jax_net"]()
    tr = _jax_trainer(net, model)
    fold = tr.fold_steps(model["jax_loss"](net), k=2, block=net)
    window = [mxj.nd.array(a, dtype=a.dtype.name) for a in _window(batches)]
    window_losses = [fold(*window).asnumpy() for _ in range(2)]
    after_windows = _jax_params(net)
    ev = tr.fold_eval(model["jax_loss"](net), block=net)
    for b in batches:
        ev(*[mxj.nd.array(a, dtype=a.dtype.name) for a in b])
    eval_mean = ev.result()
    jprofiler.disarm_compile_guard()
    return dict(name=request.param, model=model, batches=batches, start=start, losses=losses,
                after_steps=after_steps, window_losses=window_losses,
                after_windows=after_windows, eval_mean=eval_mean)


def _port(ref):
    """The port's net from the JAX starting parameters, and its Trainer."""
    model = ref["model"]
    net = model["port_net"]()
    load_numpy_params(net, ref["start"], ctx=mx.cpu())
    name, args = model["opt"]
    return net, mx.gluon.Trainer(net.collect_params(), name, dict(args))


def _tensors(arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _assert_params(net, want, tol):
    got = {k: p.data().detach().numpy() for k, p in net._collect_params_with_prefix().items()}
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **tol)


def test_fold_step_matches_jax(jax_ref):
    net, tr = _port(jax_ref)
    prog = tr.fold_step(jax_ref["model"]["port_loss"](net), block=net)
    losses = [prog(*_tensors(jax_ref["batches"][0])).numpy() for _ in range(STEPS)]
    assert prog.folded and not prog.captured and prog.logical_steps == STEPS
    np.testing.assert_allclose(np.stack(losses), np.stack(jax_ref["losses"]), **TOL)
    _assert_params(net, jax_ref["after_steps"], jax_ref["model"]["param_tol"])


def test_fold_steps_k2_matches_jax(jax_ref):
    net, tr = _port(jax_ref)
    fold = tr.fold_steps(jax_ref["model"]["port_loss"](net), k=2, block=net)
    window = _tensors(_window(jax_ref["batches"]))
    losses = [fold(*window).numpy() for _ in range(2)]
    assert fold.k == 2 and fold.logical_steps == 4 and fold.window_pos == 0
    assert losses[0].shape[0] == 2
    np.testing.assert_allclose(np.stack(losses), np.stack(jax_ref["window_losses"]), **TOL)
    _assert_params(net, jax_ref["after_windows"], jax_ref["model"]["param_tol"])


def test_fold_eval_matches_jax(jax_ref):
    net, tr = _port(jax_ref)
    load_numpy_params(net, jax_ref["after_windows"])
    ev = tr.fold_eval(jax_ref["model"]["port_loss"](net), block=net)
    calls = step_fold.EvalProgram.calls
    for b in jax_ref["batches"]:
        ev(*_tensors(b))
    assert step_fold.EvalProgram.calls - calls == 2 and ev.folded
    np.testing.assert_allclose(ev.result(), jax_ref["eval_mean"], **TOL)
    assert ev.count == 0  # reset by result()


# -- the port's own contract ----------------------------------------------------


def _port_mlp_net(seed=3, dropout=0.3):
    """An MLP with BatchNorm and Dropout, materialized from a seed."""
    mx.random.seed(seed)
    net = nn.HybridSequential()
    with net.name_scope():
        net.add(nn.Dense(16, activation="relu", use_bias=False, in_units=6),
                nn.BatchNorm(in_channels=16), nn.Dropout(dropout), nn.Dense(4, in_units=16))
    net.initialize(ctx=mx.cpu())
    return net


def _mlp_data():
    x, y = _mlp_batches()[0]
    return torch.from_numpy(x), torch.from_numpy(y)


def _l2(net):
    return lambda a, b: mx.gluon.loss.L2Loss()(net(a), b)


def _eager_step(net, tr, loss_fn, batch):
    with mx.autograd.record():
        loss = loss_fn(*batch)
    mx.autograd.backward(loss)
    tr.step(batch[0].shape[0])
    return loss.detach()


def _state_tensors(tr):
    out = []

    def walk(st):
        if isinstance(st, torch.Tensor):
            out.append(st)
        elif st is not None:
            for s in st:
                walk(s)

    for i in sorted(tr._states):
        walk(tr._states[i])
    return out


def _bert_bf16(seed=5):
    mx.random.seed(seed)
    net = tbert.BERTForPretrain(tbert.BERTModel(**dict(BERT_CFG, dropout=0.1)), vocab_size=128)
    net.initialize(ctx=mx.cpu())
    net.cast("bfloat16")
    ids = torch.from_numpy(_bert_batches()[0][0])
    with mx.autograd.predict_mode():
        net(ids, torch.zeros_like(ids), ids[:, :BERT_P] % BERT_S)
    return net


def _bert_loss(net):
    def loss_fn(ids, types, pos, labels):
        mlm, _ = net(ids, types, pos)
        return mx.gluon.loss.SoftmaxCrossEntropyLoss()(mlm.reshape(-1, 128), labels.reshape(-1))
    return loss_fn


@pytest.mark.parametrize("which", ["mlp_sgd_mom_dropout", "bert_bf16_mp_adam_dropout",
                                   "mlp_window_k2_dropout"])
def test_folded_equals_eager_bit_exact(which):
    """The same steps, folded and eager, from the same weights and the same
    generator: every parameter (BatchNorm's running statistics too), every
    optimizer state and every loss bit for bit, dropout included; the
    window case runs two ``fold_steps(k=2)`` windows of two batches against
    four eager steps."""
    runs = []
    for folded in (False, True):
        if which.startswith("mlp"):
            net = _port_mlp_net()
            tr = mx.gluon.Trainer(net.collect_params(), "sgd",
                                  {"learning_rate": 0.05, "momentum": 0.9})
            loss_fn = _l2(net)
            batches = [_tensors(b) for b in _mlp_batches()]
        else:
            net = _bert_bf16()
            tr = mx.gluon.Trainer(net.collect_params(), "adam",
                                  {"learning_rate": 1e-3, "multi_precision": True})
            loss_fn = _bert_loss(net)
            batches = [_tensors(b) for b in _bert_batches()]
        mx.random.seed(11)
        if not folded:
            steps = 4 if "window" in which else STEPS
            losses = [_eager_step(net, tr, loss_fn, batches[j % 2] if "window" in which
                                  else batches[0]) for j in range(steps)]
        elif "window" in which:
            prog = tr.fold_steps(loss_fn, k=2, block=net)
            window = [torch.stack(parts) for parts in zip(*batches)]
            losses = [x for _ in range(2) for x in prog(*window)]
        else:
            prog = tr.fold_step(loss_fn, block=net)
            losses = [prog(*batches[0]) for _ in range(STEPS)]
        assert not folded or prog.folded
        runs.append(([p.data() for p in net.collect_params().values()] + _state_tensors(tr),
                     losses))
    (a, la), (b, lb) = runs
    assert len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))
    assert len(la) == len(lb) and all(torch.equal(x, y) for x, y in zip(la, lb))


def test_window_pos_step_one_and_save_refusal():
    """``step_one`` moves the window cursor; ``save_states`` refuses off a
    K boundary and accepts on one; a whole window lands on a boundary."""
    net = _port_mlp_net(dropout=0.0)
    tr = mx.gluon.Trainer(net.collect_params(), "adam", {"learning_rate": 0.01})
    fold = tr.fold_steps(_l2(net), k=3, block=net)
    x, y = _mlp_data()
    for _ in range(3):
        assert fold.step_one(x, y).shape == (MLP_B,)
    assert fold.window_pos == 0 and fold.logical_steps == 3
    with tempfile.TemporaryDirectory() as d:
        fname = os.path.join(d, "trainer.states")
        tr.save_states(fname)
        fold.step_one(x, y)
        assert fold.window_pos == 1
        with pytest.raises(RuntimeError, match="K boundar"):
            tr.save_states(fname)
        fold.step_one(x, y)
        fold.step_one(x, y)
        assert fold.window_pos == 0 and fold.logical_steps == 6
        tr.save_states(fname)
        fold(torch.stack([x] * 3), torch.stack([y] * 3))
        fold.step_one(x, y)
        assert fold.window_pos == 1 and fold.logical_steps == 10
        fold(torch.stack([x] * 3), torch.stack([y] * 3))  # a whole window: boundary
        assert fold.window_pos == 0
    with pytest.raises(ValueError, match="stacked"):
        fold(x[0], y[0])


def test_k1_reduces_to_the_single_step_program():
    """``fold_steps(k=1)`` takes unstacked batches and is the
    ``fold_step`` program: the same bits, one folded call a step."""
    runs = []
    for k in (None, 1):
        net = _port_mlp_net()
        tr = mx.gluon.Trainer(net.collect_params(), "sgd",
                              {"learning_rate": 0.05, "momentum": 0.9})
        prog = (tr.fold_step(_l2(net), block=net) if k is None
                else tr.fold_steps(_l2(net), k=1, block=net))
        mx.random.seed(2)
        calls = step_fold.StepProgram.calls
        losses = [prog(*_mlp_data()) for _ in range(2)]
        assert step_fold.StepProgram.calls - calls == 2 and prog.k == 1
        assert prog.step_one(*_mlp_data()).shape == (MLP_B,)
        runs.append([p.data() for p in net.collect_params().values()] + losses)
    assert all(torch.equal(a, b) for a, b in zip(*runs))


def test_fold_k_env_default(monkeypatch):
    monkeypatch.setenv("MXNET_STEP_FOLD_K", "4")
    net = _port_mlp_net()
    tr = mx.gluon.Trainer(net.collect_params(), "sgd", {"learning_rate": 0.05})
    assert tr.fold_steps(_l2(net), block=net).k == 4
    assert tr.fold_steps(_l2(net), k=2, block=net).k == 2
    assert tr.fold_eval(_l2(net), block=net).k == 4
    monkeypatch.setenv("MXNET_STEP_FOLD_K", "junk")
    assert step_fold.fold_k() == 1


def _fallback_case(label, monkeypatch):
    """A program that falls back for ``label`` and its batch; the eager
    step it runs instead is the reference one."""
    opt = ("sgd", {"learning_rate": 0.05, "momentum": 0.9})
    net = _port_mlp_net(dropout=0.0)
    if label == "env-off":
        monkeypatch.setenv("MXNET_STEP_FOLD", "0")
    elif label == "block-opt-out":
        net[2]._step_fold_opt_out = True
    elif label == "grad-req-add":
        net[3].weight.grad_req = "add"
    elif label == "unsupported-optimizer":
        opt = ("adam", {"learning_rate": 0.01})
    elif label == "capture-failure":  # parameters that no one graph can hold
        monkeypatch.setattr(step_fold, "_device_of", lambda params: None)
    elif label == "deferred-init":
        mx.random.seed(3)
        net = nn.HybridSequential()
        with net.name_scope():
            net.add(nn.Dense(16, activation="relu"), nn.Dense(4))
        net.initialize(ctx=mx.cpu())
    # async-PS: the optimizer runs on the kvstore, whose updater the fold cannot replay
    tr = mx.gluon.Trainer(net.collect_params(), *opt, kvstore="device",
                          update_on_kvstore=label == "async-PS")
    if label == "unsupported-optimizer":
        tr._optimizer.__class__ = type("MyAdam", (type(tr._optimizer),), {})
    return net, tr


@pytest.mark.parametrize("label", step_fold.FALLBACK_LABELS)
def test_fallback_labels(label, monkeypatch):
    """Each documented fallback runs the eager step, counts under its label,
    and is sticky and warned once, except deferred-init, which runs one
    eager step and then folds."""
    net, tr = _fallback_case(label, monkeypatch)
    prog = tr.fold_step(_l2(net), block=net)
    before = dict(step_fold.StepProgram.fallbacks)
    calls = step_fold.StepProgram.calls
    x, y = _mlp_data()
    if label in ("grad-req-add", "unsupported-optimizer", "async-PS", "capture-failure"):
        with pytest.warns(UserWarning, match="step fold disabled"):
            prog(x, y)
    else:
        prog(x, y)
    prog(x, y)
    got = {k: v - before[k] for k, v in step_fold.StepProgram.fallbacks.items()}
    if label == "deferred-init":
        assert got == dict.fromkeys(step_fold.FALLBACK_LABELS, 0) | {label: 1}
        assert prog.folded and step_fold.StepProgram.calls - calls == 1
    else:
        assert got == dict.fromkeys(step_fold.FALLBACK_LABELS, 0) | {label: 2}
        assert not prog.folded and prog.fallback_reason
        assert step_fold.StepProgram.calls == calls
    assert prog.logical_steps == 2


@pytest.mark.parametrize("opt", [("sgd", {"learning_rate": 0.05, "momentum": 0.9}),
                                 ("adam", {"learning_rate": 0.01, "wd": 1e-3})])
def test_fold_update_equals_trainer_step(opt, monkeypatch):
    """``MXNET_STEP_FOLD=1`` routes ``Trainer.step``'s optimizer tail through
    ``fold_update`` (one replay of every group on the card); on the CPU its
    groups take the plain update: the same bits as the fused update."""
    runs = []
    for env in ("", "1"):
        monkeypatch.setenv("MXNET_STEP_FOLD", env)
        net = _port_mlp_net(dropout=0.0)
        tr = mx.gluon.Trainer(net.collect_params(), *opt)
        calls = step_fold.fold_update.calls
        losses = [_eager_step(net, tr, _l2(net), _mlp_data()) for _ in range(STEPS)]
        assert step_fold.fold_update.calls - calls == (STEPS if env else 0)
        runs.append([p.data() for p in net.collect_params().values()] + _state_tensors(tr)
                    + losses)
    assert all(torch.equal(a, b) for a, b in zip(*runs))


def test_fold_update_returns_the_leftovers():
    """Like ``fused_update``: what has no fused variant comes back to the
    caller, and aggregation off leaves everything to it."""
    w, g = torch.randn(5), torch.randn(5)
    opt = mx.optimizer.create("sgd", learning_rate=0.1, momentum=0.9)
    opt.__class__ = type("MySGD", (type(opt),), {})
    states = {0: opt.create_state_multi_precision(0, w)}
    assert step_fold.fold_update(opt, [(0, w, g)], states) == [(0, w, g)]
    opt = mx.optimizer.create("sgd", learning_rate=0.1, aggregate_num=0)
    states = {0: opt.create_state_multi_precision(0, w)}
    assert step_fold.fold_update(opt, [(0, w, g)], states) == [(0, w, g)]


def test_device_rows_equal_the_plain_group_update():
    """The values the multi-tensor kernel reads from device memory: each
    chunk's lr, wd, Adam rate and (unused) second coefficient rows and the
    group's scalars, as the plain per-tensor update reads them, chunk after
    chunk of 256 tensors; and the fold's per-step rows are those the fused
    update hands ``group_apply``."""
    n = 300
    lrs = [1e-3 * (1 + i % 3) for i in range(n)]
    wds = [1e-4 * (i % 2) for i in range(n)]
    ts = [1 + i % 4 for i in range(n)]
    S = {"rescale": 1 / 8, "clip": math.inf, "beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8}
    rows = tops.group_rows(tops.mp_adam_step, lrs, wds, ts, S)
    assert rows.dtype == np.float32 and len(rows) == 4 * n + 2 * 16
    f = np.float32
    scalars = [f(1 / 8), -1.0, 0.0, f(0.9), f(1) - f(0.9), f(0.999), f(1) - f(0.999), f(1e-8),
               0.0, 1.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0]
    for a, m in ((0, 256), (4 * 256 + 16, n - 256)):
        chunk = slice(n - m if a else 0, n if a else m)
        assert list(rows[a:a + m]) == list(np.asarray(lrs[chunk], f))
        assert list(rows[a + m:a + 2 * m]) == list(np.asarray(wds[chunk], f))
        assert list(rows[a + 2 * m:a + 3 * m]) == [
            f(tops._adam_lr(lr, 0.9, 0.999, t)) for lr, t in zip(lrs[chunk], ts[chunk])]
        assert list(rows[a + 3 * m:a + 4 * m]) == [0.0] * m
        assert list(rows[a + 4 * m:a + 4 * m + 16]) == scalars
    ws = [torch.zeros(3, dtype=torch.bfloat16) for _ in range(4)]
    table = mt.table("mp_adam", ws, ws, [(torch.zeros(3),) * 3] * 4, lrs[:4], wds[:4],
                     *tops._rates(tops.mp_adam_step, lrs[:4], ts[:4], S), S)
    assert list(table["rows"]) == list(tops.group_rows(tops.mp_adam_step, lrs[:4], wds[:4],
                                                       ts[:4], S))

    # the fold's rows of one step: bump every count, then lr, wd and t
    net = _port_mlp_net(dropout=0.0)
    tr = mx.gluon.Trainer(net.collect_params(), "adam", {"learning_rate": 0.01, "wd": 1e-3})
    _eager_step(net, tr, _l2(net), _mlp_data())
    opt = tr._optimizer
    items = [(i, p.data(), p.grad()) for i, p in enumerate(tr._params) if p.grad_req != "null"]
    (step, _, _), members = next(iter(fused.plan_groups(opt, items, tr._states)[0].items()))
    idx = [i for i, _, _, _ in members]
    want = tops.group_rows(step, [opt._get_lr(i) for i in idx], [opt._get_wd(i) for i in idx],
                           [opt._index_update_count[i] + 1 for i in idx], fused._scalars(opt))
    per_group, got = step_fold._Tail(opt, items, tr._states).values()
    assert list(got) == list(want) and per_group[0][2] == [2] * len(idx)


def test_fold_keeps_gradient_bookkeeping():
    """A folded step leaves each gradient written once and consumed, as an
    eager step does: a following ``step(ignore_stale_grad=True)`` finds
    every gradient stale and updates nothing."""
    net = _port_mlp_net(dropout=0.0)
    tr = mx.gluon.Trainer(net.collect_params(), "sgd", {"learning_rate": 0.05})
    prog = tr.fold_step(_l2(net), block=net)
    versions = [p.grad_version for p in tr._params]
    prog(*_mlp_data())
    assert [p.grad_version for p in tr._params] == [
        v + (p.grad_req != "null") for p, v in zip(tr._params, versions)]
    assert tr._stale_indices() == {i for i, p in enumerate(tr._params) if p.grad_req != "null"}
    before = [p.data().clone() for p in tr._params]
    tr.step(MLP_B, ignore_stale_grad=True)
    assert all(torch.equal(a, p.data()) for a, p in zip(before, tr._params))


def test_recaptures_after_new_tensors():
    """The cache key holds every parameter's address: a ``cast`` makes new
    tensors and a new program entry, never a replay of stale pointers."""
    net = _port_mlp_net(dropout=0.0)
    tr = mx.gluon.Trainer(net.collect_params(), "sgd", {"learning_rate": 0.05})
    prog = tr.fold_step(_l2(net), block=net)
    prog(*_mlp_data())  # makes the optimizer's states
    tail = lambda: step_fold._Tail(  # noqa: E731
        tr._optimizer, [(i, p.data(), p.grad()) for i, p in enumerate(tr._params)
                        if p.grad_req != "null"], tr._states)
    batch = _mlp_data()
    key = prog._key(batch, None, tail(), torch.device("cpu"))
    assert prog._key(batch, None, tail(), torch.device("cpu")) == key
    old = (net[3].weight.data(), net[3].weight.grad())  # held: no address is reused
    net[3].weight.cast("bfloat16")
    assert net[3].weight.data().data_ptr() != old[0].data_ptr()
    assert prog._key(batch, None, tail(), torch.device("cpu")) != key


# -- on the card ------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA CUDA card")
    return torch.device("cuda", 0)


def _card_mlp(device, dropout):
    mx.random.seed(3)
    net = nn.HybridSequential()
    with net.name_scope():
        net.add(nn.Dense(64, activation="relu", use_bias=False, in_units=32),
                nn.BatchNorm(in_channels=64), nn.Dropout(dropout), nn.Dense(8, in_units=64))
    net.initialize(ctx=mx.gpu(device.index))
    return net


@pytest.mark.cuda
def test_replay_matches_eager_on_card(cuda_device):
    """Warm-up, capture and replays of a small net against eager steps on
    the card, bit for bit; each call after the warm-up is one replay."""
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    x = torch.randn(16, 32, generator=gen, device=cuda_device)
    y = torch.randn(16, 8, generator=gen, device=cuda_device)
    runs = []
    for folded in (False, True):
        net = _card_mlp(cuda_device, 0.0)
        tr = mx.gluon.Trainer(net.collect_params(), "adam", {"learning_rate": 0.01})
        if folded:
            prog = tr.fold_step(_l2(net), block=net)
            replays = step_fold.StepProgram.replays
            losses = [prog(x, y) for _ in range(4)]
            assert step_fold.StepProgram.replays - replays == 3 and prog.captured
        else:
            losses = [_eager_step(net, tr, _l2(net), (x, y)) for _ in range(4)]
        torch.cuda.synchronize()
        runs.append([p.data() for p in net.collect_params().values()] + _state_tensors(tr)
                    + losses)
    assert all(torch.equal(a, b) for a, b in zip(*runs))


@pytest.mark.cuda
def test_replay_draws_fresh_dropout_masks_on_card(cuda_device):
    """The device generator is registered with the graph: two replays drop
    different elements, each about the dropout rate of them."""
    net = _card_mlp(cuda_device, 0.25)
    tr = mx.gluon.Trainer(net.collect_params(), "sgd", {"learning_rate": 0.01})
    probe = {}

    def hook(_, args, out):
        if "dropped" not in probe:
            probe["dropped"] = torch.empty(out.shape, dtype=torch.bool, device=out.device)
        probe["dropped"].copy_((out == 0) & (args[0] != 0))

    net[2].register_forward_hook(hook)
    prog = tr.fold_step(_l2(net), block=net)
    x = torch.randn(4096, 32, device=cuda_device)
    y = torch.randn(4096, 8, device=cuda_device)
    prog(x, y)
    prog(x, y)
    first = probe["dropped"].clone()
    prog(x, y)
    assert prog.captured and not torch.equal(first, probe["dropped"])
    for m in (first, probe["dropped"]):
        assert abs(m.float().mean().item() - 0.25) < 0.01


@pytest.mark.cuda
def test_fold_update_replays_on_card(cuda_device, monkeypatch):
    """``MXNET_STEP_FOLD=1`` on the card: the optimizer tail runs eagerly,
    then is captured and replayed, bit-equal to the fused update."""
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    x = torch.randn(16, 32, generator=gen, device=cuda_device)
    y = torch.randn(16, 8, generator=gen, device=cuda_device)
    runs = []
    for env in ("", "1"):
        monkeypatch.setenv("MXNET_STEP_FOLD", env)
        net = _card_mlp(cuda_device, 0.0)
        tr = mx.gluon.Trainer(net.collect_params(), "sgd",
                              {"learning_rate": 0.05, "momentum": 0.9})
        replays = step_fold.fold_update.replays
        for _ in range(4):
            _eager_step(net, tr, _l2(net), (x, y))
        assert step_fold.fold_update.replays - replays == (3 if env else 0)
        torch.cuda.synchronize()
        runs.append([p.data() for p in net.collect_params().values()] + _state_tensors(tr))
    assert all(torch.equal(a, b) for a, b in zip(*runs))
