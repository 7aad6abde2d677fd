"""The training-surface slice as a whole, against the JAX package on the
CPU: a 2-layer, 64-unit BERT trained three steps with LAMB, weight decay
and a PolyScheduler warm-up (fp32, dropout 0), from the same parameters
carried across by structural key; then the same under fp16 AMP with
``amp.init_trainer``: the same loss-scale sequence, and a step whose
scaled loss overflows skipped bit-exactly in both packages."""
import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as mxj
from incubator_mxnet_tpu.gluon.model_zoo import bert as jbert
import incubator_mxnet_torch as mx
from incubator_mxnet_torch.convert import load_numpy_params
from incubator_mxnet_torch.gluon.model_zoo import bert as tbert

CFG = dict(vocab_size=128, units=64, hidden_size=128, num_layers=2, num_heads=2,
           max_length=64, dropout=0.0)
B, S, P = 3, 16, 5
# fp32 through 2 post-LN layers agrees to ~1e-6 relative; LAMB, like Adam,
# divides each gradient by its running RMS, which amplifies that where a
# gradient is small: losses to 1e-5, parameters to 1e-4 relative / 1e-5
# absolute (lr <= 1e-3).
LOSS_TOL = dict(rtol=1e-5, atol=1e-5)
PARAM_TOL = dict(rtol=1e-4, atol=1e-5)
# fp16 AMP: each package's fp16 matmuls round in their own order; the
# losses agree to 1e-2 relative.
AMP_LOSS_TOL = dict(rtol=1e-2, atol=1e-2)


def _batch(seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, 128, (B, S)).astype(np.int32),
            rng.randint(0, 2, (B, S)).astype(np.int32),
            rng.randint(0, S, (B, P)).astype(np.int32),
            rng.randint(0, 128, (B, P)).astype(np.int32))


@pytest.fixture(scope="module")
def start():
    mxj.random.seed(0)
    jnet = jbert.BERTForPretrain(jbert.BERTModel(**CFG), vocab_size=128)
    jnet.initialize()
    jnet(mxj.nd.zeros((1, 4), dtype="int32"))
    return {k: p.data().asnumpy() for k, p in jnet._collect_params_with_prefix().items()}


def _nets(start):
    jnet = jbert.BERTForPretrain(jbert.BERTModel(**CFG), vocab_size=128)
    jnet.initialize()
    jnet(mxj.nd.zeros((1, 4), dtype="int32"))
    params = jnet._collect_params_with_prefix()
    for k, v in start.items():
        params[k].set_data(mxj.nd.array(v))
    tnet = tbert.BERTForPretrain(tbert.BERTModel(**CFG), vocab_size=128)
    tnet.initialize(ctx=mx.cpu())
    load_numpy_params(tnet, start)
    return jnet, tnet


def _trainer(pkg, net):
    sched = pkg.lr_scheduler.PolyScheduler(max_update=8, base_lr=1e-3, pwr=1, warmup_steps=2)
    return pkg.gluon.Trainer(net.collect_params(), "lamb", {
        "learning_rate": 1e-3, "wd": 0.01, "lr_scheduler": sched})


def _step(pkg, net, trainer, batch, scaled=False):
    if pkg is mxj:
        ids, types, pos, labels = (mxj.nd.array(a, dtype="int32") for a in batch)
    else:
        ids, types, pos, labels = (torch.from_numpy(a) for a in batch)
    loss_fn = pkg.gluon.loss.SoftmaxCrossEntropyLoss()
    with pkg.autograd.record():
        mlm, _ = net(ids, types, pos)
        loss = loss_fn(mlm.reshape((-1, 128)), labels.reshape((-1,)))
        if scaled:
            with pkg.amp.scale_loss(loss, trainer) as s:
                pass
    pkg.autograd.backward(s if scaled else loss)
    trainer.step(B)
    return np.asarray(loss.asnumpy() if pkg is mxj else loss.detach().float().numpy())


def _weights(pkg, net):
    return {k: np.asarray(p.data().asnumpy() if pkg is mxj else p.data().detach().numpy(),
                          np.float32).copy()
            for k, p in net._collect_params_with_prefix().items()}


def test_lamb_with_poly_schedule_matches_jax(start):
    jnet, tnet = _nets(start)
    jtr, ttr = _trainer(mxj, jnet), _trainer(mx, tnet)
    batch = _batch()
    for k in range(3):
        jl, tl = _step(mxj, jnet, jtr, batch), _step(mx, tnet, ttr, batch)
        np.testing.assert_allclose(tl, jl, err_msg=f"step {k}", **LOSS_TOL)
        assert ttr.learning_rate == jtr.learning_rate
    assert ttr.optimizer._index_update_count == jtr.optimizer._index_update_count
    jw, tw = _weights(mxj, jnet), _weights(mx, tnet)
    for key, ref in jw.items():
        np.testing.assert_allclose(tw[key], ref, err_msg=key, **PARAM_TOL)


def test_fp16_amp_loss_scaling_matches_jax(start):
    """Four steps under fp16 AMP through init_trainer: finite at 2**8, then
    a step at 2**40 that overflows (skipped: every weight bit for bit, the
    scale halved, no update counted), then finite again at 2**8."""
    runs = {}
    for pkg in (mxj, mx):
        jnet, tnet = _nets(start)
        net = jnet if pkg is mxj else tnet
        pkg.amp.init("float16")
        try:
            tr = _trainer(pkg, net)
            pkg.amp.init_trainer(tr)
            scales, losses, skipped_exact = [], [], None
            for k in range(4):
                tr._amp_loss_scaler.loss_scale = 2.0 ** 40 if k == 2 else 2.0 ** 8
                before = _weights(pkg, net)
                counts = dict(tr.optimizer._index_update_count)
                losses.append(_step(pkg, net, tr, _batch(k), scaled=True))
                scales.append(tr._amp_loss_scaler.loss_scale)
                if k == 2:
                    after = _weights(pkg, net)
                    skipped_exact = (all(np.array_equal(before[n], after[n]) for n in before)
                                     and dict(tr.optimizer._index_update_count) == counts)
            runs[pkg] = (scales, losses, skipped_exact, dict(tr.optimizer._index_update_count))
        finally:
            pkg.amp.disable()
    (js, jl, jskip, jc), (ts, tl, tskip, tc) = runs[mxj], runs[mx]
    assert ts == js == [2.0 ** 8, 2.0 ** 8, 2.0 ** 39, 2.0 ** 8]
    assert jskip and tskip and tc == jc
    assert set(tc.values()) == {3}
    for a, b in zip(tl, jl):
        np.testing.assert_allclose(a, b, **AMP_LOSS_TOL)
