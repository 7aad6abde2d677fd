"""Slice 4 on the CPU: the tiny BERT of the port with every FFN activation
the user's ``rtc_gelu`` CustomOp (``chip_smoke.py``: ``mx.rtc`` kernels on
CUDA tensors, its plain GELU on CPU tensors), against the JAX package's
tiny BERT with its built-in GELU, the same parameters carried across by
structural key: the MLM logits and every parameter's gradient of one
backward.  On the card ``chip_smoke.py``'s ``rtc_train`` phase runs the
same swap at BERT-base width through the kernels.
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as mxj
from incubator_mxnet_tpu.gluon.model_zoo import bert as jbert
import incubator_mxnet_torch as mx
from incubator_mxnet_torch.convert import load_numpy_params
from incubator_mxnet_torch.gluon.model_zoo import bert as tbert

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402  (the user's rtc_gelu op and FFN swap)

CFG = dict(vocab_size=128, units=32, hidden_size=64, num_layers=2, num_heads=2,
           max_length=64, dropout=0.0)
# fp32 through 2 post-LN layers in another summation order: the logits as
# tests/test_torch_bert.py holds them, the gradients as
# tests/test_torch_training.py holds its Trainer steps' parameters.
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
B, S, P = 3, 16, 5


def _batch():
    rng = np.random.RandomState(0)
    return (rng.randint(0, 128, (B, S)).astype(np.int32),
            rng.randint(0, 2, (B, S)).astype(np.int32),
            rng.randint(0, S, (B, P)).astype(np.int32),
            rng.randint(0, 128, (B, P)).astype(np.int32))


@pytest.fixture(scope="module")
def jax_ref():
    """The JAX tiny BERTForPretrain with built-in GELU: its parameters, and
    the MLM logits and gradients of one backward of the summed loss."""
    mxj.random.seed(0)
    jnet = jbert.BERTForPretrain(jbert.BERTModel(**CFG), vocab_size=128)
    jnet.initialize()
    jnet(mxj.nd.zeros((1, 4), dtype="int32"))  # materialize deferred shapes
    jnet.hybridize()  # one compiled forward and backward instead of ~100 op compiles
    params = jnet._collect_params_with_prefix()
    arrays = {k: p.data().asnumpy() for k, p in params.items()}
    ids, types, pos, labels = (mxj.nd.array(a, dtype="int32") for a in _batch())
    loss_fn = mxj.gluon.loss.SoftmaxCrossEntropyLoss()
    with mxj.autograd.record():
        mlm, _ = jnet(ids, types, pos)
        loss = loss_fn(mlm.reshape((-1, 128)), labels.reshape((-1,)))
    loss.backward()
    grads = {k: p.grad().asnumpy() for k, p in params.items()}
    return arrays, mlm.asnumpy(), grads


def test_rtc_gelu_bert_matches_jax_builtin_gelu(jax_ref):
    arrays, jmlm, jgrads = jax_ref
    net = tbert.BERTForPretrain(tbert.BERTModel(**CFG), vocab_size=128)
    net.initialize(ctx=mx.cpu())
    load_numpy_params(net, arrays)
    ids, types, pos, labels = (torch.from_numpy(a) for a in _batch())
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    plain = chip_smoke.RtcGelu.plain_calls
    with chip_smoke.rtc_gelu_ffn(net) as swapped:
        with mx.autograd.record():
            mlm, _ = net(ids, types, pos)
            loss = loss_fn(mlm.reshape(-1, 128), labels.reshape(-1))
        mx.autograd.backward(loss)
    assert swapped == CFG["num_layers"]
    assert chip_smoke.RtcGelu.plain_calls == plain + 2 * CFG["num_layers"]  # fwd + bwd a layer
    assert type(net.bert.encoder._layers[0].ffn) is chip_smoke.PositionwiseFFN  # restored
    np.testing.assert_allclose(mlm.detach().numpy(), jmlm, err_msg="mlm_logits", **LOGIT_TOL)
    params = net._collect_params_with_prefix()
    assert params.keys() == jgrads.keys()
    for key, want in jgrads.items():
        np.testing.assert_allclose(params[key].grad().numpy(), want, err_msg=key, **GRAD_TOL)
