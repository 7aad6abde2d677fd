"""The port's ``Predictor`` against the JAX package's, on the CPU.

Mirrors ``tests/test_predictor_config.py``: the checkpoint-key split,
prefixed and bare checkpoints loading alike, aux keys classified, rebinds
sharing the parameter tensors by object and reusing cached executors, an
unknown input raising, and no card meaning an error rather than the CPU.
Then the served model of the slice, a tiny ``bert_symbol`` (2 layers, 64
units, 4 heads, vocab 100, S=16, P=3), through both packages' ``Predictor``
from one fp32 checkpoint, and the same graph against the port's Gluon
``BERTForPretrain`` with those weights (dropout 0).
"""
import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as mxj
import incubator_mxnet_tpu.symbol as J
from incubator_mxnet_tpu.predictor import Predictor as JPredictor
import incubator_mxnet_torch as mx
import incubator_mxnet_torch.symbol as S
from incubator_mxnet_torch.gluon.model_zoo import bert as tbert
from incubator_mxnet_torch.predictor import Predictor, _split_param_key, load_checkpoint

from sym_bert import bert_symbol

# fp32 through 2 post-LN layers in another summation order
# (tests/test_torch_bert.py).
FP32_TOL = 1e-4
TINY = dict(num_layers=2, units=64, hidden_size=128, num_heads=4, vocab_size=100,
            seq_len=16, num_masked=3)
GLUON = dict(vocab_size=100, units=64, hidden_size=128, num_layers=2, num_heads=4,
             max_length=64, dropout=0.0)


def _nd(v):
    return mx.nd.array(v, ctx=mx.cpu())


def _pred(sym, params, shapes):
    return Predictor(sym, params, shapes, dev_type="cpu")


def _fc_model(seed=0):
    S.symbol._reset_naming()
    fc = S.FullyConnected(S.var("data"), num_hidden=4, name="fc1")
    sym = S.Activation(fc, act_type="tanh", name="t1")
    rng = np.random.RandomState(seed)
    w, b = rng.randn(4, 3).astype(np.float32), rng.randn(4).astype(np.float32)
    return sym, {"arg:fc1_weight": _nd(w), "arg:fc1_bias": _nd(b)}, w, b


def _bn_model():
    S.symbol._reset_naming()
    fc = S.FullyConnected(S.var("data"), num_hidden=4, name="fc1")
    sym = S.BatchNorm(fc, name="bn1")
    rng = np.random.RandomState(0)
    shapes, _, aux_shapes = sym.infer_shape(data=(2, 3))
    args = {n: rng.randn(*s).astype(np.float32)
            for n, s in zip(sym.list_arguments(), shapes) if n != "data"}
    auxs = {n: rng.rand(*s).astype(np.float32)
            for n, s in zip(sym.list_auxiliary_states(), aux_shapes)}
    return sym, args, auxs


def test_split_param_key():
    assert _split_param_key("arg:weight") == ("arg", "weight")
    assert _split_param_key("aux:moving_mean") == ("aux", "moving_mean")
    assert _split_param_key("weight") == (None, "weight")
    assert _split_param_key("encoder:weight") == (None, "encoder:weight")
    assert _split_param_key("arg:scope:weight") == ("arg", "scope:weight")


def test_prefixed_and_bare_checkpoints_load_identically():
    sym, args, auxs = _bn_model()
    x = np.random.RandomState(1).rand(2, 3).astype(np.float32)
    prefixed = {f"arg:{k}": _nd(v) for k, v in args.items()}
    prefixed.update({f"aux:{k}": _nd(v) for k, v in auxs.items()})
    bare = {k: _nd(v) for k, v in {**args, **auxs}.items()}
    out_p = _pred(sym, prefixed, {"data": (2, 3)}).predict(data=x)
    out_b = _pred(sym, bare, {"data": (2, 3)}).predict(data=x)
    np.testing.assert_array_equal(out_p, out_b)
    _, arg_d, aux_d = load_checkpoint(sym, bare)
    assert set(aux_d) == set(auxs) and set(arg_d) == set(args)


def test_checkpoint_files_load(tmp_path):
    sym, params, w, b = _fc_model()
    sym.save(str(tmp_path / "m-symbol.json"))
    mx.nd.save(str(tmp_path / "m-0000.params"), params)
    pred = _pred(str(tmp_path / "m-symbol.json"), str(tmp_path / "m-0000.params"),
                 {"data": (2, 3)})
    x = np.random.RandomState(1).rand(2, 3).astype(np.float32)
    out = pred.predict(data=x)
    np.testing.assert_allclose(out, np.tanh(x @ w.T + b), rtol=1e-5, atol=1e-6)
    # the JAX package's Predictor reads the same two files
    jpred = JPredictor(str(tmp_path / "m-symbol.json"), str(tmp_path / "m-0000.params"),
                       {"data": (2, 3)})
    np.testing.assert_allclose(out, jpred.predict(data=x), rtol=FP32_TOL, atol=FP32_TOL)
    pred.set_input("data", np.ones((2, 3), np.float32))
    assert pred.forward().get_output(0).shape == (2, 4)
    assert pred.num_outputs() == 1 and len(pred.get_outputs()) == 1


def test_reshape_shares_param_tensors_and_reuses_executors():
    sym, params, w, b = _fc_model()
    pred = _pred(sym, params, {"data": (2, 3)})
    exe1 = pred._exe
    w1 = exe1.arg_dict["fc1_weight"]
    pred.forward()
    assert pred.is_warm()
    x = np.random.RandomState(2).rand(8, 3).astype(np.float32)
    out = pred.reshape({"data": (8, 3)}).predict(data=x)
    np.testing.assert_allclose(out, np.tanh(x @ w.T + b), rtol=1e-5, atol=1e-6)
    exe2 = pred._exe
    assert exe2 is not exe1
    # the SAME tensors back both executors: no second device copy
    assert exe2.arg_dict["fc1_weight"] is w1
    assert exe2.arg_dict["fc1_bias"] is exe1.arg_dict["fc1_bias"]
    pred.reshape({"data": (2, 3)})
    assert pred._exe is exe1 and pred.is_warm()
    assert pred.compile_stats() == {"executors": 2, "fwd_entries": 2}
    with pytest.raises(KeyError):
        pred.reshape({"nope": (2, 3)})
    with pytest.raises(KeyError):
        pred.set_input("nope", x)
    pred.close()
    pred.close()


def test_predictor_without_dev_type_raises_with_no_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    sym, params, _, _ = _fc_model()
    with pytest.raises(mx.MXNetError, match="ctx=mx.cpu"):
        Predictor(sym, params, {"data": (2, 3)})


def _tiny_checkpoint(seed=0):
    """The tiny served BERT's fp32 weights (numpy, by parameter name) and
    its inputs."""
    sym = bert_symbol(S, max_length=64, **TINY)
    shapes = {"token_ids": (3, 16), "token_types": (3, 16), "masked_positions": (3, 3)}
    arg_shapes, _, _ = sym.infer_shape(**shapes)
    rng = np.random.RandomState(seed)
    params = {n: (rng.randn(*s) * 0.2).astype(np.float32)
              for n, s in zip(sym.list_arguments(), arg_shapes) if n not in shapes}
    inputs = {"token_ids": rng.randint(0, 100, (3, 16)).astype(np.int32),
              "token_types": rng.randint(0, 2, (3, 16)).astype(np.int32),
              "masked_positions": rng.randint(0, 16, (3, 3)).astype(np.int32)}
    return sym, shapes, params, inputs


def test_tiny_bert_symbol_through_both_predictors(tmp_path):
    sym, shapes, params, inputs = _tiny_checkpoint()
    jsym = bert_symbol(J, max_length=64, **TINY)
    assert jsym.tojson() == sym.tojson()
    mx.nd.save(str(tmp_path / "bert-0000.params"),
               {"arg:" + k: _nd(v) for k, v in params.items()})
    sym.save(str(tmp_path / "bert-symbol.json"))
    pred = _pred(str(tmp_path / "bert-symbol.json"), str(tmp_path / "bert-0000.params"),
                 shapes)
    for k, v in inputs.items():
        pred.set_input(k, v)
    got = pred.forward().get_outputs()
    jpred = JPredictor(jsym, {"arg:" + k: mxj.nd.array(v) for k, v in params.items()}, shapes)
    for k, v in inputs.items():
        jpred.set_input(k, v)
    want = jpred.forward().get_outputs()
    assert [g.shape for g in got] == [(3, 3, 100), (3, 2)]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=FP32_TOL, atol=FP32_TOL)


def test_tiny_bert_symbol_equals_the_gluon_bert():
    net = tbert.BERTForPretrain(tbert.BERTModel(**GLUON), vocab_size=100)
    net.initialize(ctx=mx.cpu())
    net(torch.zeros(1, 4, dtype=torch.int32))
    names = (net.bert.prefix, net.prefix)
    sym = bert_symbol(S, max_length=64, names=names, **TINY)
    params = {"arg:" + k: p.data() for k, p in net.collect_params().items()}
    assert {k[4:] for k in params} == set(sym.list_arguments()) - {
        "token_ids", "token_types", "masked_positions"}
    rng = np.random.RandomState(4)
    ids = rng.randint(0, 100, (3, 16)).astype(np.int32)
    types = rng.randint(0, 2, (3, 16)).astype(np.int32)
    pos = rng.randint(0, 16, (3, 3)).astype(np.int32)
    pred = _pred(sym, params, {"token_ids": (3, 16), "token_types": (3, 16),
                               "masked_positions": (3, 3)})
    pred.set_input("token_ids", ids)
    pred.set_input("token_types", types)
    pred.set_input("masked_positions", pos)
    got = pred.forward().get_outputs()
    mlm, nsp = net(*(torch.from_numpy(a) for a in (ids, types, pos)))
    np.testing.assert_allclose(got[0], mlm.detach().numpy(), rtol=FP32_TOL, atol=FP32_TOL)
    np.testing.assert_allclose(got[1], nsp.detach().numpy(), rtol=FP32_TOL, atol=FP32_TOL)
