"""``mx.sym`` and ``Executor`` of the port against the JAX package's, on
the CPU.

The same construction in both packages (each after ``_reset_naming()``)
gives the same argument, output and aux lists, the same ``tojson()``
string, and the same ``infer_shape``/``infer_type``; a JSON written by
either package loads in the other; ``simple_bind(...).forward()`` gives the
JAX executor's values, and a training-mode BatchNorm moves its aux states
alike.  Shape inference runs the ops on ``meta`` tensors, where the
attention wrapper takes its plain version and launches nothing.
"""
import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as mxj
import incubator_mxnet_tpu.symbol as J
import incubator_mxnet_torch as mx
import incubator_mxnet_torch.symbol as S
from incubator_mxnet_torch.ops import attention as tatt

# fp32 through a few ops in another summation order (tests/test_torch_bert.py).
FP32_TOL = 1e-4


def _fc(S, mxm):
    data = S.var("data")
    fc = S.FullyConnected(data, num_hidden=8, name="fc1")
    return S.Activation(fc, act_type="tanh", name="t1")


def _conv_bn(S, mxm):
    x = S.var("img")
    c = S.Convolution(x, num_filter=4, kernel=(3, 3), pad=(1, 1), name="conv")
    return S.Activation(S.BatchNorm(c, name="bn"), act_type="relu")


def _layernorm(S, mxm):
    return S.LayerNorm(S.var("data"), name="ln", eps=1e-6)


def _embedding(S, mxm):
    ids = S.var("token_ids", dtype="int32")
    return S.Embedding(ids, input_dim=20, output_dim=6, name="emb")


def _attention(S, mxm):
    qkv = S.FullyConnected(S.var("data"), num_hidden=24, flatten=False, name="qkv")
    return S.contrib.fused_qkv_attention(qkv, num_heads=2, name="att")


def _arith(S, mxm):
    a, b = S.var("a"), S.var("b")
    y = (a + b) * 2.0 - a / (b + 3.0) + 1.0 - a
    return S.Group([y, a > b, -(a ** 2.0), 5.0 - a, a.sum(axis=1), a.reshape((0, -1)),
                    S.tanh(a), S.negative(b), S.exp(a).astype("float32")])


def _internals(S, mxm):
    return _fc(S, mxm).get_internals()


def _scopes(S, mxm):
    with mxm.name.Prefix("stage1_"), mxm.AttrScope(ctx_group="dev1", lr_mult="0.1"):
        data = S.var("data")
        fc = S.FullyConnected(data, num_hidden=3)
    w = S.var("w", lr_mult=2.0, attr={"tag": "x"})
    return S.Group([fc, S.FullyConnected(fc, w, no_bias=True, num_hidden=2, name="head")])


SHAPES = {
    "fc": {"data": (2, 5)},
    "conv_bn": {"img": (2, 3, 6, 6)},
    "layernorm": {"data": (3, 7)},
    "embedding": {"token_ids": (2, 5)},
    "attention": {"data": (2, 4, 6)},
    "arith": {"a": (2, 3), "b": (2, 3)},
    "internals": {"data": (2, 5)},
    "scopes": {"data": (2, 4)},
}
BUILDERS = {"fc": _fc, "conv_bn": _conv_bn, "layernorm": _layernorm, "embedding": _embedding,
            "attention": _attention, "arith": _arith, "internals": _internals,
            "scopes": _scopes}


def _both(kind):
    J.symbol._reset_naming()
    j = BUILDERS[kind](J, mxj)
    S.symbol._reset_naming()
    t = BUILDERS[kind](S, mx)
    return j, t


@pytest.mark.parametrize("kind", sorted(BUILDERS))
def test_construction_matches_the_jax_package(kind):
    j, t = _both(kind)
    assert t.list_arguments() == j.list_arguments()
    assert t.list_outputs() == j.list_outputs()
    assert t.list_auxiliary_states() == j.list_auxiliary_states()
    assert t.attr_dict() == j.attr_dict()
    assert t.tojson() == j.tojson()
    assert t.infer_shape(**SHAPES[kind]) == j.infer_shape(**SHAPES[kind])
    assert t.infer_type(**SHAPES[kind]) == j.infer_type(**SHAPES[kind])


@pytest.mark.parametrize("kind", sorted(BUILDERS))
def test_json_loads_across_packages(kind, tmp_path):
    """A file written by either package loads in the other, and writes
    back the same bytes."""
    j, t = _both(kind)
    j.save(str(tmp_path / "j-symbol.json"))
    t.save(str(tmp_path / "t-symbol.json"))
    assert S.load(str(tmp_path / "j-symbol.json")).tojson() == j.tojson()
    assert J.load(str(tmp_path / "t-symbol.json")).tojson() == t.tojson()
    assert (tmp_path / "j-symbol.json").read_bytes() == (tmp_path / "t-symbol.json").read_bytes()


def test_attr_and_names_through_scopes():
    _, t = _both("scopes")
    assert t.list_arguments()[:3] == ["data", "stage1_fullyconnected0_weight",
                                      "stage1_fullyconnected0_bias"]
    assert t[0].attr("ctx_group") == "dev1" and t[0].attr("lr_mult") == "0.1"
    assert t.attr_dict()["w"] == {"lr_mult": "2.0", "tag": "x"}


def test_unported_op_names_its_queue():
    assert callable(S.CTCLoss)  # ported with the op library (ROADMAP §1 item 11.3)
    assert callable(S.RNN)  # ported with the RNNs (ROADMAP §1 item 11.2)
    assert callable(S.contrib.ROIAlign)
    with pytest.raises(AttributeError, match="ROADMAP §1 item 8"):
        S.moe_ffn
    assert callable(S.Custom)  # ported: a graph op (tests/test_torch_export_symbolblock.py)
    with pytest.raises(AttributeError, match="no op"):
        S.not_an_op


def _bind_both(kind, seed, is_train=False):
    """simple_bind in both packages with the same random arguments and aux
    states; returns (JAX executor, port executor, their outputs)."""
    j, t = _both(kind)
    shapes = SHAPES[kind]
    ej = j.simple_bind(grad_req="null", **shapes)
    et = t.simple_bind(mx.cpu(), grad_req="null", **shapes)
    rng = np.random.RandomState(seed)
    for name, arr in ej.arg_dict.items():
        if np.dtype(arr.dtype).kind == "i":
            v = rng.randint(0, 6, arr.shape).astype(np.int32)
        else:
            v = rng.randn(*arr.shape).astype(np.float32)
        arr[:] = v
        et.arg_dict[name][:] = torch.from_numpy(v)
    for name, arr in ej.aux_dict.items():
        v = rng.rand(*arr.shape).astype(np.float32) + 0.5
        arr[:] = v
        et.aux_dict[name][:] = torch.from_numpy(v)
    oj = [o.asnumpy() for o in ej.forward(is_train=is_train)]
    ot = [o.asnumpy() for o in et.forward(is_train=is_train)]
    return ej, et, oj, ot


@pytest.mark.parametrize("kind", ["fc", "conv_bn", "layernorm", "embedding", "attention",
                                  "arith"])
def test_simple_bind_forward_matches_the_jax_executor(kind):
    _, et, oj, ot = _bind_both(kind, seed=1)
    assert len(oj) == len(ot)
    for a, b in zip(oj, ot):
        assert a.shape == b.shape
        np.testing.assert_allclose(b, a, rtol=FP32_TOL, atol=FP32_TOL)
    # a second forward reuses the signature's plan
    assert len(et._fwd_cache) == 1
    et.forward()
    assert len(et._fwd_cache) == 1


def test_training_batchnorm_moves_aux_states_alike():
    ej, et, oj, ot = _bind_both("conv_bn", seed=2, is_train=True)
    np.testing.assert_allclose(ot[0], oj[0], rtol=FP32_TOL, atol=FP32_TOL)
    for name in ("bn_moving_mean", "bn_moving_var"):
        np.testing.assert_allclose(et.aux_dict[name].asnumpy(), ej.aux_dict[name].asnumpy(),
                                   rtol=FP32_TOL, atol=FP32_TOL)
    assert not np.allclose(et.aux_dict["bn_moving_mean"].asnumpy(), 0.0)


def test_forward_kwargs_copy_params_and_reshape():
    _, t = _both("fc")
    ex = t.simple_bind(mx.cpu(), data=(2, 5))
    rng = np.random.RandomState(3)
    w, b = rng.randn(8, 5).astype(np.float32), rng.randn(8).astype(np.float32)
    ex.copy_params_from({"fc1_weight": w, "fc1_bias": b})
    x = rng.randn(2, 5).astype(np.float32)
    np.testing.assert_allclose(ex.forward(data=x)[0].asnumpy(), np.tanh(x @ w.T + b),
                               rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError):
        ex.copy_params_from({"nope": w})
    with pytest.raises(ValueError):
        ex.forward(nope=x)
    big = ex.reshape(data=(6, 5))
    assert big.arg_dict["fc1_weight"] is ex.arg_dict["fc1_weight"]
    x6 = rng.randn(6, 5).astype(np.float32)
    np.testing.assert_allclose(big.forward(data=x6)[0].asnumpy(), np.tanh(x6 @ w.T + b),
                               rtol=1e-5, atol=1e-6)


def test_symbol_training_raises_until_module_is_ported():
    """``module/`` is ported (ROADMAP §1 item 11.1): ``backward`` and
    ``bind(args_grad=...)`` no longer raise, and train through the symbol
    path (``tests/test_torch_executor_backward.py`` holds them against the
    JAX executor)."""
    _, t = _both("fc")
    ex = t.simple_bind(mx.cpu(), data=(2, 5))
    ex.copy_params_from({"data": np.ones((2, 5), np.float32)})
    ex.forward(is_train=True)
    ex.backward()
    assert sorted(ex.grad_dict) == sorted(t.list_arguments())
    args = {k: v for k, v in ex.arg_dict.items()}
    grads = {k: mx.nd.zeros(v.shape, ctx=mx.cpu()) for k, v in args.items()}
    bound = t.bind(mx.cpu(), args=args, args_grad=grads)
    bound.forward(is_train=True)
    bound.backward()
    assert bound.grad_dict["fc1_weight"] is grads["fc1_weight"]
    np.testing.assert_array_equal(grads["fc1_weight"].asnumpy(),
                                  ex.grad_dict["fc1_weight"].asnumpy())


def test_executor_defaults_to_the_card():
    """With no ctx, simple_bind binds on the card; with none it raises."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    _, t = _both("fc")
    with pytest.raises(mx.MXNetError, match="ctx=mx.cpu"):
        t.simple_bind(data=(2, 5))


def test_meta_inference_through_attention_launches_nothing(monkeypatch):
    """infer_shape runs fused_qkv_attention on meta tensors: the wrapper
    takes its plain version there, and never reaches a kernel."""
    seen = []
    plain = tatt.flash_fwd_plain

    def spy(q, *a, **kw):
        seen.append(q.device.type)
        return plain(q, *a, **kw)

    def no_kernel(*a, **kw):
        raise AssertionError("a kernel path was reached")

    monkeypatch.setattr(tatt, "flash_fwd_plain", spy)
    monkeypatch.setattr(tatt, "_check_cuda_operands", no_kernel)
    monkeypatch.setattr(tatt, "_kernel_width", no_kernel)
    launches = tatt.flash_fwd.launches
    _, t = _both("attention")
    arg_shapes, out_shapes, _ = t.infer_shape(data=(3, 5, 6))
    assert out_shapes == [(3, 5, 8)]
    assert seen == ["meta"]
    assert tatt.flash_fwd.launches == launches
    # a meta tensor handed to the wrapper directly: shapes and dtypes only
    q = torch.empty(2, 3, 5, 16, dtype=torch.bfloat16, device="meta")
    o, lse = tatt.flash_fwd(q, q, q, with_lse=True)
    assert o.device.type == "meta" and o.shape == q.shape and o.dtype == torch.bfloat16
    assert lse.shape == (6, 5) and lse.dtype == torch.float32
