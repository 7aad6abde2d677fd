"""``Executor.backward`` of the port against the JAX package's, on the CPU.

The same graph built in both packages, bound to the same numpy values
(arguments, aux states, inputs), runs a forward and a backward in each;
the gradients, outputs and moving statistics agree within ``FP32_TOL`` of
the larger of each array's largest magnitude and 1 (fp32 through the same
ops in another summation order, as ``tests/test_torch_symbol.py`` holds the
forward).  Covered: ``grad_req`` ``write``, ``add`` and ``null``;
``args_grad`` as a list and as a dict, the caller's NDArrays filled in
place of the executor's own; ``out_grads`` and a second backward after one
forward; backward after an inference forward (train-mode gradients from
batch statistics, the same dropout masks as that forward); the BatchNorm
moving statistics moved once a forward; the two loss heads, which ignore
their head gradient; a graph's ``RNN`` dropout, which only the port applies
(from its generator, the same masks again in a second backward); a small
ResNet graph (``tests/sym_resnet.py``) and a
one-layer BERT graph (``tests/sym_bert.py``) with a ``SoftmaxOutput`` on the
masked-LM logits.
"""
import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as mxj
import incubator_mxnet_tpu.symbol as J
import incubator_mxnet_torch as mx
import incubator_mxnet_torch.symbol as S
from sym_bert import bert_symbol
from sym_resnet import resnet_v1_symbol

FP32_TOL = 1e-4


def _close(a, b, tol=FP32_TOL):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    assert np.abs(a - b).max(initial=0.0) <= tol * max(np.abs(b).max(initial=0.0), 1.0)


def _mlp_bn(S, head="softmax", dropout=0.0):
    x = S.FullyConnected(S.var("data"), num_hidden=6, name="fc1")
    x = S.Activation(S.BatchNorm(x, name="bn", fix_gamma=False, momentum=0.8),
                     act_type="relu")
    if dropout:
        x = S.Dropout(x, p=dropout)
    x = S.FullyConnected(x, num_hidden=3, name="fc2")
    if head == "softmax":
        return S.SoftmaxOutput(x, S.var("softmax_label"), name="softmax")
    if head == "linear":
        return S.LinearRegressionOutput(x, S.var("lin_label"), name="lin")
    return S.tanh(x)


def _values(ex, seed=0, scale=0.5):
    """Seeded numpy values for every argument and aux state of ``ex``
    (labels as class indices, moving variances positive)."""
    rng = np.random.RandomState(seed)
    args = {}
    for k, v in ex.arg_dict.items():
        if k == "softmax_label":
            args[k] = rng.randint(0, 3, v.shape).astype(np.float32)
        elif k == "mlm_label":
            args[k] = rng.randint(0, 32, v.shape).astype(np.float32)
        elif np.dtype(str(v.dtype).replace("torch.", "")).kind in "iu":
            args[k] = rng.randint(0, 4, v.shape).astype(np.int32)
        else:
            args[k] = (rng.randn(*v.shape) * scale).astype(np.float32)
    aux = {k: (rng.rand(*v.shape) + 0.5).astype(np.float32) for k, v in ex.aux_dict.items()}
    return args, aux


def _pair(build, shapes, grad_req="write", seed=0, **kw):
    """The JAX and the port executors of ``build(S)``, bound to the same
    values; returns ``(ej, et, args)``."""
    jsym, tsym = build(J), build(S)
    ej = jsym.simple_bind(mxj.cpu(), grad_req=grad_req, **shapes, **kw)
    et = tsym.simple_bind(mx.cpu(), grad_req=grad_req, **shapes, **kw)
    args, aux = _values(ej, seed)
    ej.copy_params_from({k: mxj.nd.array(v, dtype=v.dtype) for k, v in args.items()},
                        {k: mxj.nd.array(v) for k, v in aux.items()})
    et.copy_params_from({k: v.copy() for k, v in args.items()},
                        {k: v.copy() for k, v in aux.items()})
    return ej, et, args


def _grads(ex):
    return {k: v.asnumpy() for k, v in ex.grad_dict.items() if v is not None}


def _same_grads(ej, et):
    gj, gt = _grads(ej), _grads(et)
    assert sorted(gj) == sorted(gt)
    for k in gj:
        _close(gt[k], gj[k])


MLP_SHAPES = {"data": (8, 5), "softmax_label": (8,)}


@pytest.mark.parametrize("req", ["write", "add", "null"])
def test_grad_req(req):
    ej, et, _ = _pair(_mlp_bn, MLP_SHAPES, grad_req=req)
    assert sorted(ej.grad_dict) == sorted(et.grad_dict)
    for _ in range(2):  # add accumulates over two steps, write keeps the last
        for ex in (ej, et):
            ex.forward(is_train=True)
            ex.backward()
    if req == "null":
        assert et.grad_dict == {} and ej.grad_dict == {}
    _same_grads(ej, et)


def test_grad_req_per_argument():
    reqs = {"fc1_weight": "add", "fc2_weight": "write", "bn_gamma": "null"}
    ej, et, _ = _pair(_mlp_bn, MLP_SHAPES, grad_req=reqs)
    for _ in range(2):
        for ex in (ej, et):
            ex.forward(is_train=True)
            ex.backward()
    assert sorted(et.grad_dict) == ["fc1_weight", "fc2_weight"]
    _same_grads(ej, et)


@pytest.mark.parametrize("form", ["list", "dict"])
def test_args_grad_buffers_are_the_callers(form):
    jsym, tsym = _mlp_bn(J), _mlp_bn(S)
    shapes = dict(zip(tsym.list_arguments(), tsym.infer_shape(**MLP_SHAPES)[0]))
    rng = np.random.RandomState(1)
    vals = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    vals["softmax_label"] = rng.randint(0, 3, shapes["softmax_label"]).astype(np.float32)
    aux = {k: np.ones(s, np.float32) for k, s in zip(tsym.list_auxiliary_states(),
                                                      tsym.infer_shape(**MLP_SHAPES)[2])}
    names = ["fc1_weight", "fc2_weight", "bn_beta"]
    bufs = {n: mx.nd.zeros(shapes[n], ctx=mx.cpu()) for n in names}
    jbufs = {n: mxj.nd.zeros(shapes[n]) for n in names}
    if form == "list":
        targ = [bufs.get(n) for n in tsym.list_arguments()]
        # the JAX executor takes no None in the list: it gets a buffer each
        jarg = [jbufs[n] if n in jbufs else mxj.nd.zeros(shapes[n])
                for n in jsym.list_arguments()]
    else:
        targ, jarg = bufs, jbufs
    req = {n: "write" for n in names}
    et = tsym.bind(mx.cpu(), {k: mx.nd.array(v, ctx=mx.cpu()) for k, v in vals.items()},
                   args_grad=targ, grad_req=req,
                   aux_states={k: mx.nd.array(v, ctx=mx.cpu()) for k, v in aux.items()})
    ej = jsym.bind(mxj.cpu(), {k: mxj.nd.array(v) for k, v in vals.items()},
                   args_grad=jarg, grad_req=req,
                   aux_states={k: mxj.nd.array(v) for k, v in aux.items()})
    for ex in (ej, et):
        ex.forward(is_train=True)
        ex.backward()
    for n in names:
        assert et.grad_dict[n] is bufs[n]
        assert np.abs(bufs[n].asnumpy()).max() > 0
        _close(bufs[n].asnumpy(), jbufs[n].asnumpy())


def test_out_grads_and_backward_twice():
    ej, et, _ = _pair(lambda S: _mlp_bn(S, head=None), {"data": (8, 5)})
    seed = np.random.RandomState(2).randn(8, 3).astype(np.float32)
    for ex, og in ((ej, mxj.nd.array(seed)), (et, mx.nd.array(seed, ctx=mx.cpu()))):
        ex.forward(is_train=True)
        ex.backward(out_grads=og)
    first = _grads(et)
    _same_grads(ej, et)
    et.backward(out_grads=torch.from_numpy(seed))  # a tensor seed, the same graph
    ej.backward(out_grads=mxj.nd.array(seed))
    for k, v in _grads(et).items():
        np.testing.assert_array_equal(v, first[k])
    _same_grads(ej, et)


def test_out_grads_cast_to_output_dtype():
    """A float64 numpy seed is cast to the output's dtype."""
    ej, et, _ = _pair(lambda S: _mlp_bn(S, head=None), {"data": (8, 5)})
    seed = np.random.RandomState(3).randn(8, 3)
    for ex in (ej, et):
        ex.forward(is_train=True)
    et.backward(out_grads=[seed])
    ej.backward(out_grads=[mxj.nd.array(seed.astype(np.float32))])
    assert all(v.dtype == torch.float32 for v in (g._data for g in et.grad_dict.values()))
    _same_grads(ej, et)


def test_backward_after_inference_forward():
    """Train-mode gradients (batch statistics) after ``forward(is_train=
    False)``, as the JAX executor's recompute gives them, and no moving-
    statistics update from the backward."""
    ej, et, _ = _pair(_mlp_bn, MLP_SHAPES)
    for ex in (ej, et):
        ex.forward(is_train=False)
    mm = et.aux_dict["bn_moving_mean"].asnumpy().copy()
    for ex in (ej, et):
        ex.backward()
    np.testing.assert_array_equal(et.aux_dict["bn_moving_mean"].asnumpy(), mm)
    _same_grads(ej, et)
    # the same gradients a training forward gives
    train = _pair(_mlp_bn, MLP_SHAPES)[1]
    train.forward(is_train=True)
    train.backward()
    for k, v in _grads(train).items():
        _close(_grads(et)[k], v, 1e-6)


def test_backward_recompute_draws_the_forwards_dropout_masks():
    """Dropout masks cannot match across the two packages' generators:
    within the port, backward after an inference forward walks the graph
    from the generator state that forward started from, so it equals the
    backward of a training forward from that same state, and it leaves the
    generator where it was."""
    mx.random.seed(7)
    a = _pair(lambda S: _mlp_bn(S, dropout=0.5), MLP_SHAPES)[1]
    a.forward(is_train=True)
    a.backward()
    mx.random.seed(7)
    b = _pair(lambda S: _mlp_bn(S, dropout=0.5), MLP_SHAPES)[1]
    b.forward(is_train=False)
    gen = mx.random.get_generator("cpu")
    state = gen.get_state()
    b.backward()
    assert torch.equal(gen.get_state(), state)
    for k, v in _grads(a).items():
        np.testing.assert_allclose(_grads(b)[k], v, rtol=1e-6, atol=1e-7)


def _rnn_graph(S, p=0.5):
    x = S.RNN(S.var("data"), S.var("rnn_parameters"), mode="lstm", state_size=6,
              num_layers=2, p=p, name="rnn")
    return S.tanh(x)


RNN_SHAPES = {"data": (5, 3, 4)}


def test_rnn_dropout_in_a_graph_draws_from_the_ports_generator():
    """A graph's ``RNN(p=...)`` drops between its layers in a training
    forward, from the port's generator (the JAX package's executor gives the
    op no key, so it never drops there): the same seed gives the same
    output, a second backward walks the graph again with the forward's
    masks, and an inference forward drops nothing, as in the JAX package."""
    ej, et, _ = _pair(_rnn_graph, RNN_SHAPES)
    plain = _pair(lambda S: _rnn_graph(S, p=0.0), RNN_SHAPES)[1]
    ej.forward(is_train=False)
    _close(et.forward(is_train=False)[0].asnumpy(), ej.outputs[0].asnumpy())
    outs, grads = [], []
    for _ in range(2):
        mx.random.seed(11)
        outs.append(et.forward(is_train=True)[0].asnumpy())
        et.backward()
        first = _grads(et)
        et.backward()
        assert all(np.array_equal(first[k], v) for k, v in _grads(et).items())
        grads.append(first)
    np.testing.assert_array_equal(outs[0], outs[1])
    for k in grads[0]:
        np.testing.assert_array_equal(grads[0][k], grads[1][k])
    dropped = np.abs(outs[0] - plain.forward(is_train=True)[0].asnumpy()).max()
    assert dropped > 1e-3


def test_moving_statistics_move_once_a_forward():
    ej, et, _ = _pair(_mlp_bn, MLP_SHAPES)
    for ex in (ej, et):
        ex.forward(is_train=True)
        ex.backward()
        ex.backward()
    for k in ("bn_moving_mean", "bn_moving_var"):
        _close(et.aux_dict[k].asnumpy(), ej.aux_dict[k].asnumpy())
    before = et.aux_dict["bn_moving_mean"].asnumpy().copy()
    et.forward(is_train=True)
    assert not np.allclose(et.aux_dict["bn_moving_mean"].asnumpy(), before)


@pytest.mark.parametrize("head", ["softmax", "linear"])
def test_loss_heads_ignore_the_head_gradient(head):
    shapes = ({"data": (8, 5), "softmax_label": (8,)} if head == "softmax"
              else {"data": (8, 5), "lin_label": (8, 3)})
    ej, et, _ = _pair(lambda S: _mlp_bn(S, head=head), shapes)
    for ex in (ej, et):
        ex.forward(is_train=True)
    et.backward()
    ones = _grads(et)
    seed = np.random.RandomState(4).randn(8, 3).astype(np.float32)
    et.backward(out_grads=mx.nd.array(seed, ctx=mx.cpu()))
    ej.backward(out_grads=mxj.nd.array(seed))
    for k, v in _grads(et).items():
        np.testing.assert_array_equal(v, ones[k])
    _same_grads(ej, et)


def test_small_resnet_graph():
    """ResNet-18 depth (BasicBlockV1 [2, 2, 2, 2]), narrow, 32x32, 10
    classes, B=4: outputs, every gradient and the moving statistics."""
    build = lambda S: resnet_v1_symbol(S, (2, 2, 2, 2), (8, 8, 16, 32, 64), 10,  # noqa: E731
                                       thumbnail=True, bottleneck=False)
    ej, et, _ = _pair(build, {"data": (4, 3, 32, 32), "softmax_label": (4,)})
    oj = ej.forward(is_train=True)[0].asnumpy()
    ot = et.forward(is_train=True)[0].asnumpy()
    _close(ot, oj)
    for ex in (ej, et):
        ex.backward()
    _same_grads(ej, et)
    for k in ej.aux_dict:
        _close(et.aux_dict[k].asnumpy(), ej.aux_dict[k].asnumpy())


def test_bert_graph_with_softmax_output():
    def build(S):
        mlm = bert_symbol(S, num_layers=1, units=16, hidden_size=32, num_heads=2,
                          vocab_size=32, seq_len=8, num_masked=3, max_length=16)[0]
        return S.SoftmaxOutput(mlm, S.var("mlm_label"), name="mlm_softmax")

    shapes = {"token_ids": (2, 8), "token_types": (2, 8), "masked_positions": (2, 3),
              "mlm_label": (2, 3)}
    # the embedding tables are named float32: the JAX package's infer_type
    # gives them their integer input's type
    types = {"token_ids": "int32", "token_types": "int32", "masked_positions": "int32",
             "bertmodel0_word_embed_weight": "float32",
             "bertmodel0_type_embed_weight": "float32"}
    # the integer inputs and the label take no gradient (the JAX executor
    # cannot write one for an integer input)
    req = {n: "null" if n in shapes else "write" for n in build(S).list_arguments()}
    ej, et, args = _pair(build, shapes, grad_req=req, type_dict=types)
    for k in ("token_types", "masked_positions"):
        v = np.random.RandomState(5).randint(0, 2 if k == "token_types" else 8,
                                             shapes[k]).astype(np.int32)
        ej.arg_dict[k]._data = mxj.nd.array(v, dtype="int32")._data
        et.arg_dict[k]._data = torch.from_numpy(v)
    oj = ej.forward(is_train=True)[0].asnumpy()
    ot = et.forward(is_train=True)[0].asnumpy()
    _close(ot, oj)
    for ex in (ej, et):
        ex.backward()
    _same_grads(ej, et)


def test_reshape_shares_weights_and_gradients():
    _, et, _ = _pair(_mlp_bn, MLP_SHAPES)
    small = et.reshape(data=(4, 5), softmax_label=(4,))
    for n in ("fc1_weight", "bn_gamma"):
        assert small.arg_dict[n] is et.arg_dict[n]
        assert small.grad_dict[n] is et.grad_dict[n]
    assert small.arg_dict["data"].shape == (4, 5)
    rng = np.random.RandomState(6)
    small.forward(is_train=True, data=rng.randn(4, 5).astype(np.float32),
                  softmax_label=rng.randint(0, 3, 4).astype(np.float32))
    small.backward()
    assert np.abs(et.grad_dict["fc1_weight"].asnumpy()).max() > 0
