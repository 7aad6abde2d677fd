"""``mx.rnn`` (the legacy symbolic cells, ``FusedRNNCell``,
``BucketSentenceIter``) and the RNN shape rule of the port against the
JAX package's, on the CPU.

Each cell graph is built in both packages (after ``_reset_naming()``):
the same arguments, the same ``infer_shape`` (the ``RNN`` op's
``parameters``/``state``/``state_cell`` rule among them) and the same
``tojson()``; bound to the same seeded values, a training forward and
backward give the same outputs and gradients within ``FP32_TOL`` of the
larger of each array's largest magnitude and 1 (fp32 through the same
ops in another summation order).  ``FusedRNNCell.pack_weights`` and
``unpack_weights`` match the JAX package's and are exact inverses, and
the fused graph equals the unrolled cells with the unpacked weights.
``BucketSentenceIter`` gives the same batches in both packages after one
``np.random.seed``.
"""
import numpy as np
import pytest

import incubator_mxnet_tpu as mxj
import incubator_mxnet_tpu.symbol as J
import incubator_mxnet_torch as mx
import incubator_mxnet_torch.symbol as S

FP32_TOL = 1e-5


def _close(a, b, tol=FP32_TOL):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    assert np.abs(a - b).max(initial=0.0) <= tol * max(np.abs(b).max(initial=0.0), 1.0)


def _pkg(Spkg):
    return mx if Spkg is S else mxj


def _build(Spkg, make_cell, T=3, layout="NTC"):
    Spkg.symbol._reset_naming()
    out, states = make_cell(_pkg(Spkg)).unroll(T, inputs=Spkg.var("data"), layout=layout,
                                               merge_outputs=True)
    return Spkg.Group([out] + list(states)) if states else out


def _run_pair(make_cell, data_shape, seed=0, layout="NTC", values=None):
    """Forward (training) and backward of the cell graph in both packages
    from the same values; returns the port's executor after checking."""
    T = data_shape[1 if layout == "NTC" else 0]
    jsym, tsym = _build(J, make_cell, T, layout), _build(S, make_cell, T, layout)
    assert tsym.list_arguments() == jsym.list_arguments()
    assert tsym.tojson() == jsym.tojson()
    ej = jsym.simple_bind(mxj.cpu(), data=data_shape)
    et = tsym.simple_bind(mx.cpu(), data=data_shape)
    assert {k: v.shape for k, v in et.arg_dict.items()} == \
        {k: v.shape for k, v in ej.arg_dict.items()}
    rng = np.random.RandomState(seed)
    vals = {k: (rng.randn(*v.shape) * (1.0 if k == "data" else 0.2)).astype(np.float32)
            for k, v in ej.arg_dict.items()}
    vals.update(values or {})
    ej.copy_params_from({k: mxj.nd.array(v) for k, v in vals.items()})
    et.copy_params_from({k: v.copy() for k, v in vals.items()})
    oj, ot = ej.forward(is_train=True), et.forward(is_train=True)
    for a, b in zip(ot, oj):
        _close(a.asnumpy(), b.asnumpy())
    seeds = [rng.randn(*o.shape).astype(np.float32) for o in oj]
    ej.backward([mxj.nd.array(s) for s in seeds])
    et.backward([mx.nd.array(s, ctx=mx.cpu()) for s in seeds])
    for k in ej.grad_dict:
        _close(et.grad_dict[k].asnumpy(), ej.grad_dict[k].asnumpy())
    return et


CELLS = {
    "rnn": lambda m: m.rnn.RNNCell(num_hidden=6, prefix="r_"),
    "rnn_relu": lambda m: m.rnn.RNNCell(num_hidden=6, activation="relu", prefix="r_"),
    "lstm": lambda m: m.rnn.LSTMCell(num_hidden=6, prefix="l_"),
    "gru": lambda m: m.rnn.GRUCell(num_hidden=6, prefix="g_"),
}


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_cells(cell):
    _run_pair(CELLS[cell], (2, 3, 5))


def _stack(m):
    stack = m.rnn.SequentialRNNCell()
    stack.add(m.rnn.LSTMCell(num_hidden=6, prefix="lstm_l0_"))
    stack.add(m.rnn.DropoutCell(0.0))
    stack.add(m.rnn.ResidualCell(m.rnn.GRUCell(num_hidden=6, prefix="gru_l1_")))
    return stack


def test_sequential_residual_dropout():
    et = _run_pair(_stack, (2, 3, 5))
    args = et._symbol.list_arguments()
    assert len(args) == len(set(args))  # one set of weights, shared by every step


def test_bidirectional_cell():
    _run_pair(lambda m: m.rnn.BidirectionalCell(m.rnn.LSTMCell(num_hidden=4, prefix="fw_"),
                                                m.rnn.GRUCell(num_hidden=4, prefix="bw_")),
              (2, 3, 5))


def test_zoneout_cell_at_rate_zero_is_its_base():
    _run_pair(lambda m: m.rnn.ZoneoutCell(m.rnn.LSTMCell(num_hidden=4, prefix="z_")),
              (2, 3, 5))


@pytest.mark.parametrize("mode,bidirectional,layout", [
    ("lstm", False, "NTC"), ("lstm", True, "TNC"), ("gru", True, "NTC"),
    ("rnn_tanh", False, "TNC"), ("rnn_relu", False, "NTC")])
def test_fused_cell(mode, bidirectional, layout):
    shape = (2, 4, 5) if layout == "NTC" else (4, 2, 5)
    _run_pair(lambda m: m.rnn.FusedRNNCell(6, num_layers=2, mode=mode,
                                           bidirectional=bidirectional, prefix=f"{mode}_"),
              shape, layout=layout)


def test_fused_packing_and_the_unrolled_cells():
    """``pack_weights``/``unpack_weights`` against the JAX package's, exact
    round trip, and the fused graph against a SequentialRNNCell of
    LSTMCells carrying the unpacked weights (outputs and gradients)."""
    rng = np.random.RandomState(6)
    C, H = 5, 6
    fused_t = mx.rnn.FusedRNNCell(H, num_layers=2, mode="lstm", prefix="lstm_")
    fused_j = mxj.rnn.FusedRNNCell(H, num_layers=2, mode="lstm", prefix="lstm_")
    n = mx.ops.rnn_ops.rnn_param_size("lstm", C, H, 2)
    packed = (rng.randn(n) * 0.2).astype(np.float32)
    un_t = fused_t.unpack_weights({"lstm_parameters": mx.nd.array(packed, ctx=mx.cpu())})
    un_j = fused_j.unpack_weights({"lstm_parameters": mxj.nd.array(packed)})
    assert sorted(un_t) == sorted(un_j)
    for k in un_j:
        np.testing.assert_array_equal(un_t[k].asnumpy(), un_j[k].asnumpy())
    np.testing.assert_array_equal(fused_t.pack_weights(un_t)["lstm_parameters"].asnumpy(), packed)
    np.testing.assert_array_equal(
        fused_t.pack_weights({k: v.asnumpy() for k, v in un_t.items()})["lstm_parameters"]
        .asnumpy(), packed)

    x = rng.randn(2, 4, C).astype(np.float32)
    S.symbol._reset_naming()
    fo, _ = fused_t.unroll(4, inputs=S.var("data"), layout="NTC")
    fe = fo.simple_bind(mx.cpu(), data=x.shape)
    fe.copy_params_from({"data": x, "lstm_parameters": packed})
    S.symbol._reset_naming()
    stack = mx.rnn.SequentialRNNCell()
    for i in range(2):
        stack.add(mx.rnn.LSTMCell(num_hidden=H, prefix=f"lstm_l{i}_", forget_bias=0.0))
    so, _ = stack.unroll(4, inputs=S.var("data"), merge_outputs=True)
    se = so.simple_bind(mx.cpu(), data=x.shape)
    se.copy_params_from({"data": x, **{k: v.asnumpy() for k, v in un_t.items()}})
    seed = rng.randn(2, 4, H).astype(np.float32)
    for ex in (fe, se):
        ex.forward(is_train=True)
        ex.backward(mx.nd.array(seed, ctx=mx.cpu()))
    _close(fe.outputs[0].asnumpy(), se.outputs[0].asnumpy())
    _close(fe.grad_dict["data"].asnumpy(), se.grad_dict["data"].asnumpy())
    regrad = fused_t.unpack_weights({"lstm_parameters": fe.grad_dict["lstm_parameters"]})
    for k, v in regrad.items():
        _close(v.asnumpy(), se.grad_dict[k].asnumpy())


def test_rnn_shape_rule():
    for mode, bi, layers in (("lstm", False, 2), ("gru", True, 1), ("rnn_tanh", True, 3)):
        outs = []
        for Spkg in (J, S):
            Spkg.symbol._reset_naming()
            kw = {"state_cell": Spkg.var("c0")} if mode == "lstm" else {}
            sym = Spkg.RNN(Spkg.var("data"), Spkg.var("parameters"), Spkg.var("h0"), mode=mode,
                           state_size=7, num_layers=layers, bidirectional=bi,
                           state_outputs=True, name="rnn", **kw)
            outs.append(sym.infer_shape(data=(5, 3, 4)))
        assert outs[1] == outs[0]
        arg_shapes = dict(zip(sym.list_arguments(), outs[1][0]))
        assert arg_shapes["parameters"] == (
            mx.ops.rnn_ops.rnn_param_size(mode, 4, 7, layers, bi),)
        assert arg_shapes["h0"] == (layers * (2 if bi else 1), 3, 7)


def test_begin_state_contract():
    for m in (mx, mxj):
        cell = m.rnn.LSTMCell(num_hidden=4, prefix="bs_")
        assert len(cell.begin_state(batch_size=3)) == 2
        with pytest.raises(ValueError, match="batch_size"):
            cell.begin_state()
    fused = mx.rnn.FusedRNNCell(6, num_layers=2, mode="lstm", prefix="f2_")
    for st in fused.begin_state(batch_size=3):
        assert st.infer_shape_partial()[1] == [(2, 3, 6)]


def test_forget_bias_through_the_initializer():
    """``forget_bias`` is the ``LSTMBias`` init attribute of the i2h bias,
    which ``Module.init_params`` honours, as in the JAX package."""
    S.symbol._reset_naming()
    cell = mx.rnn.LSTMCell(num_hidden=4, prefix="fb_", forget_bias=2.5)
    out, _ = cell.unroll(2, inputs=S.var("data"), merge_outputs=True)
    pred = S.FullyConnected(S.Reshape(out, shape=(-1, 4)), num_hidden=2, name="p")
    mod = mx.mod.Module(S.SoftmaxOutput(pred, S.var("softmax_label"), name="softmax"),
                        context=mx.cpu())
    mod.bind(data_shapes=[("data", (2, 2, 3))], label_shapes=[("softmax_label", (2, 2))])
    mod.init_params(mx.initializer.Xavier())
    b = mod.get_params()[0]["fb_i2h_bias"].asnumpy()
    assert (b[4:8] == 2.5).all() and (b[:4] == 0).all() and (b[8:] == 0).all()


def test_cell_graph_json_round_trip():
    """An unrolled cell graph written by either package loads in the other
    with the same numerics and the LSTMBias ``__init__`` attribute."""
    tsym = _build(S, CELLS["lstm"])
    jsym = _build(J, CELLS["lstm"])
    for text, loader in ((tsym.tojson(), J.load_json), (jsym.tojson(), S.load_json)):
        loaded = loader(text)
        attrs = {n.name: n.attrs for n in loaded._topo() if n.op is None}
        assert "__init__" in attrs["l_i2h_bias"]
    back = S.load_json(jsym.tojson())
    x = np.random.RandomState(0).randn(2, 3, 5).astype(np.float32)
    outs = []
    for sym in (tsym, back):
        ex = sym.simple_bind(mx.cpu(), data=x.shape)
        rng = np.random.RandomState(1)
        ex.copy_params_from({k: (x if k == "data" else rng.randn(*v.shape).astype(np.float32))
                             for k, v in ex.arg_dict.items()})
        outs.append(ex.forward()[0].asnumpy())
    np.testing.assert_array_equal(outs[0], outs[1])


def test_bucket_sentence_iter_same_batches_under_one_seed():
    rng = np.random.RandomState(3)
    sentences = [list(rng.randint(1, 50, rng.randint(2, 9))) for _ in range(60)]
    runs = []
    for m in (mxj, mx):
        np.random.seed(5)
        it = m.rnn.BucketSentenceIter(sentences, batch_size=4, buckets=[3, 5, 7],
                                      invalid_label=0)
        assert it.default_bucket_key == 7
        assert [(d.name, d.shape) for d in it.provide_data] == [("data", (4, 7))]
        epochs = []
        for _ in range(2):
            epochs.append([(b.bucket_key, b.data[0].asnumpy(), b.label[0].asnumpy())
                           for b in it])
            it.reset()
        runs.append(epochs)
    (je, te) = runs
    assert len(te[0]) == len(je[0]) > 0
    for tep, jep in zip(te, je):
        for (tk, td, tl), (jk, jd, jl) in zip(tep, jep):
            assert tk == jk and td.shape == (4, tk)
            np.testing.assert_array_equal(td, jd)
            np.testing.assert_array_equal(tl, jl)
            np.testing.assert_array_equal(tl[:, :-1], td[:, 1:])
            assert (tl[:, -1] == 0).all()
    batch = next(iter(mx.rnn.BucketSentenceIter(sentences, batch_size=4, buckets=[3, 5, 7])))
    assert batch.data[0].context == mx.cpu()
