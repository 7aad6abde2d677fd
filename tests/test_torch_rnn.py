"""The RNN op (``mx.nd.RNN``/``RNNFused``), ``gluon.rnn`` and
``gluon.contrib.rnn`` of the port against the JAX package's, on the CPU.

The op: all four modes, one and two directions, two layers, with and
without initial states and ``state_outputs``; the outputs and the
gradients of data, packed parameters and states (a seeded head gradient)
agree with the JAX op's ``jax.vjp`` within ``FP32_TOL`` of the larger of
each array's largest magnitude and 1 (fp32 through the same gate math in
another summation order).  bf16 follows the JAX package's
``test_rnn_megaop_bf16``: a bf16 result that tracks fp32 within
``BF16_TOL``, and the port's bf16 result within ``BF16_TOL`` of the JAX
package's.  The validation errors are the JAX op's.

The cells and layers: the same blocks in both packages, the port's carrying
the JAX block's weights by structural key (``convert.load_numpy_params``:
``l0_i2h_weight``, ``r0_h2h_bias`` ...), run forward and backward under
``autograd.record()``; outputs, states and every parameter's gradient agree
within ``FP32_TOL``.  Dropout cannot match across the two generators, so
the stochastic cells run at rate 0 or in inference, and the port's own
dropout is checked for reproducibility from one seed.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as mxj
import incubator_mxnet_torch as mx
from incubator_mxnet_tpu.ops import rnn_ops as jrnn
from incubator_mxnet_torch.convert import load_numpy_params
from incubator_mxnet_torch.ops import rnn_ops as trnn

FP32_TOL = 1e-5
# the JAX package's test_rnn_megaop_bf16 bound (rtol = atol = 5e-2)
BF16_TOL = 5e-2


def _close(a, b, tol=FP32_TOL):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    assert np.abs(a - b).max(initial=0.0) <= tol * max(np.abs(b).max(initial=0.0), 1.0)


# -- the op -------------------------------------------------------------------------------


# every mode one-directional with initial states and two-directional
# without; LSTM and GRU the other way round too
OP_CASES = [(m, False, True) for m in ("lstm", "gru", "rnn_tanh", "rnn_relu")] + \
    [(m, True, False) for m in ("lstm", "gru", "rnn_tanh", "rnn_relu")] + \
    [("lstm", True, True), ("gru", False, False)]


@pytest.mark.parametrize("mode,bidirectional,states", OP_CASES)
def test_rnn_op_forward_and_gradients(mode, bidirectional, states):
    T, N, C, H, L = 4, 3, 5, 7, 2
    dirs = 2 if bidirectional else 1
    rng = np.random.RandomState(0)
    n = trnn.rnn_param_size(mode, C, H, L, bidirectional)
    assert n == jrnn.rnn_param_size(mode, C, H, L, bidirectional)
    inputs = [rng.randn(T, N, C).astype(np.float32),
              (rng.randn(n) * 0.3).astype(np.float32)]
    if states:
        inputs.append(rng.randn(L * dirs, N, H).astype(np.float32))
        if mode == "lstm":
            inputs.append(rng.randn(L * dirs, N, H).astype(np.float32))
    kw = dict(mode=mode, state_size=H, num_layers=L, bidirectional=bidirectional,
              state_outputs=True)
    outs_j, vjp = jax.vjp(lambda *a: jrnn.rnn_mega(*a, **kw), *[jnp.asarray(a) for a in inputs])
    seeds = [rng.randn(*o.shape).astype(np.float32) for o in outs_j]
    grads_j = vjp(tuple(jnp.asarray(s) for s in seeds))

    leaves = [torch.from_numpy(a.copy()).requires_grad_() for a in inputs]
    outs_t = trnn.rnn_mega(*leaves, **kw)
    assert len(outs_t) == (3 if mode == "lstm" else 2)
    grads_t = torch.autograd.grad(outs_t, leaves, [torch.from_numpy(s) for s in seeds])
    for a, b in zip(outs_t, outs_j):
        _close(a.detach().numpy(), np.asarray(b))
    for a, b in zip(grads_t, grads_j):
        _close(a.numpy(), np.asarray(b))
    # without state_outputs: the output alone
    kw["state_outputs"] = False
    alone = mx.nd.RNN(*[torch.from_numpy(a) for a in inputs], **kw)
    _close(alone.numpy(), np.asarray(outs_j[0]))


def test_rnn_op_ndarrays_and_registry():
    rng = np.random.RandomState(1)
    x = rng.randn(3, 2, 4).astype(np.float32)
    p = (rng.randn(trnn.rnn_param_size("gru", 4, 5)) * 0.3).astype(np.float32)
    out = mx.nd.RNN(mx.nd.array(x, ctx=mx.cpu()), mx.nd.array(p, ctx=mx.cpu()),
                    mode="gru", state_size=5)
    assert isinstance(out, mx.nd.NDArray) and out.shape == (3, 2, 5)
    _close(out.asnumpy(), mxj.nd.RNN(mxj.nd.array(x), mxj.nd.array(p), mode="gru",
                                     state_size=5).asnumpy())


def test_rnn_op_validation():
    x = torch.zeros(3, 2, 4)
    n = trnn.rnn_param_size("gru", 4, 5)
    with pytest.raises(ValueError, match="parameters length"):
        mx.nd.RNN(x, torch.zeros(n + 1), torch.zeros(1, 2, 5), mode="gru", state_size=5)
    p = torch.zeros(trnn.rnn_param_size("lstm", 4, 5))
    for kw in ({"projection_size": 3}, {"lstm_state_clip_min": -8.0},
               {"lstm_state_clip_max": 8.0}, {"lstm_state_clip_nan": True},
               {"use_sequence_length": True}):
        with pytest.raises(NotImplementedError):
            mx.nd.RNN(x, p, mode="lstm", state_size=5, **kw)
    with pytest.raises(ValueError, match="BOTH"):
        mx.nd.RNN(x, p, torch.zeros(1, 2, 5), mode="lstm", state_size=5)
    with pytest.raises(ValueError):
        trnn.rnn_param_size("lstmp", 4, 5)
    # a sequence_length tensor without the flag is ignored, as in the reference
    out = mx.nd.RNN(x, p, mode="lstm", state_size=5, sequence_length=torch.ones(2))
    assert out.shape == (3, 2, 5)


def test_rnn_op_bf16():
    T, B, C, H = 5, 2, 3, 4
    n = trnn.rnn_param_size("gru", C, H)
    rng = np.random.RandomState(0)
    xv = rng.uniform(-1, 1, (T, B, C)).astype(np.float32)
    pv = rng.uniform(-0.3, 0.3, (n,)).astype(np.float32)
    out32 = mx.nd.RNN(torch.from_numpy(xv), torch.from_numpy(pv), mode="gru", state_size=H)
    out16 = mx.nd.RNN(torch.from_numpy(xv).bfloat16(), torch.from_numpy(pv).bfloat16(),
                      mode="gru", state_size=H)
    assert out16.dtype == torch.bfloat16
    np.testing.assert_allclose(out16.float().numpy(), out32.numpy(), rtol=BF16_TOL, atol=BF16_TOL)
    jax16 = mxj.nd.RNN(mxj.nd.array(xv, dtype="bfloat16"), mxj.nd.array(pv, dtype="bfloat16"),
                       mode="gru", state_size=H).asnumpy().astype(np.float32)
    np.testing.assert_allclose(out16.float().numpy(), jax16, rtol=BF16_TOL, atol=BF16_TOL)


def test_rnn_op_dropout_between_layers_from_the_ports_generator():
    """With ``p``, ``training`` and a generator the layers run one at a
    time with a mask drawn from that generator between them: the same seed
    gives the same output, and without ``training`` (or without a
    generator) no mask is drawn, as in the JAX op."""
    rng = np.random.RandomState(2)
    x = torch.from_numpy(rng.randn(4, 3, 5).astype(np.float32))
    p = torch.from_numpy((rng.randn(trnn.rnn_param_size("lstm", 5, 6, 3)) * 0.3)
                         .astype(np.float32))
    kw = dict(mode="lstm", state_size=6, num_layers=3, p=0.5)
    plain = trnn.rnn_mega(x, p, **{**kw, "p": 0.0})
    assert torch.equal(trnn.rnn_mega(x, p, **kw), plain)
    assert torch.equal(trnn.rnn_mega(x, p, training=True, **kw), plain)
    runs = [trnn.rnn_mega(x, p, training=True, key=torch.Generator().manual_seed(3), **kw)
            for _ in range(2)]
    assert torch.equal(runs[0], runs[1])
    assert not torch.allclose(runs[0], plain)


# -- gluon.rnn and gluon.contrib.rnn --------------------------------------------------------


def _pair(make):
    """``make(pkg)`` in both packages, the port's carrying the JAX block's
    initialized weights."""
    mxj.random.seed(0)
    jb = make(mxj)
    jb.initialize(mxj.init.Uniform(0.3))
    tb = make(mx)
    load_numpy_params(tb, {k: p.data().asnumpy() for k, p in jb._collect_params_with_prefix().items()},
                      ctx=mx.cpu())
    return jb, tb


def _host(g):
    return g.asnumpy() if hasattr(g, "asnumpy") else g.numpy()


def _nd(pkg, a):
    return mx.nd.array(a, ctx=mx.cpu()) if pkg is mx else mxj.nd.array(a)


def _run(pkg, block, call, inputs):
    """``call(block, *inputs)`` -> (outputs, states) under record(); the
    loss is the sum of squares of both; returns numpy outputs, states and
    parameter gradients by structural key."""
    xs = [_nd(pkg, a) for a in inputs]
    with pkg.autograd.record():
        out, states = call(block, *xs)
        outs = out if isinstance(out, (list, tuple)) else [out]
        loss = sum((o * o).sum() for o in list(outs) + list(states))
        loss.backward()
    grads = {k: _host(p.grad()) for k, p in block._collect_params_with_prefix().items()
             if p.grad_req != "null"}
    return [o.asnumpy() for o in outs], [s.asnumpy() for s in states], grads


def _same_run(make, call, inputs):
    jb, tb = _pair(make)
    (jo, js, jg), (to, ts, tg) = _run(mxj, jb, call, inputs), _run(mx, tb, call, inputs)
    assert len(to) == len(jo) and len(ts) == len(js)
    for a, b in zip(to + ts, jo + js):
        _close(a, b)
    assert sorted(tg) == sorted(jg)
    for k in jg:
        _close(tg[k], jg[k])
    return tb


X_NTC = np.random.RandomState(3).randn(3, 3, 4).astype(np.float32)  # N=3, T=3, C=4


def _unroll(layout="NTC", merge=True):
    def call(cell, x):
        return cell.unroll(3, x, layout=layout, merge_outputs=merge)
    return call


CELLS = {
    "rnn_tanh": lambda pkg: pkg.gluon.rnn.RNNCell(6, input_size=4),
    "rnn_relu": lambda pkg: pkg.gluon.rnn.RNNCell(6, activation="relu", input_size=4),
    "lstm": lambda pkg: pkg.gluon.rnn.LSTMCell(6, input_size=4),
    "gru": lambda pkg: pkg.gluon.rnn.GRUCell(6, input_size=4),
    "lstmp": lambda pkg: pkg.gluon.contrib.rnn.LSTMPCell(6, 3, input_size=4),
}


CELL_CASES = [(c, "NTC", True) for c in sorted(CELLS)] + [("lstm", "TNC", True),
                                                          ("gru", "NTC", False)]


@pytest.mark.parametrize("cell,layout,merge", CELL_CASES)
def test_cells_unroll(cell, layout, merge):
    x = X_NTC if layout == "NTC" else X_NTC.transpose(1, 0, 2).copy()
    _same_run(CELLS[cell], _unroll(layout, merge), [x])


def test_cell_step_and_state_info():
    jb, tb = _pair(CELLS["lstm"])
    x = X_NTC[:, 0]
    outs = []
    for pkg, cell in ((mxj, jb), (mx, tb)):
        states = cell.begin_state(batch_size=3, ctx=pkg.cpu())
        out, new = cell(_nd(pkg, x), states)
        outs.append([out.asnumpy()] + [s.asnumpy() for s in new])
    for a, b in zip(*outs[::-1]):
        _close(a, b)
    assert tb.state_info(3) == jb.state_info(3)


def _stack(pkg):
    s = pkg.gluon.rnn.SequentialRNNCell()
    s.add(pkg.gluon.rnn.LSTMCell(6, input_size=4))
    s.add(pkg.gluon.rnn.DropoutCell(0.0))
    s.add(pkg.gluon.rnn.ResidualCell(pkg.gluon.rnn.GRUCell(6, input_size=6)))
    return s


def test_sequential_dropout_residual_cells():
    tb = _same_run(_stack, _unroll(), [X_NTC])
    assert len(tb) == 3 and len(tb.state_info(3)) == 3


@pytest.mark.parametrize("valid_length", [False, True])
def test_bidirectional_cell(valid_length):
    def make(pkg):
        return pkg.gluon.rnn.BidirectionalCell(pkg.gluon.rnn.LSTMCell(5, input_size=4),
                                               pkg.gluon.rnn.GRUCell(5, input_size=4))

    def call(cell, x, *vl):
        return cell.unroll(3, x, layout="NTC", merge_outputs=True,
                           valid_length=vl[0] if vl else None)

    inputs = [X_NTC] + ([np.array([3, 2, 1], np.float32)] if valid_length else [])
    _same_run(make, call, inputs)


def test_zoneout_and_variational_dropout_cells_in_inference():
    """Inference: both cells are their base cell."""
    for wrap in (lambda pkg, c: pkg.gluon.rnn.ZoneoutCell(c, 0.3, 0.3),
                 lambda pkg, c: pkg.gluon.contrib.rnn.VariationalDropoutCell(c, 0.3, 0.3, 0.3)):
        jb, tb = _pair(lambda pkg: wrap(pkg, pkg.gluon.rnn.LSTMCell(6, input_size=4)))
        outs = []
        for pkg, cell in ((mxj, jb), (mx, tb)):
            out, _ = cell.unroll(3, _nd(pkg, X_NTC), layout="NTC")
            outs.append(out.asnumpy())
        _close(outs[1], outs[0])


def test_variational_dropout_reuses_its_masks():
    cell = mx.gluon.contrib.rnn.VariationalDropoutCell(mx.gluon.rnn.RNNCell(6, input_size=4),
                                                       drop_inputs=0.5)
    cell.initialize(ctx=mx.cpu())
    mx.random.seed(1)
    x = mx.nd.ones((3, 4), ctx=mx.cpu())
    with mx.autograd.record():
        cell(x, cell.begin_state(batch_size=3, ctx=mx.cpu()))
        mask = cell._input_mask.asnumpy()
        cell(x, cell.begin_state(batch_size=3, ctx=mx.cpu()))
    np.testing.assert_array_equal(cell._input_mask.asnumpy(), mask)
    assert set(np.unique(mask)) <= {0.0, 2.0}
    cell.reset()
    assert cell._input_mask is None


CONV = {
    "rnn": lambda pkg: pkg.gluon.contrib.rnn.Conv2DRNNCell((2, 6, 6), 3, i2h_pad=(1, 1)),
    "lstm": lambda pkg: pkg.gluon.contrib.rnn.Conv2DLSTMCell((2, 6, 6), 3),
    "gru": lambda pkg: pkg.gluon.contrib.rnn.Conv2DGRUCell((2, 6, 6), 3, i2h_kernel=(1, 1)),
}


@pytest.mark.parametrize("kind", sorted(CONV))
def test_conv2d_cells(kind):
    x = np.random.RandomState(4).randn(2, 2, 2, 6, 6).astype(np.float32)  # N, T, C, H, W

    def call(cell, x):
        return cell.unroll(2, x, layout="NTC", merge_outputs=True)

    _same_run(CONV[kind], call, [x])


LAYERS = {
    "lstm": lambda pkg, **kw: pkg.gluon.rnn.LSTM(6, num_layers=2, input_size=4, **kw),
    "gru": lambda pkg, **kw: pkg.gluon.rnn.GRU(6, num_layers=2, input_size=4, **kw),
    "rnn_relu": lambda pkg, **kw: pkg.gluon.rnn.RNN(6, num_layers=2, input_size=4, **kw),
    "rnn_tanh": lambda pkg, **kw: pkg.gluon.rnn.RNN(6, num_layers=2, activation="tanh",
                                                   input_size=4, **kw),
}


# every layer in TNC without states and bidirectional in NTC with states;
# the LSTM in the other two combinations too
LAYER_CASES = [(k, "TNC", False, False) for k in sorted(LAYERS)] + \
    [(k, "NTC", True, True) for k in sorted(LAYERS)] + \
    [("lstm", "TNC", True, True), ("lstm", "NTC", False, False)]


@pytest.mark.parametrize("kind,layout,bidirectional,with_states", LAYER_CASES)
def test_layers(kind, layout, bidirectional, with_states):
    dirs = 2 if bidirectional else 1
    x = X_NTC if layout == "NTC" else X_NTC.transpose(1, 0, 2).copy()
    n_states = 2 if kind == "lstm" else 1
    states = [np.random.RandomState(5 + i).randn(2 * dirs, 3, 6).astype(np.float32)
              for i in range(n_states)]

    def call(layer, x, *st):
        if not st:
            return layer(x), []
        return layer(x, list(st))

    _same_run(lambda pkg: LAYERS[kind](pkg, layout=layout, bidirectional=bidirectional),
              call, [x] + (states if with_states else []))


def test_layer_begin_state_and_repr():
    layer = mx.gluon.rnn.LSTM(6, num_layers=2, bidirectional=True, input_size=4)
    jlayer = mxj.gluon.rnn.LSTM(6, num_layers=2, bidirectional=True, input_size=4)
    states = layer.begin_state(3, ctx=mx.cpu())
    assert [s.shape for s in states] == [(4, 3, 6), (4, 3, 6)]
    assert layer.state_info(3) == jlayer.state_info(3)
    assert repr(layer) == repr(jlayer)


def test_lstm_cell_unroll_matches_the_lstm_layer():
    """The step-by-step cell and the fused layer, same weights."""
    layer = mx.gluon.rnn.LSTM(6, input_size=4)
    layer.initialize(mx.init.Uniform(0.3), ctx=mx.cpu())
    cell = mx.gluon.rnn.LSTMCell(6, input_size=4)
    cell.initialize(ctx=mx.cpu())
    for n in ("i2h_weight", "h2h_weight", "i2h_bias", "h2h_bias"):
        getattr(cell, n).set_data(getattr(layer, "l0_" + n).data())
    x = torch.from_numpy(X_NTC.transpose(1, 0, 2).copy())
    fused = layer(x)
    unrolled, _ = cell.unroll(3, x, layout="TNC")
    assert isinstance(unrolled, torch.Tensor)
    _close(unrolled.numpy(), fused.numpy())


def test_layer_dropout_draws_from_the_ports_generator():
    layer = mx.gluon.rnn.GRU(6, num_layers=3, dropout=0.5, input_size=4)
    layer.initialize(ctx=mx.cpu())
    x = torch.from_numpy(X_NTC.transpose(1, 0, 2).copy())
    outs = []
    for _ in range(2):
        mx.random.seed(11)
        with mx.autograd.record():
            outs.append(layer(x).detach())
    assert torch.equal(outs[0], outs[1])
    assert not torch.allclose(outs[0], layer(x))  # inference: no dropout


def test_contrib_queued_names_raise():
    for name in ("estimator", "Estimator", "nn"):
        with pytest.raises(AttributeError, match="11.4"):
            getattr(mx.gluon.contrib, name)
