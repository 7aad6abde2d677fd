"""Serving's last three items against the JAX package, on the CPU:
``HybridBlock.export``, ``gluon.SymbolBlock`` and ``sym.Custom`` inside a
graph.

A tiny ``BERTForPretrain`` (2 layers, 32 units, 2 heads, vocab 128, dropout
0) is built in both packages with the same names (a fresh
``name_scope``), the JAX package's parameters carried to the port by
structural key (``convert.load_numpy_params``), seeded numpy inputs.
``export`` writes the same keys and values as the JAX ``export`` (exactly),
and each package reads the other's file.  The JAX ``SymbolBlock`` cannot
run (ROADMAP §3 "Not faults"), so the port's is held to the JAX
``Executor`` over the same ``tests/sym_bert.py`` graph and parameters: fp32
within ``SYM_REL`` of the largest |logit|.  A graph whose FFN activations
are ``sym.Custom`` of a numpy GELU registered in both packages goes
through the port's ``Predictor`` and the JAX executor (its
``pure_callback`` path), with shapes inferred from the op's prop and the
JSON the same in both.
"""
import json

import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as mxj
import incubator_mxnet_tpu.symbol as J
from incubator_mxnet_tpu.gluon import block as jblock
from incubator_mxnet_tpu.gluon.model_zoo import bert as jbert
import incubator_mxnet_torch as mx
import incubator_mxnet_torch.symbol as S
from incubator_mxnet_torch import profiler
from incubator_mxnet_torch.convert import load_numpy_params
from incubator_mxnet_torch.gluon import block as tblock
from incubator_mxnet_torch.gluon.model_zoo import bert as tbert
from incubator_mxnet_torch.predictor import Predictor, load_checkpoint

from sym_bert import DEFAULT_NAMES, bert_symbol

CFG = dict(vocab_size=128, units=32, hidden_size=64, num_layers=2, num_heads=2,
           max_length=64, dropout=0.0)
TINY = dict(num_layers=2, units=32, hidden_size=64, num_heads=2, vocab_size=128,
            seq_len=16, num_masked=3)
INPUTS = ("token_ids", "token_types", "masked_positions")
SHAPES = {"token_ids": (3, 16), "token_types": (3, 16), "masked_positions": (3, 3)}
# fp32 through 2 post-LN layers: the same arithmetic in another summation
# order, relative to the largest |logit|
SYM_REL = 1e-5
# gradients of the same graph walked by two routes in the port (Dense vs
# FullyConnected): relative L2 per parameter
GRAD_REL = 1e-5


def _inputs(seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, 128, (3, 16)).astype(np.int32),
            rng.randint(0, 2, (3, 16)).astype(np.int32),
            rng.randint(0, 16, (3, 3)).astype(np.int32))


def _rel(got, want):
    return float(np.abs(np.asarray(got) - np.asarray(want)).max() / np.abs(want).max())


@pytest.fixture(scope="module")
def nets():
    """The JAX and the port tiny BERT with the same names and weights."""
    with jblock.name_scope():
        mxj.random.seed(0)
        j = jbert.BERTForPretrain(jbert.BERTModel(**CFG), vocab_size=128)
    j.initialize()
    j(mxj.nd.zeros((1, 4), dtype="int32"))
    with tblock.name_scope():
        t = tbert.BERTForPretrain(tbert.BERTModel(**CFG), vocab_size=128)
    load_numpy_params(t, {k: p.data().asnumpy()
                          for k, p in j._collect_params_with_prefix().items()}, ctx=mx.cpu())
    assert (t.bert.prefix, t.prefix) == DEFAULT_NAMES == (j.bert.prefix, j.prefix)
    return j, t


@pytest.fixture(scope="module")
def exported(nets, tmp_path_factory):
    """Both packages' ``export`` of the hybridized nets after one forward."""
    j, t = nets
    d = tmp_path_factory.mktemp("export")
    ids, types, pos = _inputs()
    j.hybridize()
    j(mxj.nd.array(ids, dtype="int32"), mxj.nd.array(types, dtype="int32"),
      mxj.nd.array(pos, dtype="int32"))
    t.hybridize()
    t(*(torch.from_numpy(a) for a in (ids, types, pos)))
    return j.export(str(d / "jax"), epoch=3), t.export(str(d / "port"), epoch=3)


def test_export_writes_the_jax_keys_and_values(exported):
    (j_json, j_params), (t_json, t_params) = exported
    assert t_json.endswith("port-symbol.json") and t_params.endswith("port-0003.params")
    jd = mxj.nd.load(j_params)
    td = mxj.nd.load(t_params)  # the JAX package reads the port's file
    assert list(td) == list(jd)  # same keys, same (name) order
    assert {k[:4] for k in td} == {"arg:"}  # BERT has no aux state
    for k in jd:
        assert td[k].dtype == jd[k].dtype and np.array_equal(td[k].asnumpy(), jd[k].asnumpy()), k
    with open(t_json) as f:
        assert json.load(f)["format"] == tblock.EXPORT_FORMAT
    # the port's checkpoint loader reads the JAX package's file
    sym = bert_symbol(S, max_length=64, **TINY)
    _, args, aux = load_checkpoint(sym, j_params)
    assert not aux and sorted(args) == sorted(k[4:] for k in jd)
    for k, v in args.items():
        assert np.array_equal(v.asnumpy(), jd["arg:" + k].asnumpy()), k


def _dense_bn(pkg, scope):
    with scope():
        net = pkg.gluon.nn.HybridSequential()
        with net.name_scope():
            net.add(pkg.gluon.nn.Dense(4, in_units=3), pkg.gluon.nn.BatchNorm(in_channels=4))
    return net


def test_export_keys_of_aux_states_and_the_refusal(tmp_path):
    """BatchNorm's running statistics export as ``aux:``; before a forward
    after ``hybridize()`` (and after a cast) both packages refuse alike."""
    j = _dense_bn(mxj, jblock.name_scope)
    j.initialize()
    t = _dense_bn(mx, tblock.name_scope)
    t.initialize(ctx=mx.cpu())
    x = np.random.RandomState(1).rand(2, 3).astype(np.float32)
    j(mxj.nd.array(x))
    load_numpy_params(t, {k: p.data().asnumpy()
                          for k, p in j._collect_params_with_prefix().items()})
    msgs = []
    for net in (j, t):
        with pytest.raises(RuntimeError) as ei:
            net.export(str(tmp_path / "none"))
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1]
    j.hybridize()
    t.hybridize()
    for net in (j, t):
        with pytest.raises(RuntimeError):  # hybridized, no forward yet
            net.export(str(tmp_path / "none"))
    j(mxj.nd.array(x))
    t(torch.from_numpy(x))
    jd = mxj.nd.load(j.export(str(tmp_path / "j"))[1])
    td = mxj.nd.load(t.export(str(tmp_path / "t"))[1])
    assert list(td) == list(jd)
    assert sorted(k for k in td if k.startswith("aux:")) == [
        "aux:hybridsequential0_batchnorm0_running_mean",
        "aux:hybridsequential0_batchnorm0_running_var"]
    for k in jd:
        np.testing.assert_array_equal(td[k].asnumpy(), jd[k].asnumpy())
    t.cast("float32")
    with pytest.raises(RuntimeError):  # a cast drops the forward, as in the JAX package
        t.export(str(tmp_path / "t"))


def _jax_forward(jsym, params, inputs):
    """The JAX package's Executor over the graph: every argument bound."""
    args = {k: mxj.nd.array(v) for k, v in params.items()}
    args.update({k: mxj.nd.array(a, dtype="int32") for k, a in zip(INPUTS, inputs)})
    return [o.asnumpy() for o in jsym.bind(mxj.cpu(), args=args, grad_req="null").forward()]


def test_symbol_block_matches_the_jax_executor(nets, exported):
    _, t = nets
    (_, j_params), (_, t_params) = exported
    sym = bert_symbol(S, max_length=64, **TINY)
    jsym = bert_symbol(J, max_length=64, **TINY)
    params = {k[4:]: v.asnumpy() for k, v in mxj.nd.load(j_params).items()}
    profiler.reset_compiles()
    block = mx.gluon.SymbolBlock(sym, [S.var(n) for n in INPUTS])
    assert sorted(block.collect_params().keys()) == sorted(params)
    block.load_parameters(t_params, ctx=mx.cpu())
    for seed in (0, 1):
        inputs = _inputs(seed)
        want = _jax_forward(jsym, params, inputs)
        got = block(*(torch.from_numpy(a) for a in inputs))
        assert [tuple(g.shape) for g in got] == [w.shape for w in want] == [(3, 3, 128), (3, 2)]
        for g, w in zip(got, want):
            assert _rel(g.numpy(), w) <= SYM_REL
        # and bit-equal to the port's Predictor over the same file
        pred = Predictor(sym, t_params, SHAPES, dev_type="cpu")
        for k, a in zip(INPUTS, inputs):
            pred.set_input(k, a)
        for g, p in zip(got, pred.forward().get_outputs()):
            np.testing.assert_array_equal(g.numpy(), p)
    # one plan for the one signature, reported to the compile registry
    assert len(block._plans) == 1
    assert profiler.compile_stats()["gluon.symbol_block"]["count"] == 1
    block(*(torch.from_numpy(a[:2]) for a in _inputs(2)))  # a new batch: a new plan
    rec = profiler.compile_registry()["records"][-1]
    assert rec["site"] == "gluon.symbol_block" and rec["recompile"]
    assert "shape drift" in rec["attribution"]


def test_symbol_block_gradients_match_the_gluon_net(nets, exported):
    """Under ``autograd.record()`` the walk records: the Parameters'
    gradients are the Gluon net's."""
    _, t = nets
    (_, _), (_, t_params) = exported
    block = mx.gluon.SymbolBlock(bert_symbol(S, max_length=64, **TINY),
                                 [S.var(n) for n in INPUTS])
    block.load_parameters(t_params, ctx=mx.cpu())
    inputs = [torch.from_numpy(a) for a in _inputs(3)]
    for net in (t, block):
        for p in net.collect_params().values():
            p.zero_grad()
        with mx.autograd.record():
            mlm, nsp = net(*inputs)
            loss = (mlm * mlm).sum() + nsp.sum()
        loss.backward()
    grads = {p.name: p.grad() for p in t.collect_params().values()}
    for name, p in block.collect_params().items():
        g, want = p.grad(), grads[name]
        assert float((g - want).norm() / want.norm()) <= GRAD_REL, name


def test_symbol_block_loads_bare_keys_and_infers_deferred_shapes(nets, exported, tmp_path):
    """A checkpoint with bare names (``mx.nd.save`` of the parameters) loads
    as the exported one does; a block initialized without a file infers its
    parameters' shapes from the first call."""
    (_, _), (_, t_params) = exported
    sym = bert_symbol(S, max_length=64, **TINY)
    bare = str(tmp_path / "bare.params")
    with mx.cpu():
        mx.nd.save(bare, {k[4:]: v for k, v in mx.nd.load(t_params).items()})
    blocks = []
    for path in (t_params, bare):
        blocks.append(mx.gluon.SymbolBlock(sym, [S.var(n) for n in INPUTS]))
        blocks[-1].load_parameters(path, ctx=mx.cpu())
    inputs = [torch.from_numpy(a) for a in _inputs(4)]
    for a, b in zip(blocks[0](*inputs), blocks[1](*inputs)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    with pytest.raises(IOError, match="not a variable"):
        mx.nd.save(str(tmp_path / "extra.params"), {"nope": torch.zeros(1)})
        blocks[0].load_parameters(str(tmp_path / "extra.params"), allow_missing=True)
    fresh = mx.gluon.SymbolBlock(sym, [S.var(n) for n in INPUTS])
    fresh.initialize(ctx=mx.cpu())
    mlm, nsp = fresh(*inputs)
    assert tuple(mlm.shape) == (3, 3, 128) and bool(torch.isfinite(mlm).all())
    assert tuple(fresh.collect_params()[DEFAULT_NAMES[0] + "word_embed_weight"].shape) == (128, 32)


# -- sym.Custom inside a graph ------------------------------------------------------


def _np_gelu(x):
    """The op's numpy body in both packages: a sigmoid GELU in float32."""
    x = x.astype(np.float32)
    return (x / (1.0 + np.exp(-1.702 * x))).astype(np.float32)


class _JaxGeluProp(mxj.operator.CustomOpProp):
    def create_operator(self, ctx, in_shapes, in_dtypes):
        return _JaxGelu()


class _JaxGelu(mxj.operator.CustomOp):
    def forward(self, is_train, req, in_data, out_data, aux):
        self.assign(out_data[0], req[0], mxj.nd.array(_np_gelu(in_data[0].asnumpy())))


class _PortGeluProp(mx.operator.CustomOpProp):
    def create_operator(self, ctx, in_shapes, in_dtypes):
        return _PortGelu()


class _PortGelu(mx.operator.CustomOp):
    calls = 0

    def forward(self, is_train, req, in_data, out_data, aux):
        assert not in_data[0].is_meta
        _PortGelu.calls += 1
        self.assign(out_data[0], req[0], torch.from_numpy(_np_gelu(in_data[0].numpy())))


mxj.operator.register("np_gelu")(_JaxGeluProp)
mx.operator.register("np_gelu")(_PortGeluProp)


def test_custom_graph_through_the_predictor_matches_the_jax_executor(nets, exported, tmp_path):
    (_, j_params), _ = exported
    sym = bert_symbol(S, max_length=64, ffn_op_type="np_gelu", **TINY)
    jsym = bert_symbol(J, max_length=64, ffn_op_type="np_gelu", **TINY)
    assert sym.tojson() == jsym.tojson()  # the same graph file either way
    nodes = [n for n in json.loads(sym.tojson())["nodes"] if n["op"] == "Custom"]
    assert len(nodes) == TINY["num_layers"] and nodes[0]["attrs"]["op_type"] == "np_gelu"
    # the JSON round trip keeps the node, its op_type and its shapes
    sym.save(str(tmp_path / "custom-symbol.json"))
    loaded = S.load(str(tmp_path / "custom-symbol.json"))
    assert loaded.tojson() == sym.tojson()
    calls = _PortGelu.calls
    arg_shapes, out_shapes, _ = loaded.infer_shape(**SHAPES)  # from the prop, on meta
    assert out_shapes == [(3, 3, 128), (3, 2)] and _PortGelu.calls == calls
    pred = Predictor(str(tmp_path / "custom-symbol.json"), j_params, SHAPES, dev_type="cpu")
    assert _PortGelu.calls == calls  # binding never runs the user's forward
    params = {k[4:]: v.asnumpy() for k, v in mxj.nd.load(j_params).items()}
    for seed in (0, 5):
        inputs = _inputs(seed)
        for k, a in zip(INPUTS, inputs):
            pred.set_input(k, a)
        got = pred.forward().get_outputs()
        want = _jax_forward(jsym, params, inputs)
        for g, w in zip(got, want):
            assert g.shape == w.shape and _rel(g, w) <= SYM_REL
    assert _PortGelu.calls == calls + 2 * TINY["num_layers"]
    # the same net with the built-in (erf) GELU answers otherwise: the user's op ran
    plain = Predictor(bert_symbol(S, max_length=64, **TINY), j_params, SHAPES, dev_type="cpu")
    for k, a in zip(INPUTS, _inputs(5)):
        plain.set_input(k, a)
    assert _rel(plain.forward().get_outputs()[0], got[0]) > 10 * SYM_REL


def test_custom_op_in_a_graph_sees_the_executors_training_flag():
    seen = []

    class Prop(mx.operator.CustomOpProp):
        def infer_shape(self, in_shape):
            return in_shape, [in_shape[0][:-1] + [2 * in_shape[0][-1]]], []

        def create_operator(self, ctx, in_shapes, in_dtypes):
            return Op()

    class Op(mx.operator.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            seen.append(is_train)
            self.assign(out_data[0], req[0], torch.cat([in_data[0], -in_data[0]], -1))

    mx.operator.register("flip_concat")(Prop)
    sym = S.Custom(S.var("x"), op_type="flip_concat", name="fc")
    assert sym.infer_shape(x=(2, 3))[1] == [(2, 6)] and not seen
    ex = sym.simple_bind(mx.cpu(), grad_req="null", x=(2, 3))
    x = np.arange(6, dtype=np.float32).reshape(2, 3)
    out = ex.forward(x=x)[0].asnumpy()
    np.testing.assert_array_equal(out, np.concatenate([x, -x], -1))
    ex.forward(is_train=True, x=x)
    assert seen == [False, True]
