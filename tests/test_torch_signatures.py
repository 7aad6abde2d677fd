"""The port's public signatures against the JAX package's, on the CPU.

Each function takes the reference's parameters in the reference's order
and with its defaults, so a call written for the reference (positional
arguments included) does in the port what it does there: ``Block`` and
``ParameterDict.initialize``, the encoder's ``pre_norm``, ``Embedding``'s
``sparse_grad``, the fold's ``keep_grads`` and ``donate_window``, and
``random.seed``'s ``ctx``; ``mx.NDArray``, ``HybridBlock.hybridize``'s
static flags, ``oom_postmortem``'s ``failed_bytes`` and the keywords of
``record_span``, ``start_metrics``, ``device_memory_stats``,
``record_compile``, ``register``, ``Parameter``, ``autograd.backward`` and
``group_apply``; the generation tier's surface.  A value the port cannot
honour raises and names its ROADMAP item.
"""
import inspect
import json
import time

import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as mxj
from incubator_mxnet_tpu.gluon import parameter as jparameter
from incubator_mxnet_tpu.gluon.model_zoo import transformer as jtransformer_zoo
from incubator_mxnet_tpu.gluon.nn import transformer as jtransformer
from incubator_mxnet_tpu.ops import optimizer_ops as jopt_ops
from incubator_mxnet_tpu.ops import registry as jregistry
import incubator_mxnet_torch as mx
from incubator_mxnet_torch.convert import load_numpy_params
from incubator_mxnet_torch.gluon import nn
from incubator_mxnet_torch.gluon import parameter as tparameter
from incubator_mxnet_torch.gluon.nn import transformer as ttransformer
from incubator_mxnet_torch.ops import optimizer_ops as topt_ops
from incubator_mxnet_torch.ops import registry as tregistry

# fp32 through 2 layers in another summation order: tests/test_torch_bert.py's
# tolerance.
FP32_TOL = 1e-4

PAIRS = [
    ("Block.initialize", mxj.gluon.Block.initialize, mx.gluon.Block.initialize),
    ("ParameterDict.initialize", jparameter.ParameterDict.initialize,
     tparameter.ParameterDict.initialize),
    ("TransformerEncoderCell", jtransformer.TransformerEncoderCell.__init__,
     ttransformer.TransformerEncoderCell.__init__),
    ("TransformerEncoder", jtransformer.TransformerEncoder.__init__,
     ttransformer.TransformerEncoder.__init__),
    ("Embedding", mxj.gluon.nn.Embedding.__init__, nn.Embedding.__init__),
    ("Trainer.fold_step", mxj.gluon.Trainer.fold_step, mx.gluon.Trainer.fold_step),
    ("Trainer.fold_steps", mxj.gluon.Trainer.fold_steps, mx.gluon.Trainer.fold_steps),
    ("random.seed", mxj.random.seed, mx.random.seed),
    ("Predictor.__init__", mxj.predictor.Predictor.__init__, mx.predictor.Predictor.__init__),
    ("InferenceServer.__init__", mxj.serving.InferenceServer.__init__,
     mx.serving.InferenceServer.__init__),
    ("load_checkpoint", mxj.predictor.load_checkpoint, mx.predictor.load_checkpoint),
    ("ShapeBucketer.__init__", mxj.serving.ShapeBucketer.__init__,
     mx.serving.ShapeBucketer.__init__),
    ("Symbol.simple_bind", mxj.sym.Symbol.simple_bind, mx.sym.Symbol.simple_bind),
    ("Executor.__init__", mxj.Executor.__init__, mx.Executor.__init__),
    ("amp.convert_model", mxj.amp.convert_model, mx.amp.convert_model),
    # the faults of ROADMAP §3 items 1-4
    ("Block.hybridize", mxj.gluon.Block.hybridize, mx.gluon.Block.hybridize),
    ("HybridBlock.hybridize", mxj.gluon.HybridBlock.hybridize, mx.gluon.HybridBlock.hybridize),
    ("profiler.oom_postmortem", mxj.profiler.oom_postmortem, mx.profiler.oom_postmortem),
    ("profiler.maybe_oom_postmortem", mxj.profiler.maybe_oom_postmortem,
     mx.profiler.maybe_oom_postmortem),
    ("profiler.record_span", mxj.profiler.record_span, mx.profiler.record_span),
    ("profiler.start_metrics", mxj.profiler.start_metrics, mx.profiler.start_metrics),
    ("profiler.device_memory_stats", mxj.profiler.device_memory_stats,
     mx.profiler.device_memory_stats),
    ("profiler.record_compile", mxj.profiler.record_compile, mx.profiler.record_compile),
    ("registry.register", jregistry.register, tregistry.register),
    ("Parameter.__init__", jparameter.Parameter.__init__, tparameter.Parameter.__init__),
    ("autograd.backward", mxj.autograd.backward, mx.autograd.backward),
    ("optimizer_ops.group_apply", jopt_ops.group_apply, topt_ops.group_apply),
    # serving's last items and the profiler (ROADMAP §1 items 4.6-4.8 and 5)
    ("HybridBlock.export", mxj.gluon.HybridBlock.export, mx.gluon.HybridBlock.export),
    ("SymbolBlock.__init__", mxj.gluon.SymbolBlock.__init__, mx.gluon.SymbolBlock.__init__),
    ("profiler.span", mxj.profiler.span.__init__, mx.profiler.span.__init__),
    ("profiler.step_boundary", mxj.profiler.step_boundary, mx.profiler.step_boundary),
    ("profiler.dumps", mxj.profiler.dumps, mx.profiler.dumps),
    ("profiler.dump", mxj.profiler.dump, mx.profiler.dump),
    ("profiler.scope", mxj.profiler.scope.__init__, mx.profiler.scope.__init__),
    ("profiler.Marker", mxj.profiler.Marker.__init__, mx.profiler.Marker.__init__),
    ("profiler.Marker.mark", mxj.profiler.Marker.mark, mx.profiler.Marker.mark),
    ("profiler.record_downtime", mxj.profiler.record_downtime, mx.profiler.record_downtime),
    ("profiler.incr_labeled", mxj.profiler.incr_labeled, mx.profiler.incr_labeled),
    ("profiler.sample_clock_offset", mxj.profiler.sample_clock_offset,
     mx.profiler.sample_clock_offset),
]

# The one difference by design: the port's entry points run on the card
# unless the caller asks for the CPU (its default context is gpu(0), and
# with no card they raise), where the JAX package's serving entry points
# default to the CPU.  ROADMAP §3 records it.
DEFAULTS_BY_DESIGN = {
    ("Predictor.__init__", "dev_type"): ("cpu", "gpu"),
    ("InferenceServer.__init__", "dev_type"): ("cpu", "gpu"),
}


@pytest.mark.parametrize("name,ref,port", PAIRS, ids=[p[0] for p in PAIRS])
def test_parameters_in_the_reference_order(name, ref, port):
    """The port's parameters begin with the reference's, in its order and
    with its defaults, up to the reference's last."""
    want = list(inspect.signature(ref).parameters.values())
    got = list(inspect.signature(port).parameters.values())[:len(want)]
    assert [p.name for p in got] == [p.name for p in want], name
    assert [p.kind for p in got] == [p.kind for p in want], name
    for w, g in zip(want, got):
        by_design = DEFAULTS_BY_DESIGN.get((name, w.name))
        if by_design is not None:
            assert (w.default, g.default) == by_design, (name, w.name)
        else:
            assert g.default == w.default, (name, w.name)


def _dense(seed=0):
    mx.random.seed(seed)
    net = nn.Dense(4, in_units=3)
    net.initialize(ctx=mx.cpu())
    return net


def _values(net):
    return [p.data().clone() for p in net.collect_params().values()]


def test_positional_verbose_does_not_reinitialize():
    """``initialize(init, ctx, True)`` is ``verbose=True`` as in the
    reference: an initialized parameter keeps its values."""
    net = _dense()
    before = _values(net)
    mx.random.seed(99)
    net.initialize(mx.init.Uniform(), mx.cpu(), True)
    assert all(torch.equal(a, b) for a, b in zip(before, _values(net)))
    net.collect_params().initialize(mx.init.Uniform(), mx.cpu(), True)
    assert all(torch.equal(a, b) for a, b in zip(before, _values(net)))
    mx.random.seed(99)
    net.initialize(mx.init.Uniform(), mx.cpu(), True, True)  # force_reinit in fourth place
    assert not all(torch.equal(a, b) for a, b in zip(before, _values(net)))


def test_verbose_changes_no_value():
    quiet = _values(_dense(5))
    mx.random.seed(5)
    net = nn.Dense(4, in_units=3)
    net.initialize(ctx=mx.cpu(), verbose=True)
    assert all(torch.equal(a, b) for a, b in zip(quiet, _values(net)))


ENC = dict(num_layers=2, units=32, hidden_size=64, num_heads=2, dropout=0.0, pre_norm=True)


@pytest.fixture(scope="module")
def pre_norm_ref():
    """The JAX pre-norm encoder: its parameters, and its output and
    parameter gradients for a weighted sum of the output."""
    mxj.random.seed(3)
    jnet = jtransformer.TransformerEncoder(**ENC)
    jnet.initialize()
    rng = np.random.RandomState(4)
    x = rng.randn(2, 9, 32).astype(np.float32)
    w = rng.randn(2, 9, 32).astype(np.float32)
    jnet(mxj.nd.array(x))  # materialize deferred shapes
    arrays = {k: p.data().asnumpy() for k, p in jnet._collect_params_with_prefix().items()}
    with mxj.autograd.record():
        y = jnet(mxj.nd.array(x))
        loss = (y * mxj.nd.array(w)).sum()
    loss.backward()
    grads = {k: p.grad().asnumpy() for k, p in jnet._collect_params_with_prefix().items()}
    return arrays, x, w, y.asnumpy(), grads


def test_pre_norm_encoder_matches_jax(pre_norm_ref):
    """A pre-LN encoder (2 layers, units 32, 2 heads) on the JAX one's
    weights: the same output and the same parameter gradients in fp32."""
    arrays, x, w, y_ref, grads_ref = pre_norm_ref
    net = ttransformer.TransformerEncoder(**ENC)
    load_numpy_params(net, arrays, ctx=mx.cpu())
    with mx.autograd.record():
        y = net(torch.from_numpy(x))
        loss = (y * torch.from_numpy(w)).sum()
    mx.autograd.backward(loss)
    np.testing.assert_allclose(y.detach().numpy(), y_ref, rtol=FP32_TOL, atol=FP32_TOL)
    params = net._collect_params_with_prefix()
    assert sorted(params) == sorted(grads_ref)
    for key, ref in grads_ref.items():
        np.testing.assert_allclose(params[key].grad().numpy(), ref, rtol=FP32_TOL,
                                   atol=FP32_TOL, err_msg=key)


def test_pre_norm_differs_from_post_norm(pre_norm_ref):
    """``pre_norm`` reaches the cells: on the same weights the post-LN
    encoder gives another output."""
    arrays, x, _, y_ref, _ = pre_norm_ref
    net = ttransformer.TransformerEncoder(**dict(ENC, pre_norm=False))
    load_numpy_params(net, arrays, ctx=mx.cpu())
    with mx.autograd.predict_mode():
        y = net(torch.from_numpy(x)).numpy()
    assert np.abs(y - y_ref).max() > 1e-2


def test_embedding_sparse_grad_raises():
    with pytest.raises(NotImplementedError, match="sparse_grad"):
        nn.Embedding(10, 4, sparse_grad=True)
    assert nn.Embedding(10, 4, "float32", None, False).weight.shape == (10, 4)


def _mlp():
    mx.random.seed(3)
    net = nn.HybridSequential()
    with net.name_scope():
        net.add(nn.Dense(8, activation="relu", in_units=6), nn.Dense(4, in_units=8))
    net.initialize(ctx=mx.cpu())
    tr = mx.gluon.Trainer(net.collect_params(), "sgd", {"learning_rate": 0.05, "momentum": 0.9})
    loss_fn = lambda a, b: mx.gluon.loss.L2Loss()(net(a), b)  # noqa: E731
    return net, tr, loss_fn


def _batches():
    rng = np.random.RandomState(0)
    return [(torch.from_numpy(rng.rand(8, 6).astype(np.float32)),
             torch.from_numpy(rng.rand(8, 4).astype(np.float32))) for _ in range(2)]


def _fold_run(flags, window):
    net, tr, loss_fn = _mlp()
    batches = _batches()
    if window:
        prog = tr.fold_steps(loss_fn, 2, net, **flags)
        losses = list(prog(*[torch.stack(parts) for parts in zip(*batches)]))
    else:
        prog = tr.fold_step(loss_fn, net, **flags)
        losses = [prog(*batches[j % 2]) for j in range(3)]
    states = [s for i in sorted(tr._states) for s in (tr._states[i] if isinstance(
        tr._states[i], (list, tuple)) else [tr._states[i]]) if isinstance(s, torch.Tensor)]
    return losses, _values(net) + states


@pytest.mark.parametrize("window,flags", [
    (False, dict(keep_grads=True)), (False, dict(keep_grads=False)),
    (True, dict(donate_window=True)), (True, dict(keep_grads=True, donate_window=True))],
    ids=["fold_step_keep_grads", "fold_step_no_keep_grads", "fold_steps_donate_window",
         "fold_steps_both"])
def test_fold_flags_are_bit_equal_to_the_defaults(window, flags):
    """``keep_grads`` and ``donate_window`` are accepted and change no bit
    of the losses, the parameters or the optimizer states."""
    want_losses, want = _fold_run({}, window)
    got_losses, got = _fold_run(flags, window)
    assert len(got) == len(want) and all(torch.equal(a, b) for a, b in zip(got, want))
    assert all(torch.equal(a, b) for a, b in zip(got_losses, want_losses))


def test_fold_step_keep_grads_keeps_the_gradients():
    """After a ``keep_grads=True`` step each Parameter holds the step's
    gradient, the one an eager backward from the same weights gives."""
    batch = _batches()[0]
    net, tr, loss_fn = _mlp()
    with mx.autograd.record():
        loss = loss_fn(*batch)
    mx.autograd.backward(loss)
    want = [p.grad().clone() for p in net.collect_params().values()]
    net, tr, loss_fn = _mlp()
    tr.fold_step(loss_fn, net, keep_grads=True)(*batch)
    got = [p.grad() for p in net.collect_params().values()]
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert any(bool(g.abs().sum() > 0) for g in got)


@pytest.mark.parametrize("ctx", ["all", mx.cpu()], ids=["all", "cpu"])
def test_seed_ctx_gives_the_same_draws(ctx):
    mx.random.seed(17)
    want = mx.random.normal(shape=(5,), ctx=mx.cpu())
    mx.random.seed(17, ctx=ctx)
    got = mx.random.normal(shape=(5,), ctx=mx.cpu())
    assert torch.equal(got, want)
    mx.random.seed(17, ctx)
    assert torch.equal(mx.random.normal(shape=(5,), ctx=mx.cpu()), want)


# -- the mx.nd surface --------------------------------------------------------------


def _public_params(fn):
    """Parameters by (name, default), leaving out private ones (the JAX
    package binds helpers as ``_fn=...`` defaults)."""
    return [(p.name, p.default) for p in inspect.signature(fn).parameters.values()
            if not p.name.startswith("_")]


def _nd_methods():
    out = []
    for name in sorted(dir(mxj.nd.NDArray)):
        if name.startswith("_") and name not in ("__init__", "__getitem__", "__setitem__",
                                                 "__array__"):
            continue
        ref = getattr(mxj.nd.NDArray, name)
        if callable(ref) and not isinstance(ref, property):
            out.append((f"NDArray.{name}", ref, getattr(mx.nd.NDArray, name)))
    return out


def _generation_pairs():
    """The generation tier: the decoder layers, the seq2seq model and its
    search loops, the stateful executor, the slot KV cache, the server and
    the profiler's part of it."""
    from incubator_mxnet_tpu.gluon.model_zoo import transformer as jzoo
    from incubator_mxnet_tpu import predictor as jpred
    from incubator_mxnet_tpu.serving import generation as jgen, kv_cache as jkv
    from incubator_mxnet_torch.gluon.model_zoo import transformer as tzoo
    from incubator_mxnet_torch import predictor as tpred
    from incubator_mxnet_torch.serving import generation as tgen, kv_cache as tkv

    out = [(f"{n}.__init__", getattr(jtransformer, n).__init__,
            getattr(ttransformer, n).__init__)
           for n in ("TransformerDecoderCell", "TransformerDecoder",
                     "SinusoidalPositionalEncoding")]
    out += [(f"transformer.{n}", getattr(jzoo, n), getattr(tzoo, n)) for n in (
        "transformer_base", "transformer_big", "transformer_sharding_rules", "greedy_search",
        "beam_search")]
    out.append(("Transformer.__init__", jzoo.Transformer.__init__, tzoo.Transformer.__init__))
    out += [(f"StatefulExecutor.{n}", getattr(jpred.StatefulExecutor, n),
             getattr(tpred.StatefulExecutor, n)) for n in (
        "__init__", "add_program", "run", "is_warm", "compile_stats")]
    out += [(f"{c}.{n}", getattr(getattr(jkv, c), n), getattr(getattr(tkv, c), n))
            for c, names in (("SlotKVCache", ("__init__", "alloc", "free")),
                             ("KVCacheLadder", ("__init__", "try_alloc", "bucket_for")))
            for n in names]
    out += [(f"{c}.{n}", getattr(getattr(jgen, c), n), getattr(getattr(tgen, c), n))
            for c, names in (("GenerationServer", ("__init__", "submit", "generate", "close",
                                                   "start", "stats", "compile_stats")),
                             ("Tenant", ("__init__",)),
                             ("GenerationResult", ("__init__", "stream", "result", "cancel")))
            for n in names]
    out += [(f"profiler.{n}", getattr(mxj.profiler, n), getattr(mx.profiler, n)) for n in (
        "memory_budget", "disarm_compile_guard", "reset_compiles", "jit_cache_size")]
    out += [(f"MemoryBudget.{n}", getattr(mxj.profiler.MemoryBudget, n),
             getattr(mx.profiler.MemoryBudget, n)) for n in (
        "__init__", "would_fit", "under_pressure", "check")]
    return out


NEW_PAIRS = (
    [(f"random.{n}", getattr(mxj.random, n), getattr(mx.random, n)) for n in (
        "uniform", "normal", "randn", "randint", "multinomial", "shuffle", "gamma",
        "exponential", "poisson", "negative_binomial", "generalized_negative_binomial")]
    + [(f"nd.{n}", getattr(mxj.nd, n), getattr(mx.nd, n)) for n in (
        "array", "zeros", "ones", "full", "empty", "arange", "invoke", "waitall", "save",
        "load")]
    + [(f"Block.{n}", getattr(mxj.gluon.Block, n), getattr(mx.gluon.Block, n)) for n in (
        "save_parameters", "save_params", "load_parameters", "load_params")]
    + [(f"ParameterDict.{n}", getattr(jparameter.ParameterDict, n),
        getattr(tparameter.ParameterDict, n)) for n in ("save", "load")]
    + [("Parameter.set_data", jparameter.Parameter.set_data, tparameter.Parameter.set_data)]
    + _nd_methods()
    + _generation_pairs()
)


@pytest.mark.parametrize("name,ref,port", NEW_PAIRS, ids=[p[0] for p in NEW_PAIRS])
def test_nd_surface_in_the_reference_order(name, ref, port):
    want = _public_params(ref)
    assert _public_params(port)[:len(want)] == want, name


def _op_pairs():
    from incubator_mxnet_tpu.ops import registry as jreg
    from incubator_mxnet_torch.ops import registry as treg

    import nd_parity

    out = []
    for src in ("tensor", "nn", "random_ops"):
        for name in sorted(nd_parity.jax_names(src)):
            port = treg.get_op(name).fn
            try:
                inspect.signature(port)
            except (TypeError, ValueError):  # a PyTorch builtin of one tensor, as jnp's ufuncs
                continue
            out.append((name, jreg.get_op(name).fn, port))
    return out


OP_PAIRS = _op_pairs()


@pytest.mark.parametrize("name,ref,port", OP_PAIRS, ids=[p[0] for p in OP_PAIRS])
def test_ops_take_the_reference_parameters(name, ref, port):
    """Every op of ``ops/tensor.py``, ``ops/nn.py`` and ``ops/random_ops.py``
    begins with the JAX op's parameters, in order, with its defaults (the
    samplers' ``key`` is a ``torch.Generator`` in the port)."""
    want = _public_params(ref)
    assert _public_params(port)[:len(want)] == want, name


# -- the repaired faults of ROADMAP §3 items 1-4 ------------------------------------


def test_ndarray_is_exported():
    assert isinstance(mx.nd.ones((2,), ctx=mx.cpu()), mx.NDArray)
    assert mx.NDArray is mx.nd.NDArray


def test_hybridize_takes_static_flags_positionally():
    net = nn.HybridSequential()
    with net.name_scope():
        net.add(nn.Dense(4, in_units=3))
    assert net.hybridize(True, True) is net
    assert net._flags == {"static_alloc": True, "static_shape": False}
    assert net[0]._flags == {"static_alloc": True, "static_shape": False} and net[0]._active
    net.hybridize(False, static_shape=True)
    assert not net._active and net._flags["static_shape"]


def test_oom_postmortem_takes_failed_bytes_second():
    rep = mx.profiler.oom_postmortem("x", 1024)
    assert (rep["failed_bytes"], rep["error"], rep["kind"]) == (1024, None, "oom")
    assert "step" in rep and rep["where"] == "x"
    rep = mx.profiler.oom_postmortem("y", error=RuntimeError("e"), kind="budget")
    assert (rep["failed_bytes"], rep["error"], rep["kind"]) == (None, "e", "budget")
    err = torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 20.00 MiB")
    assert mx.profiler.maybe_oom_postmortem(err, "z")["failed_bytes"] == 20 << 20


def test_record_span_honours_step(tmp_path):
    from incubator_mxnet_torch import profiler

    profiler.set_config(filename=str(tmp_path / "t.json"))
    profiler.start()
    t0 = time.perf_counter()
    profiler.record_span("tagged", "test", t0, step=7, args={"k": 1})
    profiler.record_span("untagged", "test", t0)
    profiler.stop()
    with open(profiler.dump()) as f:
        events = {e["name"]: e for e in json.load(f)["traceEvents"] if e.get("ph") == "B"}
    assert events["tagged"]["args"] == {"step": 7, "k": 1}
    # an untagged span carries the step it was recorded in, as in the JAX package
    assert events["untagged"]["args"] == {"step": profiler.current_step()}


def test_keywords_outside_the_port_raise_naming_their_item(tmp_path):
    # the profiler's keywords of ROADMAP §1 item 5 are honoured since that item
    path = tmp_path / "m.jsonl"
    mx.profiler.start_metrics(jsonl=str(path), interval_s=0.05)
    time.sleep(0.2)
    mx.profiler.stop_metrics()
    assert json.loads(path.read_text().splitlines()[0])["schema"] == 1
    rec = mx.profiler.record_compile("s", {}, 1.0, args=(1,), lowered={"flops": 8.0})
    assert rec["cost"] == {"flops": 8.0}
    assert mx.profiler.record_compile("s", {}, 1.0, args=(1,))["cost"] is None
    mx.profiler.reset_compiles()
    with pytest.raises(NotImplementedError, match="ROADMAP §1 item 11"):
        tparameter.Parameter("w", shape=(2,), stype="row_sparse")
    with pytest.raises(NotImplementedError, match="ROADMAP §1 item 11"):
        tparameter.Parameter("w", "write", (2,), "float32", 1.0, 1.0, None, False, True,
                             "default", "row_sparse")
    assert tparameter.Parameter("w", shape=(2,), stype="default", grad_stype="default")
    # autograd.backward's grad_ready_hook is honoured since ROADMAP §1 item 6:
    # it sees each leaf once, its gradient written
    x = torch.ones(2, requires_grad=True)
    mx.autograd.backward((x * 2).sum(), grad_ready_hook=None)
    assert x.grad.tolist() == [2.0, 2.0]
    a = mx.nd.ones((2,), ctx=mx.cpu())
    a.attach_grad()
    seen = []
    with mx.autograd.record():
        y = (a * 3).sum()
    mx.autograd.backward(y, grad_ready_hook=lambda leaf: seen.append(leaf.grad.asnumpy()))
    assert len(seen) == 1 and seen[0].tolist() == [3.0, 3.0]


def test_record_compile_keeps_fn_and_device_stats_take_devices():
    from incubator_mxnet_torch import profiler

    def my_program():
        pass

    rec = profiler.record_compile("test.fn_identity", {"__program__": "p"}, 1.0, fn=my_program)
    assert rec["fn"].endswith("my_program")
    assert profiler.record_compile("test.fn_identity", {"__program__": "q"}, 1.0)["fn"] is None
    # no card here: nothing to report, whichever cards are asked for
    assert profiler.device_memory_stats(devices=[0]) == {}
    assert profiler.device_memory_stats([torch.device("cuda", 0), "cuda:0", mx.gpu(0)]) == {}


def test_register_takes_cacheable():
    name = "_test_uncacheable_op"
    try:
        tregistry.register(name, True, True, False)(lambda x: x)
        assert tregistry.get_op(name).cacheable is False
    finally:
        tregistry._REGISTRY.pop(name, None)
    assert tregistry.get_op("dot").cacheable is True


def test_group_apply_takes_donate_ninth_and_device_rows_by_keyword():
    """``donate`` in the ninth place, as the reference's, changes no bit (the
    port updates in place either way); ``device_rows`` is keyword-only."""
    def group(seed):
        rng = np.random.RandomState(seed)
        ws = [torch.from_numpy(rng.randn(5).astype(np.float32)) for _ in range(3)]
        gs = [torch.from_numpy(rng.randn(5).astype(np.float32)) for _ in range(3)]
        ms = [(torch.zeros(5),) for _ in range(3)]
        return ws, gs, ms

    S = {"rescale": 1.0, "clip": -1.0, "momentum": 0.9}
    outs = []
    for donate in (False, True):
        ws, gs, ms = group(0)
        w2, s2 = topt_ops.group_apply(topt_ops.sgd_mom_step, ws, gs, ms, [0.1] * 3, [0.0] * 3,
                                      [1] * 3, S, donate)
        assert all(a is b for a, b in zip(w2, ws))
        outs.append([w.clone() for w in ws] + [m[0].clone() for m in s2])
    assert all(torch.equal(a, b) for a, b in zip(*outs))
    ws, gs, ms = group(0)
    with pytest.raises(TypeError):
        topt_ops.group_apply(topt_ops.sgd_mom_step, ws, gs, ms, [0.1] * 3, [0.0] * 3, [1] * 3,
                             S, False, None)


# -- the rest of the training surface (ROADMAP §1 item 3) -------------------------------

_OPTIMIZERS = ("NAG", "AdamW", "AdaGrad", "AdaDelta", "RMSProp", "Ftrl", "Signum", "LAMB",
               "Nadam", "FTML", "SGLD", "DCASGD", "Adamax", "LBSGD", "LARS", "GroupAdaGrad")
_LOSSES = ("L1Loss", "SigmoidBinaryCrossEntropyLoss", "KLDivLoss", "HuberLoss", "HingeLoss",
           "SquaredHingeLoss", "LogisticLoss", "TripletLoss", "SDMLLoss", "PoissonNLLLoss",
           "CosineEmbeddingLoss", "CTCLoss")
_INITS = ("Orthogonal", "MSRAPrelu", "Bilinear", "LSTMBias", "Load", "Mixed")
_OPS = ("sgd_lazy_update", "sgd_mom_lazy_update", "mp_sgd_mom_lazy_update", "adam_lazy_update",
        "nag_mom_update", "mp_nag_mom_update", "adamw_update", "rmsprop_update",
        "rmspropalex_update", "adagrad_update", "adadelta_update", "ftrl_update",
        "signum_update", "lamb_update_phase1", "lamb_update_phase2", "nadam_update",
        "ftml_update", "sgld_update", "dcasgd_update", "adamax_update", "group_adagrad_update",
        "multi_sum_sq", "multi_lars", "all_finite", "nag_mom_step", "mp_nag_mom_step",
        "adamw_step", "rmsprop_step", "rmspropalex_step", "lamb_step")

SURFACE_PAIRS = (
    [(f"optimizer.{n}", getattr(mxj.optimizer, n).__init__, getattr(mx.optimizer, n).__init__)
     for n in _OPTIMIZERS]
    + [(f"lr_scheduler.{n}", getattr(mxj.lr_scheduler, n).__init__,
        getattr(mx.lr_scheduler, n).__init__) for n in (
        "LRScheduler", "FactorScheduler", "MultiFactorScheduler", "PolyScheduler",
        "CosineScheduler")]
    + [(f"amp.{n}", getattr(mxj.amp, n), getattr(mx.amp, n)) for n in (
        "LossScaler", "scale_loss", "init_trainer", "unscale", "convert_hybrid_block",
        "list_lp16_ops", "list_fp32_ops")]
    + [(f"autograd.{n}", getattr(mxj.autograd, n), getattr(mx.autograd, n))
       for n in ("grad", "mark_variables")]
    + [(f"loss.{n}", getattr(mxj.gluon.loss, n).__init__, getattr(mx.gluon.loss, n).__init__)
       for n in _LOSSES]
    + [(f"init.{n}", getattr(mxj.init, n).__init__, getattr(mx.init, n).__init__)
       for n in _INITS]
    + [("init.Initializer.dumps", mxj.init.Initializer.dumps, mx.init.Initializer.dumps)]
    + [(f"nn.{n}", getattr(mxj.gluon.nn, n).__init__, getattr(mx.gluon.nn, n).__init__)
       for n in ("GroupNorm", "InstanceNorm", "Lambda", "HybridLambda", "Concatenate",
                 "HybridConcatenate")]
    + [(f"Parameter.{n}", getattr(jparameter.Parameter, n), getattr(tparameter.Parameter, n))
       for n in ("list_data", "list_ctx", "reset_ctx", "var")]
    + [("Constant", jparameter.Constant.__init__, tparameter.Constant.__init__)]
    + [(f"ParameterDict.{n}", getattr(jparameter.ParameterDict, n),
        getattr(tparameter.ParameterDict, n)) for n in (
        "get_constant", "zero_grad", "reset_ctx", "setattr")]
    + [("Trainer.close", mxj.gluon.Trainer.close, mx.gluon.Trainer.close)]
    + [(f"Block.{n}", getattr(mxj.gluon.Block, n), getattr(mx.gluon.Block, n)) for n in (
        "register_forward_hook", "register_forward_pre_hook", "apply", "summary")]
    + [(f"HybridBlock.{n}", getattr(mxj.gluon.HybridBlock, n), getattr(mx.gluon.HybridBlock, n))
       for n in ("infer_shape", "optimize_for")]
    + [("block.name_scope", mxj.gluon.block.name_scope, mx.gluon.block.name_scope)]
    + [(f"context.{n}", getattr(mxj.context, n), getattr(mx.context, n))
       for n in ("cpu_pinned", "current_device")]
    + [("Context.empty_cache", mxj.context.Context.empty_cache, mx.context.Context.empty_cache)]
    + [(f"optimizer_ops.{n}", getattr(jopt_ops, n), getattr(topt_ops, n)) for n in _OPS]
)


@pytest.mark.parametrize("name,ref,port", SURFACE_PAIRS, ids=[p[0] for p in SURFACE_PAIRS])
def test_training_surface_in_the_reference_order(name, ref, port):
    """Every public name the training slice added begins with the JAX
    package's parameters, in order, with its defaults."""
    want = _public_params(ref)
    assert _public_params(port)[:len(want)] == want, name


# The data-parallel tier (ROADMAP §1 item 6, its pure-dp half).
_KV_METHODS = ("init", "push", "pull", "pushpull", "broadcast", "row_sparse_pull",
               "set_optimizer", "save_optimizer_states", "load_optimizer_states", "barrier",
               "supports_grad_bucketing", "membership_epoch", "wire_allreduce")
PARALLEL_PAIRS = (
    [(f"parallel.{n}", getattr(mxj.parallel, n), getattr(mx.parallel, n)) for n in (
        "make_mesh", "local_mesh", "current_mesh", "mesh_scope", "init_distributed",
        "default_rules", "fsdp_rules", "param_sharding", "batch_pspec", "shard_array",
        "replicate")]
    + [("parallel.sync_profiler_clock", mxj.parallel.mesh.sync_profiler_clock,
        mx.parallel.sync_profiler_clock),
       ("MeshConfig.resolve", mxj.parallel.MeshConfig.resolve, mx.parallel.MeshConfig.resolve),
       ("ShardingRules.__init__", mxj.parallel.ShardingRules.__init__,
        mx.parallel.ShardingRules.__init__),
       ("ShardingRules.spec_for", mxj.parallel.ShardingRules.spec_for,
        mx.parallel.ShardingRules.spec_for),
       ("ShardingRules.add", mxj.parallel.ShardingRules.add, mx.parallel.ShardingRules.add)]
    + [(f"SPMDTrainer.{n}", getattr(mxj.parallel.SPMDTrainer, n),
        getattr(mx.parallel.SPMDTrainer, n)) for n in (
        "__init__", "step", "step_bulk", "step_window", "shard_batch", "shard_window",
        "sync_to_block", "save_states", "load_states", "learning_rate")]
    + [(f"kvstore.{n}", getattr(mxj.kvstore, n), getattr(mx.kvstore, n)) for n in (
        "create", "bucket_bytes", "plan_buckets", "execute_bucket", "bucketed_pushpull")]
    + [(f"KVStore.{n}", getattr(mxj.kvstore.KVStore, n), getattr(mx.kvstore.KVStore, n))
       for n in _KV_METHODS]
    + [(f"Trainer.{n}", getattr(mxj.gluon.Trainer, n), getattr(mx.gluon.Trainer, n))
       for n in ("__init__", "backward", "allreduce_grads", "step", "update")]
    + [("transformer_sharding_rules", jtransformer_zoo.transformer_sharding_rules,
        mx.gluon.model_zoo.transformer_sharding_rules)]
)


@pytest.mark.parametrize("name,ref,port", PARALLEL_PAIRS, ids=[p[0] for p in PARALLEL_PAIRS])
def test_parallel_tier_in_the_reference_order(name, ref, port):
    """Every public name of the data-parallel tier begins with the JAX
    package's parameters, in order, with its defaults."""
    want = _public_params(ref)
    assert _public_params(port)[:len(want)] == want, name


# The input pipeline (ROADMAP §1 item 7): every public class's constructor
# and methods and every public function of mx.io, mx.recordio, mx.image
# (detection waits in item 10) and mx.gluon.data (with vision).
def _surface_pairs(prefix, jmod, tmod, names):
    out = []
    for n in names:
        j, t = getattr(jmod, n), getattr(tmod, n)
        if inspect.ismodule(j) or not callable(j):
            continue
        if not inspect.isclass(j):
            out.append((f"{prefix}.{n}", j, t))
            continue
        methods = ["__init__"] + sorted(k for k, v in vars(j).items()
                                        if callable(v) and not k.startswith("_"))
        out += [(f"{prefix}.{n}.{m}", getattr(j, m), getattr(t, m)) for m in methods]
    return out


from incubator_mxnet_tpu.gluon.data.vision import transforms as _jtransforms  # noqa: E402
from incubator_mxnet_tpu.image import image as _jimage  # noqa: E402
from incubator_mxnet_tpu.io import pipeline as _jpipeline  # noqa: E402
from incubator_mxnet_torch.gluon.data.vision import transforms as _ttransforms  # noqa: E402
from incubator_mxnet_torch.io import pipeline as _tpipeline  # noqa: E402

IO_PAIRS = (
    _surface_pairs("io", mxj.io, mx.io, mxj.io.__all__)
    + _surface_pairs("recordio", mxj.recordio, mx.recordio, mxj.recordio.__all__)
    + _surface_pairs("image", _jimage, mx.image, _jimage.__all__)
    + _surface_pairs("gluon.data", mxj.gluon.data, mx.gluon.data, mxj.gluon.data.__all__)
    + _surface_pairs("gluon.data.vision", mxj.gluon.data.vision, mx.gluon.data.vision,
                     mxj.gluon.data.vision.__all__)
    + _surface_pairs("transforms", _jtransforms, _ttransforms, _jtransforms.__all__)
    + [("io.pipeline._Engine.__init__", _jpipeline._Engine.__init__,
        _tpipeline._Engine.__init__),
       ("gluon.data.dataloader.default_batchify_fn",
        mxj.gluon.data.dataloader.default_batchify_fn,
        mx.gluon.data.dataloader.default_batchify_fn)]
)


@pytest.mark.parametrize("name,ref,port", IO_PAIRS, ids=[p[0] for p in IO_PAIRS])
def test_input_pipeline_in_the_reference_order(name, ref, port):
    """Every public name of the input pipeline begins with the JAX package's
    parameters, in order, with its defaults."""
    want = _public_params(ref)
    assert _public_params(port)[:len(want)] == want, name


def test_the_input_pipeline_is_exported():
    assert {"io", "recordio", "image"} <= set(mx.__all__) and "data" in mx.gluon.__all__
    assert set(mxj.io.__all__) == set(mx.io.__all__)
    assert set(_jimage.__all__) == set(mx.image.__all__)
    assert set(mxj.gluon.data.__all__) == set(mx.gluon.data.__all__)
    assert set(mxj.gluon.data.vision.__all__) == set(mx.gluon.data.vision.__all__)
    assert set(_jtransforms.__all__) == set(_ttransforms.__all__)
    assert len(IO_PAIRS) > 150
