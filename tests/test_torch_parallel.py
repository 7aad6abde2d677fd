"""The port's data-parallel tier (``incubator_mxnet_torch.parallel``) against
the JAX package's, on the CPU.

The JAX package's ``tests/test_parallel.py`` runs on its 8-device CPU mesh
in one process (``tests/conftest.py``); the port's mesh here is one
process (dp = 1), each of its ranks holding a card or, when asked, the
CPU.  So: the mesh's fill and divisor rules and the sharding rules are
held to the JAX functions on the same sizes; ``SPMDTrainer`` at world 1 is
held to the port's imperative ``Trainer`` and to the JAX ``SPMDTrainer``
on the 8-device mesh at the same global batch (an MLP with SGD-momentum, a
tiny BERT with Adam ``multi_precision``, a tiny ResNet whose BatchNorm
running statistics move inside the step), from the same parameters
carried across by structural key; ``step_bulk`` and ``step_window`` are
held to sequential steps bit for bit; ``save_states`` files load across the
two packages both ways; each argument of a later slice raises naming its
ROADMAP item.  The 2-rank cohorts are in ``test_torch_dist.py``.
"""
import gc
import os
import pickle

import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as mxj
from incubator_mxnet_tpu import parallel as jpar
from incubator_mxnet_tpu import profiler as jprofiler
from incubator_mxnet_tpu.gluon.model_zoo import bert as jbert
from incubator_mxnet_tpu.gluon.model_zoo.vision import resnet as jvision
import incubator_mxnet_torch as mx
from incubator_mxnet_torch import parallel as tpar
from incubator_mxnet_torch import profiler as tprofiler
from incubator_mxnet_torch.convert import load_numpy_params
from incubator_mxnet_torch.gluon import nn
from incubator_mxnet_torch.gluon.model_zoo import bert as tbert
from incubator_mxnet_torch.gluon.model_zoo import transformer as ttransformer
from incubator_mxnet_torch.gluon.model_zoo import vision as tvision

# fp32 on both sides, the same arithmetic in another summation order (the
# JAX step sums the gradient over 8 shards): 1e-5 relative, the absolute
# term for values near 0 (test_torch_step_fold.py's TOL).
TOL = dict(rtol=1e-5, atol=1e-6)
# Adam turns fp32 rounding noise in a gradient that is exactly 0 into a
# step of up to lr (test_torch_step_fold.py's ADAM_PARAM_TOL).
ADAM_TOL = dict(rtol=1e-4, atol=1e-5)
# The small ResNet in training is chaotic: one step from the same
# parameters, to test_torch_resnet.py's PARAM_TOL (lr 0.1 times a gradient
# difference of ~1e-5 relative); running statistics included.
RESNET_TOL = dict(rtol=1e-4, atol=1e-5)
B = 8  # the global batch: divisible by the JAX mesh's 8 devices
SGD = ("sgd", {"learning_rate": 0.1, "momentum": 0.9})
BERT_CFG = dict(vocab_size=64, units=32, hidden_size=64, num_layers=2, num_heads=2,
                max_length=32, dropout=0.0)
BERT_S, BERT_P = 16, 4
SMALL_RESNET = dict(layers=[1, 1, 1, 1], channels=[8, 16, 32, 64, 128], classes=10)
CPU = ["cpu"]


@pytest.fixture(autouse=True)
def _fresh_guard():
    """Both packages arm the process-wide compile guard after a trainer's
    first step; a net built afterwards must not trip it."""
    jprofiler.disarm_compile_guard()
    tprofiler.disarm_compile_guard()
    yield
    jprofiler.disarm_compile_guard()
    tprofiler.disarm_compile_guard()


def _mesh():
    return tpar.make_mesh(devices=CPU)


# -- the models, built alike in both packages ---------------------------------


def _mlp_data(n=B, d=12, seed=3):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, d).astype(np.float32),
            rng.randint(0, 4, size=(n,)).astype(np.float32))


def _jax_mlp(seed=11):
    mxj.random.seed(seed)
    net = mxj.gluon.nn.HybridSequential(prefix="mlp_")
    with net.name_scope():
        net.add(mxj.gluon.nn.Dense(32, activation="relu"),
                mxj.gluon.nn.Dense(16, activation="relu"), mxj.gluon.nn.Dense(4))
    net.initialize()
    net(mxj.nd.zeros((2, 12)))
    return net


def _port_mlp(arrays):
    net = nn.HybridSequential(prefix="mlp_")
    with net.name_scope():
        net.add(nn.Dense(32, activation="relu"), nn.Dense(16, activation="relu"), nn.Dense(4))
    net.initialize(ctx=mx.cpu())
    load_numpy_params(net, arrays)
    return net


def _bert_data(seed=1):
    rng = np.random.RandomState(seed)
    return ((rng.randint(0, 64, (B, BERT_S)).astype(np.int32),
             rng.randint(0, 2, (B, BERT_S)).astype(np.int32),
             rng.randint(0, BERT_S, (B, BERT_P)).astype(np.int32)),
            rng.randint(0, 64, (B, BERT_P)).astype(np.int32))


def _jax_bert():
    mxj.random.seed(0)
    net = jbert.BERTForPretrain(jbert.BERTModel(**BERT_CFG, prefix="bert_"), vocab_size=64,
                                prefix="pre_")
    net.initialize()
    net(mxj.nd.zeros((1, 4), dtype="int32"))
    return net


def _port_bert(arrays):
    net = tbert.BERTForPretrain(tbert.BERTModel(**BERT_CFG, prefix="bert_"), vocab_size=64,
                                prefix="pre_")
    load_numpy_params(net, arrays, ctx=mx.cpu())
    return net


def _resnet_data(seed=0):
    rng = np.random.RandomState(seed)
    return (rng.rand(B, 3, 32, 32).astype(np.float32),
            rng.randint(0, 10, (B,)).astype(np.int32))


def _jax_resnet():
    mxj.random.seed(0)
    net = jvision.ResNetV1(jvision.BottleneckV1, thumbnail=True, prefix="res_", **SMALL_RESNET)
    net.initialize()
    net(mxj.nd.zeros((1, 3, 32, 32)))
    return net


def _port_resnet(arrays):
    net = tvision.ResNetV1(tvision.BottleneckV1, thumbnail=True, prefix="res_", **SMALL_RESNET)
    net.initialize(ctx=mx.cpu())
    load_numpy_params(net, arrays)
    return net


def _ce(pkg):
    return pkg.gluon.loss.SoftmaxCrossEntropyLoss()


def _bert_loss(pkg):
    """The masked-LM loss of each sample: the mean over its P positions."""
    ce = _ce(pkg)
    if pkg is mxj:
        return lambda out, label: ce(out[0].reshape((-1, 64)), label.reshape((-1,))).reshape(
            (-1, BERT_P)).mean(axis=-1)
    return lambda out, label: ce(out[0].reshape(-1, 64), label.reshape(-1)).reshape(
        -1, BERT_P).mean(-1)


MODELS = {
    "mlp_sgd_momentum": dict(jax_net=_jax_mlp, port_net=_port_mlp, data=_mlp_data, opt=SGD,
                             loss=_ce, steps=3, tol=TOL),
    "bert_adam_mp": dict(jax_net=_jax_bert, port_net=_port_bert, data=_bert_data,
                         opt=("adam", {"learning_rate": 1e-3, "multi_precision": True}),
                         loss=_bert_loss, steps=2, tol=ADAM_TOL),
    "resnet_bn_aux": dict(jax_net=_jax_resnet, port_net=_port_resnet, data=_resnet_data,
                          opt=("sgd", {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4}),
                          loss=_ce, steps=1, tol=RESNET_TOL),
}


def _jax_params(net):
    return {k: np.array(p.data().asnumpy())
            for k, p in net._collect_params_with_prefix().items()}


def _port_params(net):
    return {k: p.data().detach().numpy().copy()
            for k, p in net._collect_params_with_prefix().items()}


def _assert_params(got, want, tol):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **tol)


def _jax_inputs(data, label):
    data = data if isinstance(data, tuple) else (data,)
    return ([mxj.nd.array(a, dtype=a.dtype.name) for a in data],
            mxj.nd.array(label, dtype=label.dtype.name))


def _port_inputs(data, label):
    data = data if isinstance(data, tuple) else (data,)
    return [torch.from_numpy(a.copy()) for a in data], torch.from_numpy(label.copy())


@pytest.fixture(scope="module", params=sorted(MODELS))
def jax_spmd(request):
    """The JAX SPMDTrainer on the 8-device mesh, once a model: its starting
    parameters, the losses and parameters after its steps, and a
    ``save_states`` file of the end."""
    model = MODELS[request.param]
    jprofiler.disarm_compile_guard()
    net = model["jax_net"]()
    start = _jax_params(net)
    data, label = model["data"]()
    name, args = model["opt"]
    tr = jpar.SPMDTrainer(net, model["loss"](mxj), name, dict(args), mesh=jpar.make_mesh())
    assert tr.mesh.devices.size == 8
    ins, lab = _jax_inputs(data, label)
    losses = [float(tr.step(ins, lab).asnumpy()) for _ in range(model["steps"])]
    tr.sync_to_block()
    jprofiler.disarm_compile_guard()
    return dict(name=request.param, model=model, start=start, data=data, label=label,
                losses=losses, after=_jax_params(net), trainer=tr, net=net)


def _port_spmd(ref, **kw):
    model = ref["model"]
    net = model["port_net"](ref["start"])
    name, args = model["opt"]
    tr = tpar.SPMDTrainer(net, model["loss"](mx), name, dict(args), mesh=_mesh(), **kw)
    return net, tr


# -- mesh and rules -----------------------------------------------------------


@pytest.mark.parametrize("sizes,n", [({}, 8), ({"tp": 2}, 8), ({"dp": 2, "fsdp": 2, "tp": 2}, 8),
                                     ({"pp": 4}, 4), ({}, 1)])
def test_mesh_config_fills_dp_as_the_reference(sizes, n):
    assert tpar.MeshConfig(**sizes).resolve(n) == jpar.MeshConfig(**sizes).resolve(n)


def test_bad_divisor_raises():
    with pytest.raises(ValueError):
        tpar.MeshConfig(tp=3).resolve(8)
    with pytest.raises(ValueError):
        tpar.MeshConfig(dp=3, tp=2).resolve(8)
    with pytest.raises(ValueError):  # one process, one rank: tp=2 cannot divide it
        tpar.make_mesh(tp=2, devices=CPU)


def test_make_mesh_is_the_world():
    mesh = _mesh()
    assert mesh.shape == {"dp": 1, "pp": 1, "fsdp": 1, "ep": 1, "sp": 1, "tp": 1}
    assert set(mesh.axis_names) == {"dp", "fsdp", "tp", "pp", "sp", "ep"}
    assert mesh.devices.size == 1 and mesh.world == 1 and mesh.group is None
    assert mesh.device == torch.device("cpu") and mesh.backend is None
    assert tpar.current_mesh() is None
    with tpar.mesh_scope(mesh):
        assert tpar.current_mesh() is mesh
        with tpar.mesh_scope(_mesh()) as inner:
            assert tpar.current_mesh() is inner
        assert tpar.current_mesh() is mesh
    assert tpar.current_mesh() is None
    if not torch.cuda.is_available():  # the card is the default: the CPU only when asked
        with pytest.raises(RuntimeError, match="devices=\\['cpu'\\]"):
            tpar.make_mesh()
    with pytest.raises(ValueError, match="2 devices for a world of 1"):
        tpar.make_mesh(devices=["cpu", "cpu"])


def test_init_distributed_without_a_coordinator_is_one_process(monkeypatch):
    for var in ("DMLC_PS_ROOT_URI", "DMLC_NUM_WORKER", "DMLC_WORKER_ID"):
        monkeypatch.delenv(var, raising=False)
    assert tpar.init_distributed() is None
    assert not torch.distributed.is_initialized()
    assert tpar.sync_profiler_clock() is None


def test_rules_first_match_wins_and_fallback():
    sizes = tpar.MeshConfig(tp=2).resolve(8)
    jmesh = jpar.make_mesh(tp=2)
    P = tpar.PartitionSpec
    rules = tpar.ShardingRules([(r"weight$", P("tp", None))])
    jrules = jpar.ShardingRules([(r"weight$", jax_p("tp", None))])
    cases = [("dense0_weight", (32, 12)), ("dense1_weight", (7, 12)), ("dense0_bias", (32,))]
    for name, shape in cases:
        got = rules.spec_for(name, shape, sizes)
        assert tuple(got) == tuple(jrules.spec_for(name, shape, jmesh)), name
    assert rules.spec_for("dense0_weight", (32, 12), sizes) == P("tp", None)
    assert rules.spec_for("dense1_weight", (7, 12), sizes) == P(None, None)  # 7 % 2: replicate
    assert rules.spec_for("dense0_bias", (32,), sizes).replicated
    fsdp, jfsdp = tpar.fsdp_rules(), jpar.fsdp_rules()
    fs = tpar.MeshConfig(dp=2, fsdp=4).resolve(8)
    for shape in ((32, 12), (6,), (4, 4)):
        assert tuple(fsdp.spec_for("w", shape, fs)) == tuple(
            jfsdp.spec_for("w", shape, jpar.make_mesh(dp=2, fsdp=4)))
    assert tpar.default_rules().spec_for("anything", (3, 4), _mesh()).replicated
    for ndim, sp in ((2, None), (3, 1), (3, 5)):
        assert tuple(tpar.batch_pspec(ndim, sp)) == tuple(jpar.batch_pspec(ndim, sp))
    sh = tpar.param_sharding(_mesh(), "w", (4, 4), tpar.default_rules())
    assert sh.spec == P(None, None)


def jax_p(*parts):
    from jax.sharding import PartitionSpec

    return PartitionSpec(*parts)


def test_shard_array_places_the_batch_and_refuses_other_axes():
    mesh = _mesh()
    x = np.arange(12, dtype=np.float32).reshape(4, 3)
    got = tpar.shard_array(mesh, x, tpar.batch_pspec(2))
    assert torch.equal(got, torch.from_numpy(x)) and got.device == mesh.device
    assert torch.equal(tpar.replicate(mesh, x), torch.from_numpy(x))
    with pytest.raises(NotImplementedError, match="item 6b"):
        tpar.shard_array(mesh, x, tpar.PartitionSpec(None, "tp"))
    with pytest.raises(NotImplementedError, match="item 6b"):
        tpar.shard_array(mesh, x[None], tpar.batch_pspec(3, sp_axis=1))


# -- SPMDTrainer ---------------------------------------------------------------


def test_matches_imperative_trainer():
    """Three SGD-momentum steps: the SPMD step against record/backward/
    Trainer.step on a copy, bit for bit (one process, the same ops)."""
    start = _jax_params(_jax_mlp())
    x, y = _mlp_data(n=64)
    net_a, net_b = _port_mlp(start), _port_mlp(start)
    loss_fn = _ce(mx)
    trainer = mx.gluon.Trainer(net_a.collect_params(), *SGD)
    for _ in range(3):
        with mx.autograd.record():
            loss = loss_fn(net_a(torch.from_numpy(x)), torch.from_numpy(y))
        mx.autograd.backward(loss)
        trainer.step(x.shape[0])
    spmd = tpar.SPMDTrainer(net_b, loss_fn, *SGD, mesh=_mesh())
    for _ in range(3):
        spmd.step(mx.nd.array(x, ctx=mx.cpu()), mx.nd.array(y, ctx=mx.cpu()))
    spmd.sync_to_block()
    a, b = _port_params(net_a), _port_params(net_b)
    assert all(np.array_equal(a[k], b[k]) for k in a)
    assert spmd.num_update == 3 and spmd.fallback_reason is None


def test_matches_jax_spmd_trainer(jax_spmd):
    """The port's world-1 SPMDTrainer against the JAX one on its 8-device
    mesh: the same global batch, parameters and steps."""
    ref = jax_spmd
    net, tr = _port_spmd(ref)
    data, label = _port_inputs(ref["data"], ref["label"])
    losses = [float(tr.step(data, label).asnumpy()) for _ in range(ref["model"]["steps"])]
    np.testing.assert_allclose(losses, ref["losses"], **TOL)
    tr.sync_to_block()
    _assert_params(_port_params(net), ref["after"], ref["model"]["tol"])
    assert tr.num_update == ref["trainer"].num_update
    assert tr.learning_rate() == pytest.approx(ref["trainer"].learning_rate())
    if ref["name"] == "resnet_bn_aux":  # the running statistics moved inside the step
        moved = [k for k in ref["after"] if "running" in k
                 and not np.allclose(ref["after"][k], ref["start"][k])]
        assert len(moved) == 2 * sum(isinstance(m, nn.BatchNorm) for m in net.modules())


def test_save_states_load_across_packages(jax_spmd, tmp_path):
    """A JAX SPMDTrainer's states file loads into the port's, and the port's
    file into a JAX trainer: the same pickle of numpy trees."""
    ref = jax_spmd
    jfile, tfile = str(tmp_path / "jax.states"), str(tmp_path / "port.states")
    ref["trainer"].save_states(jfile)
    net, tr = _port_spmd(ref)
    tr.load_states(jfile)
    assert tr.num_update == ref["trainer"].num_update
    tr.save_states(tfile)
    with open(jfile, "rb") as f:
        want = pickle.load(f)
    with open(tfile, "rb") as f:
        got = pickle.load(f)
    assert got["num_update"] == want["num_update"] and len(got["states"]) == len(want["states"])

    def flat(tree):
        if tree is None:
            return [None]
        if isinstance(tree, tuple):
            return [x for t in tree for x in flat(t)]
        return [np.asarray(tree)]

    for g, w in zip(got["states"], want["states"]):
        assert type(g) is type(w) or w is None
        for a, b in zip(flat(g), flat(w)):
            assert (a is None and b is None) or np.array_equal(a, b)
    jnet = ref["model"]["jax_net"]()
    name, args = ref["model"]["opt"]
    jtr = jpar.SPMDTrainer(jnet, ref["model"]["loss"](mxj), name, dict(args),
                           mesh=jpar.make_mesh())
    jtr.load_states(tfile)
    assert jtr.num_update == want["num_update"]
    for g, w in zip(flat(tuple(jtr._opt_states)), flat(tuple(ref["trainer"]._opt_states))):
        assert (g is None and w is None) or np.array_equal(g, w)


@pytest.mark.parametrize("k", [1, 3])
def test_step_bulk_matches_sequential(k):
    """``step_bulk(k)`` twice against 2k ``step`` calls, Adam: bit-equal, the
    same ``num_update``."""
    start = _jax_params(_jax_mlp(seed=23))
    x, y = _mlp_data(n=16)
    nets = [_port_mlp(start) for _ in range(2)]
    seq = tpar.SPMDTrainer(nets[0], _ce(mx), "adam", {"learning_rate": 0.01}, mesh=_mesh())
    blk = tpar.SPMDTrainer(nets[1], _ce(mx), "adam", {"learning_rate": 0.01}, mesh=_mesh())
    xs, ys = torch.from_numpy(x), torch.from_numpy(y)
    for _ in range(2 * k):
        last_seq = seq.step(xs, ys)
    blk.step_bulk(xs, ys, k)
    last_blk = blk.step_bulk(xs, ys, k)
    assert blk.num_update == seq.num_update == 2 * k
    assert float(last_blk.asnumpy()) == float(last_seq.asnumpy())
    a, b = _port_params(nets[0]), _port_params(nets[1])
    assert all(np.array_equal(a[k2], b[k2]) for k2 in a)
    with pytest.raises(ValueError):
        blk.step_bulk(xs, ys, 0)


def test_step_window_matches_sequential():
    """Two [3, B] windows and a 2-row tail against 8 ``step`` calls on the
    rows: bit-equal; the tail is a declared warm-up build."""
    start = _jax_params(_jax_mlp(seed=5))
    rng = np.random.RandomState(9)
    xw = rng.randn(8, 8, 12).astype(np.float32)
    yw = rng.randint(0, 4, (8, 8)).astype(np.float32)
    nets = [_port_mlp(start) for _ in range(2)]
    seq = tpar.SPMDTrainer(nets[0], _ce(mx), *SGD, mesh=_mesh())
    win = tpar.SPMDTrainer(nets[1], _ce(mx), *SGD, mesh=_mesh())
    for j in range(8):
        last_seq = seq.step(torch.from_numpy(xw[j]), torch.from_numpy(yw[j]))
    tprofiler.reset_compiles()
    for lo, hi in ((0, 3), (3, 6), (6, 8)):
        last_win = win.step_window(torch.from_numpy(xw[lo:hi]), torch.from_numpy(yw[lo:hi]))
    assert win.num_update == 8 and float(last_win.asnumpy()) == float(last_seq.asnumpy())
    a, b = _port_params(nets[0]), _port_params(nets[1])
    assert all(np.array_equal(a[k], b[k]) for k in a)
    programs = [r["program"] for r in tprofiler.compile_registry()["records"]
                if r["site"] == "spmd.step"]
    assert programs == ["step_window[3]", "step_window[2]"]
    with pytest.raises(ValueError, match="stacked"):
        win.step_window(torch.zeros(12), torch.zeros(()))


def test_adam_bias_correction_not_frozen():
    """Four Adam steps of the SPMD trainer against the imperative Trainer's:
    ``t`` moves every step."""
    start = _jax_params(_jax_mlp(seed=5))
    x, y = _mlp_data(n=16)
    net, ref = _port_mlp(start), _port_mlp(start)
    spmd = tpar.SPMDTrainer(net, _ce(mx), "adam", {"learning_rate": 0.01}, mesh=_mesh())
    tr = mx.gluon.Trainer(ref.collect_params(), "adam", {"learning_rate": 0.01})
    xs, ys = torch.from_numpy(x), torch.from_numpy(y)
    for _ in range(4):
        spmd.step(xs, ys)
        with mx.autograd.record():
            loss = _ce(mx)(ref(xs), ys)
        mx.autograd.backward(loss)
        tr.step(x.shape[0])
    spmd.sync_to_block()
    a, b = _port_params(net), _port_params(ref)
    assert all(np.array_equal(a[k], b[k]) for k in a)
    assert spmd.num_update == 4


def test_sync_to_block_and_the_memory_ledger():
    """The block's own Parameters are the trainer's: after ``sync_to_block``
    they hold the trained values, and eager use sees them; the ledger's
    ``spmd.params`` owner holds their bytes for the trainer's life."""
    start = _jax_params(_jax_mlp(seed=2))
    x, y = _mlp_data(n=8)
    net = _port_mlp(start)
    owners = lambda: tprofiler.memory_ledger()["owners"]  # noqa: E731
    gc.collect()  # earlier tests' trainers leave the ledger
    before = owners().get("spmd.params", {}).get("bytes", 0)
    tr = tpar.SPMDTrainer(net, _ce(mx), *SGD, mesh=_mesh())
    nbytes = sum(v.nbytes for v in start.values())
    assert owners()["spmd.params"]["bytes"] - before == nbytes
    tr.step(torch.from_numpy(x), torch.from_numpy(y))
    tr.sync_to_block()
    after = _port_params(net)
    assert any(not np.array_equal(after[k], start[k]) for k in start)
    with mx.autograd.predict_mode():
        out = net(torch.from_numpy(x))
    assert out.shape == (8, 4)
    del tr
    gc.collect()
    assert owners()["spmd.params"]["bytes"] == before


def test_shard_batch_is_idempotent_and_bills_the_host():
    start = _jax_params(_jax_mlp(seed=2))
    tr = tpar.SPMDTrainer(_port_mlp(start), _ce(mx), *SGD, mesh=_mesh())
    x = torch.ones(2, 12)
    staged = tr.shard_batch(x, np.zeros(2, np.float32), mx.nd.ones((2,), ctx=mx.cpu()))
    assert staged[0] is x and all(isinstance(s, torch.Tensor) for s in staged)
    assert tr.shard_window(x)[0] is x


def _queued_rules():
    return tpar.ShardingRules([(r"weight$", tpar.PartitionSpec("tp", None))])


@pytest.mark.parametrize("kw,item", [
    (dict(compression="int8"), "6b"), (dict(compression="bf16"), "6b"),
    (dict(stages=[]), "8"), (dict(pipeline={"n_microbatches": 2}), "8"),
    (dict(sp_axis=1), "6b"), (dict(rules="tp"), "6b"), (dict(rules="fsdp"), "6b"),
    (dict(rules="transformer"), "6b"), (dict(env="int8"), "6b")])
def test_queued_arguments_raise_naming_their_item(kw, item, monkeypatch):
    start = _jax_params(_jax_mlp(seed=2))
    if "env" in kw:
        monkeypatch.setenv("MXNET_GRAD_COMPRESS", kw.pop("env"))
    rules = kw.get("rules")
    if rules is not None:
        kw["rules"] = {"tp": _queued_rules(), "fsdp": tpar.fsdp_rules(),
                       "transformer": ttransformer.transformer_sharding_rules()}[rules]
    net = _port_mlp(start)
    if rules == "transformer":  # a layer named as the transformer's query projection
        net = nn.Dense(4, in_units=12, prefix="enc_q_")
        net.initialize(ctx=mx.cpu())
    with pytest.raises(NotImplementedError, match=f"ROADMAP §1 item {item}"):
        tpar.SPMDTrainer(net, _ce(mx), *SGD, mesh=_mesh(), **kw)


def test_replicated_rules_and_compression_off_are_accepted(monkeypatch):
    monkeypatch.setenv("MXNET_GRAD_COMPRESS", "off")
    start = _jax_params(_jax_mlp(seed=2))
    tr = tpar.SPMDTrainer(_port_mlp(start), _ce(mx), *SGD, mesh=_mesh(),
                          rules=tpar.default_rules(), compression=None, donate=False)
    x, y = _mlp_data(n=4)
    assert np.isfinite(float(tr.step(torch.from_numpy(x), torch.from_numpy(y)).asnumpy()))


def test_the_package_exports_and_queued_names():
    assert mx.kv is mx.kvstore and mx.parallel is tpar
    assert mx.parallel.SPMDTrainer is tpar.trainer.SPMDTrainer
    for name, item in (("ring_attention", "8"), ("pipeline_apply", "8"), ("elastic", "9"),
                       ("CollectiveWatchdog", "9"), ("RunCheckpoint", "9")):
        with pytest.raises(AttributeError, match=f"item {item}"):
            getattr(mx.parallel, name)
    assert not hasattr(mx.parallel, "no_such_name")
    missing = sorted(set(jpar.__all__) - set(tpar.__all__) - set(tpar._ITEM_OF))
    assert missing == []


def test_an_unmaterialized_block_raises():
    net = nn.Dense(4)
    net.initialize(ctx=mx.cpu())
    with pytest.raises(ValueError, match="not materialized"):
        tpar.SPMDTrainer(net, _ce(mx), *SGD, mesh=_mesh())


def test_amp_init_drops_the_built_programs():
    start = _jax_params(_jax_mlp(seed=2))
    tr = tpar.SPMDTrainer(_port_mlp(start), _ce(mx), *SGD, mesh=_mesh())
    x, y = _mlp_data(n=4)
    tr.step(torch.from_numpy(x), torch.from_numpy(y))
    assert tr._programs
    mx.amp.init("bfloat16")
    try:
        assert not tr._programs
    finally:
        mx.amp.disable()


def test_default_mesh_is_the_parameters_device():
    start = _jax_params(_jax_mlp(seed=2))
    tr = tpar.SPMDTrainer(_port_mlp(start), _ce(mx), *SGD)
    assert tr.mesh.device == torch.device("cpu") and tr.mesh.world == 1
    mesh = _mesh()
    with tpar.mesh_scope(mesh):
        assert tpar.SPMDTrainer(_port_mlp(start), _ce(mx), *SGD).mesh is mesh


def test_env_is_clean():
    assert os.environ.get("MXNET_GRAD_COMPRESS", "off").lower() in ("off", "", "0", "none")
