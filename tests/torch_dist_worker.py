"""One rank of a ``torch.distributed`` cohort of the port's data-parallel
tier: the counterpart of ``tests/dist_worker.py`` (the reference's
``tests/nightly/dist_sync_kvstore.py`` assertions) and more.

Launched N times by ``tools/launch_local.py`` (the ``DMLC_*`` contract):

    python tools/launch_local.py -n 2 python tests/torch_dist_worker.py SCENARIOS \\
        [--device cpu|cuda:0] [--backend gloo|nccl] [--model mlp|resnet|bert] \\
        [--params start.npz] [--out DIR] [--steps N]

Scenarios, one or several joined by commas (each prints ``torch_dist_worker
rank R/N: SCENARIO assertions passed``; the worker exits 0, or raises):

* ``kv``: the ``dist_sync`` store's exact aggregated values (int and string
  keys, list aggregation, an updater on the store, pushpull, broadcast,
  buckets), compression raising with its ROADMAP item, the wire-agreement
  check, the barrier, the clock offset sampled at ``init_distributed``,
  and an ``SPMDTrainer`` over the N-rank mesh that learns with every rank's
  parameters bitwise equal;
* ``overlap``: ``Trainer(kvstore='dist_sync')`` with ``Trainer.backward``'s
  overlap against a plain backward and ``allreduce_grads`` on a copy:
  gradients and parameters bit-equal (deterministic algorithms), the ranks
  bitwise equal, buckets launched mid-backward;
* ``spmd``: ``SPMDTrainer`` at N ranks, each on its rows of the global
  batch, against one rank (a mesh of this process alone, rank 0) on the
  whole batch: losses and parameters within ``--tol`` (BatchNorm by the
  global batch's statistics, running statistics included), the ranks
  bitwise equal; rank 0 writes the N-rank parameters and losses to
  ``--out``/``spmd_<model>.npz``.

Every rank runs on ``--device`` (ranks may share one card over gloo).  The
models: ``mlp`` (Dense 12-32-16-4, SGD-momentum), ``resnet`` (a small
ResNetV1 with BatchNorm, SGD-momentum), ``bert`` (BERT-base's width, 768
units, 12 heads, vocab 30522, at 2 layers; fp32 for ``spmd``, bf16 with
fp32 Adam masters for ``overlap``).  ``--params`` gives starting
parameters by structural key (otherwise a seed makes them).
"""
import argparse
import contextlib
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

import incubator_mxnet_torch as mx  # noqa: E402
from incubator_mxnet_torch import parallel  # noqa: E402
from incubator_mxnet_torch import profiler  # noqa: E402
from incubator_mxnet_torch.convert import load_numpy_params  # noqa: E402
from incubator_mxnet_torch.gluon import nn  # noqa: E402
from incubator_mxnet_torch.gluon.model_zoo import bert as bert_zoo  # noqa: E402
from incubator_mxnet_torch.gluon.model_zoo import vision  # noqa: E402
from incubator_mxnet_torch.ops.nn import streaming_softmax_ce  # noqa: E402

GLOBAL_B = {"mlp": 8, "resnet": 8, "bert": 8}
SMALL_RESNET = dict(layers=[1, 1, 1, 1], channels=[8, 16, 32, 64, 128], classes=10)
BERT_2L = dict(vocab_size=30522, units=768, hidden_size=3072, num_layers=2, num_heads=12,
               max_length=512, dropout=0.0)
BERT_S, BERT_P = 128, 20


def _ctx(device):
    return mx.cpu() if device.type == "cpu" else mx.gpu(device.index or 0)


# -- models ------------------------------------------------------------------------


def build(model, device, params=None, dtype="float32"):
    """The model on ``device`` from ``params`` (by structural key) or a
    seed, materialized; and its per-sample loss ``loss_fn(out, label)``."""
    ctx = _ctx(device)
    mx.random.seed(0)
    if model == "mlp":
        net = nn.HybridSequential(prefix="mlp_")
        with net.name_scope():
            net.add(nn.Dense(32, activation="relu", in_units=12),
                    nn.Dense(16, activation="relu", in_units=32), nn.Dense(4, in_units=16))
        loss = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    elif model == "resnet":
        net = vision.ResNetV1(vision.BottleneckV1, thumbnail=True, prefix="res_",
                              **SMALL_RESNET)
        loss = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    else:
        net = bert_zoo.BERTForPretrain(bert_zoo.BERTModel(**BERT_2L, prefix="bert_"),
                                       vocab_size=BERT_2L["vocab_size"], prefix="pre_")

        def loss(out, label):
            return streaming_softmax_ce(out[0], label).mean(-1)
    net.initialize(ctx=ctx)
    data, _ = batch(model, device, 0, 2)
    with mx.autograd.predict_mode():
        net(*data)
    if params is not None:
        load_numpy_params(net, params)
    if dtype != "float32":
        net.cast(dtype)
    return net, loss


def batch(model, device, lo, hi, seed=3):
    """Rows ``lo:hi`` of the model's global batch (made from a seed, the
    same in every process): ``(inputs, label)`` on ``device``."""
    rng = np.random.RandomState(seed)
    b = max(GLOBAL_B[model], hi)
    if model == "mlp":
        data = [rng.randn(b, 12).astype(np.float32)]
        label = rng.randint(0, 4, b).astype(np.float32)
    elif model == "resnet":
        data = [rng.rand(b, 3, 32, 32).astype(np.float32)]
        label = rng.randint(0, 10, b).astype(np.int32)
    else:
        v = BERT_2L["vocab_size"]
        data = [rng.randint(0, v, (b, BERT_S)).astype(np.int32),
                rng.randint(0, 2, (b, BERT_S)).astype(np.int32),
                np.sort(np.stack([rng.choice(BERT_S, BERT_P, replace=False)
                                  for _ in range(b)])).astype(np.int32)]
        label = rng.randint(0, v, (b, BERT_P)).astype(np.int32)
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a[lo:hi])).to(device)  # noqa: E731
    return [to(a) for a in data], to(label)


def _flat(net):
    return torch.cat([p.data().detach().float().reshape(-1)
                      for _, p in sorted(net._collect_params_with_prefix().items())])


def ranks_equal(t):
    """Whether ``t`` is bitwise the same tensor on every rank (its max and
    min over the ranks agree element by element)."""
    hi, lo = t.detach().clone(), t.detach().clone()
    dist.all_reduce(hi, op=dist.ReduceOp.MAX)
    dist.all_reduce(lo, op=dist.ReduceOp.MIN)
    return torch.equal(hi, lo) and torch.equal(hi, t)


@contextlib.contextmanager
def deterministic():
    before = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(before)


# -- scenarios ---------------------------------------------------------------------


def scenario_kv(args, rank, nw, device):
    ctx = _ctx(device)
    ones = lambda shape: mx.nd.ones(shape, ctx=ctx)  # noqa: E731
    zeros = lambda shape: mx.nd.zeros(shape, ctx=ctx)  # noqa: E731
    f32 = np.float32
    kv = mx.kv.create("dist_sync")
    assert (kv.rank, kv.num_workers) == (rank, nw), (kv.rank, kv.num_workers)

    kv.init(3, ones((4, 5)))
    kv.push(3, ones((4, 5)) * (rank + 1))  # the sum over ranks of r + 1
    out = zeros((4, 5))
    kv.pull(3, out=out)
    np.testing.assert_array_equal(out.asnumpy(), np.full((4, 5), nw * (nw + 1) / 2, f32))

    kv.init("weight0", zeros((3,)))
    kv.push("weight0", mx.nd.array([float(rank), 1.0, -1.0], ctx=ctx))
    out = zeros((3,))
    kv.pull("weight0", out=out)
    np.testing.assert_array_equal(out.asnumpy(),
                                  np.array([nw * (nw - 1) / 2, nw, -nw], f32))

    kv.push(3, [ones((4, 5)), ones((4, 5))])  # each rank 2: the list first, then the ranks
    out2 = zeros((4, 5))
    kv.pull(3, out=out2)
    np.testing.assert_array_equal(out2.asnumpy(), np.full((4, 5), 2.0 * nw, f32))

    kvu = mx.kv.create("dist_sync")  # an updater on the store
    kvu.init(11, ones((2, 2)))

    def updater(key, grad, weight):
        weight += -0.1 * grad

    kvu._set_updater(updater)
    kvu.push(11, ones((2, 2)))  # the summed gradient is nw
    out = zeros((2, 2))
    kvu.pull(11, out=out)
    want = f32(1.0) + f32(-0.1) * f32(nw)
    np.testing.assert_array_equal(out.asnumpy(), np.full((2, 2), want, f32))
    assert not kvu.supports_grad_bucketing()

    kvp = mx.kv.create("dist_sync")
    kvp.init(9, zeros((4,)))
    outp = zeros((4,))
    g = np.array([0.6, -0.7, 0.1, 0.0], f32)
    kvp.pushpull(9, mx.nd.array(g, ctx=ctx), out=outp)
    np.testing.assert_array_equal(outp.asnumpy(), g * nw)
    one = zeros((1,))
    kvp.broadcast(12, mx.nd.array([5.0], ctx=ctx), out=one)
    np.testing.assert_array_equal(one.asnumpy(), np.array([5.0], f32))
    try:
        kvp.set_gradient_compression({"type": "2bit", "threshold": 0.5})
    except NotImplementedError as e:
        assert "ROADMAP §1 item 6b" in str(e)
    else:
        raise AssertionError("gradient compression must raise, naming item 6b")

    # buckets: every rank plans the same; the sums are exact
    grads = [torch.full((3, 4), float(rank + 1), device=device),
             torch.arange(7, dtype=torch.float32, device=device) * (rank + 1),
             torch.full((5,), 0.5, dtype=torch.bfloat16, device=device)]
    mx.kvstore.bucketed_pushpull(kv, list(enumerate(grads)), cap_bytes=48)
    tri = nw * (nw + 1) / 2
    assert torch.equal(grads[0], torch.full((3, 4), tri, device=device))
    assert torch.equal(grads[1], torch.arange(7, dtype=torch.float32, device=device) * tri)
    assert torch.equal(grads[2], torch.full((5,), 0.5 * nw, dtype=torch.bfloat16,
                                            device=device))
    kv.check_wire_agreement("__grad_bucket__:0:fp32:float32:0")
    try:
        kv.check_wire_agreement(f"rank{rank}")
    except RuntimeError as e:
        assert "wire-format mismatch" in str(e)
    else:
        raise AssertionError("a rank formatting another bucket must raise on every rank")
    kv.barrier()
    info = profiler.process_info()
    assert info["rank"] == rank and info["clock_rtt_s"] is not None, info

    # SPMDTrainer over the N-rank mesh: each rank feeds its own rows
    mesh = parallel.make_mesh(devices=[device] * nw)
    assert mesh.world == nw and mesh.devices.size == nw and mesh.rank == rank
    net = nn.Dense(4, flatten=False, in_units=8)
    mx.random.seed(rank)  # different on each rank: the trainer broadcasts rank 0's
    net.initialize(ctx=ctx)
    tr = parallel.SPMDTrainer(net, lambda out, label: ((out - label) ** 2).mean(-1), "sgd",
                              {"learning_rate": 0.1}, mesh=mesh)
    assert "world" in tr.fallback_reason
    rng = np.random.RandomState(42 + rank)
    x = mx.nd.array(rng.rand(4, 8).astype(f32), ctx=ctx)
    y = mx.nd.array(rng.rand(4, 4).astype(f32), ctx=ctx)
    l0 = float(tr.step(x, y).asscalar())
    for _ in range(20):
        loss = tr.step(x, y)
    l1 = float(loss.asscalar())
    assert np.isfinite(l0) and l1 < l0, (l0, l1)
    assert ranks_equal(net.weight.data()) and ranks_equal(loss._data.reshape(1))
    # the step was not captured, and its one build record says why
    builds = [r for r in profiler.compile_registry()["records"] if r["site"] == "spmd.step"]
    assert len(builds) == 1 and "fallback_reason" in builds[0]["signature"], builds


def scenario_overlap(args, rank, nw, device):
    model = args.model
    dtype = "bfloat16" if model == "bert" else "float32"
    opt = (("adam", {"learning_rate": 1e-4, "multi_precision": True}) if model == "bert"
           else ("sgd", {"learning_rate": 0.1, "momentum": 0.9}))
    b = GLOBAL_B[model] // nw
    data, label = batch(model, device, rank * b, (rank + 1) * b)
    params, launched = [], 0
    with deterministic():
        for overlap in (False, True):
            net, loss_fn = build(model, device, dtype=dtype)
            tr = mx.gluon.Trainer(net.collect_params(), *opt, kvstore="dist_sync")
            for step in range(2):
                c0 = profiler.counters()["allreduce_overlap_launched"]
                with mx.autograd.record():
                    loss = loss_fn(net(*data), label)
                if overlap:
                    tr.backward(loss)
                else:
                    mx.autograd.backward(loss)
                launched += profiler.counters()["allreduce_overlap_launched"] - c0
                tr.step(b * nw)
            ps = sorted(net._collect_params_with_prefix().items())
            params.append([p.data().detach().clone() for _, p in ps]
                          + [p.grad().clone() for _, p in ps if p.grad_req != "null"])
            trained = [p.data().detach().float().reshape(-1) for _, p in ps
                       if p.grad_req != "null"]
            del net, tr
    equal = all(torch.equal(a, c) for a, c in zip(*params))
    assert equal, "the overlapped backward differs from the plain one"
    assert launched >= 2, launched  # a bucket or more a step
    # the summed gradients make every rank's trained parameters equal (a
    # Trainer's BatchNorm keeps each rank's own running statistics)
    assert ranks_equal(torch.cat(trained))
    print(f"rank {rank}: overlap bit-equal over 2 steps, {launched} buckets launched "
          f"mid-backward", flush=True)


def scenario_spmd(args, rank, nw, device):
    model = args.model
    start = dict(np.load(args.params)) if args.params else None
    opt = ("sgd", {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4}
           if model == "resnet" else {"learning_rate": 0.1, "momentum": 0.9})
    b = GLOBAL_B[model] // nw
    steps = args.steps
    with deterministic():
        net, loss_fn = build(model, device, start)
        tr = parallel.SPMDTrainer(net, loss_fn, *opt,
                                  mesh=parallel.make_mesh(devices=[device] * nw))
        data, label = batch(model, device, rank * b, (rank + 1) * b)
        losses = [float(tr.step(data, label).asnumpy()) for _ in range(steps)]
        got = {k: p.data().detach().float().cpu().numpy()
               for k, p in net._collect_params_with_prefix().items()}
        assert ranks_equal(_flat(net)), "the ranks' parameters differ"
        if rank == 0:
            one, _ = build(model, device, start)
            tr1 = parallel.SPMDTrainer(one, loss_fn, *opt,
                                       mesh=parallel.make_mesh(devices=[device]))
            assert tr1.mesh.world == 1 and tr1.fallback_reason is None
            data1, label1 = batch(model, device, 0, b * nw)
            losses1 = [float(tr1.step(data1, label1).asnumpy()) for _ in range(steps)]
            ref = {k: p.data().detach().float().cpu().numpy()
                   for k, p in one._collect_params_with_prefix().items()}
            np.testing.assert_allclose(losses, losses1, rtol=args.tol, atol=args.tol)
            worst = 0.0
            for k in ref:
                np.testing.assert_allclose(got[k], ref[k], rtol=args.tol, atol=args.tol,
                                           err_msg=k)
                worst = max(worst, float(np.abs(got[k] - ref[k]).max()))
            print(f"rank 0: {model} {nw} ranks vs 1 over {steps} steps: losses {losses} vs "
                  f"{losses1}, largest parameter difference {worst:.3e} (tol {args.tol})",
                  flush=True)
            if args.out:
                np.savez(os.path.join(args.out, f"spmd_{model}.npz"), __losses__=losses, **got)
    dist.barrier()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("scenarios", help="kv, overlap or spmd, or several joined by commas, "
                                       "run in that order")
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--backend", default="gloo")
    ap.add_argument("--model", default="mlp", choices=("mlp", "resnet", "bert"))
    ap.add_argument("--params", default=None)
    ap.add_argument("--out", default=None)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--tol", type=float, default=1e-5)
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cpu":
        torch.set_num_threads(1)
    else:
        torch.cuda.set_device(device)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    parallel.init_distributed(backend=args.backend)
    rank, nw = dist.get_rank(), dist.get_world_size()
    assert nw == int(os.environ["DMLC_NUM_WORKER"])
    try:
        for name in args.scenarios.split(","):
            if name not in ("kv", "overlap", "spmd"):
                raise ValueError(f"unknown scenario {name!r}")
            globals()[f"scenario_{name}"](args, rank, nw, device)
            print(f"torch_dist_worker rank {rank}/{nw}: {name} assertions passed", flush=True)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
