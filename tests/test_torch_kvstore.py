"""The port's kvstore (``incubator_mxnet_torch.kvstore``) against the JAX
package's, on the CPU, in one process.

``'local'``/``'device'`` push, pull, pushpull, list aggregation, an updater
on the store and ``save_optimizer_states`` give the JAX store's values
exactly (the same fp32 sums and optimizer arithmetic on small integers);
``plan_buckets`` draws the JAX plan's bucket boundaries and keys on the
same items and caps.  The Trainer's kvstore path: ``update_on_kvstore``
against the plain step, and ``Trainer.backward``'s overlap against a plain
backward followed by ``allreduce_grads``, bit for bit, on a store that
stands in for two workers (its wire doubles each bucket, the sum of two
equal ranks); a failure on that wire leaves the failed bucket's gradients
as they were.  The cross-process stores run in ``test_torch_dist.py``.
"""
import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as mxj
import incubator_mxnet_torch as mx
from incubator_mxnet_torch import kvstore as tkv
from incubator_mxnet_torch import profiler as tprofiler
from incubator_mxnet_torch.gluon import nn


def _nd(pkg, a):
    return pkg.nd.array(np.asarray(a, np.float32), **({"ctx": mx.cpu()} if pkg is mx else {}))


def _zeros(pkg, shape):
    return pkg.nd.zeros(shape, **({"ctx": mx.cpu()} if pkg is mx else {}))


def _session(pkg, name):
    """One script of store calls; the values it pulls, as numpy."""
    kv = pkg.kv.create(name)
    got = []
    kv.init(3, _nd(pkg, np.ones((4, 5))))
    kv.push(3, _nd(pkg, np.full((4, 5), 2.0)))
    out = _zeros(pkg, (4, 5))
    kv.pull(3, out=out)
    got.append(out.asnumpy())
    kv.push(3, [_nd(pkg, np.ones((4, 5))), _nd(pkg, np.full((4, 5), 3.0))])  # list: summed
    outs = [_zeros(pkg, (4, 5)), _zeros(pkg, (4, 5))]
    kv.pull(3, out=outs)
    got += [o.asnumpy() for o in outs]
    kv.init(["a", "b"], [_nd(pkg, [1.0, 2.0]), _nd(pkg, [3.0])])
    o2 = [_zeros(pkg, (2,)), _zeros(pkg, (1,))]
    kv.pushpull(["a", "b"], [_nd(pkg, [5.0, 6.0]), _nd(pkg, [7.0])], out=o2)
    got += [o.asnumpy() for o in o2]
    kv.broadcast("c", _nd(pkg, [9.0, 8.0]), out=o2[0])
    got.append(o2[0].asnumpy())
    # an updater on the store: weight += -0.5 * grad
    kvu = pkg.kv.create(name)
    kvu.init(11, _nd(pkg, np.ones((2, 2))))
    kvu._set_updater(lambda key, grad, weight: weight.__iadd__(-0.5 * grad))
    kvu.push(11, _nd(pkg, np.full((2, 2), 2.0)))
    ou = _zeros(pkg, (2, 2))
    kvu.pull(11, out=ou)
    got.append(ou.asnumpy())
    return got, kv


@pytest.mark.parametrize("name", ["local", "device"])
def test_local_store_matches_jax(name):
    got, kv = _session(mx, name)
    want, jkv = _session(mxj, name)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert (kv.type, kv.rank, kv.num_workers) == (jkv.type, jkv.rank, jkv.num_workers) \
        == (name, 0, 1)
    assert not kv.supports_grad_bucketing() and kv.membership_epoch() == 0
    kv.barrier()


def test_set_optimizer_and_save_optimizer_states(tmp_path):
    """The optimizer on the store: three SGD-momentum pushes give the JAX
    store's weights; the states file restores the momentum."""
    def run(pkg, fname=None):
        kv = pkg.kv.create("local")
        kv.set_optimizer(pkg.optimizer.create("sgd", learning_rate=0.25, momentum=0.5))
        kv.init(0, _nd(pkg, [1.0, -2.0, 4.0]))
        out = _zeros(pkg, (3,))
        for g in ([1.0, 2.0, 3.0], [0.5, 0.0, -1.0], [2.0, 2.0, 2.0]):
            kv.pushpull(0, _nd(pkg, g), out=out)
        if fname is not None:
            kv.save_optimizer_states(fname)
        return out.asnumpy(), kv

    got, kv = run(mx, str(tmp_path / "kv.states"))
    want, _ = run(mxj)
    np.testing.assert_array_equal(got, want)
    fresh = mx.kv.create("local")
    with pytest.raises(ValueError):
        fresh.save_optimizer_states(str(tmp_path / "x"))
    fresh.set_optimizer(mx.optimizer.create("sgd", learning_rate=0.25, momentum=0.5))
    fresh.load_optimizer_states(str(tmp_path / "kv.states"))
    assert torch.equal(fresh._updater.states[0], kv._updater.states[0])


ITEMS = [((4, 5), "float32"), ((7,), "float32"), ((300,), "float32"), ((3, 3), "float16"),
         ((1000,), "float32"), ((2,), "float16"), ((64, 64), "float32"), ((5,), "float32")]


@pytest.mark.parametrize("cap", [0, 64, 1024, 4096, 1 << 20])
def test_plan_buckets_matches_jax(cap):
    titems = [(i, torch.zeros(s, dtype=getattr(torch, d))) for i, (s, d) in enumerate(ITEMS)]
    jitems = [(i, mxj.nd.zeros(s, dtype=d)) for i, (s, d) in enumerate(ITEMS)]
    policy, got = tkv.plan_buckets(titems, cap_bytes=cap)
    jpolicy, want = mxj.kvstore.plan_buckets(jitems, cap_bytes=cap, compression="off")
    assert policy is None and jpolicy is None
    assert [(b["key"], b["positions"], b["nbytes"], b["cid"]) for b in got] == \
        [(b["key"], b["positions"], b["nbytes"], b["cid"]) for b in want]


def test_bucketed_pushpull_in_one_process_keeps_values():
    grads = [torch.arange(6, dtype=torch.float32).reshape(2, 3), torch.ones(5),
             torch.full((4,), 2.0, dtype=torch.float16)]
    before = [g.clone() for g in grads]
    c0 = tprofiler.counters()["allreduce_bucket"]
    tkv.bucketed_pushpull(tkv.create("dist_sync"), list(enumerate(grads)), cap_bytes=32)
    assert all(torch.equal(g, b) for g, b in zip(grads, before))
    assert tprofiler.counters()["allreduce_bucket"] - c0 == 3  # 24 B | 20 B, and the fp16 one


def test_later_tiers_raise_naming_their_items():
    with pytest.raises(NotImplementedError, match="ROADMAP §1 item 9"):
        mx.kv.create("dist_async")
    kv = mx.kv.create("dist_sync")
    assert kv.type == "dist_sync" and kv.num_workers == 1 and kv.rank == 0
    assert kv.supports_grad_bucketing()
    for call in (lambda: kv.set_gradient_compression({"type": "2bit"}),
                 lambda: kv._quantize_2bit(0, torch.ones(2)),
                 lambda: tkv.plan_buckets([(0, torch.ones(2))], compression="int8"),
                 lambda: tkv.bucketed_pushpull(kv, [(0, torch.ones(2))], compression="bf16")):
        with pytest.raises(NotImplementedError, match="ROADMAP §1 item 6b"):
            call()
    assert mx.kv.create("horovod").type == "dist_sync"
    with pytest.raises(ValueError):
        mx.kv.create("nosuchstore")
    with pytest.raises(AttributeError, match="item 9"):
        mx.kvstore.KVStoreDistAsync


class _TwoRanks(tkv.KVStoreLocal):
    """Stands in for a store of two workers whose ranks hold the same
    gradients: its wire doubles a bucket in place; ``fail_at`` makes the
    n-th bucket's wire raise."""

    def __init__(self, fail_at=None):
        super().__init__("dist_sync")
        self.fail_at, self.calls = fail_at, 0

    @property
    def num_workers(self):
        return 2

    def supports_grad_bucketing(self):
        return True

    def wire_allreduce(self, arr, op="sum", async_op=False):
        self.calls += 1
        if self.calls == self.fail_at:
            raise RuntimeError("wire down")
        arr.mul_(2)
        return None if async_op else arr


def _net():
    mx.random.seed(4)
    net = nn.HybridSequential()
    with net.name_scope():
        net.add(nn.Dense(16, activation="relu", in_units=6), nn.Dense(8, in_units=16),
                nn.Dense(4, in_units=8))
    net.initialize(ctx=mx.cpu())
    return net


def _grads(net):
    return [p.grad().clone() for p in net.collect_params().values()]


def _loss(net, x):
    return (net(x) ** 2).sum(-1)


def test_backward_overlap_is_a_plain_backward_then_allreduce(monkeypatch):
    monkeypatch.setenv("MXNET_KVSTORE_BUCKET_BYTES", "256")
    x = torch.from_numpy(np.random.RandomState(0).rand(5, 6).astype(np.float32))
    runs = []
    for overlap in ("1", "0"):
        monkeypatch.setenv("MXNET_ALLREDUCE_OVERLAP", overlap)
        net = _net()
        tr = mx.gluon.Trainer(net.collect_params(), "sgd", {"learning_rate": 0.1},
                              kvstore=_TwoRanks())
        c0 = tprofiler.counters()["allreduce_overlap_launched"]
        with mx.autograd.record():
            loss = _loss(net, x)
        tr.backward(loss)
        launched = tprofiler.counters()["allreduce_overlap_launched"] - c0
        tr.allreduce_grads()
        runs.append((_grads(net), launched, tr._kvstore.calls))
    (g1, launched, calls1), (g0, none, calls0) = runs
    assert launched > 1 and none == 0 and calls1 == calls0
    assert all(torch.equal(a, b) for a, b in zip(g1, g0))


def test_a_stale_overlap_plan_is_reduced_anew(monkeypatch):
    """A backward after an overlapped one (no step between) rewrites the
    gradients: ``allreduce_grads`` must reduce them, not skip them."""
    monkeypatch.setenv("MXNET_KVSTORE_BUCKET_BYTES", "256")
    x = torch.ones(2, 6)
    net = _net()
    tr = mx.gluon.Trainer(net.collect_params(), "sgd", {"learning_rate": 0.1},
                          kvstore=_TwoRanks())
    with mx.autograd.record():
        loss = _loss(net, x)
    tr.backward(loss)
    with mx.autograd.record():
        loss = _loss(net, x)
    mx.autograd.backward(loss)
    plain = _grads(net)
    tr.allreduce_grads()
    assert all(torch.equal(g, 2 * p) for g, p in zip(_grads(net), plain))


def test_a_wire_failure_leaves_the_bucket_untouched(monkeypatch):
    monkeypatch.setenv("MXNET_KVSTORE_BUCKET_BYTES", "256")
    x = torch.ones(3, 6)
    net = _net()
    tr = mx.gluon.Trainer(net.collect_params(), "sgd", {"learning_rate": 0.1},
                          kvstore=_TwoRanks(fail_at=2))
    with mx.autograd.record():
        loss = _loss(net, x)
    with pytest.raises(RuntimeError, match="wire down"):
        tr.backward(loss)
    assert tr._overlap is None
    # every gradient keeps its own value or its reduced one, never a half
    with mx.autograd.record():
        loss = _loss(net, x)
    mx.autograd.backward(loss)
    plain = _grads(net)
    kv = _TwoRanks(fail_at=1)
    items = list(enumerate(p.grad() for p in net.collect_params().values()))
    _, buckets = tkv.plan_buckets(items, cap_bytes=256)
    with pytest.raises(RuntimeError, match="wire down"):
        tkv.execute_bucket(kv, buckets[0], items, None, None)
    assert all(torch.equal(g, p) for g, p in zip(_grads(net), plain))


def test_update_on_kvstore_matches_the_local_update(tmp_path):
    x = torch.from_numpy(np.random.RandomState(1).rand(4, 6).astype(np.float32))
    params = []
    for on_store in (False, True):
        net = _net()
        tr = mx.gluon.Trainer(net.collect_params(), "sgd",
                              {"learning_rate": 0.1, "momentum": 0.9}, kvstore="local",
                              update_on_kvstore=on_store)
        for _ in range(3):
            with mx.autograd.record():
                loss = _loss(net, x)
            mx.autograd.backward(loss)
            tr.step(4)
        params.append([p.data().detach().clone() for p in net.collect_params().values()])
        if on_store:
            with pytest.raises(RuntimeError, match="update_on_kvstore"):
                tr.allreduce_grads()
            tr.save_states(str(tmp_path / "s"))
            tr.load_states(str(tmp_path / "s"))
    assert all(torch.equal(a, b) for a, b in zip(*params))


def test_close_covers_a_store_object():
    closed = []

    class Closable(tkv.KVStoreLocal):
        def close(self):
            closed.append(True)

    tr = mx.gluon.Trainer(_net().collect_params(), "sgd", kvstore=Closable("local"))
    tr.close()
    with mx.gluon.Trainer(_net().collect_params(), "sgd", kvstore=Closable("local")):
        pass
    assert closed == [True, True]


def test_fold_against_a_multi_worker_store_raises():
    net = _net()
    tr = mx.gluon.Trainer(net.collect_params(), "sgd", kvstore=_TwoRanks())
    for fold in (tr.fold_step, tr.fold_steps):
        with pytest.raises(NotImplementedError, match="ROADMAP §1 item 6b"):
            fold(lambda a: _loss(net, a), block=net)
    tr = mx.gluon.Trainer(net.collect_params(), "sgd", kvstore="dist_sync")
    assert tr.fold_step(lambda a: _loss(net, a), block=net).folded
