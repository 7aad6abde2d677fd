"""``mx.metric``, ``mx.callback`` and ``mx.Monitor`` of the port against the
JAX package's, on the CPU.

Every metric case of ``tests/test_metric.py`` (and a few more: empty
metrics, ignore labels, the registry's aliases) is fed the same numpy
labels and predictions in both packages, as NDArrays and, on the port, as
tensors too; ``get()`` agrees to ``METRIC_TOL`` (float64 host arithmetic
on the same values: only the order of the sums can differ).  The callbacks
log the same lines once ``Speedometer``'s measured rate is masked, and
``do_checkpoint`` writes a checkpoint either package loads.  ``Monitor`` is
held on a Gluon block tree carrying the same weights in both packages, as
``tests/test_monitor_viz.py`` drives the JAX one.
"""
import logging
import re

import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as mxj
import incubator_mxnet_torch as mx
from incubator_mxnet_torch.convert import load_numpy_params

METRIC_TOL = 1e-12

P2 = np.array([[0.3, 0.7], [0.9, 0.1], [0.4, 0.6]], np.float32)
R = np.random.RandomState(0)
P5 = R.dirichlet(np.ones(5), 12).astype(np.float32)
Y5 = R.randint(0, 5, 12).astype(np.float32)
YB = R.randint(0, 2, 40).astype(np.float32)
PB = np.eye(2, dtype=np.float32)[np.where(R.rand(40) < 0.7, YB, 1 - YB).astype(int)]
REG_P = R.randn(6, 3).astype(np.float32)
REG_L = R.randn(6, 3).astype(np.float32)

# (metric name or class name, kwargs, labels, preds): one update each
CASES = [
    ("Accuracy", {}, [np.array([1, 0, 0], np.float32)], [P2]),
    ("Accuracy", {}, [Y5], [P5]),
    ("Accuracy", {}, [Y5], [P5.argmax(1).astype(np.float32)]),
    ("TopKAccuracy", {"top_k": 2},
     [np.array([1, 2], np.float32)], [np.array([[0.1, 0.2, 0.7], [0.7, 0.2, 0.1]], np.float32)]),
    ("TopKAccuracy", {"top_k": 3}, [Y5], [P5]),
    ("MSE", {}, [np.array([[1.5], [2.5]], np.float32)], [np.array([[1.0], [2.0]], np.float32)]),
    ("RMSE", {}, [np.array([[1.5], [2.5]], np.float32)], [np.array([[1.0], [2.0]], np.float32)]),
    ("MAE", {}, [np.array([[1.5], [2.5]], np.float32)], [np.array([[1.0], [2.0]], np.float32)]),
    ("MSE", {}, [REG_L], [REG_P]),
    ("RMSE", {}, [REG_L], [REG_P]),
    ("MAE", {}, [REG_L], [REG_P]),
    ("Perplexity", {}, [np.array([0, 0], np.float32)],
     [np.array([[0.5, 0.5], [0.9, 0.1]], np.float32)]),
    ("Perplexity", {"ignore_label": 0}, [Y5], [P5]),
    ("CrossEntropy", {}, [Y5], [P5]),
    ("NegativeLogLikelihood", {}, [Y5], [P5]),
    ("F1", {}, [np.array([1, 1, 0], np.float32)],
     [np.array([[0.2, 0.8], [0.8, 0.2], [0.3, 0.7]], np.float32)]),
    ("F1", {}, [YB], [PB]),
    ("MCC", {}, [np.array([1, 0, 0, 1], np.float32)],
     [np.array([[0.2, 0.8], [0.9, 0.1], [0.3, 0.7], [0.6, 0.4]], np.float32)]),
    ("MCC", {}, [np.array([1, 0], np.float32)], [np.array([[0.1, 0.9], [0.8, 0.2]], np.float32)]),
    ("MCC", {}, [np.array([1, 1], np.float32)], [np.array([[0.1, 0.9], [0.2, 0.8]], np.float32)]),
    ("MCC", {}, [YB], [PB]),
    ("PCC", {}, [YB], [PB]),
    ("PCC", {}, [Y5], [P5]),
    ("PearsonCorrelation", {}, [REG_L], [REG_P]),
    ("Loss", {}, [], [np.array([2.0, 4.0], np.float32)]),
    ("acc", {}, [Y5], [P5]),
    ("ce", {}, [Y5], [P5]),
    ("nll_loss", {}, [Y5], [P5]),
    ("top_k_accuracy", {"top_k": 2}, [Y5], [P5]),
    ("top_k_acc", {"top_k": 2}, [Y5], [P5]),
    ("mcc", {}, [YB], [PB]),
    ("pcc", {}, [Y5], [P5]),
    ("f1", {}, [YB], [PB]),
    ("perplexity", {"ignore_label": 1}, [Y5], [P5]),
]


def _make(pkg, name, kwargs):
    cls = getattr(pkg.metric, name, None)
    return cls(**kwargs) if isinstance(cls, type) else pkg.metric.create(name, **kwargs)


def _same(a, b):
    (na, va), (nb, vb) = a, b
    assert na == nb
    va, vb = np.atleast_1d(np.asarray(va, np.float64)), np.atleast_1d(np.asarray(vb, np.float64))
    assert va.shape == vb.shape
    both_nan = np.isnan(va) & np.isnan(vb)
    assert np.all(both_nan | (np.abs(va - vb) <= METRIC_TOL * np.maximum(1.0, np.abs(vb))))


@pytest.mark.parametrize("case", range(len(CASES)),
                         ids=[f"{c[0]}{i}" for i, c in enumerate(CASES)])
def test_metric_against_jax(case):
    name, kwargs, labels, preds = CASES[case]
    mj, mt, mt_tensor = (_make(mxj, name, kwargs), _make(mx, name, kwargs),
                         _make(mx, name, kwargs))
    _same(mt.get(), mj.get())  # nothing seen yet: nan
    for _ in range(2):  # two updates accumulate
        mj.update([mxj.nd.array(v) for v in labels], [mxj.nd.array(v) for v in preds])
        mt.update([mx.nd.array(v, ctx=mx.cpu()) for v in labels],
                  [mx.nd.array(v, ctx=mx.cpu()) for v in preds])
        mt_tensor.update([torch.from_numpy(v) for v in labels],
                         [torch.from_numpy(v) for v in preds])
    _same(mt.get(), mj.get())
    _same(mt_tensor.get(), mj.get())
    assert [n for n, _ in mt.get_name_value()] == [n for n, _ in mj.get_name_value()]
    mt.reset()
    mj.reset()
    _same(mt.get(), mj.get())


@pytest.mark.parametrize("name", ["f1", "mcc"])
def test_binary_metrics_reject_multiclass(name):
    m = mx.metric.create(name)
    with pytest.raises(ValueError):
        m.update([np.array([0, 1, 2])], [np.array([[0.2, 0.3, 0.5]] * 3)])


def test_composite_custom_and_np_alias():
    feval = lambda lab, pred: float(np.abs(lab - pred).sum())  # noqa: E731
    for metric_of in (lambda pkg: pkg.metric.create(["acc", "ce", pkg.metric.TopKAccuracy(3)]),
                      lambda pkg: pkg.metric.CustomMetric(feval, name="absdiff"),
                      lambda pkg: pkg.metric.np(feval),
                      lambda pkg: pkg.metric.create(feval),
                      lambda pkg: pkg.metric.CompositeEvalMetric(["mse", "mae"])):
        mj, mt = metric_of(mxj), metric_of(mx)
        lab, pred = Y5, P5
        if isinstance(mt, mx.metric.CompositeEvalMetric) and mt.metrics[0].name == "mse":
            lab, pred = REG_L, REG_P
        elif isinstance(mt, mx.metric.CustomMetric):
            lab, pred = Y5, P5.argmax(1).astype(np.float32)
        mj.update([mxj.nd.array(lab)], [mxj.nd.array(pred)])
        mt.update([lab], [pred])
        _same(mt.get(), mj.get())
        assert str(mt) == str(mj)
    assert isinstance(mx.metric.create("mcc"), mx.metric.MCC)
    assert mx.metric.create("pcc").name == "pcc"


def _log_lines(caplog, fn):
    caplog.clear()
    with caplog.at_level(logging.INFO):
        fn()
    return [re.sub(r"Speed: [0-9.]+", "Speed: <rate>", r.getMessage()) for r in caplog.records]


@pytest.mark.parametrize("auto_reset", [True, False])
def test_speedometer_and_metric_logging(caplog, auto_reset):
    def drive(pkg):
        metric = pkg.metric.create(["acc", "ce"])
        cbs = [pkg.callback.Speedometer(16, 2, auto_reset=auto_reset),
               pkg.callback.log_train_metric(3, auto_reset=False),
               pkg.callback.ProgressBar(8, length=10),
               pkg.callback.LogValidationMetricsCallback()]
        for epoch in range(2):
            for nbatch in range(8):
                metric.update([Y5], [np.roll(P5, nbatch, axis=0)])
                for cb in cbs:
                    cb(pkg.model.BatchEndParam(epoch, nbatch, metric, {}))

    want = _log_lines(caplog, lambda: drive(mxj))
    got = _log_lines(caplog, lambda: drive(mx))
    assert any("Speed: <rate>" in line for line in want)
    assert got == want


def test_do_checkpoint_crosses_packages(tmp_path):
    import incubator_mxnet_tpu.symbol as J
    import incubator_mxnet_torch.symbol as S

    arg = {"fc_weight": np.arange(6, dtype=np.float32).reshape(3, 2),
           "fc_bias": np.ones(3, np.float32)}
    aux = {"bn_moving_mean": np.full(3, 0.5, np.float32)}
    for writer, reader in ((mx, mxj), (mxj, mx)):
        sym = (S if writer is mx else J).FullyConnected((S if writer is mx else J).var("data"),
                                                        num_hidden=3, name="fc")
        prefix = str(tmp_path / f"ckpt_{writer.__name__}")
        cb = writer.callback.do_checkpoint(prefix, period=2)
        to_nd = ((lambda v: mx.nd.array(v, ctx=mx.cpu())) if writer is mx else mxj.nd.array)
        for epoch in range(4):
            cb(epoch, sym, {k: to_nd(v) for k, v in arg.items()},
               {k: to_nd(v) for k, v in aux.items()})
        assert not (tmp_path / f"ckpt_{writer.__name__}-0001.params").exists()
        loaded_sym, la, lx = reader.model.load_checkpoint(prefix, 4)
        assert loaded_sym.list_arguments() == ["data", "fc_weight", "fc_bias"]
        for k, v in arg.items():
            np.testing.assert_array_equal(la[k].asnumpy(), v)
        np.testing.assert_array_equal(lx["bn_moving_mean"].asnumpy(), aux["bn_moving_mean"])


def _dense_pair():
    """The same two-layer Gluon net in both packages (port weights from
    the JAX net's by structural key)."""
    mxj.random.seed(0)
    jnet = mxj.gluon.nn.HybridSequential()
    jnet.add(mxj.gluon.nn.Dense(8, activation="relu"), mxj.gluon.nn.Dense(4))
    jnet.initialize()
    jnet(mxj.nd.zeros((2, 6)))
    tnet = mx.gluon.nn.HybridSequential()
    tnet.add(mx.gluon.nn.Dense(8, activation="relu", in_units=6), mx.gluon.nn.Dense(4, in_units=8))
    load_numpy_params(tnet, {k: p.data().asnumpy()
                             for k, p in jnet._collect_params_with_prefix().items()},
                      ctx=mx.cpu())
    return jnet, tnet


def _stats(res):
    return [(s, re.sub(r"\d+", "#", n), float(v)) for s, n, v in res]


def test_monitor_block_outputs_on_interval():
    jnet, tnet = _dense_pair()
    x = np.linspace(-1, 1, 12, dtype=np.float32).reshape(2, 6)
    runs = []
    for pkg, net, xin in ((mxj, jnet, mxj.nd.array(x)), (mx, tnet, mx.nd.array(x, ctx=mx.cpu()))):
        mon = pkg.Monitor(interval=2, pattern=".*")
        mon.install(net)
        stats = []
        for _ in range(4):
            mon.tic()
            net(xin)
            stats.append(mon.toc())
        mon.uninstall()
        mon.tic()
        net(xin)
        assert mon.toc() == []  # hooks removed
        runs.append(stats)
    jstats, tstats = runs
    assert tstats[1] == [] and tstats[3] == [] and len(tstats[0]) == 3
    for j, t in zip(jstats, tstats):
        assert [n for _, n, _ in _stats(t)] == [n for _, n, _ in _stats(j)]
        np.testing.assert_allclose([v for *_, v in _stats(t)], [v for *_, v in _stats(j)],
                                   rtol=1e-6)


def test_monitor_all_params_and_grads_sorted():
    jnet, tnet = _dense_pair()
    x = np.linspace(-1, 1, 12, dtype=np.float32).reshape(2, 6)
    res = []
    for pkg, net, xin in ((mxj, jnet, mxj.nd.array(x)), (mx, tnet, mx.nd.array(x, ctx=mx.cpu()))):
        mon = pkg.Monitor(interval=1, monitor_all=True, sort=True, pattern=".*dense.*")
        mon.install(net)
        mon.tic()
        with pkg.autograd.record():
            out = net(xin)
            out.sum().backward()
        res.append(mon.toc())
    jres, tres = res
    names = [n for _, n, _ in _stats(tres)]
    assert any(n.endswith("weight_grad") for n in names)
    assert names == [n for _, n, _ in _stats(jres)]
    np.testing.assert_allclose([v for *_, v in _stats(tres)], [v for *_, v in _stats(jres)],
                               rtol=1e-6)
