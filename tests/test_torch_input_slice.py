"""The input pipeline slice as a whole, on the CPU: a narrow ResNet trained
from a 64-record ``.rec`` through ``ImageRecordIter`` -> ``DataPipeline``
-> ``SPMDTrainer`` in the port, against the JAX package's same pipeline and
``SPMDTrainer`` on its 8-device CPU mesh, from the same parameters carried
across by ``convert.py``.

Every delivered batch is equal in both packages (the native pools at one
thread draw the same augmentations); the training is held as
``tests/test_torch_parallel.py`` holds the ResNet: the losses of two steps
and the parameters (running statistics included) after them to
``tests/test_torch_resnet.py``'s PARAM_TOL.
"""
import numpy as np
import pytest

import incubator_mxnet_tpu as mxj
from incubator_mxnet_tpu import parallel as jpar
from incubator_mxnet_tpu import profiler as jprofiler
from incubator_mxnet_tpu.gluon.model_zoo.vision import resnet as jvision
import incubator_mxnet_torch as mx
from incubator_mxnet_torch import parallel as tpar
from incubator_mxnet_torch import profiler as tprofiler
from incubator_mxnet_torch.convert import load_numpy_params
from incubator_mxnet_torch.gluon.model_zoo import vision as tvision

# One SGD step of a chaotic net from the same parameters, the second from
# parameters already 1e-6 apart: test_torch_resnet.py's PARAM_TOL; the
# losses to its LOSS_TOL.
PARAM_TOL = dict(rtol=1e-4, atol=1e-5)
LOSS_TOL = dict(rtol=1e-5, atol=1e-5)
SMALL_RESNET = dict(layers=[1, 1, 1, 1], channels=[8, 16, 32, 64, 128], classes=10)
RECORDS, BATCH, STEPS = 64, 8, 2
READER = dict(data_shape=(3, 32, 32), batch_size=BATCH, shuffle=True, rand_crop=True,
              rand_mirror=True, seed=5, preprocess_threads=1, mean_r=123.68, mean_g=116.28,
              mean_b=103.53, std_r=58.395, std_g=57.12, std_b=57.375)
SGD = ("sgd", {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4})


@pytest.fixture(scope="module")
def rec(tmp_path_factory):
    path = tmp_path_factory.mktemp("slice") / "train.rec"
    rng = np.random.RandomState(0)
    w = mx.recordio.MXRecordIO(str(path), "w")
    for i in range(RECORDS):
        img = rng.randint(0, 256, (rng.randint(36, 48), rng.randint(36, 48), 3)).astype(np.uint8)
        w.write(mx.recordio.pack_img(mx.recordio.IRHeader(0, float(rng.randint(0, 10)), i, 0),
                                     img, quality=95))
    w.close()
    return str(path)


def _ce(pkg):
    ce = pkg.gluon.loss.SoftmaxCrossEntropyLoss()
    return lambda out, label: ce(out, label)


def _params(net, jax):
    return {k: (p.data().asnumpy() if jax else p.data().detach().numpy()).copy()
            for k, p in net._collect_params_with_prefix().items()}


@pytest.fixture(scope="module")
def jax_run(rec):
    jprofiler.disarm_compile_guard()
    mxj.random.seed(0)
    net = jvision.ResNetV1(jvision.BottleneckV1, thumbnail=True, prefix="res_", **SMALL_RESNET)
    net.initialize()
    net(mxj.nd.zeros((1, 3, 32, 32)))
    start = _params(net, jax=True)
    mesh = jpar.make_mesh()
    tr = jpar.SPMDTrainer(net, _ce(mxj), SGD[0], dict(SGD[1]), mesh=mesh)
    pipe = mxj.io.DataPipeline(mxj.io.ImageRecordIter(rec, **READER), mesh=mesh)
    batches, losses = [], []
    try:
        for b in pipe:
            batches.append((b.data[0].asnumpy(), b.label[0].asnumpy()))
            if len(losses) < STEPS:
                losses.append(float(tr.step(b.data[0], b.label[0]).asnumpy()))
    finally:
        pipe.close()
    tr.sync_to_block()
    jprofiler.disarm_compile_guard()
    return dict(start=start, batches=batches, losses=losses, after=_params(net, jax=True))


@pytest.fixture(scope="module")
def port_run(rec, jax_run):
    tprofiler.disarm_compile_guard()
    net = tvision.ResNetV1(tvision.BottleneckV1, thumbnail=True, prefix="res_", **SMALL_RESNET)
    net.initialize(ctx=mx.cpu())
    load_numpy_params(net, jax_run["start"])
    mesh = tpar.make_mesh(devices=["cpu"])
    tr = tpar.SPMDTrainer(net, _ce(mx), SGD[0], dict(SGD[1]), mesh=mesh)
    it = mx.io.ImageRecordIter(rec, **READER)
    pipe = mx.io.DataPipeline(it, mesh=mesh)
    batches, losses, passthrough = [], [], []
    try:
        for b in pipe:
            batches.append((b.data[0].asnumpy(), b.label[0].asnumpy()))
            if len(losses) < STEPS:
                staged = tr.shard_batch(b.data[0], b.label[0])
                passthrough.append(staged[0] is b.data[0]._data)
                losses.append(float(tr.step(b.data[0], b.label[0]).asnumpy()))
    finally:
        pipe.close()
    tprofiler.disarm_compile_guard()
    return dict(batches=batches, losses=losses, after=_params(net, jax=False),
                native=it.native, passthrough=passthrough)


def test_the_pipelines_deliver_the_same_batches(jax_run, port_run):
    assert port_run["native"]
    assert len(port_run["batches"]) == len(jax_run["batches"]) == RECORDS // BATCH
    for (td, tl), (jd, jl) in zip(port_run["batches"], jax_run["batches"]):
        assert td.dtype == jd.dtype == np.float32 and td.shape == (BATCH, 3, 32, 32)
        np.testing.assert_array_equal(td, jd)
        np.testing.assert_array_equal(tl, jl)


def test_spmd_trainer_fed_by_the_pipeline_matches_jax(jax_run, port_run):
    np.testing.assert_allclose(port_run["losses"], jax_run["losses"], **LOSS_TOL)
    got, want = port_run["after"], jax_run["after"]
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **PARAM_TOL)
    moved = [k for k in want if "running" in k and not np.allclose(want[k], jax_run["start"][k])]
    assert moved  # the running statistics moved inside the steps
    assert all(port_run["passthrough"])  # the pipeline's tensors pass straight through

