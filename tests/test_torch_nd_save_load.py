"""``mx.nd.save``/``load`` and the Gluon save and load, across the two packages.

A file written by either package loads in the other to the same names and
values, in both containers (``.params``, the reference's binary layout, and
``.npz``), for lists and dicts of fp32, fp16, int32 and bf16 arrays, with
one exception: the JAX package cannot read the bf16 records of an ``.npz``
(its own ones included), which the port writes byte for byte as the JAX
package does.  ``ParameterDict.save(strip_prefix)``/``load(restore_prefix)``
round-trip, and a 2-layer, 64-unit BERT and a small ResNet (running
statistics included) saved by one package and ``load_parameters``'d by the
other give the first one's outputs, within the tolerances of
``tests/test_torch_bert.py`` (fp32 1e-4) and ``tests/test_torch_resnet.py``
(1e-5).
"""
import io
import zipfile

import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as mxj
from incubator_mxnet_tpu.gluon.model_zoo import bert as jbert
from incubator_mxnet_tpu.gluon.model_zoo.vision import resnet as jresnet
import incubator_mxnet_torch as mx
from incubator_mxnet_torch.gluon.model_zoo import bert as tbert
from incubator_mxnet_torch.gluon.model_zoo import vision as tvision

R = np.random.RandomState(0)
ARRAYS = {
    "float32": R.randn(3, 4).astype(np.float32),
    "float16": R.randn(2, 5).astype(np.float16),
    "int32": R.randint(-9, 9, (4,)).astype(np.int32),
    "bfloat16": R.randn(3, 2).astype(np.float32),
}
BERT_TOL = 1e-4    # tests/test_torch_bert.py's FP32_TOL
RESNET_TOL = 1e-5  # tests/test_torch_resnet.py's OP_TOL and LOSS_TOL


def _jax_arrays(names):
    return {k: mxj.nd.array(ARRAYS[k]).astype(k) for k in names}


def _port_arrays(names):
    with mx.cpu():
        return {k: mx.nd.array(ARRAYS[k]).astype(k) for k in names}


def _host(x):
    a = x.asnumpy()
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def _want(name, container):
    """What a loaded array's dtype must be: bf16 crosses a ``.params`` file
    as float32 (the format has no bf16 flag)."""
    return "float32" if name == "bfloat16" and container == "params" else name


def _dtype(x):
    return x.dtype.name


NAMES = list(ARRAYS)


@pytest.mark.parametrize("container", ["params", "npz"])
@pytest.mark.parametrize("mode", ["dict", "list"])
def test_jax_files_load_in_the_port(tmp_path, container, mode):
    f = str(tmp_path / f"x.{container}")
    arrays = _jax_arrays(NAMES)
    mxj.nd.save(f, arrays if mode == "dict" else list(arrays.values()))
    got = mx.nd.load(f, ctx=mx.cpu())
    if mode == "list":
        assert isinstance(got, list) and len(got) == len(NAMES)
        got = dict(zip(NAMES, got))
    assert list(got) == NAMES
    for k in NAMES:
        assert isinstance(got[k], mx.nd.NDArray) and got[k].context == mx.cpu()
        assert _dtype(got[k]) == _want(k, container), k
        np.testing.assert_array_equal(_host(got[k]), _host(arrays[k]))


@pytest.mark.parametrize("container", ["params", "npz"])
@pytest.mark.parametrize("mode", ["dict", "list"])
def test_port_files_load_in_jax(tmp_path, container, mode):
    names = NAMES if container == "params" else [n for n in NAMES if n != "bfloat16"]
    f = str(tmp_path / f"x.{container}")
    arrays = _port_arrays(names)
    mx.nd.save(f, arrays if mode == "dict" else list(arrays.values()))
    got = mxj.nd.load(f)
    if mode == "list":
        got = dict(zip(names, got))
    assert list(got) == names
    for k in names:
        assert _dtype(got[k]) == _want(k, container), k
        np.testing.assert_array_equal(_host(got[k]), _host(arrays[k]))


def test_bf16_npz_is_byte_identical_and_the_jax_package_cannot_read_it(tmp_path, monkeypatch):
    import time

    monkeypatch.setattr(time, "time", lambda: 1.7e9)  # the zip members' timestamps
    fj, ft = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    mxj.nd.save(fj, _jax_arrays(NAMES))
    mx.nd.save(ft, _port_arrays(NAMES))
    jb, tb = open(fj, "rb").read(), open(ft, "rb").read()
    assert jb == tb
    with zipfile.ZipFile(io.BytesIO(tb)) as z:
        assert b"'descr': '<V2'" in z.read("bfloat16.npy")[:80]
    with pytest.raises(TypeError, match="V2"):
        mxj.nd.load(ft)
    got = mx.nd.load(fj, ctx=mx.cpu())["bfloat16"]
    assert got.dtype == "bfloat16"
    np.testing.assert_array_equal(_host(got), _host(_port_arrays(["bfloat16"])["bfloat16"]))


@pytest.mark.parametrize("names", [["float32", "int32"], NAMES], ids=["fp32_int32", "all"])
def test_params_files_are_byte_identical(tmp_path, names):
    fj, ft = str(tmp_path / "j.params"), str(tmp_path / "t.params")
    mxj.nd.save(fj, _jax_arrays(names))
    mx.nd.save(ft, _port_arrays(names))
    assert open(fj, "rb").read() == open(ft, "rb").read()


def test_save_takes_tensors_and_a_single_array(tmp_path):
    f = str(tmp_path / "x.npz")
    mx.nd.save(f, torch.arange(4, dtype=torch.int32))
    (got,) = mx.nd.load(f, ctx=mx.cpu())
    assert got.dtype == np.int32 and got.asnumpy().tolist() == [0, 1, 2, 3]


def test_parameter_dict_save_strip_and_load_restore(tmp_path):
    def dense(prefix):
        mx.random.seed(3)
        net = mx.gluon.nn.Dense(3, in_units=2, prefix=prefix)
        net.initialize(ctx=mx.cpu())
        return net

    src = dense("src_")
    f = str(tmp_path / "p.params")
    src.collect_params().save(f, strip_prefix="src_")
    assert sorted(mx.nd.load(f, ctx=mx.cpu())) == ["bias", "weight"]
    dst = mx.gluon.nn.Dense(3, in_units=2, prefix="dst_")
    dst.collect_params().load(f, ctx=mx.cpu(), restore_prefix="dst_")
    for a, b in zip(src.collect_params().values(), dst.collect_params().values()):
        assert torch.equal(a.data(), b.data())
    with pytest.raises(IOError, match="missing"):
        mx.gluon.nn.Dense(3, in_units=2, prefix="other_").collect_params().load(f, mx.cpu())
    jd = mxj.gluon.nn.Dense(3, in_units=2, prefix="jd_")
    jd.initialize()
    jd.collect_params().load(f, restore_prefix="jd_")
    np.testing.assert_array_equal(jd.weight.data().asnumpy(),
                                  src.weight.data().detach().numpy())


BERT = dict(vocab_size=128, units=64, hidden_size=128, num_layers=2, num_heads=2,
            max_length=64, dropout=0.0)
IDS = np.random.RandomState(1).randint(0, 128, (2, 12)).astype(np.int32)
TYPES = np.random.RandomState(2).randint(0, 2, (2, 12)).astype(np.int32)
POS = np.random.RandomState(3).randint(0, 12, (2, 4)).astype(np.int32)


def _jax_bert():
    mxj.random.seed(5)
    net = jbert.BERTForPretrain(jbert.BERTModel(**BERT), vocab_size=128)
    net.initialize()
    net(mxj.nd.zeros((1, 4), dtype="int32"))
    return net


def _jax_bert_out(net):
    a = lambda x: mxj.nd.array(x, dtype="int32")  # noqa: E731
    return [o.asnumpy() for o in net(a(IDS), a(TYPES), a(POS))]


def _port_bert_out(net):
    with mx.cpu():
        a = lambda x: mx.nd.array(x, dtype="int32")  # noqa: E731
        return [o.asnumpy() for o in net(a(IDS), a(TYPES), a(POS))]


@pytest.mark.parametrize("container", ["params", "npz"])
def test_bert_saved_by_jax_loads_in_the_port(tmp_path, container):
    jnet = _jax_bert()
    f = str(tmp_path / f"bert.{container}")
    jnet.save_parameters(f)
    tnet = tbert.BERTForPretrain(tbert.BERTModel(**BERT), vocab_size=128)
    tnet.load_parameters(f, ctx=mx.cpu())
    for g, w in zip(_port_bert_out(tnet), _jax_bert_out(jnet)):
        np.testing.assert_allclose(g, w, rtol=BERT_TOL, atol=BERT_TOL)


@pytest.mark.parametrize("container", ["params", "npz"])
def test_bert_saved_by_the_port_loads_in_jax(tmp_path, container):
    mx.random.seed(6)
    tnet = tbert.BERTForPretrain(tbert.BERTModel(**BERT), vocab_size=128)
    tnet.initialize(ctx=mx.cpu())
    want = _port_bert_out(tnet)  # materializes the deferred shapes
    f = str(tmp_path / f"bert.{container}")
    tnet.save_parameters(f)
    jnet = _jax_bert()
    jnet.load_parameters(f)
    for g, w in zip(want, _jax_bert_out(jnet)):
        np.testing.assert_allclose(g, w, rtol=BERT_TOL, atol=BERT_TOL)


RESNET = dict(layers=[1, 1, 1, 1], channels=[8, 16, 32, 64, 128], classes=10, thumbnail=True)
IMG = np.random.RandomState(4).rand(2, 3, 32, 32).astype(np.float32)


def _jax_resnet(train_forward):
    mxj.random.seed(7)
    net = jresnet.ResNetV1(jresnet.BottleneckV1, **RESNET)
    net.initialize()
    net(mxj.nd.zeros((1, 3, 32, 32)))
    net.hybridize()
    if train_forward:  # move the running statistics away from 0 and 1
        with mxj.autograd.record():
            net(mxj.nd.array(IMG))
    return net


def _running(params):
    return {k: v for k, v in params.items() if k.endswith(("running_mean", "running_var"))}


@pytest.mark.parametrize("container", ["params", "npz"])
def test_resnet_saved_by_jax_loads_in_the_port(tmp_path, container):
    jnet = _jax_resnet(train_forward=True)
    f = str(tmp_path / f"resnet.{container}")
    jnet.save_parameters(f)
    tnet = tvision.ResNetV1(tvision.BottleneckV1, **RESNET)
    tnet.load_parameters(f, ctx=mx.cpu())
    running = _running(tnet._collect_params_with_prefix())
    assert running and all(p.data().abs().sum() > 0 for p in running.values())
    jrun = _running(jnet._collect_params_with_prefix())
    for k, p in running.items():
        np.testing.assert_array_equal(p.data().numpy(), jrun[k].data().asnumpy())
    with mx.cpu():
        got = tnet(mx.nd.array(IMG)).asnumpy()
    np.testing.assert_allclose(got, jnet(mxj.nd.array(IMG)).asnumpy(), rtol=RESNET_TOL,
                               atol=RESNET_TOL)


@pytest.mark.parametrize("container", ["params", "npz"])
def test_resnet_saved_by_the_port_loads_in_jax(tmp_path, container):
    mx.random.seed(8)
    tnet = tvision.ResNetV1(tvision.BottleneckV1, **RESNET)
    tnet.initialize(ctx=mx.cpu())
    with mx.cpu(), mx.autograd.record():
        tnet(mx.nd.array(IMG))  # moves the running statistics
    f = str(tmp_path / f"resnet.{container}")
    tnet.save_parameters(f)
    jnet = _jax_resnet(train_forward=False)
    jnet.load_parameters(f)
    with mx.cpu():
        want = tnet(mx.nd.array(IMG)).asnumpy()
    np.testing.assert_allclose(jnet(mxj.nd.array(IMG)).asnumpy(), want, rtol=RESNET_TOL,
                               atol=RESNET_TOL)


def test_load_parameters_checks_keys_and_takes_the_saved_dtype(tmp_path):
    net = mx.gluon.nn.Dense(3, in_units=2)
    net.initialize(ctx=mx.cpu())
    f = str(tmp_path / "d.npz")
    with mx.cpu():
        mx.nd.save(f, {"weight": mx.nd.ones((3, 2), dtype="float16"), "bias": mx.nd.zeros(3),
                       "extra": mx.nd.zeros(1)})
    with pytest.raises(IOError, match="extra"):
        net.load_parameters(f)
    net.load_parameters(f, ignore_extra=True)
    assert net.weight.data().dtype == torch.float32 and net.weight.data().sum().item() == 6
    net.load_params(f, ignore_extra=True, cast_dtype=True, dtype_source="saved")
    assert net.weight.data().dtype == torch.float16
    mx.nd.save(f, {"weight": torch.ones(3, 2)})
    with pytest.raises(IOError, match="bias"):
        net.load_parameters(f)
    net.load_parameters(f, allow_missing=True)
    g = str(tmp_path / "g.params")
    net.save_params(g)
    assert sorted(mx.nd.load(g, ctx=mx.cpu())) == ["bias", "weight"]
    mx.nd.save(g, [torch.ones(3, 2)])
    with pytest.raises(IOError, match="without names"):
        net.load_parameters(g)
    with pytest.raises(IOError, match="without names"):
        net.collect_params().load(g)
