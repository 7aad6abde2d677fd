"""INT8 quantization in the port against the JAX package, on the CPU.

* The six ops of ``ops/quantization.py`` (``nd_op_cases`` cases): int8 and
  int32 outputs and ranges exactly equal, float outputs within one ulp
  class of ``nd_parity``, the bias gradients of the compute ops.
* ``optimal_threshold`` / ``optimal_threshold_from_hist`` on fixed
  histograms: equal to the JAX value (the port spreads each candidate's
  reconstruction over its chunks at once, the same arithmetic).
* ``contrib.quantization.quantize_net`` on a small ResNet-18 v1 (thumbnail,
  32x32, 10 classes) with the same numpy-seeded weights in both packages,
  two calibration batches, ``naive`` (all 21 layers) and ``entropy`` (the
  stem, the first block and the output Dense: the JAX package's KL sweep
  costs seconds a layer), the rest excluded by name: the layers are paired
  by their order in the network (structure, not names); each layer's int8
  weight and its range are equal, each calibrated input range equal within
  1e-5 relative (fp32 activations of another summation order), and the
  quantized networks' logits within 2e-2 of the largest |logit|: an input
  whose quantization rounds the other way at one layer moves the next
  layers by a step of its scale.
"""
import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as mxj
from incubator_mxnet_tpu.contrib import quantization as jq
from incubator_mxnet_tpu.gluon.model_zoo import vision as jvision
import incubator_mxnet_torch as mx
from incubator_mxnet_torch.contrib import quantization as tq
from incubator_mxnet_torch.gluon.model_zoo import vision as tvision
from incubator_mxnet_torch.ops import quantization as tqops

import nd_parity as P
from test_torch_vision_zoo import twin_nets

CASES = P.cases("quantization")
GRAD_CASES = [c for c in CASES if P.has_grad(c)]
LOGIT_REL = 2e-2
RANGE_REL = 1e-5


def test_registry_has_every_name_of_the_jax_file():
    P.check_registry("quantization")


@pytest.mark.parametrize("case", CASES, ids=P.ids(CASES))
def test_values(case):
    P.check_values(case)


@pytest.mark.parametrize("case", GRAD_CASES, ids=P.ids(GRAD_CASES))
def test_gradients(case):
    P.check_grads(case)


def test_int8_sums_are_exact():
    """The plain int32 sums equal an int64 product at the largest K of a
    ResNet-50 layer (3x3x512 = 4608) with every product at 127²."""
    a = torch.full((3, 4608), 127, dtype=torch.int8)
    w = torch.full((2, 4608), -127, dtype=torch.int8)
    got = tqops.int_matmul(a, w)
    assert got.dtype == torch.int32
    assert (got.long() == -127 * 127 * 4608).all()


@pytest.mark.parametrize("kind", ["gauss", "outliers", "skewed", "relu", "integers", "spike"])
def test_optimal_threshold_equals_the_jax_value(kind):
    """Equal thresholds on fixed histograms: a Gaussian, outliers, a heavy
    one-sided tail, a ReLU's output (half the values 0), integers (most
    bins empty) and a spike at 0 with a few large values (chunks whose
    only non-zero bin is a folded edge)."""
    rng = np.random.RandomState(7)
    x = rng.randn(50000).astype(np.float32)
    if kind == "outliers":
        x[:10] = 300.0
    elif kind == "skewed":
        x = np.abs(x) ** 3
    elif kind == "relu":
        x = np.maximum(x, 0) * 2.5
    elif kind == "integers":
        x = np.round(x * 3)
    elif kind == "spike":
        x = np.zeros(50000, np.float32)
        x[:7] = rng.randn(7) * 100
    assert tq.optimal_threshold(x) == jq.optimal_threshold(x)
    hist, edges = np.histogram(x, bins=2001, range=(-np.abs(x).max(), np.abs(x).max()))
    assert tq.optimal_threshold_from_hist(hist, edges) == jq.optimal_threshold_from_hist(
        hist, edges)


def _recording(module, monkeypatch):
    """Record each layer's (block, int8 weight, weight range, input range)
    as ``quantize_net`` attaches its int8 forward."""
    seen = []
    attach = module._attach_int8_forward

    def record(blk, wq, wmin, wmax, lo, hi):
        seen.append((blk, wq, wmin, wmax, lo, hi))
        return attach(blk, wq, wmin, wmax, lo, hi)

    monkeypatch.setattr(module, "_attach_int8_forward", record)
    return seen


def _excluded(module, net, keep):
    """The names of the quantizable layers of ``net`` (in network order)
    whose positions are not in ``keep``."""
    layers = [b for _, b in module._iter_blocks(net) if module._quantizable(b)]
    assert len(layers) == 21
    return [b.name for i, b in enumerate(layers) if i not in keep]


def _np(x):
    return x.asnumpy() if hasattr(x, "asnumpy") else x.detach().numpy()


@pytest.mark.parametrize("mode", ["naive", "entropy"])
def test_quantize_net_matches_the_jax_package(mode, monkeypatch):
    rng = np.random.RandomState(11)
    batches = [rng.uniform(-1, 1, (2, 3, 32, 32)).astype(np.float32) for _ in range(3)]
    jnet, net = twin_nets(lambda: tvision.resnet18_v1(classes=10, thumbnail=True),
                          lambda: jvision.resnet18_v1(classes=10, thumbnail=True),
                          batches[0], seed=3, grads=False)
    jseen, tseen = _recording(jq, monkeypatch), _recording(tq, monkeypatch)
    # the JAX package's KL sweep costs seconds a layer: entropy quantizes the
    # stem, the first block and the output Dense, the rest stay fp32
    keep = range(21) if mode == "naive" else (0, 1, 2, 20)
    jx, tx = _excluded(jq, jnet, keep), _excluded(tq, net, keep)
    with mxj.autograd.predict_mode():
        jq.quantize_net(jnet, [mxj.nd.array(b) for b in batches[:2]], calib_mode=mode,
                        excluded_layers=jx)
    with mx.autograd.predict_mode():
        tq.quantize_net(net, [torch.from_numpy(b) for b in batches[:2]], calib_mode=mode,
                        excluded_layers=tx)
    assert len(tseen) == len(jseen) == len(keep)  # of 20 convolutions and the output Dense
    for (jb, jw, jmin, jmax, jlo, jhi), (tb, tw, tmin, tmax, tlo, thi) in zip(jseen, tseen):
        assert type(jb).__name__ == type(tb).__name__ and jb.weight.shape == tb.weight.shape
        np.testing.assert_array_equal(_np(tw), _np(jw))
        assert (_np(tmin), _np(tmax)) == (_np(jmin), _np(jmax))
        np.testing.assert_allclose([tlo, thi], [jlo, jhi], rtol=RANGE_REL)
    with mxj.autograd.predict_mode():
        want = jnet(mxj.nd.array(batches[2])).asnumpy()
    with mx.autograd.predict_mode():
        got = net(torch.from_numpy(batches[2])).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=LOGIT_REL * np.abs(want).max())


def test_calibration_hooks_are_removed():
    mx.random.seed(2)
    net = mx.gluon.nn.HybridSequential()
    net.add(mx.gluon.nn.Dense(8, activation="relu", in_units=4), mx.gluon.nn.Dense(3, in_units=8))
    net.initialize(ctx=mx.cpu())
    x = torch.randn(5, 4)
    tq.quantize_net(net, [x], calib_mode="naive")
    assert all(not b._mx_pre_hooks for b in (net, net[0], net[1]))
    assert net[0]._quantized and net[1]._quantized
    with pytest.raises(ValueError, match="calib_mode"):
        tq.quantize_net(net, [x], calib_mode="kl")
