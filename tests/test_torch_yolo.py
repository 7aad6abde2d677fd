"""YOLOv3 in the PyTorch port against the JAX package, on the CPU.

The tiny YOLOv3 of tests/test_yolo.py (a darknet of one block a stage at
widths 8-128, three scales, 3 classes) at 128x128: the forward (raw
predictions and the decode tables), ``yolo3_decode``, ``yolo3_targets``
(with a crowded prior, a padded row, and bench.py's call of ``nd.box_iou``
on ``[B·M, 4] x [N, 4]``), ``yolo3_loss`` and one SGD-momentum step as
bench.py's ``bench_yolo3`` takes it (momentum 0.9, wd 5e-4), with the
same numpy-seeded parameters in both packages (``twin_nets`` of
tests/test_torch_vision_zoo.py: the JAX values carried across by
structural key, BatchNorm's running statistics included).  The losses run
on ``mx.nd`` on both sides (NDArrays), and the port's also on tensors, as
``SPMDTrainer`` hands them.

Tolerances: the decode tables exactly; targets and masks exactly where
they are indices or 0/1 and 1e-6 relative where they are encodings; the
forward, decode and loss within 1e-4 of the tensor's largest |value|
(fp32 through 40 convolutions in another order, train-mode BatchNorm);
parameters after the step 1e-4 relative / 1e-5 absolute, as
tests/test_torch_resnet.py holds its steps.  At 64x64 the stride-32 maps
are 2x2, and train-mode BatchNorm over 8 values a channel is so badly
conditioned that the JAX package's compiled gradients there stray by up
to 8 % from a float64 evaluation (the port's stay within 4e-5 of it);
at 128x128 the two agree to 1e-4.
"""
import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as mxj
from incubator_mxnet_tpu.gluon.model_zoo import yolo as jyolo
import incubator_mxnet_torch as mx
from incubator_mxnet_torch.convert import load_numpy_params
from incubator_mxnet_torch.gluon import nn
from incubator_mxnet_torch.gluon.model_zoo import yolo as tyolo
from test_torch_vision_zoo import assert_close_to_scale, params_of, twin_nets

C, B, SIZE = 3, 2, 128
OP_TOL = dict(rtol=1e-6, atol=1e-6)
NET_REL = 1e-4
PARAM_TOL = dict(rtol=1e-4, atol=1e-5)
SGD = {"learning_rate": 1e-3, "momentum": 0.9, "wd": 5e-4}


def _tiny(mod):
    return mod.YOLOV3(mod.DarknetV3(layers=(1, 1, 1, 1, 1), channels=(8, 16, 32, 64, 128)),
                      num_classes=C, channels=(16, 32, 64))


def _batch():
    rng = np.random.RandomState(0)
    img = rng.rand(B, 3, SIZE, SIZE).astype(np.float32)
    lab = np.full((B, 4, 5), -1, np.float32)
    lab[:, 0] = [1, 8, 8, 30, 30]
    lab[:, 1] = [2, 20, 12, 50, 40]
    lab[1, 2] = [0, 21, 13, 49, 41]   # crowds gt 1's prior
    return img, lab


def _np(x):
    return x.asnumpy() if hasattr(x, "asnumpy") else x.detach().numpy()


def _split(mod_nd, label):
    return (mod_nd.slice_axis(label, axis=-1, begin=1, end=5),
            mod_nd.slice_axis(label, axis=-1, begin=0, end=1))


class _JaxLoss(mxj.gluon.HybridBlock):
    """bench.py's ``yolo_loss`` over the JAX net, hybridized as one program
    (its eager ops would compile one at a time): the per-sample loss, the
    forward and the targets."""

    def __init__(self, net):
        super().__init__()
        with self.name_scope():
            self.net = net

    def hybrid_forward(self, F, x, label):
        out = self.net(x)
        gt_boxes, gt_ids = _split(F, label)
        targets = jyolo.yolo3_targets(gt_boxes, gt_ids, *out[1:], C)
        return (jyolo.yolo3_loss(out[0], *targets, C, reduction="none"),) + tuple(out) \
            + tuple(targets)


class _JaxTargets(mxj.gluon.HybridBlock):
    """``yolo3_targets`` at ignore_thresh 0.3 as one hybridized program."""

    def __init__(self):
        super().__init__()
        self.hybridize()

    def hybrid_forward(self, F, *args):
        return tuple(jyolo.yolo3_targets(*args, C, ignore_thresh=0.3))


@pytest.fixture(scope="module")
def jax_yolo():
    """The tiny YOLOv3 in both packages with the same seeded parameters;
    the JAX side's forward and targets (train mode), decode, and the loss
    and parameters after one Trainer step on bench.py's loss."""
    img, lab = _batch()
    jnet, _ = twin_nets(lambda: _tiny(tyolo), lambda: _tiny(jyolo), img)
    start = params_of(jnet)
    step = _JaxLoss(jnet)
    step.hybridize()
    trainer = mxj.gluon.Trainer(jnet.collect_params(), "sgd", dict(SGD))
    with mxj.autograd.record():
        res = step(mxj.nd.array(img), mxj.nd.array(lab))
    res[0].backward()
    trainer.step(B)
    out, targets = res[1:5], res[5:]
    decoded = jyolo.yolo3_decode(*out, C)
    return (start, [o.asnumpy() for o in out], [d.asnumpy() for d in decoded],
            [t.asnumpy() for t in targets], res[0].asnumpy(), params_of(jnet))


def _port(start):
    net = _tiny(tyolo)
    net.initialize(ctx=mx.cpu())
    load_numpy_params(net, start)
    return net


def _assert_targets(got, want):
    (gobj, gbox, gcls, gmask), (wobj, wbox, wcls, wmask) = got, want
    np.testing.assert_array_equal(gobj, wobj)
    np.testing.assert_array_equal(gcls, wcls)
    np.testing.assert_array_equal(gmask, wmask)
    np.testing.assert_allclose(gbox, wbox, **OP_TOL)


def test_forward_decode_targets_loss_and_sgd_step_match_jax(jax_yolo):
    start, jout, jdec, jtargets, jloss, jparams = jax_yolo
    net = _port(start)
    img, lab = _batch()
    x, y = mx.nd.array(img, ctx=mx.cpu()), mx.nd.array(lab, ctx=mx.cpu())
    trainer = mx.gluon.Trainer(net.collect_params(), "sgd", dict(SGD))
    with mx.autograd.record():
        out = net(x)
        gt_boxes, gt_ids = _split(mx.nd, y)
        targets = tyolo.yolo3_targets(gt_boxes, gt_ids, *out[1:], C)
        loss = tyolo.yolo3_loss(out[0], *targets, C, reduction="none")
    loss.backward()
    trainer.step(B)
    assert isinstance(loss, mx.nd.NDArray)
    assert_close_to_scale(_np(out[0]), jout[0], NET_REL)
    for got, want in zip(out[1:], jout[1:]):
        np.testing.assert_array_equal(_np(got), want)
    _assert_targets([_np(t) for t in targets], jtargets)
    assert_close_to_scale(_np(loss), jloss, NET_REL)
    decoded = tyolo.yolo3_decode(*out, C)
    np.testing.assert_array_equal(_np(decoded[0]), jdec[0])
    for got, want in zip(decoded[1:], jdec[1:]):
        assert_close_to_scale(_np(got), want, NET_REL)
    got = params_of(net)
    assert got.keys() == jparams.keys()
    assert any(k.endswith("running_var") for k in got)
    for key, want in jparams.items():
        np.testing.assert_allclose(got[key], want, err_msg=key, **PARAM_TOL)


def test_loss_on_tensors_as_spmd_trainer_hands_them(jax_yolo):
    """bench.py's ``yolo_loss(out, label)`` on tensors (what SPMDTrainer's
    step passes): tensors come back, equal to the NDArray run."""
    start, jout, _, jtargets, _, _ = jax_yolo
    net = _port(start)
    img, lab = _batch()
    with mx.autograd.train_mode():
        out = net(torch.from_numpy(img))
    assert all(isinstance(o, torch.Tensor) for o in out)
    gt_boxes, gt_ids = _split(mx.nd, torch.from_numpy(lab))
    targets = tyolo.yolo3_targets(gt_boxes, gt_ids, *out[1:], C)
    assert all(isinstance(t, torch.Tensor) for t in targets)
    _assert_targets([_np(t) for t in targets], jtargets)
    per_sample = tyolo.yolo3_loss(out[0], *targets, C, reduction="none")
    mean = tyolo.yolo3_loss(out[0], *targets, C)
    assert per_sample.shape == (B,) and mean.shape == ()
    torch.testing.assert_close(mean, per_sample.mean())


def test_targets_crowded_prior_and_padding_match_jax():
    """A 4x4 grid of one anchor: two gts on one prior (the higher IoU wins
    it outright), a padded row, and a gt in the ignore band."""
    offsets = np.array([[[i % 4, i // 4] for i in range(16)]], np.float32)
    anchors = np.full((1, 16, 2), 16, np.float32)
    strides = np.full((1, 16, 1), 16, np.float32)
    gt_boxes = np.array([[[16, 32, 40, 52], [18, 34, 38, 50], [-1, -1, -1, -1]],
                         [[0, 0, 20, 20], [-1, -1, -1, -1], [-1, -1, -1, -1]]], np.float32)
    gt_ids = np.array([[[1], [2], [-1]], [[0], [-1], [-1]]], np.float32)
    args = (gt_boxes, gt_ids, offsets, anchors, strides)
    mxj.random.seed(0)  # the JAX key exists before the trace
    want = _JaxTargets()(*(mxj.nd.array(a) for a in args))
    got = tyolo.yolo3_targets(*(mx.nd.array(a, ctx=mx.cpu()) for a in args), C,
                              ignore_thresh=0.3)
    _assert_targets([_np(t) for t in got], [w.asnumpy() for w in want])
    assert _np(got[0])[0, :, 0].sum() == 1.0


def test_decode_tables_cached_per_shape_and_device():
    net = _tiny(tyolo)
    net.initialize(ctx=mx.cpu())
    with mx.autograd.predict_mode():
        a = net(torch.zeros(1, 3, 64, 64))
        b = net(torch.zeros(2, 3, 64, 64))
        net(torch.zeros(1, 3, 128, 128))
    assert sorted(k[:3] for k in net._table_cache) == sorted(
        [(2, 2, 0), (4, 4, 1), (8, 8, 2), (4, 4, 0), (8, 8, 1), (16, 16, 2)])
    assert {k[3] for k in net._table_cache} == {torch.device("cpu")}
    for x, y in zip(a[1:], b[1:]):
        assert torch.equal(x, y) and x.dtype == torch.float32


def test_darknet53_structure():
    """yolo3_darknet53: 72 BatchNorms and 222 trainable parameters, the JAX
    net's structural keys; reachable as gluon.model_zoo.yolo."""
    net = tyolo.yolo3_darknet53(num_classes=80)
    assert sum(isinstance(m, nn.BatchNorm) for m in net.modules()) == 72
    assert sum(p.grad_req != "null" for p in net.collect_params().values()) == 222
    assert sorted(net._collect_params_with_prefix()) == \
        sorted(jyolo.yolo3_darknet53(num_classes=80)._collect_params_with_prefix())
    assert mx.gluon.model_zoo.yolo is tyolo
    assert mx.gluon.model_zoo.yolo3_darknet53 is tyolo.yolo3_darknet53
