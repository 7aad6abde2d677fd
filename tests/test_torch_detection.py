"""The detection ops and SSD in the PyTorch port against the JAX package,
on the CPU.

The five ops of ``ops/detection.py`` (``box_iou``, ``multibox_prior``,
``multibox_target`` with hard-negative mining, ``multibox_detection``,
``box_nms``) on seeded inputs, with the cases where a port can go wrong:
two gts whose best anchor is the same anchor (the later gt wins it), a
valid gt whose best anchor is anchor 0 followed by padded rows (the padded
rows' scatter takes its forced match away in the JAX op, and in the port),
mining among tied scores, ``force_suppress``, ``id_index``,
``in_format="center"``, ``topk``; the registry's names (``nd.contrib``,
``mx.nd``, ``mx.sym``); then a small SSD (a strided conv, BatchNorm and
three scales at 64x64) through its forward, bench.py's loss
(``multibox_target`` + softmax CE + L1) and one SGD-momentum step, with
the same numpy-seeded parameters in both packages (``twin_nets`` of tests/test_torch_vision_zoo.py).

Tolerances: indices, matches, class targets, masks and kept rows exact;
floats within 1e-6 relative (+1e-7 absolute): both sides compute the same
float32 arithmetic, and ``log`` and division may differ by an ulp.  The
SSD forward and loss are float32 through 9 convolutions in another
summation order, with train-mode BatchNorm over 2x2 maps: within 1e-4 of
the tensor's largest |value|; parameters after the step 1e-4 relative /
1e-5 absolute, as tests/test_torch_resnet.py holds its steps.
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import incubator_mxnet_tpu as mxj
from incubator_mxnet_tpu.gluon.model_zoo import ssd as jssd
from incubator_mxnet_tpu.ops import detection as jdet
import incubator_mxnet_torch as mx
from incubator_mxnet_torch.convert import load_numpy_params
from incubator_mxnet_torch.gluon import nn
from incubator_mxnet_torch.gluon.model_zoo import ssd as tssd
from incubator_mxnet_torch.ops import detection as tdet
from incubator_mxnet_torch.ops import nn as tnn
from test_torch_vision_zoo import assert_close_to_scale, params_of, twin_nets

OP_TOL = dict(rtol=1e-6, atol=1e-7)
NET_REL = 1e-4
PARAM_TOL = dict(rtol=1e-4, atol=1e-5)
SGD = {"learning_rate": 0.01, "momentum": 0.9, "wd": 5e-4}


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _both(jfn, tfn, arrays, **kw):
    """The JAX op (jitted: one compile instead of one an eager op) and the
    port's op on the same numpy inputs."""
    want = jax.jit(functools.partial(jfn, **kw))(*(jnp.asarray(a) for a in arrays))
    got = tfn(*(torch.from_numpy(a) for a in arrays), **kw)
    return want, got


def _boxes(rng, shape, lo=0.0, span=1.0):
    """Corner boxes with x1 < x2, y1 < y2 in [lo, lo + span]."""
    a = rng.rand(*shape, 2, 2).astype(np.float32) * span + lo
    return np.concatenate([a.min(-2), a.max(-2)], -1).astype(np.float32)


def _anchors(n, seed=0):
    return _boxes(np.random.RandomState(seed), (1, n))


def _labels(rng, b, m, n_valid):
    lab = np.full((b, m, 5), -1, np.float32)
    for i in range(b):
        for j in range(n_valid[i]):
            x0, y0 = rng.rand(2) * 0.5
            lab[i, j] = [j % 3, x0, y0, x0 + 0.2 + 0.3 * rng.rand(), y0 + 0.4]
    return lab


# -- box_iou and multibox_prior ------------------------------------------------


@pytest.mark.parametrize("fmt", ["corner", "center"])
def test_box_iou_matches_jax(fmt):
    rng = np.random.RandomState(0)
    lhs, rhs = _boxes(rng, (2, 7)), _boxes(rng, (2, 5))
    want, got = _both(jdet.box_iou, tdet.box_iou, (lhs, rhs), format=fmt)
    assert got.shape == (2, 7, 5)
    np.testing.assert_allclose(_np(got), np.asarray(want), **OP_TOL)


@pytest.mark.parametrize("kw", [
    dict(sizes=(0.3, 0.5), ratios=(1.0, 2.0, 0.5), clip=True),
    dict(sizes=0.2, ratios=1.0),
    dict(sizes=(0.75, 0.8216), ratios=(1.0, 2.0, 0.5, 3.0, 1.0 / 3), steps=(0.1, 0.2),
         offsets=(0.25, 0.75)),
], ids=["clip", "scalar", "steps_offsets"])
def test_multibox_prior_matches_jax(kw):
    # eager: XLA contracts the jitted op's multiply-subtract into an fma
    want = jdet.multibox_prior(jnp.zeros((2, 3, 5, 7)), **kw)
    got = tdet.multibox_prior(torch.zeros(2, 3, 5, 7), **kw)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_array_equal(_np(got), np.asarray(want))


# -- multibox_target -------------------------------------------------------------


def _target(anchors, label, cls_pred, **kw):
    want, got = _both(jdet.multibox_target, tdet.multibox_target, (anchors, label, cls_pred),
                      **kw)
    for w, g in zip(want, got):
        assert g.shape == w.shape and g.dtype == torch.float32
    return [np.asarray(w) for w in want], [_np(g) for g in got]


def _assert_target_equal(want, got):
    (wbt, wbm, wct), (gbt, gbm, gct) = want, got
    np.testing.assert_array_equal(gbm, wbm)   # the matches
    np.testing.assert_array_equal(gct, wct)   # class targets (mining included)
    np.testing.assert_allclose(gbt, wbt, **OP_TOL)


def test_multibox_target_duplicate_best_anchor_goes_to_the_later_gt():
    """Two gts whose best anchor is anchor 1: the later gt takes it (the
    JAX scatter's last writer in gt order)."""
    anchors = np.array([[[0, 0, .5, .5], [.5, .5, 1, 1], [0, .5, .5, 1]]], np.float32)
    lab = np.full((1, 3, 5), -1, np.float32)
    lab[0, 0] = [1, 0.5, 0.5, 0.9, 0.9]
    lab[0, 1] = [2, 0.55, 0.55, 1.0, 1.0]
    cp = np.random.RandomState(0).rand(1, 4, 3).astype(np.float32)
    want, got = _target(anchors, lab, cp)
    _assert_target_equal(want, got)
    np.testing.assert_array_equal(got[2], [[0, 3, 0]])  # anchor 1 → gt 1 (class 2 + 1)


def test_multibox_target_padded_rows_take_anchor_zeros_forced_match():
    """A valid gt whose best anchor is anchor 0 (IoU below the threshold),
    then padded rows: each padded row's best anchor is also anchor 0 and it
    writes -1 there after the valid gt, so anchor 0 stays unmatched: the
    reference's own behaviour, which the port keeps (ROADMAP §3)."""
    anchors = np.array([[[0, 0, .5, .5], [.5, .5, 1, 1], [0, .5, .5, 1]]], np.float32)
    lab = np.full((1, 3, 5), -1, np.float32)
    lab[0, 0] = [3, 0.0, 0.0, 0.3, 0.3]       # IoU 0.36 with anchor 0
    cp = np.random.RandomState(1).rand(1, 4, 3).astype(np.float32)
    want, got = _target(anchors, lab, cp)
    _assert_target_equal(want, got)
    np.testing.assert_array_equal(got[2], [[0, 0, 0]])
    lab[0, 1:] = lab[0, 0]                     # no padding: the gt keeps anchor 0
    lab[0, 1:, 0] = 3
    want, got = _target(anchors, lab, cp)
    _assert_target_equal(want, got)
    np.testing.assert_array_equal(got[2], [[4, 0, 0]])


@pytest.mark.parametrize("kw", [
    dict(),
    dict(overlap_threshold=0.3),
    dict(negative_mining_ratio=3.0),
    dict(negative_mining_ratio=2.0, minimum_negative_samples=5, negative_mining_thresh=0.4),
    dict(negative_mining_ratio=1.0, ignore_label=-2.0, variances=(0.2, 0.2, 0.1, 0.1)),
], ids=["default", "threshold", "mining", "mining_minimum", "mining_ignore"])
def test_multibox_target_matches_jax(kw):
    """48 anchors, samples with 0-3 valid gts; the background scores of the
    first 12 anchors tie (mining keeps the earlier ones) and many negatives
    sit at -inf."""
    rng = np.random.RandomState(2)
    anchors = _anchors(48, seed=3)
    lab = _labels(rng, 4, 5, [0, 1, 2, 3])
    cp = rng.rand(4, 4, 48).astype(np.float32)
    cp[:, 0, :12] = 0.25
    want, got = _target(anchors, lab, cp, **kw)
    _assert_target_equal(want, got)
    if kw.get("negative_mining_ratio", -1) > 0:
        ignore = kw.get("ignore_label", -1.0)
        assert (got[2] == ignore).any() and (got[2] == 0).any()


# -- multibox_detection and box_nms -----------------------------------------------


def _det_inputs(seed=4, n=40, b=3, classes=3):
    rng = np.random.RandomState(seed)
    logits = rng.randn(b, classes + 1, n).astype(np.float32) * 2
    prob = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    prob[0, 1, :6] = prob[0, 1, 0]  # tied scores
    loc = (rng.randn(b, n * 4) * 0.2).astype(np.float32)
    return prob.astype(np.float32), loc, _anchors(n, seed=seed)


@pytest.mark.parametrize("kw", [
    dict(),
    dict(force_suppress=True),
    dict(nms_topk=8),
    dict(nms_threshold=0.2, threshold=0.3),
    dict(background_id=2, clip=False),
], ids=["default", "force_suppress", "topk", "thresholds", "background_2"])
def test_multibox_detection_matches_jax(kw):
    want, got = _both(jdet.multibox_detection, tdet.multibox_detection, _det_inputs(), **kw)
    want, got = np.asarray(want), _np(got)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got[..., 0], want[..., 0])      # kept rows and classes
    np.testing.assert_allclose(got, want, **OP_TOL)


def _records(seed=5, b=2, n=30):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, 3, (b, n, 1)).astype(np.float32)
    score = rng.rand(b, n, 1).astype(np.float32)
    score[0, :5] = score[0, 0]      # ties
    return np.concatenate([ids, score, _boxes(rng, (b, n), span=0.6)], -1)


@pytest.mark.parametrize("kw", [
    dict(),
    dict(id_index=0),
    dict(id_index=0, force_suppress=True),
    dict(id_index=0, background_id=1, valid_thresh=0.2),
    dict(topk=7, overlap_thresh=0.3),
    dict(in_format="center", out_format="center"),
], ids=["default", "id_index", "force_suppress", "background", "topk", "center"])
def test_box_nms_matches_jax(kw):
    recs = _records()
    want, got = _both(jdet.box_nms, tdet.box_nms, (recs,), **kw)
    np.testing.assert_array_equal(_np(got), np.asarray(want))
    # leading batch axes are kept
    want, got = _both(jdet.box_nms, tdet.box_nms, (recs[None],), **kw)
    assert got.shape == (1,) + recs.shape
    np.testing.assert_array_equal(_np(got), np.asarray(want))


def test_registry_names_and_ndarrays():
    """``nd.contrib.MultiBox*``, ``nd.box_iou`` and the ``contrib_box_*``
    aliases resolve; NDArrays in give NDArrays out."""
    anchors = _anchors(10)
    a = mx.nd.array(anchors, ctx=mx.cpu())
    prior = mx.nd.contrib.MultiBoxPrior(mx.nd.zeros((1, 2, 3, 3), ctx=mx.cpu()), sizes=(0.5,))
    assert isinstance(prior, mx.nd.NDArray) and prior.shape == (1, 9, 4)
    lab = mx.nd.array(_labels(np.random.RandomState(6), 2, 3, [1, 2]), ctx=mx.cpu())
    cp = mx.nd.array(np.random.RandomState(7).rand(2, 4, 10).astype(np.float32), ctx=mx.cpu())
    bt, bm, ct = mx.nd.contrib.MultiBoxTarget(a, lab, cp)
    assert (bt.shape, bm.shape, ct.shape) == ((2, 40), (2, 40), (2, 10))
    np.testing.assert_array_equal(mx.nd.box_iou(a[0], a[0]).asnumpy(),
                                  mx.nd.contrib.box_iou(a[0], a[0]).asnumpy())
    recs = mx.nd.array(_records(), ctx=mx.cpu())
    np.testing.assert_array_equal(mx.nd.contrib.box_nms(recs).asnumpy(),
                                  mx.nd.box_nms(recs).asnumpy())
    det = mx.nd.contrib.MultiBoxDetection(mx.nd.softmax(cp, axis=1),
                                          mx.nd.zeros((2, 40), ctx=mx.cpu()), a)
    assert det.shape == (2, 10, 6)


def test_symbol_graph_binds_multibox_prior_and_box_nms():
    """``mx.sym.contrib.MultiBoxPrior`` and ``mx.sym.box_nms`` in a graph,
    bound and run through an executor on the CPU, equal the ops."""
    data = mx.sym.var("data")
    recs = mx.sym.var("recs")
    out = mx.sym.Group([mx.sym.contrib.MultiBoxPrior(data, sizes=(0.4, 0.6),
                                                     ratios=(1.0, 2.0), clip=True),
                        mx.sym.box_nms(recs, overlap_thresh=0.4, id_index=0)])
    x = np.zeros((1, 2, 4, 5), np.float32)
    r = _records()
    exe = out.simple_bind(ctx=mx.cpu(), data=x.shape, recs=r.shape)
    prior, kept = exe.forward(data=mx.nd.array(x, ctx=mx.cpu()),
                              recs=mx.nd.array(r, ctx=mx.cpu()))
    np.testing.assert_array_equal(
        prior.asnumpy(), _np(tdet.multibox_prior(torch.from_numpy(x), sizes=(0.4, 0.6),
                                                 ratios=(1.0, 2.0), clip=True)))
    np.testing.assert_array_equal(
        kept.asnumpy(), _np(tdet.box_nms(torch.from_numpy(r), overlap_thresh=0.4, id_index=0)))


# -- the small SSD ---------------------------------------------------------------

B, SIZE = 2, 64


def _small_ssd(m, ssd_mod):
    feat = m.HybridSequential()
    feat.add(m.Conv2D(16, kernel_size=3, strides=2, padding=1))
    feat.add(m.BatchNorm())
    feat.add(m.Activation("relu"))
    return ssd_mod.SSD(feat, num_classes=3, scales=ssd_mod.SSDAnchorScales[:3], channels=32)


def _ssd_batch():
    rng = np.random.RandomState(8)
    img = rng.rand(B, 3, SIZE, SIZE).astype(np.float32)
    lab = np.full((B, 4, 5), -1, np.float32)
    lab[:, 0] = [1, 0.2, 0.2, 0.7, 0.7]
    lab[:, 1] = [2, 0.5, 0.5, 0.9, 0.9]
    lab[1, 2] = [0, 0.05, 0.6, 0.3, 0.95]
    return img, lab


class _JaxLoss(mxj.gluon.HybridBlock):
    """bench.py's SSD loss over the JAX net (per-sample softmax CE over the
    anchors + masked L1), hybridized as one program: the loss, the forward
    and the targets."""

    def __init__(self, net):
        super().__init__()
        with self.name_scope():
            self.net = net
            self.ce = mxj.gluon.loss.SoftmaxCrossEntropyLoss()

    def hybrid_forward(self, F, x, label):
        anchors, cls_preds, box_preds = self.net(x)
        bt, bm, ct = F.contrib.MultiBoxTarget(anchors, label, cls_preds.transpose((0, 2, 1)))
        loss = self.ce(cls_preds, ct) + (F.abs(box_preds - bt) * bm).mean(axis=-1)
        return loss, anchors, cls_preds, box_preds, bt, bm, ct


@pytest.fixture(scope="module")
def jax_ssd():
    """The small SSD in both packages with the same seeded parameters; the
    JAX side's outputs and targets in training mode, and the loss and
    parameters after one Trainer step on bench.py's loss."""
    img, lab = _ssd_batch()
    jnet, _ = twin_nets(lambda: _small_ssd(nn, tssd), lambda: _small_ssd(mxj.gluon.nn, jssd),
                        img)
    start = params_of(jnet)
    step = _JaxLoss(jnet)
    step.hybridize()
    trainer = mxj.gluon.Trainer(jnet.collect_params(), "sgd", dict(SGD))
    with mxj.autograd.record():
        res = step(mxj.nd.array(img), mxj.nd.array(lab))
    res[0].backward()
    trainer.step(B)
    return start, [o.asnumpy() for o in res[1:]], res[0].asnumpy(), params_of(jnet)


def ssd_loss(out, label):
    """bench.py's SSD loss on the port."""
    anchors, cls_preds, box_preds = out
    bt, bm, ct = tdet.multibox_target(anchors, label, cls_preds.transpose(1, 2))
    ce = tnn.streaming_softmax_ce(cls_preds, ct).mean(-1)
    return ce + ((box_preds - bt).abs() * bm).mean(-1)


def test_small_ssd_forward_loss_and_sgd_step_match_jax(jax_ssd):
    start, jouts, jloss, jparams = jax_ssd
    net = _small_ssd(nn, tssd)
    net.initialize(ctx=mx.cpu())
    load_numpy_params(net, start)
    img, lab = (torch.from_numpy(a) for a in _ssd_batch())
    trainer = mx.gluon.Trainer(net.collect_params(), "sgd", dict(SGD))
    with mx.autograd.record():
        out = net(img)
        loss = ssd_loss(out, lab)
    mx.autograd.backward(loss)
    trainer.step(B)
    anchors, cls_preds, box_preds = out
    bt, bm, ct = tdet.multibox_target(anchors, lab, cls_preds.detach().transpose(1, 2))
    np.testing.assert_array_equal(_np(anchors), jouts[0])
    for got, want in zip((cls_preds, box_preds), jouts[1:3]):
        assert_close_to_scale(_np(got), want, NET_REL)
    np.testing.assert_array_equal(_np(bm), jouts[4])
    np.testing.assert_array_equal(_np(ct), jouts[5])
    np.testing.assert_allclose(_np(bt), jouts[3], **OP_TOL)
    assert_close_to_scale(_np(loss), jloss, NET_REL)
    got = params_of(net)
    assert got.keys() == jparams.keys()
    for key, want in jparams.items():
        np.testing.assert_allclose(got[key], want, err_msg=key, **PARAM_TOL)


def test_ssd_zoo_structure_and_keys():
    """ssd_512_resnet18: 25 BatchNorms and 109 trainable parameters;
    ssd_512_vgg16_atrous: 10 (all in the downsamplers; the backbone has
    none) and 94; the structural keys of both packages' nets are the same."""
    net = tssd.ssd_512_resnet18(num_classes=20)
    assert sum(isinstance(m, nn.BatchNorm) for m in net.modules()) == 25
    assert sum(p.grad_req != "null" for p in net.collect_params().values()) == 109
    vgg = tssd.ssd_512_vgg16_atrous(num_classes=20)
    assert sum(isinstance(m, nn.BatchNorm) for m in vgg.modules()) == 10
    assert sum(isinstance(m, nn.BatchNorm) for m in vgg.features.modules()) == 0
    assert sum(p.grad_req != "null" for p in vgg.collect_params().values()) == 94
    for t, j in ((net, jssd.ssd_512_resnet18(num_classes=20)),
                 (vgg, jssd.ssd_512_vgg16_atrous(num_classes=20))):
        assert sorted(t._collect_params_with_prefix()) == sorted(j._collect_params_with_prefix())
    assert mx.gluon.model_zoo.ssd is tssd
