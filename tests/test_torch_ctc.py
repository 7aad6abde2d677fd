"""CTC in the port against the JAX package, on the CPU.

* ``gluon.loss.CTCLoss``, the JAX package's own trellis (not the op's), in
  ``NTC`` and ``TNC``, with and without ``pred_lengths``/``label_lengths``
  (without them the padded labels count, as in the JAX package), and with
  ``sample_weight``: losses within 1e-5 relative.  Its gradient, which the
  JAX package's NaN at unreachable trellis positions spoils, is held to
  PyTorch's own ``F.ctc_loss`` gradient on the same inputs (lengths given,
  labels without repeats so that both trellises agree) within 1e-4.
* example/ctc_ocr.py's OCRNet (hidden 16) trained three Adam steps (lr
  3e-3) through ``mx.nd.CTCLoss`` on the example's seeded batches, the
  JAX example's net and the port's (``chip_smoke.OCRNet``) from the same
  weights: each step's loss within 1e-5 relative, the parameters after
  each step within 1e-4 of the largest |value| of each.
"""
import importlib.util
import os

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import incubator_mxnet_tpu as mxj
import incubator_mxnet_torch as mx
from incubator_mxnet_torch.convert import load_numpy_params

import chip_smoke

_EXAMPLE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "example", "ctc_ocr.py")


def _example():
    spec = importlib.util.spec_from_file_location("ctc_ocr_example", _EXAMPLE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _inputs(layout, seed=0):
    r = np.random.RandomState(seed)
    T, B, C = 9, 4, 6
    pred = r.randn(B, T, C) if layout == "NTC" else r.randn(T, B, C)
    lab = np.array([[1, 2, 0, 0], [3, 3, 5, 1], [4, 0, 0, 0], [2, 5, 2, 3]], np.float32)
    return (pred.astype(np.float32), lab, np.array([9, 7, 8, 6], np.float32),
            np.array([2, 4, 1, 4], np.float32), r.uniform(0.5, 2, (B,)).astype(np.float32))


@pytest.mark.parametrize("lengths", ["none", "pred", "label", "both"])
@pytest.mark.parametrize("layout", ["NTC", "TNC"])
def test_gluon_ctc_loss_matches_the_jax_package(layout, lengths):
    pred, lab, pl, ll, _ = _inputs(layout)
    args = [pred, lab]
    if lengths in ("pred", "both"):
        args.append(pl)
    if lengths == "label":
        args.append(None)
    if lengths in ("label", "both"):
        args.append(ll)
    t = mx.gluon.loss.CTCLoss(layout=layout)(
        *(None if a is None else torch.from_numpy(a) for a in args))
    j = mxj.gluon.loss.CTCLoss(layout=layout)(
        *(None if a is None else mxj.nd.array(a) for a in args))
    np.testing.assert_allclose(t.numpy(), j.asnumpy(), rtol=1e-5)


def test_gluon_ctc_loss_sample_weight():
    pred, lab, pl, ll, w = _inputs("NTC", seed=4)
    t = mx.gluon.loss.CTCLoss(weight=0.5)(torch.from_numpy(pred), torch.from_numpy(lab),
                                          torch.from_numpy(pl), torch.from_numpy(ll),
                                          torch.from_numpy(w))
    j = mxj.gluon.loss.CTCLoss(weight=0.5)(mxj.nd.array(pred), mxj.nd.array(lab),
                                           mxj.nd.array(pl), mxj.nd.array(ll),
                                           mxj.nd.array(w))
    np.testing.assert_allclose(t.numpy(), j.asnumpy(), rtol=1e-5)


def test_gluon_ctc_gradient_matches_torch_ctc():
    r = np.random.RandomState(2)
    T, B, C = 10, 3, 6
    pred = torch.from_numpy(r.randn(T, B, C).astype(np.float32)).requires_grad_()
    lab = torch.tensor([[1., 2., 3.], [4., 1., 0.], [5., 0., 0.]])
    pl, ll = torch.tensor([10., 8., 9.]), torch.tensor([3., 2., 1.])
    with mx.autograd.record():
        loss = mx.gluon.loss.CTCLoss(layout="TNC")(pred, lab, pl, ll)
    loss.sum().backward()
    assert torch.isfinite(pred.grad).all()
    ref_in = pred.detach().clone().requires_grad_()
    ref = F.ctc_loss(torch.log_softmax(ref_in, -1), lab.long(), pl.long(), ll.long(),
                     blank=0, reduction="none", zero_infinity=False)
    ref.sum().backward()
    torch.testing.assert_close(loss.detach(), ref.detach(), rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(pred.grad, ref_in.grad, rtol=1e-4, atol=1e-4)


def _params(net):
    return {k: (p.data().asnumpy() if hasattr(p.data(), "asnumpy")
                else p.data().detach().numpy()).copy()
            for k, p in net._collect_params_with_prefix().items()}


def test_ocr_adam_steps_match_the_jax_example():
    ex = _example()
    rng = np.random.RandomState(0)
    batches = [chip_smoke.ocr_batch(rng, 8) for _ in range(3)]
    mxj.random.seed(0)
    jnet = ex.OCRNet(hidden=16)
    jnet.initialize()
    jnet(mxj.nd.array(batches[0][0]))
    net = chip_smoke.OCRNet(hidden=16)
    net.initialize(ctx=mx.cpu())
    net(torch.from_numpy(batches[0][0]))
    load_numpy_params(net, _params(jnet))
    jtr = mxj.gluon.Trainer(jnet.collect_params(), "adam", {"learning_rate": 3e-3})
    ttr = mx.gluon.Trainer(net.collect_params(), "adam", {"learning_rate": 3e-3})
    for x, y in batches:
        with mxj.autograd.record():
            jl = mxj.nd.CTCLoss(jnet(mxj.nd.array(x)), mxj.nd.array(y)).mean()
        jl.backward()
        jtr.step(8)
        with mx.autograd.record():
            tl = mx.nd.CTCLoss(net(torch.from_numpy(x)), torch.from_numpy(y)).mean()
        mx.autograd.backward(tl)
        ttr.step(8)
        np.testing.assert_allclose(tl.item(), float(jl.asnumpy()), rtol=1e-5)
        want, got = _params(jnet), _params(net)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=0,
                                       atol=1e-4 * np.abs(want[k]).max(), err_msg=k)


def test_greedy_decode_collapses_repeats_and_drops_blanks():
    logits = torch.zeros(6, 1, 4)
    for t, c in enumerate([1, 1, 0, 1, 3, 3]):
        logits[t, 0, c] = 1.0
    assert chip_smoke.greedy_decode(logits) == [[1, 1, 3]]
