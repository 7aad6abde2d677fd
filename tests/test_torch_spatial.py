"""The port's ``ops/spatial.py`` against the JAX package's, op by op, on
the CPU.

Every name the JAX ``ops/spatial.py`` registers (aliases included) is a
case of ``nd_op_cases.LIBRARY_CASES``: values and output dtypes through
both packages' ``mx.nd``, and for a differentiable op the input gradients
of ``autograd.record``/``backward`` with random head gradients (the output
heads' own gradients, whatever the head).  Bounds are stated in
``nd_parity`` (1e-5 of the case's largest |value|).  The CTC op is held in
both blank modes, with and without lengths, on an impossible alignment
(about 1e30, not inf) and with the ``'last'`` mode's -1 padding.
"""
import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as mxj
import incubator_mxnet_torch as mx

import nd_parity as P

CASES = P.cases("spatial")
GRAD_CASES = [c for c in CASES if P.has_grad(c)]


def test_registry_has_every_name_of_the_jax_file():
    P.check_registry("spatial")


@pytest.mark.parametrize("case", CASES, ids=P.ids(CASES))
def test_values(case):
    P.check_values(case)


@pytest.mark.parametrize("case", GRAD_CASES, ids=P.ids(GRAD_CASES))
def test_gradients(case):
    P.check_grads(case)


def test_ctc_impossible_alignment_costs_1e30_not_inf():
    """Three labels cannot align with two frames: the JAX package's -1e30
    for log 0 makes the cost about 1e30 in both packages."""
    rng = np.random.RandomState(0)
    x = rng.randn(2, 2, 4).astype(np.float32)
    lab = np.array([[1, 2, 3], [1, 1, 0]], np.float32)
    got = mx.nd.CTCLoss(torch.from_numpy(x), torch.from_numpy(lab)).numpy()
    ref = mxj.nd.CTCLoss(mxj.nd.array(x), mxj.nd.array(lab)).asnumpy()
    assert np.isfinite(got).all() and got[0] > 1e29
    np.testing.assert_allclose(got, ref, rtol=1e-5)


@pytest.mark.parametrize("blank", ["first", "last"])
def test_ctc_padding_and_lengths_agree(blank):
    """The label length read from the padding equals the one given by
    ``label_lengths``; a shorter ``data_lengths`` freezes the recursion."""
    rng = np.random.RandomState(1)
    x = torch.from_numpy(rng.randn(7, 3, 6).astype(np.float32))
    if blank == "first":
        lab = torch.tensor([[1., 2., 0.], [3., 3., 5.], [4., 0., 0.]])
    else:
        lab = torch.tensor([[0., 1., -1.], [2., 2., 4.], [3., -1., -1.]])
    lens = torch.tensor([2., 3., 1.])
    a = mx.nd.CTCLoss(x, lab, None, lens, use_label_lengths=True, blank_label=blank)
    b = mx.nd.CTCLoss(x, lab, blank_label=blank)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    short = mx.nd.CTCLoss(x, lab, torch.tensor([4., 7., 5.]), use_data_lengths=True,
                          blank_label=blank)
    ref = mxj.nd.CTCLoss(mxj.nd.array(x.numpy()), mxj.nd.array(lab.numpy()),
                         mxj.nd.array(np.array([4., 7., 5.], np.float32)),
                         use_data_lengths=True, blank_label=blank).asnumpy()
    np.testing.assert_allclose(short.numpy(), ref, rtol=1e-5)
    torch.testing.assert_close(mx.nd.CTCLoss(x[:4, :1], lab[:1], blank_label=blank),
                               short[:1], rtol=1e-6, atol=0)


def _graph(pkg):
    """ROIAlign, the CTC op and an interleaved product in one mx.sym graph."""
    S = pkg.sym
    data, rois = S.var("data"), S.var("rois")
    pooled = S.contrib.ROIAlign(data, rois, pooled_size=(2, 2), sample_ratio=2)
    acts, label = S.var("acts"), S.var("label")
    qkv = S.var("qkv")
    return S.Group([pooled, S.CTCLoss(acts, label),
                    S.contrib.interleaved_matmul_selfatt_qk(qkv, heads=2)])


def test_the_ops_run_in_a_symbol_graph_as_in_the_jax_executor():
    """Bound and run through each package's executor (the port infers the
    shapes on meta tensors): the outputs within 1e-5."""
    r = np.random.RandomState(4)
    arrays = {"data": r.randn(2, 3, 8, 8).astype(np.float32),
              "rois": np.array([[0, 1, 1, 6, 5], [1, 0.5, 2, 7, 7.5]], np.float32),
              "acts": r.randn(6, 2, 5).astype(np.float32),
              "label": np.array([[1, 2, 0], [3, 3, 1]], np.float32),
              "qkv": r.randn(4, 2, 2 * 3 * 4).astype(np.float32)}
    shapes = {k: v.shape for k, v in arrays.items()}
    assert _graph(mx).infer_shape(**shapes)[1] == _graph(mxj).infer_shape(**shapes)[1]
    ej = _graph(mxj).bind(mxj.cpu(), {k: mxj.nd.array(v) for k, v in arrays.items()})
    et = _graph(mx).bind(mx.cpu(), {k: mx.nd.array(v, ctx=mx.cpu()) for k, v in arrays.items()})
    for a, b in zip(et.forward(), ej.forward()):
        np.testing.assert_allclose(a.asnumpy(), b.asnumpy(), rtol=1e-5, atol=1e-5)
