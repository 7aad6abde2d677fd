"""The four interleaved-matmul attention ops (GluonNLP 0.x's fused
multi-head attention) against the JAX package's, on the CPU, in fp32 and
bf16: values, output dtypes and input gradients (``nd_op_cases`` cases,
bounds of ``nd_parity``: 1e-5 of the largest |value| in fp32, one bf16
unit, two for gradients).  The self-attention pair (qk → softmax → valatt)
is also held against the port's ``flash_attention`` on the same q, k and v
(the flash kernels' plain version on the CPU) within 1e-5 in fp32, values
and gradients."""
import math

import numpy as np
import pytest
import torch

import incubator_mxnet_torch as mx
from incubator_mxnet_torch.ops import attention as att

import nd_parity as P

CASES = P.cases("interleaved")
GRAD_CASES = [c for c in CASES if P.has_grad(c)]


def test_registry_has_the_four_ops():
    P.check_registry("interleaved")


@pytest.mark.parametrize("case", CASES, ids=P.ids(CASES))
def test_values(case):
    P.check_values(case)


@pytest.mark.parametrize("case", GRAD_CASES, ids=P.ids(GRAD_CASES))
def test_gradients(case):
    P.check_grads(case)


def _interleave(q, k, v):
    """[B, S, H, Dh] q, k, v → the [S, B, H·3·Dh] projection, interleaved a
    head."""
    b, s, h, d = q.shape
    return torch.stack([q, k, v], 3).permute(1, 0, 2, 3, 4).reshape(s, b, h * 3 * d)


def _interleaved_attention(qkv, heads, nd):
    scores = nd.contrib.interleaved_matmul_selfatt_qk(qkv, heads=heads)
    return nd.contrib.interleaved_matmul_selfatt_valatt(qkv, torch.softmax(scores, -1),
                                                        heads=heads)


@pytest.mark.parametrize("shape", [(2, 7, 3, 8), (1, 16, 2, 32)])
def test_selfatt_pair_equals_flash_attention(shape):
    b, s, h, d = shape
    r = np.random.RandomState(sum(shape))
    q, k, v = (torch.from_numpy(r.randn(*shape).astype(np.float32)).requires_grad_()
               for _ in range(3))
    out = _interleaved_attention(_interleave(q, k, v), h, mx.nd)  # [S, B, H·Dh]
    q2, k2, v2 = (t.detach().clone().requires_grad_() for t in (q, k, v))
    ref = att.flash_attention(q2.transpose(1, 2), k2.transpose(1, 2), v2.transpose(1, 2))
    ref = ref.transpose(1, 2).reshape(b, s, h * d).transpose(0, 1)
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)
    g = torch.from_numpy(r.randn(s, b, h * d).astype(np.float32))
    out.backward(g)
    ref.backward(g)
    for a, c in ((q, q2), (k, k2), (v, v2)):
        torch.testing.assert_close(a.grad, c.grad, rtol=1e-5, atol=1e-5)


def test_scores_are_scaled_by_the_head_dim():
    qkv = torch.ones(1, 1, 3 * 4)
    assert mx.nd.contrib.interleaved_matmul_selfatt_qk(qkv, heads=1).item() == pytest.approx(
        4 / math.sqrt(4))
