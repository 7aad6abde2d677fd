"""The port's ``ops/linalg.py`` against the JAX package's, op by op, on
the CPU: every name of the JAX file, values and output dtypes, and the
input gradients of every differentiable case but ``syevd``, whose
eigenvectors are free in sign.  ``gelqf`` (diag(L) ≥ 0 on both sides) and
``syevd`` are held by reconstruction: L·Q and Uᵀ·diag(λ)·U against A, Q's
rows orthonormal, and U's rows against the JAX package's up to sign
(``nd_op_cases.decomp_ratio``, within 1e-5 of the largest |value|)."""
import numpy as np
import pytest
import torch

import incubator_mxnet_torch as mx

import nd_parity as P

CASES = P.cases("linalg")
GRAD_CASES = [c for c in CASES if c.op != "linalg_syevd" and P.has_grad(c)]


def test_registry_has_every_name_of_the_jax_file():
    P.check_registry("linalg")


@pytest.mark.parametrize("case", CASES, ids=P.ids(CASES))
def test_values(case):
    P.check_values(case)


@pytest.mark.parametrize("case", GRAD_CASES, ids=P.ids(GRAD_CASES))
def test_gradients(case):
    P.check_grads(case)


def test_gelqf_normalises_the_signs_of_a_qr_with_negative_diagonal():
    """A matrix whose QR (of its transpose) has a negative diagonal in R
    still gives diag(L) ≥ 0, and L·Q = A."""
    a = torch.tensor([[-2.0, 1.0, 0.5], [0.3, -1.5, 2.0]])
    q, l = mx.nd.linalg_gelqf(a)
    assert (torch.diagonal(l) >= 0).all()
    torch.testing.assert_close(l @ q, a, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(q @ q.T, torch.eye(2), rtol=0, atol=1e-6)


def test_syevd_rows_are_eigenvectors():
    r = np.random.RandomState(3)
    a = r.uniform(-1, 1, (4, 4))
    a = torch.from_numpy((a + a.T).astype(np.float32))
    u, lam = mx.nd.linalg_syevd(a)
    for i in range(4):  # A uᵢ = λᵢ uᵢ for the rows of U
        torch.testing.assert_close(a @ u[i], lam[i] * u[i], rtol=1e-5, atol=1e-5)
    assert torch.all(lam[1:] >= lam[:-1])


def test_moments_is_the_one_pass_form():
    """E[x²] − E[x]² in fp32 (a large offset loses the variance, as in the
    JAX package and the port's BatchNorm)."""
    x = torch.tensor([4096.0, 4096.5, 4095.5, 4096.0])
    mean, var = mx.nd.moments(x, axes=(0,))
    assert mean.item() == 4096.0
    assert var.item() == float(np.float32((x.double() ** 2).float().mean()) - np.float32(4096.0) ** 2)
