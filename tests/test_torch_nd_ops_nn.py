"""The port's ``ops/nn.py`` against the JAX package's, op by op, on the CPU.

Every name the JAX ``ops/nn.py`` registers (aliases included) is a case
of ``nd_op_cases``, ``SoftmaxOutput``'s ``ignore_label`` and
``normalization`` rules among them: values and output dtypes
through both packages' ``mx.nd`` on NDArrays, and for a differentiable op
the input gradients of ``autograd.record``/``backward`` with random head
gradients.  Bounds are stated in ``nd_parity``.
"""
import pytest

import nd_parity as P

CASES = P.cases("nn")
GRAD_CASES = [c for c in CASES if P.has_grad(c)]


def test_registry_has_every_name_of_the_jax_file():
    P.check_registry("nn")


@pytest.mark.parametrize("case", CASES, ids=P.ids(CASES))
def test_values(case):
    P.check_values(case)


@pytest.mark.parametrize("case", GRAD_CASES, ids=P.ids(GRAD_CASES))
def test_gradients(case):
    P.check_grads(case)
