"""``mx.operator`` of the PyTorch port against the JAX package's, on the CPU.

The ops of ``tests/test_custom_op.py`` (a sigmoid, and a two-output clip),
a two-input product, and an erf GELU are registered in both packages under
the same names; the same seeded numpy inputs go through ``nd.Custom`` under
``autograd.record()`` on both sides, and the values and input gradients
must agree.  For the GELU the JAX op launches ``PallasModule`` kernels (in
interpret mode, as ``tests/test_rtc.py`` runs them) and the port's op is
the user op of ``chip_smoke.py`` (``rtc_gelu``: ``mx.rtc`` kernels on CUDA
tensors), on its plain CPU branch.
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as mxj
import incubator_mxnet_torch as mx

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402  (registers the user's rtc_gelu op in the port)

# The same fp32 formulas on both sides; exp and erf of another library.
TOL = dict(rtol=1e-5, atol=1e-6)


# -- the ops, once per package ------------------------------------------------


def _register(pkg, as_array, to_numpy):
    """Register the test ops in ``pkg`` (either package); ``as_array`` makes
    an output from numpy, ``to_numpy`` reads an input."""
    op = pkg.operator

    @op.register("parity_sigmoid")
    class SigmoidProp(op.CustomOpProp):
        def __init__(self):
            super().__init__(need_top_grad=True)

        def create_operator(self, ctx, in_shapes, in_dtypes):
            return Sigmoid()

    class Sigmoid(op.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            x = to_numpy(in_data[0])
            self.assign(out_data[0], req[0], as_array(1.0 / (1.0 + np.exp(-x))))

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            y, g = to_numpy(out_data[0]), to_numpy(out_grad[0])
            self.assign(in_grad[0], req[0], as_array(g * y * (1.0 - y)))

    @op.register("parity_clip2")
    class TwoOutProp(op.CustomOpProp):
        def list_outputs(self):
            return ["pos", "neg"]

        def infer_shape(self, in_shape):
            return in_shape, [in_shape[0], in_shape[0]], []

        def create_operator(self, ctx, in_shapes, in_dtypes):
            return TwoOut()

    class TwoOut(op.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            x = to_numpy(in_data[0])
            self.assign(out_data[0], req[0], as_array(np.maximum(x, 0)))
            self.assign(out_data[1], req[1], as_array(np.minimum(x, 0)))

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            x = to_numpy(in_data[0])
            g = to_numpy(out_grad[0]) * (x > 0) + to_numpy(out_grad[1]) * (x <= 0)
            self.assign(in_grad[0], req[0], as_array(g.astype(np.float32)))

    @op.register("parity_mul")
    class MulProp(op.CustomOpProp):
        def list_arguments(self):
            return ["a", "b"]

        def create_operator(self, ctx, in_shapes, in_dtypes):
            return Mul()

    class Mul(op.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            self.assign(out_data[0], req[0],
                        as_array(to_numpy(in_data[0]) * to_numpy(in_data[1])))

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            a, b, g = (to_numpy(t) for t in (in_data[0], in_data[1], out_grad[0]))
            self.assign(in_grad[0], req[0], as_array(g * b))
            self.assign(in_grad[1], req[1], as_array(g * a))


_register(mxj, mxj.nd.array, lambda a: a.asnumpy())
_register(mx, torch.from_numpy, lambda t: t.detach().numpy())

JAX_GELU_SRC = '''
def gelu(x_ref, o_ref):
    x = x_ref[...]
    o_ref[...] = x * 0.5 * (1.0 + jax.lax.erf(x * 0.7071067811865476))

def gelu_bwd(x_ref, dy_ref, o_ref):
    x = x_ref[...]
    cdf = 0.5 * (1.0 + jax.lax.erf(x * 0.7071067811865476))
    pdf = jnp.exp(-0.5 * x * x) * 0.3989422804014327
    o_ref[...] = dy_ref[...] * (cdf + x * pdf)
'''
_JAX_GELU = mxj.rtc.PallasModule(JAX_GELU_SRC)


@mxj.operator.register("rtc_gelu")
class _JaxGeluProp(mxj.operator.CustomOpProp):
    def create_operator(self, ctx, in_shapes, in_dtypes):
        return _JaxGelu()


class _JaxGelu(mxj.operator.CustomOp):
    """The JAX package's user GELU: Pallas kernels compiled by mx.rtc."""

    launches = 0

    def forward(self, is_train, req, in_data, out_data, aux):
        x = in_data[0]
        _JaxGelu.launches += 1
        self.assign(out_data[0], req[0],
                    _JAX_GELU.get_kernel("gelu", out_shapes=[x.shape]).launch([x]))

    def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
        x = in_data[0]
        _JaxGelu.launches += 1
        k = _JAX_GELU.get_kernel("gelu_bwd", out_shapes=[x.shape])
        self.assign(in_grad[0], req[0], k.launch([x, out_grad[0]]))


# -- running both sides -------------------------------------------------------


def _jax_run(op_type, arrays, head):
    """Outputs and input gradients of ``head(nd.Custom(*inputs))`` in JAX."""
    xs = [mxj.nd.array(a) for a in arrays]
    for x in xs:
        x.attach_grad()
    with mxj.autograd.record():
        out = mxj.nd.Custom(*xs, op_type=op_type)
        outs = out if isinstance(out, list) else [out]
        loss = head(mxj.nd, outs, xs)
    loss.backward()
    return [o.asnumpy() for o in outs], [x.grad.asnumpy() for x in xs]


def _port_run(op_type, arrays, head):
    ps = [mx.gluon.Parameter(f"x{i}", shape=a.shape) for i, a in enumerate(arrays)]
    for p, a in zip(ps, arrays):
        p.initialize(ctx=mx.cpu())
        p.set_data(a)
    with mx.autograd.record():
        out = mx.nd.Custom(*[p.data() for p in ps], op_type=op_type)
        outs = out if isinstance(out, list) else [out]
        loss = head(mx.nd, outs, [p.data() for p in ps])
    mx.autograd.backward(loss)
    return [o.detach().numpy() for o in outs], [p.grad().numpy() for p in ps]


def _inputs(*shapes, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randn(*s).astype(np.float32) for s in shapes]


def _assert_same(port, jax):
    for name, got, want in zip(("outputs", "gradients"), port, jax):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, err_msg=name, **TOL)


HEADS = {
    "square_sum": lambda nd, outs, xs: nd.sum(outs[0] * outs[0]),
    "builtin_ops_around": lambda nd, outs, xs: nd.sum(outs[0] * 3.0 + xs[0] * outs[0]),
}


@pytest.mark.parametrize("head", sorted(HEADS))
@pytest.mark.parametrize("shape", [(3,), (4, 5)])
def test_sigmoid_matches_jax(shape, head):
    arrays = _inputs(shape)
    _assert_same(_port_run("parity_sigmoid", arrays, HEADS[head]),
                 _jax_run("parity_sigmoid", arrays, HEADS[head]))


def test_composes_with_builtin_ops_on_the_tape():
    """A built-in op before and after the custom one, on both sides."""
    arrays = _inputs((2, 3), seed=1)

    def run(nd, autograd, x, backward):
        with autograd.record():
            y = nd.Custom(x * 3.0, op_type="parity_sigmoid")
            loss = nd.sum(y * y)
        backward(loss)
        return y

    jx = mxj.nd.array(arrays[0])
    jx.attach_grad()
    jy = run(mxj.nd, mxj.autograd, jx, lambda loss: loss.backward())
    p = mx.gluon.Parameter("x", shape=(2, 3))
    p.initialize(ctx=mx.cpu())
    p.set_data(arrays[0])
    ty = run(mx.nd, mx.autograd, p.data(), mx.autograd.backward)
    np.testing.assert_allclose(ty.detach().numpy(), jy.asnumpy(), **TOL)
    np.testing.assert_allclose(p.grad().numpy(), jx.grad.asnumpy(), **TOL)


@pytest.mark.parametrize("used", ["both", "pos_only"])
def test_multi_output_matches_jax(used):
    """An output no loss reaches gets a zero cotangent."""
    arrays = [np.array([1.0, -2.0, 3.0, 0.5, -0.25], np.float32)]

    def head(nd, outs, xs):
        loss = nd.sum(outs[0] * 2.0)
        return loss + nd.sum(outs[1] * 5.0) if used == "both" else loss

    port, jax = _port_run("parity_clip2", arrays, head), _jax_run("parity_clip2", arrays, head)
    _assert_same(port, jax)
    want = [2.0, 5.0, 2.0, 2.0, 5.0] if used == "both" else [2.0, 0.0, 2.0, 2.0, 0.0]
    np.testing.assert_allclose(port[1][0], want)


def test_two_inputs_match_jax():
    arrays = _inputs((3, 4), (3, 4), seed=2)
    _assert_same(_port_run("parity_mul", arrays, HEADS["square_sum"]),
                 _jax_run("parity_mul", arrays, HEADS["square_sum"]))


@pytest.mark.parametrize("req", ["write", "inplace", "add", "null"])
def test_assign_honours_req_as_jax_does(req):
    dst0, src = _inputs((2, 3), (2, 3), seed=3)
    jdst = mxj.nd.array(dst0)
    mxj.operator.CustomOp().assign(jdst, req, mxj.nd.array(src))
    tdst = torch.from_numpy(dst0.copy())
    mx.operator.CustomOp().assign(tdst, req, torch.from_numpy(src))
    np.testing.assert_allclose(tdst.numpy(), jdst.asnumpy(), **TOL)
    with pytest.raises(ValueError, match="unknown req"):
        mx.operator.CustomOp().assign(tdst, "sum", torch.from_numpy(src))


def test_unregistered_op_raises_as_jax_does():
    with pytest.raises(KeyError, match="not registered"):
        mxj.nd.Custom(mxj.nd.ones((2,)), op_type="nope")
    with pytest.raises(KeyError, match="not registered"):
        mx.nd.Custom(torch.ones(2), op_type="nope")
    with pytest.raises(ValueError, match="op_type"):
        mx.nd.Custom(torch.ones(2))


@pytest.mark.parametrize("shape", [(7,), (3, 5, 16)])
def test_pallas_gelu_op_matches_the_ports_rtc_gelu_on_the_cpu(shape):
    """The JAX op launches two PallasModule kernels (interpret mode); the
    port's user op takes its plain branch on CPU tensors and launches
    nothing."""
    arrays = _inputs(shape, seed=4)
    arrays[0] *= 3
    head = HEADS["square_sum"]
    jax_launches = _JaxGelu.launches
    jax = _jax_run("rtc_gelu", arrays, head)
    plain = chip_smoke.RtcGelu.plain_calls
    port = _port_run("rtc_gelu", arrays, head)
    _assert_same(port, jax)
    assert _JaxGelu.launches == jax_launches + 2
    assert chip_smoke.RtcGelu.plain_calls == plain + 2
    assert chip_smoke.GELU_FWD.launches == 0 and chip_smoke.GELU_BWD.launches == 0


@mx.operator.register("probe_scopes")
class _ProbeProp(mx.operator.CustomOpProp):
    seen = []

    def __init__(self, need_top_grad="1"):
        super().__init__(need_top_grad=need_top_grad == "1")

    def list_auxiliary_states(self):
        return ["state"]

    def infer_shape(self, in_shape):
        return in_shape, [in_shape[0]], [in_shape[0]]

    def create_operator(self, ctx, in_shapes, in_dtypes):
        return _Probe()


class _Probe(mx.operator.CustomOp):
    def forward(self, is_train, req, in_data, out_data, aux):
        _ProbeProp.seen.append(("forward", is_train, mx.autograd.is_recording(),
                                torch.is_grad_enabled(), aux[0].sum().item()))
        aux[0].add_(1.0)
        self.assign(out_data[0], req[0], in_data[0] * 2)

    def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
        _ProbeProp.seen.append(("backward", out_grad[0] is None, mx.autograd.is_recording(),
                                torch.is_grad_enabled(), req))
        self.assign(in_grad[0], req[0], torch.full_like(in_data[0], 2.0))


@pytest.mark.parametrize("need_top_grad", [True, False])
def test_scopes_aux_and_need_top_grad(need_top_grad):
    """Recording is paused inside forward and backward; aux starts at zero
    on every call; with need_top_grad=False the backward gets no top
    gradient; every input's req is write."""
    _ProbeProp.seen.clear()
    x = torch.ones(3, requires_grad=True)
    flag = "1" if need_top_grad else "0"
    for _ in range(2):
        with mx.autograd.record():
            y = mx.nd.Custom(x, op_type="probe_scopes", need_top_grad=flag)
        mx.autograd.backward(y)
    assert _ProbeProp.seen == [("forward", True, False, False, 0.0),
                               ("backward", not need_top_grad, False, False, ["write"])] * 2
    torch.testing.assert_close(x.grad, torch.full((3,), 4.0))
    _ProbeProp.seen.clear()
    y = mx.nd.Custom(x, op_type="probe_scopes")  # off the tape: no graph
    assert y.grad_fn is None and _ProbeProp.seen == [("forward", False, False, False, 0.0)]
