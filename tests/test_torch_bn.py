"""The port's BatchNorm kernels (``incubator_mxnet_torch/ops/bn.py``) against
the JAX package's ``ops/pallas_bn.py`` on the CPU.

On the CPU the port's wrappers take the kernels' plain versions; the JAX
package's Pallas kernels run with ``interpret=True``, as
``tests/test_pallas_bn.py`` runs them, and its trainable BatchNorm is
reached through ``ops.nn.batch_norm`` under ``MXNET_TPU_PALLAS_BN=interpret``
(set on the JAX side only; the port has no such switch).  The shapes are
those of ``test_pallas_bn.py``: odd H·W (33, 5x9) and C = 12, which is not a
multiple of the JAX kernels' channel block of 8.  The CUDA kernels
themselves are held against the plain versions by the ``cuda`` tests below
(skipped without a card) and by ``chip_smoke.py``.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from incubator_mxnet_tpu.ops import nn as jnn
from incubator_mxnet_tpu.ops import pallas_bn
from incubator_mxnet_torch.ops import bn
from incubator_mxnet_torch.ops import nn as tnn

# fp32: the same formula on both sides, summed in another order; sums of at
# most a few hundred terms of |x| ~ 2 agree to ~1e-6 relative.
FP32_TOL = dict(rtol=1e-5, atol=1e-5)
# Gradients through the recomputed formula: the same fp32 algebra, another
# summation order, through rsqrt and the E[x²] − E[x]² cancellation.
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
ROWS = [(2, 8, 33), (3, 12, 45), (5, 6, 33)]


def _np(shape, seed, offset=0.5):
    rng = np.random.RandomState(seed)
    return (2 * rng.randn(*shape) + offset).astype(np.float32)


def _bf16_ulp(a):
    """Spacing of bf16 values at |a| (8 significant bits)."""
    return np.ldexp(1.0, np.frexp(np.abs(a))[1] - 8)


@pytest.mark.parametrize("shape", ROWS)
def test_bn_stats_plain_matches_pallas(shape):
    x = _np(shape, 0)
    want = np.asarray(pallas_bn.bn_stats(jnp.asarray(x), interpret=True))
    got = bn.bn_stats(torch.from_numpy(x.copy()))
    assert got.dtype == torch.float32 and tuple(got.shape) == (shape[1], 2)
    np.testing.assert_allclose(got.numpy(), want, **FP32_TOL)


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("with_res", [False, True])
@pytest.mark.parametrize("shape", ROWS[:2])
def test_bn_apply_plain_matches_pallas_fp32(shape, relu, with_res):
    x, res = _np(shape, 1), _np(shape, 2)
    rng = np.random.RandomState(3)
    scale = (rng.rand(shape[1]) + 0.5).astype(np.float32)
    shift = rng.randn(shape[1]).astype(np.float32)
    want = pallas_bn.bn_apply(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(shift),
                              residual=jnp.asarray(res) if with_res else None, relu=relu,
                              interpret=True)
    got = bn.bn_apply(torch.from_numpy(x.copy()), torch.from_numpy(scale),
                      torch.from_numpy(shift),
                      residual=torch.from_numpy(res.copy()) if with_res else None, relu=relu)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("relu", [False, True])
def test_bn_apply_res_bf16_within_one_ulp(relu):
    """bf16 x and residual, fp32 math, one rounding to bf16 on each side: the
    fp32 values may differ in their last bit (a fused multiply-add on one
    side), which can move the rounded output by one bf16 ulp."""
    shape = (3, 12, 45)
    x = jnp.asarray(_np(shape, 4)).astype(jnp.bfloat16)
    res = jnp.asarray(_np(shape, 5)).astype(jnp.bfloat16)
    scale = jnp.asarray(np.linspace(0.5, 1.5, 12).astype(np.float32))
    shift = jnp.asarray(np.linspace(-1, 1, 12).astype(np.float32))
    want = np.asarray(pallas_bn.bn_apply(x, scale, shift, residual=res, relu=relu,
                                         interpret=True).astype(jnp.float32))
    tx = torch.from_numpy(np.array(x.astype(jnp.float32))).bfloat16()
    tres = torch.from_numpy(np.array(res.astype(jnp.float32))).bfloat16()
    got = bn.bn_apply_res(tx, torch.from_numpy(np.array(scale)),
                          torch.from_numpy(np.array(shift)), tres, relu=relu)
    assert got.dtype == torch.bfloat16
    err = np.abs(got.float().numpy() - want)
    assert (err <= _bf16_ulp(want) + 1e-6).all(), err.max()


@pytest.mark.parametrize("shape", [(2, 8, 3, 11), (3, 12, 5, 9), (4, 6, 7, 7)])
def test_fused_bn_relu_matches_pallas(shape):
    x = _np(shape, 6)
    rng = np.random.RandomState(7)
    g = (rng.rand(shape[1]) + 0.5).astype(np.float32)
    b = rng.randn(shape[1]).astype(np.float32)
    out, mean, var = pallas_bn.fused_bn_relu(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b),
                                             interpret=True)
    tout, tmean, tvar = bn.fused_bn_relu(torch.from_numpy(x.copy()), torch.from_numpy(g),
                                         torch.from_numpy(b))
    np.testing.assert_allclose(tmean.numpy(), np.asarray(mean), **FP32_TOL)
    np.testing.assert_allclose(tvar.numpy(), np.asarray(var), **FP32_TOL)
    np.testing.assert_allclose(tout.numpy(), np.asarray(out), rtol=1e-4, atol=1e-4)


def test_fused_bn_relu_residual_bf16_matches_pallas():
    shape = (2, 8, 14, 14)
    x = jnp.asarray(_np(shape, 8)).astype(jnp.bfloat16)
    res = jnp.asarray(_np(shape, 9)).astype(jnp.bfloat16)
    g, b = jnp.ones(8, jnp.float32), jnp.zeros(8, jnp.float32)
    out, mean, _ = pallas_bn.fused_bn_relu(x, g, b, residual=res, interpret=True)
    tx = torch.from_numpy(np.array(x.astype(jnp.float32))).bfloat16()
    tres = torch.from_numpy(np.array(res.astype(jnp.float32))).bfloat16()
    tout, tmean, _ = bn.fused_bn_relu(tx, torch.ones(8), torch.zeros(8), residual=tres)
    assert tout.dtype == torch.bfloat16 and tmean.dtype == torch.float32
    np.testing.assert_allclose(tmean.numpy(), np.asarray(mean), **FP32_TOL)
    want = np.asarray(out.astype(jnp.float32))
    # the fp32 scale and shift differ in their last bits between the two
    # sides, which can move a rounded output by one bf16 ulp
    err = np.abs(tout.float().numpy() - want)
    assert (err <= _bf16_ulp(want) + 1e-6).all(), err.max()


def test_trainable_batch_norm_values_and_grads(monkeypatch):
    """Values and the gradients of x, gamma and beta through
    sum(sin(out)) + sum(mean) + sum(var), against the JAX package's
    trainable BatchNorm (Pallas forward in interpret mode, reference vjp)."""
    monkeypatch.setenv("MXNET_TPU_PALLAS_BN", "interpret")
    rng = np.random.RandomState(10)
    x = (rng.randn(3, 12, 5, 9) * 1.5 + 0.3).astype(np.float32)
    g = (rng.rand(12) + 0.5).astype(np.float32)
    b = rng.randn(12).astype(np.float32)
    mm, mv = jnp.zeros(12), jnp.ones(12)

    def jloss(x, g, b):
        out, mean, var = jnn.batch_norm(x, g, b, mm, mv, fix_gamma=False)
        return jnp.sum(jnp.sin(out)) + jnp.sum(mean) + jnp.sum(var)

    jv, jg = jax.value_and_grad(jloss, argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(g),
                                                          jnp.asarray(b))
    tx, tg, tb = (torch.from_numpy(a.copy()).requires_grad_() for a in (x, g, b))
    out, mean, var = bn.trainable_batch_norm(tx, tg, tb)
    loss = torch.sin(out).sum() + mean.sum() + var.sum()
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jv), rtol=1e-5)
    for got, want in zip((tx.grad, tg.grad, tb.grad), jg):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **GRAD_TOL)


def test_trainable_batch_norm_gradient_of_x_only():
    """A fixed gamma (``fix_gamma``) and beta without gradients: only x's
    gradient is formed, and it equals the reference formula's."""
    rng = np.random.RandomState(11)
    x = torch.from_numpy(rng.randn(2, 4, 3, 5).astype(np.float32)).requires_grad_()
    g, b = torch.ones(4), torch.zeros(4)
    out, _, _ = bn.trainable_batch_norm(x, g, b)
    (gx,) = torch.autograd.grad((out * out).sum(), x)
    x2 = x.detach().requires_grad_()
    ref, _, _ = bn.batch_norm_reference(x2, g, b)
    (rx,) = torch.autograd.grad((ref * ref).sum(), x2)
    torch.testing.assert_close(gx, rx, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("case", ["train_4d", "global_stats_4d", "train_2d"])
def test_op_batch_norm_matches_jax(case):
    """The ``BatchNorm`` op: the train-mode 4-D route (the kernels' plain
    versions here) and the reference branch, against the JAX package's
    reference ``ops.nn.batch_norm``."""
    shape = (6, 5) if case == "train_2d" else (3, 5, 4, 6)
    x = _np(shape, 12)
    rng = np.random.RandomState(13)
    g, b = (rng.rand(5) + 0.5).astype(np.float32), rng.randn(5).astype(np.float32)
    mm, mv = rng.randn(5).astype(np.float32), (rng.rand(5) + 0.5).astype(np.float32)
    use_global = case == "global_stats_4d"
    want = jnn.batch_norm(*(jnp.asarray(a) for a in (x, g, b, mm, mv)), fix_gamma=False,
                          use_global_stats=use_global)
    before = tnn.batch_norm.reference_calls
    got = tnn.batch_norm(*(torch.from_numpy(a.copy()) for a in (x, g, b, mm, mv)),
                         fix_gamma=False, use_global_stats=use_global)
    assert tnn.batch_norm.reference_calls - before == (0 if case == "train_4d" else 1)
    for t, j in zip(got, want):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("bad,match", [
    (lambda: torch.zeros(2, 3, 4, dtype=torch.float64), "dtype"),
    (lambda: torch.zeros(2, 3, 4, 5), "3-D"),
    (lambda: torch.zeros(2, 4, 3).transpose(1, 2), "unit stride"),
])
def test_operand_checks_raise(bad, match):
    """What the CUDA wrappers refuse, checked before any launch."""
    with pytest.raises(ValueError, match=match):
        bn._check_x("bn_stats", bad())


def test_channel_vector_and_residual_checks_raise():
    x = torch.zeros(2, 3, 4)
    with pytest.raises(ValueError, match="scale"):
        bn._check_channel_vector("bn_apply", "scale", torch.zeros(3, dtype=torch.float16), x)
    with pytest.raises(ValueError, match="shift"):
        bn._check_channel_vector("bn_apply", "shift", torch.zeros(4), x)


def test_no_other_device_falls_back():
    """Only CPU and CUDA tensors are computed on; any other device raises.
    A meta tensor (shape inference: it holds no data) gets the plain
    version's shapes and dtypes, and launches nothing."""

    class OtherDevice:  # a tensor of a device with no backend in this build
        device = torch.device("xpu")
        shape = (2, 3, 4)

    x = OtherDevice()
    with pytest.raises(ValueError, match="CPU or CUDA"):
        bn.bn_stats(x)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        bn.bn_apply(x, torch.ones(3), torch.zeros(3))
    launches = bn.bn_stats.launches, bn.bn_apply.launches
    m = torch.zeros(2, 3, 4, device="meta", dtype=torch.bfloat16)
    stats = bn.bn_stats(m)
    out = bn.bn_apply(m, torch.ones(3, device="meta"), torch.zeros(3, device="meta"))
    assert stats.device.type == "meta" and stats.shape == (3, 2) and stats.dtype == torch.float32
    assert out.device.type == "meta" and out.shape == m.shape and out.dtype == m.dtype
    assert (bn.bn_stats.launches, bn.bn_apply.launches) == launches


def test_stats_slabs_fill_the_card():
    """The stem (C = 64) splits N so that the grid has ~2000 blocks; wide
    layers need no split."""
    assert bn._stats_slabs(256, 64, 12544, 2) * 64 >= 1056
    assert bn._stats_slabs(256, 2048, 49, 2) <= 2
    assert bn._stats_slabs(1, 64, 3136, 2) == 1


# -- on the card -----------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(256, 64, 3136), (64, 2048, 49), (8, 12, 33)])
def test_kernels_match_plain_on_card(cuda_device, shape):
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    x = (2 * torch.randn(shape, generator=gen, device=cuda_device) + 0.5).bfloat16()
    res = torch.randn(shape, generator=gen, device=cuda_device).bfloat16()
    scale = torch.rand(shape[1], generator=gen, device=cuda_device) + 0.5
    shift = torch.randn(shape[1], generator=gen, device=cuda_device)
    stats = bn.bn_stats(x)
    assert torch.equal(stats, bn.bn_stats(x))  # deterministic
    ref = bn.bn_stats_plain(x)
    abs_sum = x.float().abs().sum(dim=(0, 2))
    assert ((stats[:, 0] - ref[:, 0]).abs() <= 1e-5 * abs_sum).all()
    assert ((stats[:, 1] - ref[:, 1]).abs() <= 1e-5 * ref[:, 1]).all()
    # one bf16 ulp of the result plus two fp32 roundings of the largest term
    # (the kernel's fused multiply-add against a rounded product)
    terms = (x.float() * scale[None, :, None]).abs() + shift.abs()[None, :, None]
    for r in (None, res):
        for relu in (False, True):
            got = bn.bn_apply(x, scale, shift, residual=r, relu=relu).float()
            want = bn.bn_apply_plain(x, scale, shift, r, relu).float()
            ulp = torch.ldexp(torch.ones_like(want), torch.frexp(want.abs())[1] - 8)
            big = terms if r is None else terms + r.float().abs()
            assert ((got - want).abs() <= ulp + 2.0 ** -22 * big).all()


@pytest.mark.cuda
def test_trainable_batch_norm_on_card(cuda_device):
    torch.backends.cudnn.allow_tf32 = False
    x = torch.randn(4, 8, 5, 7, device=cuda_device, requires_grad=True)
    g = torch.rand(8, device=cuda_device, requires_grad=True)
    b = torch.randn(8, device=cuda_device, requires_grad=True)
    launches = bn.bn_stats.launches, bn.bn_apply.launches
    out, mean, var = bn.trainable_batch_norm(x, g, b)
    assert (bn.bn_stats.launches, bn.bn_apply.launches) == (launches[0] + 1, launches[1] + 1)
    (torch.sin(out).sum() + mean.sum() + var.sum()).backward()
    xc, gc, bc = (t.detach().cpu().requires_grad_() for t in (x, g, b))
    ro, rm, rv = bn.batch_norm_reference(xc, gc, bc)
    (torch.sin(ro).sum() + rm.sum() + rv.sum()).backward()
    for got, want in ((out, ro), (x.grad, xc.grad), (g.grad, gc.grad), (b.grad, bc.grad)):
        torch.testing.assert_close(got.detach().cpu(), want.detach(), rtol=1e-4, atol=1e-5)
