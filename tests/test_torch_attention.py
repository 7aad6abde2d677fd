"""The PyTorch port's attention against the JAX package, on the CPU.

Both packages get the same numpy inputs from a seed.  On the CPU the
port's ``flash_fwd`` takes its plain version; it is held against the JAX
``attention_reference`` and against the JAX Pallas kernel run in interpret
mode (``MXNET_TPU_FLASH=interpret``), which is how the JAX package's own
tests run the kernel on the CPU.  The CUDA kernel itself is compared with
the plain version on the card by ``chip_smoke.py`` and by the ``cuda``
tests below, which skip here.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from incubator_mxnet_tpu.ops import attention as jatt
from incubator_mxnet_torch.ops import attention as tatt

# fp32: both sides compute in fp32 (JAX at "highest" matmul precision);
# only the summation order differs.
FP32_TOL = 2e-5
# bf16 against the JAX reference: identical dtype policy (fp32 scores and
# softmax, p rounded to bf16, fp32 accumulation), so o differs by at most
# one bf16 rounding of |o| < 2: 2**-7.
BF16_REF_TOL = 1e-2
# bf16 against the Pallas kernel: the kernel rounds the unnormalized p to
# bf16 and divides at the end, the reference rounds the normalized p: a few
# bf16 ulps of |o| < 2.
BF16_KERNEL_TOL = 2e-2

CASES = [  # name, B, H, Sq, Sk, Dh, causal
    ("s128", 2, 2, 128, 128, 32, False),
    ("s128_causal", 2, 2, 128, 128, 32, True),
    ("unaligned_s200_causal", 1, 2, 200, 200, 16, True),
    ("unaligned_s200", 1, 2, 200, 200, 16, False),
    ("cross_sq64_sk128", 2, 2, 64, 128, 16, False),
    ("cross_sq64_sk128_causal", 2, 2, 64, 128, 16, True),
]


def _qkv(seed, b, h, sq, sk, d):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, h, sq, d).astype(np.float32), rng.randn(b, h, sk, d).astype(np.float32),
            rng.randn(b, h, sk, d).astype(np.float32))


def _port(arrs, dtype=torch.float32):
    return [torch.from_numpy(a).to(dtype) for a in arrs]


def _np(x):
    return np.asarray(x.float().numpy() if isinstance(x, torch.Tensor) else jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("name,b,h,sq,sk,d,causal", CASES, ids=[c[0] for c in CASES])
def test_flash_fp32_matches_jax_reference(name, b, h, sq, sk, d, causal):
    arrs = _qkv(0, b, h, sq, sk, d)
    ref = jatt.attention_reference(*map(jnp.asarray, arrs), causal=causal)
    out = tatt.flash_attention(*_port(arrs), causal=causal)
    np.testing.assert_allclose(_np(out), _np(ref), rtol=FP32_TOL, atol=FP32_TOL)


@pytest.mark.parametrize("name,b,h,sq,sk,d,causal", CASES, ids=[c[0] for c in CASES])
def test_flash_fp32_matches_pallas_interpret(name, b, h, sq, sk, d, causal, monkeypatch):
    monkeypatch.setenv("MXNET_TPU_FLASH", "interpret")
    arrs = _qkv(1, b, h, sq, sk, d)
    ref = jatt.flash_attention(*map(jnp.asarray, arrs), causal=causal)
    out = tatt.flash_attention(*_port(arrs), causal=causal)
    np.testing.assert_allclose(_np(out), _np(ref), rtol=FP32_TOL, atol=FP32_TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_bf16_matches_jax(causal, monkeypatch):
    arrs = _qkv(2, 2, 2, 128, 128, 32)
    jq = [jnp.asarray(a).astype(jnp.bfloat16) for a in arrs]
    out = tatt.flash_attention(*_port(arrs, torch.bfloat16), causal=causal)
    assert out.dtype == torch.bfloat16
    ref = jatt.attention_reference(*jq, causal=causal)
    np.testing.assert_allclose(_np(out), _np(ref), rtol=0, atol=BF16_REF_TOL)
    monkeypatch.setenv("MXNET_TPU_FLASH", "interpret")
    kern = jatt.flash_attention(*jq, causal=causal)
    np.testing.assert_allclose(_np(out), _np(kern), rtol=0, atol=BF16_KERNEL_TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_lse_matches_pallas_kernel(causal):
    b, h, s, d = 2, 2, 128, 32
    arrs = _qkv(3, b, h, s, s, d)
    scale = 1.0 / np.sqrt(d)
    flat = [jnp.asarray(a.reshape(b * h, s, d)) for a in arrs]
    _, jlse = jatt._flash_fwd_pallas(*flat, causal, scale, True, with_lse=True)
    o, lse = tatt.flash_fwd(*_port(arrs), causal=causal, with_lse=True)
    assert lse.shape == (b * h, s) and lse.dtype == torch.float32
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse)[..., 0], rtol=FP32_TOL, atol=FP32_TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_fused_qkv_attention_matches_jax(causal):
    """test_transformer.py's shapes: [B, S, 3·H·Dh] straight from the QKV
    projection."""
    b, s, h, dh = 2, 32, 4, 16
    qkv = np.random.RandomState(4).randn(b, s, 3 * h * dh).astype(np.float32)
    ref = jatt.fused_qkv_attention(jnp.asarray(qkv), num_heads=h, causal=causal)
    out = tatt.fused_qkv_attention(torch.from_numpy(qkv), num_heads=h, causal=causal)
    assert out.shape == (b, s, h * dh)
    np.testing.assert_allclose(_np(out), _np(ref), rtol=FP32_TOL, atol=FP32_TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_fused_kv_attention_matches_jax(causal):
    b, sq, sk, h, dh = 2, 8, 16, 2, 8
    rng = np.random.RandomState(5)
    q = rng.randn(b, sq, h * dh).astype(np.float32)
    kv = rng.randn(b, sk, 2 * h * dh).astype(np.float32)
    ref = jatt.fused_kv_attention(jnp.asarray(q), jnp.asarray(kv), num_heads=h, causal=causal)
    out = tatt.fused_kv_attention(torch.from_numpy(q), torch.from_numpy(kv), num_heads=h,
                                  causal=causal)
    np.testing.assert_allclose(_np(out), _np(ref), rtol=FP32_TOL, atol=FP32_TOL)


def test_fused_attention_matches_jax():
    b, s, d, h = 2, 16, 32, 4
    rng = np.random.RandomState(6)
    q, k, v = (rng.randn(b, s, d).astype(np.float32) for _ in range(3))
    ref = jatt.fused_attention(*map(jnp.asarray, (q, k, v)), num_heads=h)
    out = tatt.fused_attention(*map(torch.from_numpy, (q, k, v)), num_heads=h)
    np.testing.assert_allclose(_np(out), _np(ref), rtol=FP32_TOL, atol=FP32_TOL)


def test_bshd_reference_matches_jax():
    rng = np.random.RandomState(7)
    q, k, v = (rng.randn(2, 24, 3, 16).astype(np.float32) for _ in range(3))
    ref = jatt.attention_reference_bshd(*map(jnp.asarray, (q, k, v)), causal=True)
    out = tatt.attention_reference_bshd(*map(torch.from_numpy, (q, k, v)), causal=True)
    np.testing.assert_allclose(_np(out), _np(ref), rtol=FP32_TOL, atol=FP32_TOL)


def test_cpu_gradients_match_jax():
    """On the CPU the autograd Function runs the plain forward and backward;
    its gradients agree with JAX's (tolerance of test_transformer.py)."""
    arrs = _qkv(8, 2, 2, 64, 64, 16)
    g_ref = jax.grad(lambda q, k, v: (jatt.attention_reference(q, k, v, causal=True) ** 2).sum(),
                     argnums=(0, 1, 2))(*map(jnp.asarray, arrs))
    ts = [t.requires_grad_() for t in _port(arrs)]
    (tatt.flash_attention(*ts, causal=True) ** 2).sum().backward()
    for t, g in zip(ts, g_ref):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), rtol=2e-4, atol=2e-5)


def test_fully_masked_rows_give_zero():
    """A row that sees no key: o = 0 and lse = 0 (the JAX kernel's rule)."""
    q = torch.randn(1, 1, 4, 16)
    k = torch.randn(1, 1, 0, 16)
    o, lse = tatt.flash_fwd(q, k, k, with_lse=True)
    assert torch.equal(o, torch.zeros_like(o)) and torch.equal(lse, torch.zeros(1, 4))


def test_cpu_path_launches_nothing():
    before = tatt.flash_fwd.launches
    arrs = _port(_qkv(9, 1, 2, 32, 32, 16))
    tatt.flash_fwd(*arrs)
    tatt.flash_fwd(*(a.transpose(1, 2) for a in arrs), layout="bshd")
    assert tatt.flash_fwd.launches == before
    with pytest.raises(ValueError, match="layout"):
        tatt.flash_fwd(*arrs, layout="sbhd")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [False, True])
def test_kernel_matches_plain_on_card(cuda_device, causal):
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    x = torch.randn(2, 200, 3, 4, 64, generator=gen, device=cuda_device).to(torch.bfloat16)
    q, k, v = x[:, :, 0], x[:, :, 1], x[:, :, 2]
    before = tatt.flash_fwd.launches
    o, lse = tatt.flash_fwd(q, k, v, causal=causal, with_lse=True, layout="bshd")
    assert tatt.flash_fwd.launches == before + 1
    t = lambda a: a.transpose(1, 2)  # noqa: E731
    o_ref, lse_ref = tatt.flash_fwd_plain(t(q), t(k), t(v), causal, with_lse=True)
    assert (t(o).float() - o_ref.float()).abs().max().item() <= BF16_KERNEL_TOL
    assert (lse - lse_ref).abs().max().item() <= 1e-4


@pytest.mark.cuda
def test_kernel_gradients_on_card(cuda_device):
    """On the card, autograd through flash_attention runs the forward with
    lse and both backward kernels (tests/test_torch_flash_bwd.py holds
    their values to the plain version)."""
    q = torch.randn(1, 2, 64, 32, device=cuda_device, requires_grad=True)
    before = (tatt.flash_fwd.launches, tatt.flash_bwd_dq.launches, tatt.flash_bwd_dkv.launches)
    tatt.flash_attention(q, q, q).sum().backward()
    assert q.grad.shape == q.shape and torch.isfinite(q.grad).all()
    assert (tatt.flash_fwd.launches, tatt.flash_bwd_dq.launches,
            tatt.flash_bwd_dkv.launches) == tuple(n + 1 for n in before)
