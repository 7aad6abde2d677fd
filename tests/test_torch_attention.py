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


# Head dims the kernels have no instance for: the wrapper zero-pads q, k
# and v to the next one (8 -> 16, 48 -> 64, 80 and 96 -> 128) and
# passes the scale of the true head dim; zero columns add nothing to q·kᵀ,
# so the sliced o is the same function.
PAD_DIMS = (8, 48, 80, 96)


@pytest.mark.parametrize("d", PAD_DIMS)
@pytest.mark.parametrize("causal", [False, True])
def test_padded_head_dim_matches_jax_reference(d, causal):
    arrs = _qkv(10, 2, 2, 40, 56, d)
    ref = jatt.attention_reference(*map(jnp.asarray, arrs), causal=causal)
    q, k, v = _port(arrs)
    width = tatt._kernel_width("flash_fwd", q, k, v)
    assert width in tatt._HEAD_DIMS and width >= d and (width == 16 or width // 2 < d)
    qp, kp, vp = tatt._kernel_operands(width, False, q, k, v)
    assert qp.shape[-1] == width and torch.equal(qp[..., d:], torch.zeros_like(qp[..., d:]))
    o, _ = tatt.flash_fwd_plain(qp, kp, vp, causal, 1.0 / np.sqrt(d))
    np.testing.assert_allclose(_np(o[..., :d]), _np(ref), rtol=FP32_TOL, atol=FP32_TOL)


def test_head_dim_above_128_is_refused():
    q = torch.zeros(1, 1, 4, 256)
    with pytest.raises(ValueError, match="head dim 256"):
        tatt._kernel_width("flash_fwd", q, q, q)
    with pytest.raises(ValueError, match="equal"):
        tatt._kernel_width("flash_fwd", q, q[..., :128], q)


@pytest.mark.parametrize("layout", ["bhsd", "bshd"])
def test_sequence_stride0_operand_becomes_contiguous(layout):
    """TMA reads rows in boxes: a 16-bit operand repeating one row along
    its sequence is handed to the kernels contiguous, with the same
    values; strides of 0 over batch or heads stay as they are (the tensor
    maps read them at coordinate 0), and fp32 operands are not copied."""
    bshd = layout == "bshd"
    row = torch.randn(2, 1, 3, 16) if bshd else torch.randn(2, 3, 1, 16)
    shape = (2, 40, 3, 16) if bshd else (2, 3, 40, 16)
    rep = row.to(torch.bfloat16).expand(shape)
    got = tatt._rows_readable(rep, bshd)
    assert got.is_contiguous() and torch.equal(got, rep)
    heads = torch.randn(2, 1, 40, 16).to(torch.bfloat16).expand(2, 3, 40, 16)
    assert tatt._rows_readable(heads, False) is heads
    (q,) = tatt._kernel_operands(16, bshd, rep)
    assert q.is_contiguous() and torch.equal(q, rep)
    (q32,) = tatt._kernel_operands(16, bshd, row.expand(shape))
    assert q32.stride(1 if bshd else 2) == 0
    o, _ = tatt.flash_fwd_plain(*(x.float() for x in (rep, rep, rep)))
    o_ref, _ = tatt.flash_fwd_plain(*(x.float() for x in (got, got, got)))
    torch.testing.assert_close(o, o_ref)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA CUDA card")
    return torch.device("cuda", 0)


# name, B, H, Sq, Sk, Dh, dtype, causal, layout ("qkv": the [B, S, 3, H, Dh]
# projection view).  Beside the path's own shapes, the 16-bit kernel's
# persistent schedule: more 128-row work items than the grid holds, a single
# item, fewer rows than a consumer warpgroup's 64, many K/V ring stages with
# a key tail, and each head dim's swizzle.
CARD_CASES = [
    ("qkv_s200", 2, 4, 200, 200, 64, torch.bfloat16, False, "qkv"),
    ("qkv_s200_causal", 2, 4, 200, 200, 64, torch.bfloat16, True, "qkv"),
    ("items_over_grid", 67, 12, 128, 128, 64, torch.bfloat16, False, "bhsd"),
    ("single_item", 1, 1, 128, 128, 64, torch.bfloat16, False, "bhsd"),
    ("sq40", 4, 12, 40, 40, 64, torch.bfloat16, False, "bhsd"),
    ("sk1000_causal", 2, 4, 1000, 1000, 64, torch.bfloat16, True, "bhsd"),
    ("seq512", 8, 12, 512, 512, 64, torch.bfloat16, False, "qkv"),
    ("cross_sq77_sk200", 4, 4, 77, 200, 64, torch.bfloat16, False, "bhsd"),
    ("fp16_dh16", 2, 4, 128, 128, 16, torch.float16, False, "bhsd"),
    ("dh32", 2, 4, 128, 128, 32, torch.bfloat16, False, "bhsd"),
    ("dh128_causal", 2, 4, 200, 200, 128, torch.bfloat16, True, "bhsd"),
]


def _card_inputs(device, b, h, sq, sk, d, dtype, layout):
    gen = torch.Generator(device=device).manual_seed(0)
    if layout == "qkv":
        x = torch.randn(b, sq, 3, h, d, generator=gen, device=device).to(dtype)
        return x[:, :, 0], x[:, :, 1], x[:, :, 2], "bshd"
    q = torch.randn(b, h, sq, d, generator=gen, device=device).to(dtype)
    k, v = (torch.randn(b, h, sk, d, generator=gen, device=device).to(dtype) for _ in range(2))
    return q, k, v, "bhsd"


@pytest.mark.cuda
@pytest.mark.parametrize("name,b,h,sq,sk,d,dtype,causal,layout", CARD_CASES,
                         ids=[c[0] for c in CARD_CASES])
def test_kernel_matches_plain_on_card(cuda_device, name, b, h, sq, sk, d, dtype, causal, layout):
    q, k, v, layout = _card_inputs(cuda_device, b, h, sq, sk, d, dtype, layout)
    before = tatt.flash_fwd.launches
    o, lse = tatt.flash_fwd(q, k, v, causal=causal, with_lse=True, layout=layout)
    assert tatt.flash_fwd.launches == before + 1
    t = (lambda a: a.transpose(1, 2)) if layout == "bshd" else (lambda a: a)
    o_ref, lse_ref = tatt.flash_fwd_plain(t(q), t(k), t(v), causal, with_lse=True)
    assert (t(o).float() - o_ref.float()).abs().max().item() <= BF16_KERNEL_TOL
    assert (lse - lse_ref).abs().max().item() <= 1e-4


# A scale other than 1/sqrt(Dh), negative and zero too (the row max must be
# that of the scaled scores, masked keys must stay at -inf), over a causal
# tail; and k/v expanded over the batch or the heads (stride 0).
OPTION_CASES = [("scale_0.3", 0.3, None), ("scale_-0.3", -0.3, None), ("scale_0", 0.0, None),
                ("kv_expanded_over_batch", None, "b"), ("kv_expanded_over_heads", None, "h")]


@pytest.mark.cuda
@pytest.mark.parametrize("name,scale,expand", OPTION_CASES, ids=[c[0] for c in OPTION_CASES])
def test_kernel_options_on_card(cuda_device, name, scale, expand):
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    b, h, s, d = 2, 4, 200, 64
    kv = (1 if expand == "b" else b, 1 if expand == "h" else h, s, d)
    q = torch.randn(b, h, s, d, generator=gen, device=cuda_device).to(torch.bfloat16)
    k, v = (torch.randn(kv, generator=gen, device=cuda_device).to(torch.bfloat16)
            .expand(b, h, s, d) for _ in range(2))
    o, lse = tatt.flash_fwd(q, k, v, causal=True, scale=scale, with_lse=True)
    o_ref, lse_ref = tatt.flash_fwd_plain(q, k, v, True, scale, with_lse=True)
    assert (o.float() - o_ref.float()).abs().max().item() <= BF16_KERNEL_TOL
    assert (lse - lse_ref).abs().max().item() <= 1e-4


@pytest.mark.cuda
def test_kernel_refuses_repeated_sequence_on_card(cuda_device):
    """TMA reads rows in boxes and cannot repeat one: a k whose sequence
    stride is 0 is no longer refused but handed to the kernel contiguous,
    with one launch and the plain version's result."""
    q = torch.randn(2, 4, 128, 64, device=cuda_device).to(torch.bfloat16)
    k = q[:, :, :1].expand(q.shape)
    before = tatt.flash_fwd.launches
    o, lse = tatt.flash_fwd(q, k, q, with_lse=True)
    assert tatt.flash_fwd.launches == before + 1
    o_ref, lse_ref = tatt.flash_fwd_plain(q, k, q, with_lse=True)
    assert (o.float() - o_ref.float()).abs().max().item() <= BF16_KERNEL_TOL
    assert (lse - lse_ref).abs().max().item() <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("d", [48, 80])
def test_kernel_takes_padded_head_dim_on_card(cuda_device, d):
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    q, k, v = (torch.randn(2, 4, 200, d, generator=gen, device=cuda_device).to(torch.bfloat16)
               for _ in range(3))
    o, lse = tatt.flash_fwd(q, k, v, causal=True, with_lse=True)
    assert o.shape == q.shape
    o_ref, lse_ref = tatt.flash_fwd_plain(q, k, v, True, with_lse=True)
    assert (o.float() - o_ref.float()).abs().max().item() <= BF16_KERNEL_TOL
    assert (lse - lse_ref).abs().max().item() <= 1e-4


@pytest.mark.cuda
def test_kernel_refuses_head_dim_above_128_on_card(cuda_device):
    q = torch.randn(1, 2, 64, 256, device=cuda_device).to(torch.bfloat16)
    before = tatt.flash_fwd.launches
    with pytest.raises(ValueError, match="head dim"):
        tatt.flash_fwd(q, q, q)
    assert tatt.flash_fwd.launches == before


@pytest.mark.cuda
def test_kernel_is_deterministic_on_card(cuda_device):
    """A static schedule with no atomics: two runs give the same bits."""
    q, k, v, layout = _card_inputs(cuda_device, 67, 12, 128, 128, 64, torch.bfloat16, "qkv")
    first, second = (tatt.flash_fwd(q, k, v, with_lse=True, layout=layout) for _ in range(2))
    assert torch.equal(first[0], second[0]) and torch.equal(first[1], second[1])


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
