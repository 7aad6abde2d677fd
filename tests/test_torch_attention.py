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
# and v to the next one and passes the scale of the true head dim; zero
# columns add nothing to q·kᵀ, so the sliced o is the same function.  In
# bf16 and fp16 that is the next 16-bit instance (8 -> 16, 48 -> 64, 80 and
# 96 -> 128, 160 and 200 -> 256; 256, the widest, runs as it is); in fp32,
# which runs on flash_wide.cu at every width, the next multiple of 64 (8 and
# 48 -> 64, 80 and 96 -> 128, 160 -> 192, 200 and 256 -> 256).
PAD_DIMS = (8, 48, 80, 96, 160, 200, 256)


@pytest.mark.parametrize("d", PAD_DIMS)
@pytest.mark.parametrize("causal", [False, True])
def test_padded_head_dim_matches_jax_reference(d, causal):
    arrs = _qkv(10, 2, 2, 40, 56, d)
    ref = jatt.attention_reference(*map(jnp.asarray, arrs), causal=causal)
    q, k, v = _port(arrs)
    half = tatt._kernel_width("flash_fwd", *(x.bfloat16() for x in (q, k, v)))
    assert half in tatt._HEAD_DIMS and half >= d and (half == 16 or half // 2 < d)
    wide = tatt._kernel_width("flash_fwd", q, k, v)
    assert wide % 64 == 0 and wide - 64 < d <= wide
    for width in (half, wide):
        qp, kp, vp = tatt._kernel_operands(width, False, q, k, v)
        assert qp.shape[-1] == width and torch.equal(qp[..., d:], torch.zeros_like(qp[..., d:]))
        o, _ = tatt.flash_fwd_plain(qp, kp, vp, causal, 1.0 / np.sqrt(d))
        np.testing.assert_allclose(_np(o[..., :d]), _np(ref), rtol=FP32_TOL, atol=FP32_TOL)


def test_head_dim_above_128_is_refused():
    """No head dim the JAX function takes is refused: above the widest
    instance of flash_fwd.cu (256) the head goes to flash_wide.cu, padded to
    a multiple of 64.  Only unequal head dims are refused."""
    q = torch.zeros(1, 1, 4, 320)
    assert tatt._kernel_width("flash_fwd", q, q, q) == 320
    assert tatt._kernel_width("flash_fwd", *(q[..., :300],) * 3) == 320
    assert tatt._kernel_width("flash_fwd", *(q[..., :257],) * 3) == 320
    with pytest.raises(ValueError, match="equal"):
        tatt._kernel_width("flash_fwd", q, q[..., :128], q)


@pytest.mark.parametrize("d", [300, 320, 384, 448, 512, 576, 640, 1024])
@pytest.mark.parametrize("causal", [False, True])
def test_wide_head_dim_matches_jax_reference(d, causal):
    """Above Dh 256 the card runs flash_wide.cu on operands padded to a
    multiple of 64 with the true head dim's scale (above 512 its streamed
    16-bit instances): the padded plain route against the JAX
    attention_reference (o) and _flash_bwd_xla (dq, dk, dv)."""
    arrs = _qkv(11, 2, 2, 40, 56, d)
    do = np.random.RandomState(12).randn(2, 2, 40, d).astype(np.float32)
    scale = 1.0 / np.sqrt(d)
    ref = jatt.attention_reference(*map(jnp.asarray, arrs), causal=causal)
    ref_grads = jatt._flash_bwd_xla(causal, scale, tuple(map(jnp.asarray, arrs)),
                                    jnp.asarray(do))
    q, k, v = _port(arrs)
    width = tatt._kernel_width("flash_fwd", q, k, v)
    assert width % 64 == 0 and width - 64 < d <= width
    qp, kp, vp = tatt._kernel_operands(width, False, q, k, v)
    o, lse = tatt.flash_fwd_plain(qp, kp, vp, causal, scale, with_lse=True)
    assert torch.equal(o[..., d:], torch.zeros_like(o[..., d:]))
    np.testing.assert_allclose(_np(o[..., :d]), _np(ref), rtol=FP32_TOL, atol=FP32_TOL)
    dop = tatt._kernel_operands(width, False, torch.from_numpy(do))[0]
    grads = tatt.flash_bwd_plain(qp, kp, vp, o, dop, lse, causal, scale)
    for g, r in zip(grads, ref_grads):
        assert torch.equal(g[..., d:], torch.zeros_like(g[..., d:]))
        np.testing.assert_allclose(_np(g[..., :d]), _np(r), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("d", [129, 160, 192, 200, 255, 256, 257, 512])
def test_kernel_width_up_to_256(d):
    """In 16 bits Dh 129-256 runs the 256 instance; above it, flash_wide.cu
    at the next multiple of 64 (257 -> 320, 512 -> 512), where the wrappers
    used to refuse.  fp32 runs flash_wide.cu at every width: the next
    multiple of 64 (160 -> 192)."""
    q = torch.zeros(1, 1, 4, d, dtype=torch.bfloat16)
    if d > 256:
        assert tatt._kernel_width("flash_bwd", q, q, q) == -(-d // 64) * 64
    else:
        assert tatt._kernel_width("flash_bwd", q, q, q) == 256
    q = q.float()
    assert tatt._kernel_width("flash_fwd", q, q, q) == -(-d // 64) * 64


@pytest.mark.parametrize("width,launches", [(16, 1), (32, 1), (64, 1), (128, 1), (256, 2)])
def test_launches_per_pass(width, launches):
    """The widest instance runs each pass as one launch per 128-column
    output slab; the counters count each."""
    assert tatt._launches(width) == launches


@pytest.mark.parametrize("width,dtype,launches", [
    (256, torch.bfloat16, 2), (64, torch.float32, 1), (192, torch.float32, 1),
    (256, torch.float32, 1), (512, torch.float32, 1)])
def test_backward_launches_per_pass_by_dtype(width, dtype, launches):
    """A pass in fp32 runs on flash_wide.cu at every width, one launch a
    pass (its slabs are blocks of that launch); a 16-bit one up to 256
    keeps flash_bwd.cu's launch a slab, which is also the count given no
    dtype."""
    assert tatt._launches(width, dtype) == launches
    assert tatt._launches(width) == (2 if width == 256 else 1)


@pytest.mark.parametrize("width,dtype,with_dq,launches", [
    (64, torch.bfloat16, False, 1), (256, torch.bfloat16, False, 2),
    (320, torch.bfloat16, False, 2), (512, torch.float16, False, 2),
    (512, torch.float32, False, 2), (576, torch.float32, False, 2),
    (64, torch.bfloat16, True, 1), (256, torch.bfloat16, True, 2),
    (320, torch.bfloat16, True, 1), (1024, torch.float16, True, 1),
    (512, torch.float32, True, 1), (64, torch.float32, False, 2),
    (192, torch.float32, False, 2), (64, torch.float32, True, 1),
    (256, torch.float32, True, 1)])
def test_dkv_launches_per_pass(width, dtype, with_dq, launches):
    """A backward call on flash_wide.cu (above Dh 256 in every dtype, and
    in fp32 at every width) launches its delta pass once, before its
    passes: a dk/dv pass alone counts two launches, the delta pass and its
    kernel, and beside a dq pass one (the dq pass counts the delta).  A
    16-bit call up to 256 runs flash_bwd.cu, with no delta pass."""
    assert tatt._dkv_launches(width, dtype, with_dq) == launches
    assert tatt._has_delta_pass(width, dtype) == (width > 256 or dtype == torch.float32)


@pytest.mark.parametrize("width,dtype,launches", [
    (64, torch.bfloat16, 1), (256, torch.float16, 2), (320, torch.bfloat16, 2),
    (576, torch.float16, 2), (1024, torch.bfloat16, 2), (512, torch.float32, 2),
    (64, torch.float32, 2), (128, torch.float32, 2), (256, torch.float32, 2)])
def test_dq_launches_per_pass(width, dtype, launches):
    """The dq pass counts its kernel's launches and, on flash_wide.cu
    (above Dh 256 in every dtype, in fp32 at every width), the call's one
    delta launch: at fp32 Dh 256 that is the delta launch and one dq
    launch, where flash_bwd.cu's CUDA-core pair took two slab launches."""
    assert tatt._dq_launches(width, dtype) == launches


@pytest.mark.parametrize("width", [64, 256, 320, 448, 640])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
def test_backward_call_launches_delta_once(width, dtype):
    """The counting rule of one backward call: the delta launch counts once
    whichever passes the call runs (on dq when it runs, else on dk/dv), so a
    call running both counts what the two single-pass calls count less one
    delta launch (three on flash_wide.cu, not four: above 256 in every
    dtype, and in fp32 at every width)."""
    delta = int(tatt._has_delta_pass(width, dtype))
    kernels = tatt._launches(width, dtype)
    pair = tatt._dq_launches(width, dtype) + tatt._dkv_launches(width, dtype, with_dq=True)
    alone = tatt._dq_launches(width, dtype) + tatt._dkv_launches(width, dtype)
    assert pair == 2 * kernels + delta and alone == pair + delta
    assert delta == (width > 256 or dtype == torch.float32)
    if delta:
        assert pair == 3


class _FakeEntry:
    """A C entry point as ctypes gives it, before its argtypes are set."""

    def __init__(self, name):
        self.name, self.argtypes, self.restype = name, None, None


@pytest.mark.parametrize("d", (16, 32, 48, 64, 80, 128, 160, 256, 320))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_fp32_backward_routes_to_flash_wide(d, dtype, monkeypatch):
    """Every fp32 backward, at every head dim the wrappers take, goes to
    flash_wide.cu's entry (``mx_flash_wide_bwd``, which takes the delta
    buffer) at the head dim padded to a multiple of 64, its operands with
    no repeated rows (TMA); a 16-bit backward up to 256 keeps flash_bwd.cu's
    entry and instance.  The counters stay those of the caller's head dim.
    Pure Python: the library is a stand-in."""
    libs = {name: type("Lib", (), {"mx_flash_bwd": _FakeEntry("mx_flash_bwd"),
                                   "mx_flash_wide_bwd": _FakeEntry("mx_flash_wide_bwd")})()
            for name in ("flash_bwd", "flash_wide")}
    monkeypatch.setattr(tatt._cuda, "load", lambda name: libs[name])
    q = torch.zeros(1, 2, 8, d, dtype=dtype)
    width = tatt._kernel_width("flash_bwd", q, q, q)
    fn = tatt._bwd_entry(width, dtype)
    if dtype == torch.float32 or d > 256:
        assert width == -(-d // 64) * 64
        assert fn.name == "mx_flash_wide_bwd" and len(fn.argtypes) == 20
    else:
        assert width == tatt._kernel_width("flash_fwd", q, q, q)
        assert width in tatt._HEAD_DIMS and fn.name == "mx_flash_bwd" and len(fn.argtypes) == 19
    tatt._check_cuda_operands("flash_bwd", *tatt._kernel_operands(width, False, q, q, q),
                              False)
    rep = q[:, :, :1].expand(q.shape)
    (got,) = tatt._kernel_operands(width, False, rep)
    assert got.is_contiguous() and torch.equal(got[..., :d], rep)
    want = ((tatt.flash_wide_bwd_dq, tatt.flash_wide_bwd_dkv) if d > 256
            else (tatt.flash_bwd_dq, tatt.flash_bwd_dkv))
    assert tatt._bwd_counters(d) == want


@pytest.mark.parametrize("d", (16, 32, 48, 64, 80, 128, 160, 192, 256, 320))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_fp32_forward_routes_to_flash_wide(d, dtype, monkeypatch):
    """Every fp32 forward, at every head dim, goes to flash_wide.cu's entry
    (``mx_flash_wide_fwd``, whose split-TF32 kernels read by TMA) at the
    head dim padded to a multiple of 64, its operands with no repeated
    rows; a 16-bit forward up to 256 keeps flash_fwd.cu's entry and
    instance.  The launches count on the wrapper of the caller's head dim
    (``flash_fwd`` up to 256, ``flash_wide_fwd`` above): one in fp32 at
    every width, two in 16 bits at 129-256.  Pure Python: the library is a
    stand-in."""
    libs = {name: type("Lib", (), {"mx_flash_fwd": _FakeEntry("mx_flash_fwd"),
                                   "mx_flash_wide_fwd": _FakeEntry("mx_flash_wide_fwd")})()
            for name in ("flash_fwd", "flash_wide")}
    monkeypatch.setattr(tatt._cuda, "load", lambda name: libs[name])
    q = torch.zeros(1, 2, 8, d, dtype=dtype)
    width = tatt._kernel_width("flash_fwd", q, q, q)
    fn = tatt._entry(width, dtype)
    assert len(fn.argtypes) == 15
    if dtype == torch.float32 or d > 256:
        assert width == -(-d // 64) * 64 and fn.name == "mx_flash_wide_fwd"
        assert tatt._launches(width, dtype) == 1
    else:
        assert width == next(w for w in tatt._HEAD_DIMS if w >= d) and fn.name == "mx_flash_fwd"
        assert tatt._launches(width, dtype) == (2 if width > 128 else 1)
    tatt._check_cuda_operands("flash_fwd", *tatt._kernel_operands(width, False, q, q, q), False)
    rep = torch.randn(1, 2, 1, d).to(dtype).expand(q.shape)
    (got,) = tatt._kernel_operands(width, False, rep)
    assert got.is_contiguous() and torch.equal(got[..., :d], rep)
    assert tatt._fwd_counter(d) is (tatt.flash_wide_fwd if d > 256 else tatt.flash_fwd)


@pytest.mark.parametrize("width", [16, 64, 128, 256, 320, 512])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_forward_launches_by_dtype(width, dtype):
    """Launches of one forward call at the instance ``width``: in fp32 one
    at every width (flash_wide.cu, whose slabs are blocks of one launch);
    in 16 bits two at 129-256 (flash_fwd.cu's launch a 128-column slab),
    else one; with no dtype, the 16-bit count."""
    want = 1 if dtype == torch.float32 or not 128 < width <= 256 else 2
    assert tatt._launches(width, dtype) == want
    assert tatt._launches(width) == (2 if 128 < width <= 256 else 1)


def _tf32(x, mode):
    """x with its fp32 mantissa cut to TF32's 10 bits: to nearest (ties
    away from zero, as cvt.rna) or by truncation (how the card's tensor
    core reads a raw fp32 word)."""
    bits = x.contiguous().view(torch.int32)
    if mode == "nearest":
        bits = bits + 0x1000
    return (bits & ~0x1FFF).view(torch.float32)


def _tf32_matmul(a, b, mode, split):
    """a·b on emulated tensor cores: TF32 operands (exact products in fp32)
    and fp32 sums.  ``split``: three products hi·hi′ + hi·lo′ + lo·hi′ with
    x = hi + lo, lo = x − hi cut to TF32 in turn (lo·lo′ dropped), as the
    fp32 wide kernels compute; else one product of the operands cut to TF32."""
    ah, bh = _tf32(a, mode), _tf32(b, mode)
    if not split:
        return ah @ bh
    al, bl = _tf32(a - ah, mode), _tf32(b - bh, mode)
    return (ah @ bl + al @ bh) + ah @ bh


def _emulated_attention(q, k, v, do, o_ref, mm, scale):
    """o, lse, dq, dk and dv with every product of flash_wide.cu's fp32
    kernels through ``mm``: the forward's q·kᵀ and p·v, the dq pass's q·kᵀ,
    do·vᵀ and ds·k, the dk/dv pass's k·qᵀ, v·doᵀ, pᵀ·do and dsᵀ·q; the
    softmax, exponentials and rowsums (delta) in fp32."""
    s = mm(q, k.transpose(-1, -2)) * scale
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    o = mm(p, v) / l
    lse = m + torch.log(l)
    delta = (do * o_ref).sum(-1, keepdim=True)
    ds = torch.exp(s - lse) * (mm(do, v.transpose(-1, -2)) - delta)  # as the dq pass forms it
    st = mm(k, q.transpose(-1, -2)) * scale  # sᵀ, as the dk/dv kernel reduces it
    pt = torch.exp(st - lse.transpose(-1, -2))
    dpt = mm(v, do.transpose(-1, -2))
    dst = pt * (dpt - delta.transpose(-1, -2))
    return (o, lse.reshape(-1, q.shape[-2]), mm(ds, k) * scale, mm(dst, q) * scale,
            mm(pt, do))


@pytest.mark.parametrize("d", [512, 320, 256, 128, 64, 48, 16])
@pytest.mark.parametrize("mode", ["nearest", "truncate"])
def test_split_tf32_keeps_the_fp32_bounds(d, mode):
    """The arithmetic of flash_wide.cu's fp32 kernels: with every product in
    split TF32, o and lse stay within chip_smoke.py's FP32_FWD_BOUND and
    LSE_BOUND of the fp32 plain version and dq, dk, dv within FP32_BWD_REL
    of their largest value, whether the card rounds or truncates to TF32;
    one TF32 product does not.  Every fp32 forward and backward runs these
    kernels, at every head dim, on operands zero-padded to a multiple of 64
    with the true head dim's scale (16 and 48 to 64), so the narrow and
    padded widths are held to the same bounds."""
    import chip_smoke

    rng = np.random.RandomState(11)
    q, k, v, do = (torch.from_numpy(rng.randn(1, 2, 128, d).astype(np.float32))
                   for _ in range(4))
    o_ref, lse_ref = tatt.flash_fwd_plain(q, k, v, with_lse=True)
    grads_ref = tatt.flash_bwd_plain(q, k, v, o_ref, do, lse_ref)
    width = -(-d // 64) * 64
    padded = tatt._kernel_operands(width, False, q, k, v, do, o_ref)

    def within(split):
        o, lse, *grads = _emulated_attention(
            *padded, lambda a, b: _tf32_matmul(a, b, mode, split), 1.0 / np.sqrt(d))
        o, grads = o[..., :d], [g[..., :d] for g in grads]
        return [(o - o_ref).abs().max().item() <= chip_smoke.FP32_FWD_BOUND,
                (lse - lse_ref).abs().max().item() <= chip_smoke.LSE_BOUND,
                *((g - r).abs().max().item() <= chip_smoke.FP32_BWD_REL * r.abs().max().item()
                  for g, r in zip(grads, grads_ref))]

    assert all(within(split=True))
    one = within(split=False)
    assert not one[0] and not one[1] and not any(one[2:])


@pytest.mark.parametrize("d,dtype", [
    (512, torch.bfloat16), (576, torch.bfloat16), (1024, torch.float16), (576, torch.float32)])
def test_wide_16bit_head_above_512_is_taken(d, dtype):
    """flash_wide.cu takes every multiple of 64 above 256 in each dtype:
    above 512 its 16-bit kernels stream k and v through their rings and
    make each slab of the outputs a work item.  A head dim that is not a
    multiple of 64 there is the wrappers' to pad, and the check refuses it."""
    q = torch.zeros(1, 2, 8, d, dtype=dtype)
    tatt._check_cuda_operands("flash_fwd", q, q, q, False)
    with pytest.raises(ValueError, match="multiple of 64"):
        tatt._check_cuda_operands("flash_fwd", *(q[..., :d - 8],) * 3, False)


@pytest.mark.parametrize("layout", ["bhsd", "bshd"])
def test_sequence_stride0_operand_becomes_contiguous(layout):
    """TMA reads rows in boxes: an operand repeating one row along its
    sequence is handed to the kernels contiguous, with the same values;
    strides of 0 over batch or heads stay as they are (the tensor maps read
    them at coordinate 0).  Every kernel reads by TMA, fp32 ones too
    (flash_wide.cu at every width, forward and backward), so an fp32
    operand is copied as a 16-bit one is."""
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
    (q32,) = tatt._kernel_operands(64, bshd, row.expand(shape))
    assert q32.is_contiguous() and torch.equal(q32[..., :16], row.expand(shape))
    o, _ = tatt.flash_fwd_plain(*(x.float() for x in (rep, rep, rep)))
    o_ref, _ = tatt.flash_fwd_plain(*(x.float() for x in (got, got, got)))
    torch.testing.assert_close(o, o_ref)


@pytest.mark.parametrize("layout", ["bhsd", "bshd"])
def test_wide_fp32_operand_with_repeated_rows_becomes_contiguous(layout):
    """The fp32 kernels read rows by TMA: an fp32 operand repeating one row
    along its sequence goes to them contiguous, with the same values, above
    Dh 256 and at a narrow width alike (flash_wide.cu runs every fp32 pass,
    forward and backward)."""
    bshd = layout == "bshd"
    row = torch.randn(1, 1, 2, 320) if bshd else torch.randn(1, 2, 1, 320)
    rep = row.expand((1, 30, 2, 320) if bshd else (1, 2, 30, 320))
    (q,) = tatt._kernel_operands(320, bshd, rep)
    assert q.is_contiguous() and torch.equal(q, rep)
    (q,) = tatt._kernel_operands(512, bshd, rep)
    assert q.is_contiguous() and q.shape[-1] == 512 and torch.equal(q[..., :320], rep)
    (narrow,) = tatt._kernel_operands(64, bshd, rep[..., :64])
    assert narrow.is_contiguous() and torch.equal(narrow, rep[..., :64])


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
@pytest.mark.parametrize("d", [48, 80, 160, 256])
def test_kernel_takes_padded_head_dim_on_card(cuda_device, d):
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    q, k, v = (torch.randn(2, 4, 200, d, generator=gen, device=cuda_device).to(torch.bfloat16)
               for _ in range(3))
    before = tatt.flash_fwd.launches
    o, lse = tatt.flash_fwd(q, k, v, causal=True, with_lse=True)
    assert tatt.flash_fwd.launches == before + (2 if d > 128 else 1)  # a launch a slab
    assert o.shape == q.shape
    o_ref, lse_ref = tatt.flash_fwd_plain(q, k, v, True, with_lse=True)
    assert (o.float() - o_ref.float()).abs().max().item() <= BF16_KERNEL_TOL
    assert (lse - lse_ref).abs().max().item() <= 1e-4


# name, B, H, Sq, Sk, Dh, dtype, causal, layout ("s0": q repeating one row
# along the sequence): flash_wide.cu above Dh 256 (tests/test_torch_flash_bwd.py
# runs the same cases through the backward).  In 16 bits its forward and
# dk/dv pass run on TMA and wgmma at each consumer split (320: 192 + 128
# columns, 384: 192 + 192, 448: 256 + 192, 512: 256 + 256) and streamed
# above 512 (576, 640, 1024), with a ragged S, causal and not, causal with
# Sk < Sq and with one key, in bf16 and fp16; a cross shape, the QKV view, a
# sequence of stride 0 and a padded 300; fp32 (split TF32 on the tensor
# cores) at 320, 512 and 640, the QKV view and a sequence of stride 0.
WIDE_CARD_CASES = [
    (f"{str(dt)[6:]}_dh{d}{'_causal' if c else ''}", 2, 2, 200, 200, d, dt, c, "bhsd")
    for d in (320, 384, 512) for dt in (torch.bfloat16, torch.float16) for c in (False, True)
] + [
    ("cross_sq77_sk200_dh512", 2, 2, 77, 200, 512, torch.bfloat16, False, "bhsd"),
    ("cross_sq200_sk77_dh320_causal", 2, 2, 200, 77, 320, torch.bfloat16, True, "bhsd"),
    ("qkv_dh512_causal", 2, 2, 130, 130, 512, torch.bfloat16, True, "qkv"),
    ("q_seq_stride0_dh384", 2, 2, 130, 130, 384, torch.bfloat16, False, "s0"),
    ("fp16_dh300_causal", 2, 2, 150, 150, 300, torch.float16, True, "bhsd"),
    ("fp32_dh512_causal", 1, 2, 200, 200, 512, torch.float32, True, "bhsd"),
    ("dh448_causal_sq130_sk65", 2, 2, 130, 65, 448, torch.bfloat16, True, "bhsd"),
    ("dh448_causal_sq130_sk1", 2, 2, 130, 1, 448, torch.bfloat16, True, "bhsd"),
    ("bfloat16_dh576", 2, 2, 200, 200, 576, torch.bfloat16, False, "bhsd"),
    ("float16_dh640_causal", 2, 2, 200, 200, 640, torch.float16, True, "bhsd"),
    ("qkv_dh1024_causal", 2, 2, 130, 130, 1024, torch.bfloat16, True, "qkv"),
    ("fp32_dh320_causal", 2, 2, 200, 200, 320, torch.float32, True, "bhsd"),
    ("fp32_dh640", 1, 2, 150, 150, 640, torch.float32, False, "bhsd"),
    ("fp32_qkv_dh512", 2, 2, 130, 130, 512, torch.float32, False, "qkv"),
    ("q_seq_stride0_dh384_fp32", 2, 2, 130, 130, 384, torch.float32, False, "s0"),
]


def _ulps(ref, dtype, n=2):
    """n units in the last place of the largest |ref| in ``dtype``."""
    mantissa = {torch.bfloat16: 7, torch.float16: 10}[dtype]
    return n * 2.0 ** (np.frexp(ref.float().abs().max().item())[1] - 1 - mantissa)


@pytest.mark.cuda
@pytest.mark.parametrize("name,b,h,sq,sk,d,dtype,causal,layout", WIDE_CARD_CASES,
                         ids=[c[0] for c in WIDE_CARD_CASES])
def test_kernel_refuses_head_dim_above_128_on_card(cuda_device, name, b, h, sq, sk, d, dtype,
                                                   causal, layout):
    """Dh above 256 is no longer refused: flash_wide_fwd against the plain
    version, o within 2 ulps of its largest value in 16 bits (fp32:
    chip_smoke.py's 2e-5), lse within 1e-4, one launch counted on
    flash_wide_fwd and none on flash_fwd, and two runs bit-identical (a
    static schedule, no atomics)."""
    q, k, v, layout = _card_inputs(cuda_device, b, h, sq, sk, d, dtype,
                                   "bhsd" if layout == "s0" else layout)
    if name.startswith("q_seq_stride0"):
        q = q[:, :, :1].expand(q.shape)
    before = (tatt.flash_fwd.launches, tatt.flash_wide_fwd.launches)
    o, lse = tatt.flash_fwd(q, k, v, causal=causal, with_lse=True, layout=layout)
    assert (tatt.flash_fwd.launches, tatt.flash_wide_fwd.launches) == (before[0], before[1] + 1)
    again = tatt.flash_wide_fwd(q, k, v, causal=causal, with_lse=True, layout=layout)
    assert torch.equal(o, again[0]) and torch.equal(lse, again[1])
    t = (lambda a: a.transpose(1, 2)) if layout == "bshd" else (lambda a: a)
    o_ref, lse_ref = tatt.flash_fwd_plain(t(q), t(k), t(v), causal, with_lse=True)
    bound = 2e-5 if dtype == torch.float32 else _ulps(o_ref, dtype)
    assert o.shape == q.shape
    assert (t(o).float() - o_ref.float()).abs().max().item() <= bound
    assert (lse - lse_ref).abs().max().item() <= 1e-4


# name, B, H, Sq, Sk, Dh, causal, layout: fp32 forwards on flash_wide.cu's
# split-TF32 kernels at narrow heads (flash_wide_fwd_f32_rows at 1 and 2
# column boxes; Dh 192 on flash_wide_fwd_f32), ragged S, causal with Sk < Sq,
# the QKV view and padded heads.
FP32_CARD_CASES = [
    ("fp32_qkv_s200_causal", 2, 4, 200, 200, 64, True, "qkv"),
    ("fp32_dh32", 2, 4, 128, 128, 32, False, "bhsd"),
    ("fp32_dh80_causal", 2, 4, 200, 200, 80, True, "bhsd"),
    ("fp32_dh128_sq77_sk200", 2, 4, 77, 200, 128, False, "bhsd"),
    ("fp32_dh192_causal", 2, 2, 200, 200, 192, True, "bhsd"),
    ("fp32_causal_sq130_sk65", 2, 4, 130, 65, 64, True, "bhsd"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("name,b,h,sq,sk,d,causal,layout", FP32_CARD_CASES,
                         ids=[c[0] for c in FP32_CARD_CASES])
def test_fp32_forward_matches_plain_on_card(cuda_device, name, b, h, sq, sk, d, causal, layout):
    """The fp32 forward at heads up to 256 runs flash_wide.cu's split-TF32
    kernels: o within chip_smoke.py's 2e-5 of the plain version, lse
    within 1e-4, one launch counted on flash_fwd (the caller's head dim)
    and none on flash_wide_fwd, two runs bit-identical."""
    q, k, v, layout = _card_inputs(cuda_device, b, h, sq, sk, d, torch.float32, layout)
    before = (tatt.flash_fwd.launches, tatt.flash_wide_fwd.launches)
    o, lse = tatt.flash_fwd(q, k, v, causal=causal, with_lse=True, layout=layout)
    assert (tatt.flash_fwd.launches, tatt.flash_wide_fwd.launches) == (before[0] + 1, before[1])
    again = tatt.flash_fwd(q, k, v, causal=causal, with_lse=True, layout=layout)
    assert torch.equal(o, again[0]) and torch.equal(lse, again[1])
    t = (lambda a: a.transpose(1, 2)) if layout == "bshd" else (lambda a: a)
    o_ref, lse_ref = tatt.flash_fwd_plain(t(q), t(k), t(v), causal, with_lse=True)
    assert o.shape == q.shape
    assert (t(o) - o_ref).abs().max().item() <= 2e-5
    assert (lse - lse_ref).abs().max().item() <= 1e-4


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
    their values to the plain version); in fp32 the backward is
    flash_wide.cu's delta launch and split-TF32 pair, counted on
    flash_bwd_dq (delta and dq) and flash_bwd_dkv."""
    q = torch.randn(1, 2, 64, 32, device=cuda_device, requires_grad=True)
    before = (tatt.flash_fwd.launches, tatt.flash_bwd_dq.launches, tatt.flash_bwd_dkv.launches)
    tatt.flash_attention(q, q, q).sum().backward()
    assert q.grad.shape == q.shape and torch.isfinite(q.grad).all()
    assert (tatt.flash_fwd.launches, tatt.flash_bwd_dq.launches,
            tatt.flash_bwd_dkv.launches) == (before[0] + 1, before[1] + 2, before[2] + 1)
