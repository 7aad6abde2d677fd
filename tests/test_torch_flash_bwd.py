"""The PyTorch port's attention backward against the JAX package, on the CPU.

``flash_bwd_plain`` (what the port's CPU path runs, and what the CUDA
kernels ``flash_bwd_dq``/``flash_bwd_dkv`` are held to on the card) is
compared with the JAX package's Pallas backward kernels run in interpret
mode, given the same q, k, v, do and the JAX forward's o and lse; the
port's autograd through ``flash_attention`` and ``fused_qkv_attention`` is
compared with ``jax.grad`` of the JAX functions on their Pallas path.  The
kernels themselves are compared with the plain version by the ``cuda``
tests below, which skip here, and by ``chip_smoke.py``.
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from incubator_mxnet_tpu.ops import attention as jatt
from incubator_mxnet_torch.ops import attention as tatt

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402  (the one-key bound on dq and dk)
from test_torch_attention import WIDE_CARD_CASES  # noqa: E402  (the cases of the forward)

# fp32 gradients: both sides compute in fp32 (JAX at "highest" matmul
# precision) with the same algebra in another summation order; the
# tolerance of test_transformer.py's test_gradients_match_reference.
RTOL, ATOL = 2e-4, 2e-5
# bf16 against the JAX XLA backward: the same roundings of p and ds to
# bf16 and fp32 accumulation, but the XLA path recomputes o and rounds p
# after normalising; gradients of |g| < ~4 differ by a few bf16 ulps.
BF16_ATOL = 6e-2

CASES = [  # name, BH, Sq, Sk, Dh, causal
    ("s128", 2, 128, 128, 32, False),
    ("s128_causal", 2, 128, 128, 32, True),
    ("cross_sq64_sk128", 2, 64, 128, 32, False),
    ("cross_sq64_sk128_causal", 2, 64, 128, 32, True),
    ("unaligned_s200", 1, 200, 200, 16, False),
    ("unaligned_s200_causal", 1, 200, 200, 16, True),
    # the shapes the 16-bit kernels' tiling meets: 128-row items with a
    # tail (64-row streamed tiles at Dh 128), fewer rows than one consumer
    # warpgroup's 64, and a causal cross shape whose last key tile sees no
    # query
    ("s200_causal_dh64", 1, 200, 200, 64, True),
    ("s200_causal_dh128", 1, 200, 200, 128, True),
    ("sq40", 2, 40, 40, 64, False),
    ("cross_sq77_sk200_causal", 1, 77, 200, 64, True),
]


def _inputs(seed, bh, sq, sk, d):
    rng = np.random.RandomState(seed)
    return [rng.randn(*shape).astype(np.float32)
            for shape in ((bh, sq, d), (bh, sk, d), (bh, sk, d), (bh, sq, d))]


@pytest.mark.parametrize("name,bh,sq,sk,d,causal", CASES, ids=[c[0] for c in CASES])
def test_plain_backward_matches_pallas_interpret(name, bh, sq, sk, d, causal):
    q, k, v, do = _inputs(0, bh, sq, sk, d)
    scale = 1.0 / np.sqrt(d)
    jq, jk, jv, jdo = map(jnp.asarray, (q, k, v, do))
    blocks = dict(block_q=sq if sq % 128 else 128, block_k=sk if sk % 128 else 128)  # S=200: one
    o, lse = jatt._flash_fwd_pallas(jq, jk, jv, causal, scale, True, with_lse=True, **blocks)
    ref = jatt._flash_bwd_pallas(jq, jk, jv, jdo, o, lse, causal, scale, True, **blocks)
    t = torch.from_numpy
    got = tatt.flash_bwd_plain(t(q), t(k), t(v), t(np.array(o)), t(do),
                               t(np.array(lse)[..., 0]), causal, scale)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=RTOL, atol=ATOL)


def _jax_grads(fn, arrs, w):
    return jax.grad(lambda *a: (fn(*a) * w).sum(), argnums=tuple(range(len(arrs))))(
        *map(jnp.asarray, arrs))


@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_autograd_matches_jax_pallas(causal, monkeypatch):
    monkeypatch.setenv("MXNET_TPU_FLASH", "interpret")
    monkeypatch.setattr(jatt, "_PALLAS_BWD_MIN_SEQ", 0)
    rng = np.random.RandomState(1)
    arrs = [rng.randn(2, 2, 128, 32).astype(np.float32) for _ in range(3)]
    w = rng.randn(2, 2, 128, 32).astype(np.float32)
    ref = _jax_grads(lambda q, k, v: jatt.flash_attention(q, k, v, causal=causal), arrs, w)
    ts = [torch.from_numpy(a).requires_grad_() for a in arrs]
    (tatt.flash_attention(*ts, causal=causal) * torch.from_numpy(w)).sum().backward()
    for t, r in zip(ts, ref):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(r), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("causal", [False, True])
def test_fused_qkv_attention_autograd_matches_jax_pallas(causal, monkeypatch):
    monkeypatch.setenv("MXNET_TPU_FLASH", "interpret")
    monkeypatch.setattr(jatt, "_PALLAS_BWD_MIN_SEQ", 0)
    b, s, h, dh = 2, 32, 4, 16
    rng = np.random.RandomState(2)
    qkv = rng.randn(b, s, 3 * h * dh).astype(np.float32)
    w = rng.randn(b, s, h * dh).astype(np.float32)
    (ref,) = _jax_grads(lambda x: jatt.fused_qkv_attention(x, num_heads=h, causal=causal),
                        [qkv], w)
    x = torch.from_numpy(qkv).requires_grad_()
    (tatt.fused_qkv_attention(x, num_heads=h, causal=causal) * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)


def test_fused_kv_attention_autograd_matches_jax():
    b, sq, sk, h, dh = 2, 8, 16, 2, 8
    rng = np.random.RandomState(3)
    q = rng.randn(b, sq, h * dh).astype(np.float32)
    kv = rng.randn(b, sk, 2 * h * dh).astype(np.float32)
    w = rng.randn(b, sq, h * dh).astype(np.float32)
    ref = _jax_grads(lambda a, c: jatt.fused_kv_attention(a, c, num_heads=h), [q, kv], w)
    tq, tkv = (torch.from_numpy(a).requires_grad_() for a in (q, kv))
    (tatt.fused_kv_attention(tq, tkv, num_heads=h) * torch.from_numpy(w)).sum().backward()
    for t, r in zip((tq, tkv), ref):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(r), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("causal", [False, True])
def test_plain_backward_bf16_matches_jax_xla(causal):
    bh, s, d = 2, 128, 32
    q, k, v, do = _inputs(4, bh, s, s, d)
    jb = [jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v, do)]
    ref = jatt._flash_bwd_xla(causal, 1.0 / np.sqrt(d), tuple(jb[:3]), jb[3])
    tb = [torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v, do)]
    o, lse = tatt.flash_fwd(*tb[:3], causal=causal, with_lse=True)
    got = tatt.flash_bwd_plain(*tb[:3], o, tb[3], lse, causal)
    for g, r in zip(got, ref):
        assert g.dtype == torch.bfloat16
        np.testing.assert_allclose(g.float().numpy(), np.asarray(r, np.float32), rtol=0,
                                   atol=BF16_ATOL)


def test_fully_masked_rows_get_zero_gradient():
    """A row that sees no key (Sk = 0): o = 0 and lse = 0 in the forward,
    p = 0 and so dq = 0 in the backward."""
    q = torch.randn(1, 1, 4, 16)
    k = torch.randn(1, 1, 0, 16)
    o, lse = tatt.flash_fwd(q, k, k, with_lse=True)
    dq, dk, dv = tatt.flash_bwd(q, k, k, o, torch.randn_like(o), lse)
    assert torch.equal(dq, torch.zeros_like(dq)) and dk.shape == k.shape == dv.shape


def test_cpu_backward_launches_nothing_and_writes_given_buffers():
    rng = np.random.RandomState(5)
    x = torch.from_numpy(rng.randn(2, 24, 3, 2, 16).astype(np.float32))
    q, k, v = x[:, :, 0], x[:, :, 1], x[:, :, 2]
    o, lse = tatt.flash_fwd(q, k, v, with_lse=True, layout="bshd")
    do = torch.from_numpy(rng.randn(*o.shape).astype(np.float32))
    before = (tatt.flash_bwd_dq.launches, tatt.flash_bwd_dkv.launches)
    dqkv = torch.empty_like(x)
    out = (dqkv[:, :, 0], dqkv[:, :, 1], dqkv[:, :, 2])
    got = tatt.flash_bwd(q, k, v, o, do, lse, layout="bshd", out=out)
    assert all(g is w for g, w in zip(got, out))
    t = lambda a: a.transpose(1, 2)  # noqa: E731
    ref = tatt.flash_bwd_plain(t(q), t(k), t(v), t(o), t(do), lse)
    for g, r in zip(out, ref):
        torch.testing.assert_close(t(g), r)
    torch.testing.assert_close(tatt.flash_bwd_dq(q, k, v, o, do, lse, layout="bshd"), out[0])
    for g, w in zip(tatt.flash_bwd_dkv(q, k, v, o, do, lse, layout="bshd"), out[1:]):
        torch.testing.assert_close(g, w)
    assert (tatt.flash_bwd_dq.launches, tatt.flash_bwd_dkv.launches) == before
    with pytest.raises(ValueError, match="layout"):
        tatt.flash_bwd(q, k, v, o, do, lse, layout="sbhd")


def test_inference_saves_nothing_for_backward():
    """Without a gradient the forward takes no lse and builds no graph."""
    x = torch.randn(2, 16, 3 * 32)
    out = tatt.fused_qkv_attention(x, num_heads=2)
    assert out.grad_fn is None
    y = x.clone().requires_grad_()
    with torch.no_grad():
        assert tatt.fused_qkv_attention(y, num_heads=2).grad_fn is None
    names, fn = [], tatt.fused_qkv_attention(y, num_heads=2).grad_fn
    while fn is not None:
        names.append(type(fn).__name__)
        fn = fn.next_functions[0][0] if fn.next_functions else None
    assert "_FlashAttentionBackward" in names


# bf16 above Dh 256, where the card runs flash_wide.cu's dq pass on TMA and
# wgmma: an unpadded 320 and a streamed 576 (more than 512 columns), a
# causal cross shape too.  Both sides round ds to bf16 before ds·k (p stays
# fp32 in the dq pass) and accumulate in fp32; their sums run in other
# orders, which can flip a rounding of ds by one bf16 ulp and moves dq by a
# fraction of an ulp: measured up to 0.25 ulp of the largest |dq|.  The
# bound is chip_smoke.py's BWD_ULPS, 2 bf16 ulps of the largest |dq|; a
# wrong mask, delta or scale moves dq by its own size.
WIDE_BF16_CASES = [  # name, BH, Sq, Sk, Dh, causal
    ("dh320", 2, 72, 72, 320, False),
    ("dh320_causal", 2, 72, 72, 320, True),
    ("dh576", 2, 72, 72, 576, False),
    ("dh576_causal_sq64_sk128", 2, 64, 128, 576, True),
]


@pytest.mark.parametrize("name,bh,sq,sk,d,causal", WIDE_BF16_CASES,
                         ids=[c[0] for c in WIDE_BF16_CASES])
def test_plain_bf16_dq_above_256_matches_pallas_interpret(name, bh, sq, sk, d, causal):
    q, k, v, do = _inputs(7, bh, sq, sk, d)
    scale = 1.0 / np.sqrt(d)
    jq, jk, jv, jdo = (jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v, do))
    blocks = dict(block_q=sq if sq % 128 else 128, block_k=sk if sk % 128 else 128)
    o, lse = jatt._flash_fwd_pallas(jq, jk, jv, causal, scale, True, with_lse=True, **blocks)
    ref = np.asarray(jatt._flash_bwd_pallas(jq, jk, jv, jdo, o, lse, causal, scale, True,
                                            **blocks)[0], np.float32)

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)

    assert tatt._kernel_width("flash_bwd", t(jq), t(jk), t(jv)) == d
    dq = tatt.flash_bwd_plain(t(jq), t(jk), t(jv), t(o), t(jdo),
                              torch.from_numpy(np.array(lse)[..., 0]), causal, scale)[0]
    assert dq.dtype == torch.bfloat16
    bound = chip_smoke.BWD_ULPS * chip_smoke.ulp(np.abs(ref).max(), torch.bfloat16)
    assert np.abs(dq.float().numpy() - ref).max() <= bound


@pytest.mark.parametrize("d", (8, 48, 80, 96, 160, 200, 256))
@pytest.mark.parametrize("causal", [False, True])
def test_padded_head_dim_backward_matches_jax_xla(d, causal):
    """On the card a head dim the kernels have no instance for runs on q,
    k, v, o and do zero-padded to the next one, with the scale of the true
    head dim, and the gradients come back sliced: the same function."""
    bh, sq, sk = 2, 40, 56
    q, k, v, do = _inputs(6, bh, sq, sk, d)
    scale = 1.0 / np.sqrt(d)
    ref = jatt._flash_bwd_xla(causal, scale, tuple(map(jnp.asarray, (q, k, v))),
                              jnp.asarray(do))
    t = torch.from_numpy
    o, lse = tatt.flash_fwd_plain(t(q), t(k), t(v), causal, scale, with_lse=True)
    width = tatt._kernel_width("flash_bwd", t(q), t(k), t(v))
    padded = tatt._kernel_operands(width, False, t(q), t(k), t(v), o, t(do))
    assert all(x.shape[-1] == width for x in padded)
    got = tatt.flash_bwd_plain(*padded, lse, causal, scale)
    for g, r in zip(got, ref):
        assert torch.equal(g[..., d:], torch.zeros_like(g[..., d:]))
        np.testing.assert_allclose(g[..., :d].numpy(), np.asarray(r), rtol=RTOL, atol=ATOL)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("causal", [False, True])
def test_kernels_match_plain_on_card(cuda_device, causal, dtype):
    """dq, dk and dv written into one [B, S, 3, H, Dh] buffer, unaligned S:
    bf16 within 2 bf16 ulps of the largest gradient (chip_smoke.py's
    BWD_ULPS, with its reasoning); fp32, which runs flash_wide.cu's delta
    launch and split-TF32 dq and dk/dv kernels (the delta launch counted on
    flash_bwd_dq), within FP32_BWD_REL of it."""
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    x = torch.randn(2, 200, 3, 4, 64, generator=gen, device=cuda_device).to(dtype)
    q, k, v = x[:, :, 0], x[:, :, 1], x[:, :, 2]
    do = torch.randn(2, 200, 4, 64, generator=gen, device=cuda_device).to(dtype)
    o, lse = tatt.flash_fwd(q, k, v, causal=causal, with_lse=True, layout="bshd")
    before = (tatt.flash_bwd_dq.launches, tatt.flash_bwd_dkv.launches)
    dqkv = torch.empty_like(x)
    tatt.flash_bwd(q, k, v, o, do, lse, causal, layout="bshd",
                   out=(dqkv[:, :, 0], dqkv[:, :, 1], dqkv[:, :, 2]))
    delta = int(dtype == torch.float32)
    assert (tatt.flash_bwd_dq.launches, tatt.flash_bwd_dkv.launches) == (before[0] + 1 + delta,
                                                                         before[1] + 1)
    t = lambda a: a.transpose(1, 2)  # noqa: E731
    ref = tatt.flash_bwd_plain(t(q), t(k), t(v), t(o), t(do), lse, causal)
    for i, r in enumerate(ref):
        ref_max = r.float().abs().max().item()
        bound = (chip_smoke.FP32_BWD_REL * ref_max if dtype == torch.float32
                 else 2 * 2.0 ** (np.frexp(ref_max)[1] - 1 - 7))
        assert (t(dqkv[:, :, i]).float() - r.float()).abs().max().item() <= bound


@pytest.mark.cuda
def test_kernels_refuse_what_they_cannot_take(cuda_device):
    """Dh 48 is no longer refused: it runs padded to 64, once through each
    kernel, and matches the plain version within 2 bf16 ulps of the
    largest gradient."""
    dtype = torch.bfloat16
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    q, k, v, do = (torch.randn(1, 2, 100, 48, generator=gen, device=cuda_device).to(dtype)
                   for _ in range(4))
    o, lse = tatt.flash_fwd_plain(q, k, v, with_lse=True)
    before = (tatt.flash_bwd_dq.launches, tatt.flash_bwd_dkv.launches)
    got = tatt.flash_bwd(q, k, v, o, do, lse)
    assert (tatt.flash_bwd_dq.launches, tatt.flash_bwd_dkv.launches) == (before[0] + 1,
                                                                         before[1] + 1)
    for g, r in zip(got, tatt.flash_bwd_plain(q, k, v, o, do, lse)):
        ref_max = r.float().abs().max().item()
        bound = 2 * 2.0 ** (np.frexp(ref_max)[1] - 1 - 7)
        assert g.shape == r.shape and (g.float() - r.float()).abs().max().item() <= bound


@pytest.mark.cuda
@pytest.mark.parametrize("d", [160, 256])
def test_wide_head_dims_on_card(cuda_device, d):
    """Dh 129-256 runs the 256 instance, each pass as two launches of a
    128-column slab (both counted), within 2 bf16 ulps of the largest
    gradient."""
    gen = torch.Generator(device=cuda_device).manual_seed(4)
    q, k, v, do = (torch.randn(1, 2, 200, d, generator=gen, device=cuda_device)
                   .to(torch.bfloat16) for _ in range(4))
    o, lse = tatt.flash_fwd_plain(q, k, v, causal=True, with_lse=True)
    before = (tatt.flash_bwd_dq.launches, tatt.flash_bwd_dkv.launches)
    got = tatt.flash_bwd(q, k, v, o, do, lse, True)
    assert (tatt.flash_bwd_dq.launches, tatt.flash_bwd_dkv.launches) == (before[0] + 2,
                                                                         before[1] + 2)
    tatt.flash_bwd_dq(q, k, v, o, do, lse, True)
    tatt.flash_bwd_dkv(q, k, v, o, do, lse, True)
    assert (tatt.flash_bwd_dq.launches, tatt.flash_bwd_dkv.launches) == (before[0] + 4,
                                                                         before[1] + 4)
    for g, r in zip(got, tatt.flash_bwd_plain(q, k, v, o, do, lse, True)):
        ref_max = r.float().abs().max().item()
        bound = 2 * 2.0 ** (np.frexp(ref_max)[1] - 1 - 7)
        assert g.shape == r.shape and (g.float() - r.float()).abs().max().item() <= bound


@pytest.mark.cuda
@pytest.mark.parametrize("name,b,h,sq,sk,d,dtype,causal,layout", WIDE_CARD_CASES,
                         ids=[c[0] for c in WIDE_CARD_CASES])
def test_kernels_refuse_head_dim_above_128(cuda_device, name, b, h, sq, sk, d, dtype, causal,
                                           layout):
    """Dh above 256 is no longer refused: flash_wide_bwd_dq and
    flash_wide_bwd_dkv against the plain version, each gradient within 2
    ulps of its largest value in 16 bits (fp32: 1e-4 of it, chip_smoke.py's
    FP32_BWD_REL); with one key (Sk = 1) dq and dk, exactly 0, within
    chip_smoke.py's bound on the rounding of dp − delta.  The counters take
    one launch a pass and the call's one delta launch on dq (three in all,
    in every dtype); each pass alone counts its kernel and a delta launch
    of its own; two runs are bit-identical."""
    gen = torch.Generator(device=cuda_device).manual_seed(7)
    if layout == "qkv":
        x = torch.randn(b, sq, 3, h, d, generator=gen, device=cuda_device).to(dtype)
        q, k, v = x[:, :, 0], x[:, :, 1], x[:, :, 2]
        do = torch.randn(b, sq, h, d, generator=gen, device=cuda_device).to(dtype)
    else:
        q, do = (torch.randn(b, h, sq, d, generator=gen, device=cuda_device).to(dtype)
                 for _ in range(2))
        k, v = (torch.randn(b, h, sk, d, generator=gen, device=cuda_device).to(dtype)
                for _ in range(2))
        if layout == "s0":
            q = q[:, :, :1].expand(q.shape)
    lay = "bshd" if layout == "qkv" else "bhsd"
    t = (lambda a: a.transpose(1, 2)) if lay == "bshd" else (lambda a: a)
    o, lse = tatt.flash_fwd(q, k, v, causal=causal, with_lse=True, layout=lay)
    counters = (tatt.flash_bwd_dq, tatt.flash_bwd_dkv, tatt.flash_wide_bwd_dq,
                tatt.flash_wide_bwd_dkv)
    delta = int(tatt._has_delta_pass(d, dtype))  # one a call above 256, every dtype
    before = [c.launches for c in counters]
    got = tatt.flash_bwd(q, k, v, o, do, lse, causal, layout=lay)
    assert [c.launches - n for c, n in zip(counters, before)] == [0, 0, 1 + delta, 1]
    dq = tatt.flash_wide_bwd_dq(q, k, v, o, do, lse, causal, layout=lay)
    dk, dv = tatt.flash_wide_bwd_dkv(q, k, v, o, do, lse, causal, layout=lay)
    assert [c.launches - n for c, n in zip(counters, before)] == [0, 0, 2 + 2 * delta,
                                                                  2 + delta]
    assert all(torch.equal(a, b) for a, b in zip(got, (dq, dk, dv)))
    ref = tatt.flash_bwd_plain(t(q), t(k), t(v), t(o), t(do), lse, causal)
    zero = chip_smoke.one_key_bounds(t(q), t(k), t(v), t(do)) if sk == 1 else ()
    for i, (g, r) in enumerate(zip(got, ref)):
        assert g.shape == t(r).shape
        if i < len(zero):  # dq, dk with one key: exactly 0
            assert g.float().abs().max().item() <= zero[i]
            continue
        bound = (1e-4 * r.float().abs().max().item() if dtype == torch.float32
                 else 2 * 2.0 ** (np.frexp(r.float().abs().max().item())[1] - 1
                                  - (7 if dtype == torch.bfloat16 else 10)))
        assert (t(g).float() - r.float()).abs().max().item() <= bound


# The three calls a user makes above Dh 256: the dq pass alone, the dk/dv
# pass alone and the pair (flash_bwd), at a head of 320, 512 and 640
# (streamed), causal and not, in each dtype.
WIDE_PASS_CASES = [(passes, d, dtype, causal)
                   for passes in ("dq", "dkv", "pair")
                   for d, dtype, causal in ((320, torch.bfloat16, True),
                                            (512, torch.float16, False),
                                            (640, torch.bfloat16, True),
                                            (512, torch.float32, True),
                                            (320, torch.float32, False))]


@pytest.mark.cuda
@pytest.mark.parametrize("passes,d,dtype,causal", WIDE_PASS_CASES,
                         ids=[f"{p}_dh{d}_{str(dt)[6:]}{'_causal' if c else ''}"
                              for p, d, dt, c in WIDE_PASS_CASES])
def test_wide_backward_passes_on_card(cuda_device, passes, d, dtype, causal):
    """Each pass alone and the pair: the counts of the rule (one delta
    launch a call in every dtype, on dq when the call runs it, else on
    dk/dv), nothing counted on flash_bwd_dq/flash_bwd_dkv, and the same bits
    as the pair's gradients, which are held to the plain version within 2
    ulps of each gradient's largest value (fp32: 1e-4 of it)."""
    gen = torch.Generator(device=cuda_device).manual_seed(9)
    q, k, v, do = (torch.randn(2, 2, 150, d, generator=gen, device=cuda_device).to(dtype)
                   for _ in range(4))
    o, lse = tatt.flash_fwd(q, k, v, causal=causal, with_lse=True)
    ref = tatt.flash_bwd_plain(q, k, v, o, do, lse, causal)
    pair = tatt.flash_bwd(q, k, v, o, do, lse, causal)
    counters = (tatt.flash_bwd_dq, tatt.flash_bwd_dkv, tatt.flash_wide_bwd_dq,
                tatt.flash_wide_bwd_dkv)
    delta = int(tatt._has_delta_pass(d, dtype))  # one a call above 256, every dtype
    before = [c.launches for c in counters]
    if passes == "dq":
        got = (tatt.flash_wide_bwd_dq(q, k, v, o, do, lse, causal), None, None)
        want = [0, 0, 1 + delta, 0]
    elif passes == "dkv":
        got = (None, *tatt.flash_wide_bwd_dkv(q, k, v, o, do, lse, causal))
        want = [0, 0, 0, 1 + delta]
    else:
        got = tatt.flash_bwd(q, k, v, o, do, lse, causal)
        want = [0, 0, 1 + delta, 1]
    assert [c.launches - n for c, n in zip(counters, before)] == want
    for g, p, r in zip(got, pair, ref):
        ref_max = r.float().abs().max().item()
        bound = (1e-4 * ref_max if dtype == torch.float32
                 else 2 * 2.0 ** (np.frexp(ref_max)[1] - 1
                                  - (7 if dtype == torch.bfloat16 else 10)))
        assert (p.float() - r.float()).abs().max().item() <= bound
        if g is not None:
            assert torch.equal(g, p)


# An fp32 backward up to Dh 256 runs flash_wide.cu too (padded to a
# multiple of 64: 48 to 64, 80 to 128, 160 to 192), counted on the narrow
# wrappers: each pass alone and the pair, causal and not, one key.
NARROW_FP32_CASES = [(passes, d, causal, sk)
                     for passes in ("dq", "dkv", "pair")
                     for d, causal, sk in ((64, False, 150), (48, True, 150), (160, True, 150),
                                           (256, False, 77), (128, True, 1))]


@pytest.mark.cuda
@pytest.mark.parametrize("passes,d,causal,sk", NARROW_FP32_CASES,
                         ids=[f"{p}_dh{d}{'_causal' if c else ''}_sk{sk}"
                              for p, d, c, sk in NARROW_FP32_CASES])
def test_narrow_fp32_backward_passes_on_card(cuda_device, passes, d, causal, sk):
    """The fp32 backward up to Dh 256: one delta launch a call and the
    split-TF32 dq and dk/dv kernels, counted on flash_bwd_dq (delta and dq)
    and flash_bwd_dkv, nothing on the flash_wide_* counters; the pair's
    gradients within FP32_BWD_REL of the plain version's largest value
    (with one key, dq and dk within the one-key bound of the exact 0), and
    each pass alone gives the pair's bits."""
    gen = torch.Generator(device=cuda_device).manual_seed(10)
    q, do = (torch.randn(2, 3, 150, d, generator=gen, device=cuda_device) for _ in range(2))
    k, v = (torch.randn(2, 3, sk, d, generator=gen, device=cuda_device) for _ in range(2))
    o, lse = tatt.flash_fwd(q, k, v, causal=causal, with_lse=True)
    ref = tatt.flash_bwd_plain(q, k, v, o, do, lse, causal)
    pair = tatt.flash_bwd(q, k, v, o, do, lse, causal)
    counters = (tatt.flash_bwd_dq, tatt.flash_bwd_dkv, tatt.flash_wide_bwd_dq,
                tatt.flash_wide_bwd_dkv)
    before = [c.launches for c in counters]
    if passes == "dq":
        got, want = (tatt.flash_bwd_dq(q, k, v, o, do, lse, causal), None, None), [2, 0, 0, 0]
    elif passes == "dkv":
        got, want = (None, *tatt.flash_bwd_dkv(q, k, v, o, do, lse, causal)), [0, 2, 0, 0]
    else:
        got, want = tatt.flash_bwd(q, k, v, o, do, lse, causal), [2, 1, 0, 0]
    assert [c.launches - n for c, n in zip(counters, before)] == want
    zero = chip_smoke.one_key_bounds(q, k, v, do) if sk == 1 else ()
    for i, (g, p, r) in enumerate(zip(got, pair, ref)):
        if i < len(zero):
            assert p.abs().max().item() <= zero[i]
        else:
            assert (p - r).abs().max().item() <= chip_smoke.FP32_BWD_REL * r.abs().max().item()
        if g is not None:
            assert torch.equal(g, p)


@pytest.mark.cuda
def test_kernels_are_deterministic_on_card(cuda_device):
    """A static schedule with no atomics: two runs give the same bits."""
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    x = torch.randn(8, 200, 3, 12, 64, generator=gen, device=cuda_device).to(torch.bfloat16)
    q, k, v = x[:, :, 0], x[:, :, 1], x[:, :, 2]
    do = torch.randn(8, 200, 12, 64, generator=gen, device=cuda_device).to(torch.bfloat16)
    o, lse = tatt.flash_fwd(q, k, v, causal=True, with_lse=True, layout="bshd")
    first, second = (tatt.flash_bwd(q, k, v, o, do, lse, True, layout="bshd") for _ in range(2))
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.cuda
def test_kernels_run_from_a_fresh_thread(cuda_device):
    """The tensor maps need a current CUDA context, which a thread that has
    made no CUDA call yet lacks (autograd's backward thread, a server's
    worker): the kernels make the device's context current themselves."""
    import threading

    gen = torch.Generator(device=cuda_device).manual_seed(3)
    q, k, v, do = (torch.randn(2, 4, 64, 64, generator=gen, device=cuda_device)
                   .to(torch.bfloat16) for _ in range(4))
    o, lse = tatt.flash_fwd(q, k, v, with_lse=True)
    want = tatt.flash_bwd(q, k, v, o, do, lse)
    got = {}
    worker = threading.Thread(target=lambda: got.update(
        fwd=tatt.flash_fwd(q, k, v, with_lse=True), bwd=tatt.flash_bwd(q, k, v, o, do, lse)))
    worker.start()
    worker.join()
    torch.cuda.synchronize()
    assert torch.equal(got["fwd"][0], o) and torch.equal(got["fwd"][1], lse)
    assert all(torch.equal(a, b) for a, b in zip(got["bwd"], want))
