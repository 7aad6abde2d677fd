"""The port's seq2seq Transformer against the JAX package's, on the CPU.

Weights are carried from the JAX model by structural key
(``convert.load_numpy_params``) and inputs come from a numpy seed; the
shapes are ``tests/test_seq2seq.py``'s (units 32, 2 heads, 2+2 layers,
vocabulary 23).  Held: the decoder cell and decoder (pre- and post-LN),
the sinusoidal table (odd ``units`` too), ``encode``/``decode``/``forward``
logits, the KV-cache decoder's step logits, ``greedy_search`` and
``beam_search`` tokens and scores with and without the cache, causality
bit for bit, and transformer-big's declared parameter shapes.
"""
import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as mxj
from incubator_mxnet_tpu.gluon.model_zoo import transformer as jt
from incubator_mxnet_tpu.gluon.nn import transformer as jnn
import incubator_mxnet_torch as mx
from incubator_mxnet_torch.convert import load_numpy_params
from incubator_mxnet_torch.gluon.model_zoo import transformer as tt
from incubator_mxnet_torch.gluon.nn import transformer as tnn

VOCAB, BOS, EOS = 23, 1, 2
TINY = dict(units=32, hidden_size=64, num_heads=2, num_encoder_layers=2, num_decoder_layers=2,
            dropout=0.0, max_length=64)
# fp32 through 2+2 layers in another summation order (tests/test_torch_bert.py's
# tolerance); beam scores are sums of float64 log-softmax of such logits.
FP32_TOL = 1e-4
SEARCH_LEN = 10  # decode buckets 8 and 10: two shapes for the JAX oracle


def _arrays(jblock):
    return {k: p.data().asnumpy() for k, p in jblock._collect_params_with_prefix().items()}


def _ids(shape, seed):
    return np.random.RandomState(seed).randint(3, VOCAB, shape).astype(np.int32)


def _jids(a):
    return mxj.nd.array(a, dtype="int32")


@pytest.fixture(scope="module")
def pair():
    """The JAX tiny Transformer (materialized) and the port's on its
    weights."""
    mxj.random.seed(0)
    j = jt.Transformer(VOCAB, **TINY)
    j.initialize()
    j(_jids(_ids((1, 8), 0)), _jids(_ids((1, 1), 0)))
    t = tt.Transformer(VOCAB, **TINY)
    load_numpy_params(t, _arrays(j), ctx=mx.cpu())
    return j, t


@pytest.mark.parametrize("pre_norm", [True, False], ids=["pre_norm", "post_norm"])
def test_decoder_cell_and_decoder_match_jax(pre_norm):
    rng = np.random.RandomState(1)
    x = rng.randn(2, 7, 32).astype(np.float32)
    mem = rng.randn(2, 9, 32).astype(np.float32)
    for jcls, tcls, args in ((jnn.TransformerDecoderCell, tnn.TransformerDecoderCell, ()),
                             (jnn.TransformerDecoder, tnn.TransformerDecoder, (2,))):
        mxj.random.seed(2)
        j = jcls(*args, 32, 64, 2, pre_norm=pre_norm)
        j.initialize()
        want = j(mxj.nd.array(x), mxj.nd.array(mem)).asnumpy()
        t = tcls(*args, 32, 64, 2, pre_norm=pre_norm)
        load_numpy_params(t, _arrays(j), ctx=mx.cpu())
        got = t(torch.from_numpy(x), torch.from_numpy(mem)).numpy()
        np.testing.assert_allclose(got, want, rtol=FP32_TOL, atol=FP32_TOL, err_msg=jcls.__name__)


@pytest.mark.parametrize("units", [24, 25], ids=["even", "odd"])
def test_sinusoidal_table_matches_jax(units):
    j = jnn.SinusoidalPositionalEncoding(units, max_length=50)
    t = tnn.SinusoidalPositionalEncoding(units, max_length=50)
    assert t._table.dtype == np.float32
    np.testing.assert_array_equal(t._table, j._table)
    x = np.random.RandomState(3).randn(2, 11, units).astype(np.float32)
    np.testing.assert_array_equal(t(torch.from_numpy(x)).numpy(),
                                  j(mxj.nd.array(x)).asnumpy())
    xb = torch.from_numpy(x).to(torch.bfloat16)
    yb = t(xb)
    assert yb.dtype == torch.bfloat16  # added in x's dtype, no fp32 promotion
    assert torch.equal(yb, xb + torch.from_numpy(t._table[:11]).to(torch.bfloat16))


def test_encode_decode_forward_match_jax(pair):
    j, t = pair
    src, tgt = _ids((3, 8), 4), _ids((3, 7), 5)
    mem_j = j.encode(_jids(src))
    mem_t = t.encode(torch.from_numpy(src))
    np.testing.assert_allclose(mem_t.numpy(), mem_j.asnumpy(), rtol=FP32_TOL, atol=FP32_TOL)
    dec_j = j.decode(_jids(tgt), mem_j).asnumpy()
    dec_t = t.decode(torch.from_numpy(tgt), mem_t).numpy()
    assert dec_t.shape == (3, 7, VOCAB)
    np.testing.assert_allclose(dec_t, dec_j, rtol=FP32_TOL, atol=FP32_TOL)
    fwd_t = t(torch.from_numpy(src), torch.from_numpy(tgt)).numpy()
    np.testing.assert_array_equal(fwd_t, dec_t)


def test_decoder_is_causal_bit_for_bit(pair):
    """Changing target tokens from position 5 on leaves the logits of
    positions 0-4 bit-equal, and changes the later ones."""
    _, t = pair
    src, tgt = _ids((2, 8), 6), _ids((2, 8), 7)
    mem = t.encode(torch.from_numpy(src))
    l1 = t.decode(torch.from_numpy(tgt), mem).numpy()
    tgt2 = tgt.copy()
    tgt2[:, 5:] = (tgt2[:, 5:] + 7) % VOCAB
    l2 = t.decode(torch.from_numpy(tgt2), mem).numpy()
    np.testing.assert_array_equal(l1[:, :5], l2[:, :5])
    assert np.abs(l1[:, 5:] - l2[:, 5:]).max() > 1e-4


def test_kv_cache_step_logits_match_jax(pair):
    """Five cached steps, the same tokens through both packages' caches
    (the bucket grows from 8 at t = 8 in neither; positions 0-4)."""
    j, t = pair
    src = _ids((3, 8), 8)
    jc = jt._KVCacheDecoder(j, j.encode(_jids(src)), 3, SEARCH_LEN)
    tc = tt._KVCacheDecoder(t, t.encode(torch.from_numpy(src)), 3, SEARCH_LEN)
    for step in range(5):
        tok = _ids((3,), 20 + step)
        np.testing.assert_allclose(tc.step(tok, step), jc.step(tok, step), rtol=FP32_TOL,
                                   atol=FP32_TOL, err_msg=f"step {step}")


def test_kv_cache_grows_and_reorders():
    """The bucket doubles at t = 8 with the earlier rows kept, and a beam
    reorder permutes the batch axis of both caches."""
    mx.random.seed(1)
    t = tt.Transformer(VOCAB, **TINY)
    t.initialize(ctx=mx.cpu())
    src = torch.from_numpy(_ids((2, 5), 9))
    c = tt._KVCacheDecoder(t, t.encode(src), 2, 64)
    for step in range(9):
        c.step(_ids((2,), 30 + step), step)
    assert c._bucket == 16 and c._self_k.shape[2] == 16
    assert c._self_k[:, :, 9:].abs().max() == 0 and c._self_k[:, :, :9].abs().min() >= 0
    before = c._self_k.clone()
    c.reorder([1, 0])
    assert torch.equal(c._self_k[:, 0], before[:, 1]) and torch.equal(c._self_k[:, 1], before[:, 0])


@pytest.mark.parametrize("use_cache", [True, False], ids=["cache", "rerun"])
def test_greedy_search_matches_jax(pair, use_cache):
    j, t = pair
    src = _ids((3, 8), 10)
    want_tok, want_len = jt.greedy_search(j, _jids(src), BOS, EOS, max_length=SEARCH_LEN,
                                          use_cache=use_cache)
    got_tok, got_len = tt.greedy_search(t, torch.from_numpy(src), BOS, EOS,
                                        max_length=SEARCH_LEN, use_cache=use_cache)
    np.testing.assert_array_equal(got_tok, want_tok)
    np.testing.assert_array_equal(got_len, want_len)


@pytest.mark.parametrize("use_cache", [True, False], ids=["cache", "rerun"])
def test_beam_search_matches_jax(pair, use_cache):
    j, t = pair
    src = _ids((2, 8), 11)
    want_tok, want_sc = jt.beam_search(j, _jids(src), BOS, EOS, beam_size=3,
                                       max_length=SEARCH_LEN, use_cache=use_cache)
    got_tok, got_sc = tt.beam_search(t, torch.from_numpy(src), BOS, EOS, beam_size=3,
                                     max_length=SEARCH_LEN, use_cache=use_cache)
    assert got_tok.shape == (2, 3, SEARCH_LEN) and got_sc.shape == (2, 3)
    np.testing.assert_array_equal(got_tok, want_tok)
    np.testing.assert_allclose(got_sc, want_sc, rtol=FP32_TOL, atol=FP32_TOL)
    assert (np.diff(got_sc, axis=1) <= 1e-9).all() and (got_tok[:, :, 0] == BOS).all()


def test_cache_equals_rerun_in_the_port(pair):
    """The port's own oracle: cached and re-run decodes give the same
    tokens, and beam scores agree (greedy over 24 positions: the cache
    bucket grows twice)."""
    _, t = pair
    src = torch.from_numpy(_ids((3, 8), 12))
    a = tt.greedy_search(t, src, BOS, EOS, max_length=24, use_cache=True)
    b = tt.greedy_search(t, src, BOS, EOS, max_length=24, use_cache=False)
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])
    tc, sc = tt.beam_search(t, src[:2], BOS, EOS, beam_size=3, max_length=12, use_cache=True)
    tr, sr = tt.beam_search(t, src[:2], BOS, EOS, beam_size=3, max_length=12, use_cache=False)
    np.testing.assert_array_equal(tc, tr)
    np.testing.assert_allclose(sc, sr, rtol=1e-5, atol=1e-6)


def test_bucket_ladder():
    assert [tt._bucket(n, 64) for n in (1, 7, 8, 9, 17, 40, 64)] == [8, 8, 8, 16, 32, 64, 64]


def test_transformer_big_shapes_match_jax():
    """Declared parameter shapes, key for key (deferred input dims are 0
    in both packages); nothing is allocated."""
    j = jt.transformer_big(vocab_size=100)
    t = tt.transformer_big(vocab_size=100)
    want = {k: tuple(p.shape) for k, p in j._collect_params_with_prefix().items()}
    got = {k: tuple(p.shape) for k, p in t._collect_params_with_prefix().items()}
    assert got == want
    assert t._units == 1024 and t.encoder._layers[0].attention._num_heads == 16
    assert len(t.encoder._layers) == len(t.decoder._layers) == 6
    base = tt.transformer_base(vocab_size=100)
    assert base._units == 512 and base.pos_enc._table.shape == (1024, 512)


def test_sharding_rules_name_their_queue():
    """The rules are the JAX package's; placing a parameter by them raises,
    naming the queue of tensor and fsdp placement."""
    from incubator_mxnet_torch import parallel as tpar

    sizes = tpar.MeshConfig(tp=2, fsdp=2).resolve(8)
    jmesh = mxj.parallel.make_mesh(tp=2, fsdp=2)
    for fsdp in (False, True):
        rules, jrules = tt.transformer_sharding_rules(fsdp), jt.transformer_sharding_rules(fsdp)
        for name, shape in (("enc_qkv_weight", (96, 32)), ("dec_kv_weight", (64, 32)),
                            ("ffn1_weight", (128, 32)), ("att_out_weight", (32, 32)),
                            ("ffn2_weight", (32, 128)), ("src_embed_weight", (100, 32)),
                            ("ffn1_bias", (128,)), ("ln_gamma", (32,))):
            assert tuple(rules.spec_for(name, shape, sizes)) == tuple(
                jrules.spec_for(name, shape, jmesh)), (fsdp, name)
    net = mx.gluon.nn.Dense(4, in_units=8, prefix="enc_q_")
    net.initialize(ctx=mx.cpu())
    with pytest.raises(NotImplementedError, match="ROADMAP §1 item 6b"):
        tpar.SPMDTrainer(net, mx.gluon.loss.L2Loss(), "sgd",
                         rules=tt.transformer_sharding_rules(),
                         mesh=tpar.make_mesh(devices=["cpu"]))


def test_ndarray_inputs_follow_the_currency_rule(pair):
    """NDArrays in give NDArrays out, with the tensor path's values; the
    search loops take NDArrays too."""
    _, t = pair
    src, tgt = _ids((2, 8), 13), _ids((2, 5), 14)
    out = t(mx.nd.array(src, ctx=mx.cpu(), dtype="int32"),
            mx.nd.array(tgt, ctx=mx.cpu(), dtype="int32"))
    assert isinstance(out, mx.NDArray)
    np.testing.assert_array_equal(out.asnumpy(),
                                  t(torch.from_numpy(src), torch.from_numpy(tgt)).numpy())
    a = tt.greedy_search(t, mx.nd.array(src, ctx=mx.cpu(), dtype="int32"), BOS, EOS,
                         max_length=SEARCH_LEN)
    b = tt.greedy_search(t, torch.from_numpy(src), BOS, EOS, max_length=SEARCH_LEN)
    np.testing.assert_array_equal(a[0], b[0])
