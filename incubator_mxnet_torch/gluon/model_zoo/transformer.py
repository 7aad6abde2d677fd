"""Transformer encoder-decoder for seq2seq (WMT en-de) and its search
loops.

Counterpart of the JAX package's ``gluon/model_zoo/transformer.py``, with
the same parameter names and structural keys, so weights carry across by
name (``incubator_mxnet_torch.convert``).  The model is pre-norm, ReLU,
sinusoidal positions, with tied source/target/output embeddings.  On the
card every attention call of a forward reaches the port's flash-attention
kernel: non-causal in the encoder, causal at Sq = Sk and cross at Sq ≠ Sk
in the decoder.

Decode: ``greedy_search`` and ``beam_search`` keep a K/V cache a decoder
layer (``_KVCacheDecoder``), padded to a power-of-two bucket of positions;
each step writes position t in place and runs attention for one query row
over the cache view ``[:, :t+1]`` and over the encoder's memory, both
through ``flash_fwd`` reading the cache by its strides: two launches a
layer a step.  Parameters are read live at every step (nothing is baked
into a compiled program, so no per-model program cache is kept).
``use_cache=False`` re-runs the causal decoder over the prefix padded to a
bucket, the oracle the cache is held to.
"""
from __future__ import annotations

import math

import numpy as _np
import torch

from ...ops import attention as _att
from ...ops.registry import nd as F
from ..block import HybridBlock, block_method
from ..nn.basic_layers import Dense, Dropout, Embedding
from ..nn.transformer import (SinusoidalPositionalEncoding, TransformerDecoder,
                              TransformerEncoder)

__all__ = ["Transformer", "transformer_base", "transformer_big", "transformer_sharding_rules",
           "beam_search", "greedy_search"]


class Transformer(HybridBlock):
    """Encoder-decoder transformer with tied source/target/output
    embeddings (the WMT convention)."""

    def __init__(self, vocab_size, units=512, hidden_size=2048, num_heads=8,
                 num_encoder_layers=6, num_decoder_layers=6, dropout=0.1, max_length=1024,
                 tie_weights=True, dtype="float32", prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._units = units
        self._vocab = vocab_size
        self._tie = tie_weights
        with self.name_scope():
            self.embed = Embedding(vocab_size, units, dtype=dtype, prefix="embed_")
            self.pos_enc = SinusoidalPositionalEncoding(units, max_length)
            self.encoder = TransformerEncoder(num_encoder_layers, units, hidden_size, num_heads,
                                              dropout, pre_norm=True, activation="relu",
                                              dtype=dtype, prefix="enc_")
            self.decoder = TransformerDecoder(num_decoder_layers, units, hidden_size, num_heads,
                                              dropout, pre_norm=True, activation="relu",
                                              dtype=dtype, prefix="dec_")
            if not tie_weights:
                self.proj = Dense(vocab_size, use_bias=False, flatten=False, dtype=dtype,
                                  prefix="proj_")
        self._drop = Dropout(dropout) if dropout else None
        if self._drop is not None:
            self.register_child(self._drop, "dropout")

    # -- halves (used by the search loops; each runs as a Block call) ---
    @block_method
    def encode(self, src):
        x = self.pos_enc(self.embed(src) * math.sqrt(self._units))
        if self._drop is not None:
            x = self._drop(x)
        return self.encoder(x)

    @block_method
    def decode(self, tgt, memory):
        """tgt [B, T] int tokens → logits [B, T, V] (causal)."""
        x = self.pos_enc(self.embed(tgt) * math.sqrt(self._units))
        if self._drop is not None:
            x = self._drop(x)
        h = self.decoder(x, memory)
        if self._tie:
            return F.dot(h, self.embed.weight.data(), transpose_b=True)
        return self.proj(h)

    def forward(self, src, tgt):
        return self.decode(tgt, self.encode(src))


def transformer_base(vocab_size, max_length=1024, dropout=0.1, **kwargs):
    return Transformer(vocab_size, units=512, hidden_size=2048, num_heads=8,
                       max_length=max_length, dropout=dropout, **kwargs)


def transformer_big(vocab_size, max_length=1024, dropout=0.3, **kwargs):
    """The WMT'14 "big" configuration (BASELINE.md config 4)."""
    return Transformer(vocab_size, units=1024, hidden_size=4096, num_heads=16,
                       max_length=max_length, dropout=dropout, **kwargs)


def transformer_sharding_rules(fsdp=False):
    """Megatron-style tensor-parallel placement for ``SPMDTrainer``, built as
    the JAX package builds it: QKV and FFN-in column-parallel, out-proj and
    FFN-out row-parallel, the embedding vocab-sharded.  The port's trainer
    places parameters replicated only: given these rules it raises, naming
    ROADMAP §1 item 6b."""
    from ...parallel.sharding import ShardingRules

    dp = "fsdp" if fsdp else None
    return ShardingRules(rules=[
        (r".*qkv_weight$", ("tp", dp)),
        (r".*kv_weight$", ("tp", dp)),
        (r".*q_weight$", ("tp", dp)),
        (r".*ffn1_weight$", ("tp", dp)),
        (r".*(out|ffn2)_weight$", (dp, "tp")),
        (r".*embed_weight$", ("tp", dp)),
        (r".*_bias$", (None,)),
    ])


# ---------------------------------------------------------------------------
# Search (greedy + beam) — bucketed KV-cache decode
# ---------------------------------------------------------------------------


def _bucket(n, max_len):
    b = 8
    while b < n:
        b *= 2
    return min(b, max_len)


def _tensor(x):
    return getattr(x, "_data", x)  # an NDArray's tensor, or the tensor itself


def _device_of(model):
    return next(iter(model.collect_params().values())).data().device


def _host_logits(t):
    return t.detach().float().cpu().numpy()


class _KVCacheDecoder:
    """Incremental decoder over bucketed K/V caches ``[L, B, bucket, H,
    dh]``: position t is written in place, the bucket doubles (a padded
    copy) when t reaches it, and attention reads the caches through
    strided views."""

    def __init__(self, model, memory, batch, max_length, dtype=None):
        cells = model.decoder._layers
        if not all(c._pre_norm for c in cells):
            raise NotImplementedError("KV-cache decode requires pre-norm cells")
        memory = _tensor(memory)
        self._model = model
        self._cells = cells
        self._units = model._units
        self._heads = cells[0].self_attention._num_heads
        self._dh = self._units // self._heads
        self._max_length = max_length
        if any(p._data is None for p in model.collect_params().values()):
            # deferred shapes: one [B, 1] decode materializes every weight
            model.decode(torch.zeros((batch, 1), dtype=torch.int32, device=memory.device),
                         memory)
        self._dtype = dtype or memory.dtype
        self._bucket = _bucket(1, max_length)
        L, B, H, dh = len(cells), batch, self._heads, self._dh
        with torch.no_grad():
            self._self_k = torch.zeros((L, B, self._bucket, H, dh), dtype=self._dtype,
                                       device=memory.device)
            self._self_v = torch.zeros_like(self._self_k)
            # cross-attention K/V depend only on the encoder memory: once a
            # layer, through the cells' own kv projections
            kv = [cell.cross_attention.kv_proj(memory).reshape(B, memory.shape[1], 2, H, dh)
                  for cell in cells]
            self._mem_k = torch.stack([a[:, :, 0] for a in kv]).to(self._dtype)
            self._mem_v = torch.stack([a[:, :, 1] for a in kv]).to(self._dtype)

    # -- cache maintenance ----------------------------------------------
    def _grow(self, needed):
        pad = lambda t, n: torch.nn.functional.pad(t, (0, 0, 0, 0, 0, n))  # noqa: E731
        while self._bucket < needed:
            new_b = min(self._bucket * 2, self._max_length)
            self._self_k = pad(self._self_k, new_b - self._bucket)
            self._self_v = pad(self._self_v, new_b - self._bucket)
            self._bucket = new_b

    def reorder(self, flat_indices):
        """Beam bookkeeping: permute the batch axis of the caches."""
        idx = torch.as_tensor(_np.asarray(flat_indices), dtype=torch.long,
                              device=self._self_k.device)
        self._self_k = self._self_k.index_select(1, idx)
        self._self_v = self._self_v.index_select(1, idx)

    # -- one step --------------------------------------------------------
    @torch.no_grad()
    def _logits(self, tok, t):
        model, H, dh, units = self._model, self._heads, self._dh, self._units
        B = tok.shape[0]
        x = model.embed(tok) * math.sqrt(units)
        x = x + model.pos_enc.table(x.device, x.dtype)[t]
        for l, cell in enumerate(self._cells):
            qkv = cell.self_attention.qkv(cell.ln_self(x)).reshape(B, 1, 3, H, dh)
            self._self_k[l, :, t] = qkv[:, 0, 1]
            self._self_v[l, :, t] = qkv[:, 0, 2]
            out = _att.flash_fwd(qkv[:, :, 0], self._self_k[l, :, :t + 1],
                                 self._self_v[l, :, :t + 1], layout="bshd")[0]
            x = x + cell.self_attention.out_proj(out.reshape(B, 1, units))
            q2 = cell.cross_attention.q_proj(cell.ln_cross(x)).reshape(B, 1, H, dh)
            out2 = _att.flash_fwd(q2, self._mem_k[l], self._mem_v[l], layout="bshd")[0]
            x = x + cell.cross_attention.out_proj(out2.reshape(B, 1, units))
            x = x + cell.ffn(cell.ln_ffn(x))
        if model._tie:
            return torch.matmul(x, model.embed.weight.data().to(x.dtype).t())[:, 0]
        return model.proj(x)[:, 0]

    def step(self, tok_np, t):
        """tok_np: [B] int32 tokens at position t → logits [B, V] (numpy)."""
        self._grow(t + 1)
        tok = torch.from_numpy(_np.ascontiguousarray(tok_np, dtype=_np.int32).reshape(-1, 1))
        return _host_logits(self._logits(tok.to(self._self_k.device), t))


def _step_logits(model, tgt_padded, memory, t):
    """Logits for position t given prefix tgt[:, :t+1], padded to a bucket
    length.  Causality guarantees positions > t cannot leak in."""
    return model.decode(tgt_padded, memory)[:, t]


def _tokens(arr, device):
    return torch.from_numpy(_np.ascontiguousarray(arr, dtype=_np.int32)).to(device)


def _source(model, src):
    """The source batch as an int tensor on the model's device (from an
    NDArray, a tensor or a numpy array)."""
    src = _tensor(src)
    if isinstance(src, torch.Tensor):
        return src.to(_device_of(model))
    return _tokens(src, _device_of(model))


def greedy_search(model, src, bos, eos, max_length=64, use_cache=True):
    """Greedy decode → (tokens [B, max_length], lengths [B]), numpy int32.

    ``use_cache=True`` (default) decodes through the bucketed KV cache;
    ``False`` re-runs the causal prefix (the oracle, and the path for a
    post-norm decoder)."""
    src = _source(model, src)
    with torch.no_grad():
        memory = _tensor(model.encode(src))
    B = src.shape[0]
    cache = None
    if use_cache:
        try:
            cache = _KVCacheDecoder(model, memory, B, max_length)
        except NotImplementedError:
            cache = None
    tokens = _np.full((B, max_length), eos, _np.int32)
    tokens[:, 0] = bos
    lengths = _np.full(B, max_length, _np.int32)
    done = _np.zeros(B, bool)
    for t in range(max_length - 1):
        if cache is not None:
            logits_np = cache.step(tokens[:, t], t)
        else:
            tb = _bucket(t + 1, max_length)
            with torch.no_grad():
                logits_np = _host_logits(_step_logits(
                    model, _tokens(tokens[:, :tb], memory.device), memory, t))
        nxt = logits_np.argmax(axis=-1).astype(_np.int32)
        nxt = _np.where(done, eos, nxt)
        tokens[:, t + 1] = nxt
        newly = (~done) & (nxt == eos)
        lengths[newly] = t + 2
        done |= nxt == eos
        if done.all():
            break
    return tokens, lengths


def beam_search(model, src, bos, eos, beam_size=4, max_length=64, alpha=0.6, use_cache=True):
    """Length-penalized beam search (GNMT penalty ((5+len)/6)^alpha).

    Returns (tokens [B, K, max_length], scores [B, K]) sorted best-first.
    The network decodes the [B·K] beam batch one step at a time (through
    the KV cache, whose batch axis follows the surviving beams); the beam
    bookkeeping is numpy on the host."""
    src = _source(model, src)
    with torch.no_grad():
        memory = _tensor(model.encode(src))           # [B, S, D]
    B, K = src.shape[0], beam_size
    mem = torch.repeat_interleave(memory, K, dim=0)  # [B·K, S, D]
    cache = None
    if use_cache:
        try:
            cache = _KVCacheDecoder(model, mem, B * K, max_length)
        except NotImplementedError:
            cache = None

    tokens = _np.full((B, K, max_length), eos, _np.int32)
    tokens[:, :, 0] = bos
    scores = _np.full((B, K), -_np.inf, _np.float64)
    scores[:, 0] = 0.0                  # only beam 0 live at t=0
    done = _np.zeros((B, K), bool)

    for t in range(max_length - 1):
        if cache is not None:
            logits_np = cache.step(tokens[:, :, t].reshape(B * K), t)
        else:
            tb = _bucket(t + 1, max_length)
            flat = tokens[:, :, :tb].reshape(B * K, tb)
            with torch.no_grad():
                logits_np = _host_logits(_step_logits(model, _tokens(flat, mem.device), mem, t))
        logp = _log_softmax_np(logits_np.astype(_np.float64))  # [B·K, V]
        V = logp.shape[-1]
        logp = logp.reshape(B, K, V)
        # finished beams only extend with eos at zero cost
        logp = _np.where(done[:, :, None],
                         _np.where(_np.arange(V)[None, None] == eos, 0.0, -_np.inf), logp)
        cand = scores[:, :, None] + logp            # [B, K, V]
        flat_cand = cand.reshape(B, K * V)
        top = _np.argsort(-flat_cand, axis=1)[:, :K]  # [B, K]
        new_scores = _np.take_along_axis(flat_cand, top, axis=1)
        src_beam = top // V
        nxt_tok = (top % V).astype(_np.int32)

        tokens = _np.take_along_axis(tokens, src_beam[:, :, None], axis=1)
        tokens[:, :, t + 1] = nxt_tok
        done = _np.take_along_axis(done, src_beam, axis=1) | (nxt_tok == eos)
        scores = new_scores
        if cache is not None:
            # permute the cache batch to follow the surviving beams
            cache.reorder((_np.arange(B)[:, None] * K + src_beam).reshape(-1))
        if done.all():
            break

    lengths = _np.argmax(tokens == eos, axis=-1) + 1
    lengths[~done] = max_length
    lp = ((5.0 + lengths) / 6.0) ** alpha
    final = scores / lp
    order = _np.argsort(-final, axis=1)
    return (_np.take_along_axis(tokens, order[:, :, None], axis=1),
            _np.take_along_axis(final, order, axis=1))


def _log_softmax_np(x):
    m = x.max(axis=-1, keepdims=True)
    e = _np.exp(x - m)
    return (x - m) - _np.log(e.sum(axis=-1, keepdims=True))
