"""Transformer layers: the encoder (BERT conventions by default: post-LN,
GELU, learned positions; pre-LN on request), the decoder (causal
self-attention, cross-attention over the encoder's memory, FFN) and the
sinusoidal position table of the WMT Transformer.

Counterpart of the JAX package's ``gluon/nn/transformer.py``, with the
same parameter names.  Self-attention is one fused QKV projection whose
``[B, S, 3·D]`` output goes to ``fused_qkv_attention`` as it is,
cross-attention a q projection and one fused KV projection of the memory
(``fused_kv_attention``); on the card both reach the port's
flash-attention kernel.  The JAX ``PositionwiseFFN``'s rematerialization
switch ``MXNET_TPU_REMAT_FFN`` is a checkpoint policy of the JAX trace
and has no counterpart: the port runs eagerly, and PyTorch saves what
autograd needs.
"""
from __future__ import annotations

import numpy as _np
import torch

from ...ops.registry import nd as F
from ..block import HybridBlock
from .basic_layers import Dense, Dropout, Embedding, LayerNorm

__all__ = ["MultiHeadAttention", "PositionwiseFFN", "TransformerEncoderCell",
           "TransformerEncoder", "TransformerDecoderCell", "TransformerDecoder",
           "PositionalEmbedding", "SinusoidalPositionalEncoding"]


class MultiHeadAttention(HybridBlock):
    """Multi-head attention with fused QKV projection.  Inputs [B, S, D];
    with ``cross=True``, a [B, S_kv, D] memory supplies keys and values."""

    def __init__(self, units, num_heads, dropout=0.0, causal=False, use_bias=True,
                 cross=False, dtype="float32", prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        if units % num_heads:
            raise ValueError(f"units {units} not divisible by num_heads {num_heads}")
        self._units = units
        self._num_heads = num_heads
        self._causal = causal
        self._cross = cross
        with self.name_scope():
            if cross:
                self.q_proj = Dense(units, use_bias=use_bias, flatten=False, dtype=dtype, prefix="q_")
                self.kv_proj = Dense(2 * units, use_bias=use_bias, flatten=False, dtype=dtype, prefix="kv_")
            else:
                self.qkv = Dense(3 * units, use_bias=use_bias, flatten=False, dtype=dtype, prefix="qkv_")
            self.out_proj = Dense(units, use_bias=use_bias, flatten=False, dtype=dtype, prefix="out_")
        self._dropout = Dropout(dropout) if dropout else None
        if self._dropout is not None:
            self.register_child(self._dropout, "dropout")

    def forward(self, x, memory=None):
        H = self._num_heads
        if self._cross:
            if memory is None:
                raise ValueError("cross-attention requires a memory input")
            out = F.contrib.fused_kv_attention(self.q_proj(x), self.kv_proj(memory),
                                               num_heads=H, causal=self._causal)
        else:
            out = F.contrib.fused_qkv_attention(self.qkv(x), num_heads=H, causal=self._causal)
        out = self.out_proj(out)
        if self._dropout is not None:
            out = self._dropout(out)
        return out


class PositionwiseFFN(HybridBlock):
    """Dense → activation → (dropout) → Dense."""

    def __init__(self, units, hidden_size, activation="gelu", dropout=0.0,
                 dtype="float32", prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        with self.name_scope():
            self.ffn_1 = Dense(hidden_size, flatten=False, dtype=dtype, prefix="ffn1_")
            self.ffn_2 = Dense(units, flatten=False, dtype=dtype, prefix="ffn2_")
        self._activation = activation
        self._dropout = Dropout(dropout) if dropout else None
        if self._dropout is not None:
            self.register_child(self._dropout, "dropout")

    def forward(self, x):
        h = self.ffn_1(x)
        if self._activation == "gelu":
            h = F.LeakyReLU(h, act_type="gelu")
        else:
            h = F.Activation(h, act_type=self._activation)
        if self._dropout is not None:
            h = self._dropout(h)
        return self.ffn_2(h)


class TransformerEncoderCell(HybridBlock):
    """Encoder layer: post-LN by default (the BERT convention), pre-LN with
    ``pre_norm=True`` (LayerNorm before attention and before the FFN, the
    residual added outside).  The residual dropout is applied once, by
    this cell."""

    def __init__(self, units, hidden_size, num_heads, dropout=0.0, pre_norm=False,
                 activation="gelu", dtype="float32", prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._pre_norm = pre_norm
        with self.name_scope():
            self.attention = MultiHeadAttention(units, num_heads, dropout=0.0, dtype=dtype, prefix="attn_")
            self.ln_attn = LayerNorm(prefix="ln1_")
            self.ffn = PositionwiseFFN(units, hidden_size, activation, dropout=0.0, dtype=dtype, prefix="ffn_")
            self.ln_ffn = LayerNorm(prefix="ln2_")
        self._drop = Dropout(dropout) if dropout else None
        if self._drop is not None:
            self.register_child(self._drop, "dropout")

    def forward(self, x):
        d = self._drop if self._drop is not None else (lambda t: t)
        if self._pre_norm:
            x = x + d(self.attention(self.ln_attn(x)))
            return x + d(self.ffn(self.ln_ffn(x)))
        x = self.ln_attn(x + d(self.attention(x)))
        return self.ln_ffn(x + d(self.ffn(x)))


class TransformerEncoder(HybridBlock):
    def __init__(self, num_layers, units, hidden_size, num_heads, dropout=0.0, pre_norm=False,
                 activation="gelu", dtype="float32", prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._layers = []
        with self.name_scope():
            for i in range(num_layers):
                cell = TransformerEncoderCell(units, hidden_size, num_heads, dropout, pre_norm,
                                              activation, dtype=dtype, prefix=f"layer{i}_")
                self.register_child(cell, f"layer{i}")
                self._layers.append(cell)

    def forward(self, x):
        for cell in self._layers:
            x = cell(x)
        return x


class TransformerDecoderCell(HybridBlock):
    """Decoder layer: causal self-attention, cross-attention over the
    memory, FFN; post-LN by default, pre-LN with ``pre_norm=True``.  The
    residual dropout is applied once, by this cell."""

    def __init__(self, units, hidden_size, num_heads, dropout=0.0, pre_norm=False,
                 activation="relu", dtype="float32", prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._pre_norm = pre_norm
        with self.name_scope():
            self.self_attention = MultiHeadAttention(units, num_heads, dropout=0.0, causal=True,
                                                     dtype=dtype, prefix="selfattn_")
            self.ln_self = LayerNorm(prefix="ln1_")
            self.cross_attention = MultiHeadAttention(units, num_heads, dropout=0.0, cross=True,
                                                      dtype=dtype, prefix="crossattn_")
            self.ln_cross = LayerNorm(prefix="ln2_")
            self.ffn = PositionwiseFFN(units, hidden_size, activation, dropout=0.0, dtype=dtype,
                                       prefix="ffn_")
            self.ln_ffn = LayerNorm(prefix="ln3_")
        self._drop = Dropout(dropout) if dropout else None
        if self._drop is not None:
            self.register_child(self._drop, "dropout")

    def forward(self, x, memory):
        d = self._drop if self._drop is not None else (lambda t: t)
        if self._pre_norm:
            x = x + d(self.self_attention(self.ln_self(x)))
            x = x + d(self.cross_attention(self.ln_cross(x), memory))
            return x + d(self.ffn(self.ln_ffn(x)))
        x = self.ln_self(x + d(self.self_attention(x)))
        x = self.ln_cross(x + d(self.cross_attention(x, memory)))
        return self.ln_ffn(x + d(self.ffn(x)))


class TransformerDecoder(HybridBlock):
    def __init__(self, num_layers, units, hidden_size, num_heads, dropout=0.0, pre_norm=False,
                 activation="relu", dtype="float32", prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._layers = []
        with self.name_scope():
            for i in range(num_layers):
                cell = TransformerDecoderCell(units, hidden_size, num_heads, dropout, pre_norm,
                                              activation, dtype=dtype, prefix=f"layer{i}_")
                self.register_child(cell, f"layer{i}")
                self._layers.append(cell)

    def forward(self, x, memory):
        for cell in self._layers:
            x = cell(x, memory)
        return x


class PositionalEmbedding(HybridBlock):
    """Learned positional embedding (BERT style): x [B, S, D] → x + pos[:S]."""

    def __init__(self, max_length, units, dtype="float32", prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        with self.name_scope():
            self.embed = Embedding(max_length, units, dtype=dtype, prefix="pos_")

    def forward(self, x):
        return x + self.embed(F.arange(0, x.shape[1], ctx=x.device, dtype="int32"))


def sinusoidal_table(units, max_length):
    """The WMT Transformer's position table, float32 ``[max_length,
    units]``: sin at even columns, cos at odd ones, of pos / 10000^(2i /
    units) (an odd ``units`` has one sine column more than cosines)."""
    pos = _np.arange(max_length)[:, None]
    dim = _np.arange((units + 1) // 2)[None, :]
    angle = pos / _np.power(10000.0, 2 * dim / units)
    table = _np.zeros((max_length, units), dtype=_np.float32)
    table[:, 0::2] = _np.sin(angle)
    table[:, 1::2] = _np.cos(angle[:, : units // 2])
    return table


class SinusoidalPositionalEncoding(HybridBlock):
    """Fixed sinusoidal encoding (WMT Transformer); no parameters.  The
    numpy float32 ``_table`` is kept (the serving adapter reads it); it is
    added in ``x``'s dtype, so a bf16 network stays bf16."""

    def __init__(self, units, max_length=4096, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._units = units
        self._table = sinusoidal_table(units, max_length)
        self._device_tables = {}

    def table(self, device, dtype):
        """The table as a tensor on ``device`` in ``dtype``, made once a
        (device, dtype)."""
        key = (str(device), dtype)
        t = self._device_tables.get(key)
        if t is None:
            t = self._device_tables[key] = torch.from_numpy(self._table).to(device, dtype)
        return t

    def forward(self, x):
        return x + self.table(x.device, x.dtype)[: x.shape[1]]
