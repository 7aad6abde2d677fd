"""Fused multi-layer RNN: the ``RNN`` op and the ``RNNFused`` op the Gluon
layers run.

Counterpart of the JAX package's ``ops/rnn_ops.py`` (parity target: the
reference's cuDNN fused path, [U:src/operator/rnn.cc],
[U:src/operator/nn/cudnn/cudnn_rnn-inl.h]).  The JAX package runs one
``lax.scan`` a layer and direction; no hand-written kernel stands behind
it.  The port calls PyTorch's fused RNN functions (``torch.lstm``,
``torch.gru``, ``torch.rnn_tanh``, ``torch.rnn_relu``): cuDNN on a CUDA
tensor, the reference's own GPU path, and PyTorch's CPU loop on a CPU
tensor, through one code path.  Their gate orders ([i, f, g, o] and
[r, z, n]), the GRU's reset-after-matmul form, the packing order and the
bidirectional state order are the JAX op's.

The packed ``parameters`` of ``RNN`` are cut into views in the reference's
layout (every weight first, then every bias).  That is not cuDNN's own flat
layout, so on the card cuDNN copies the weights into its buffer at every
call.  Dropout between layers draws its masks from the port's generator
passed as ``key``, one layer at a time, as the JAX op draws from its key;
PyTorch's own ``dropout=`` would draw from PyTorch's global generator.
"""
from __future__ import annotations

import torch

from .registry import register

_GATES = {"rnn_tanh": 1, "rnn_relu": 1, "lstm": 4, "gru": 3}
_FUSED = {"rnn_tanh": torch.rnn_tanh, "rnn_relu": torch.rnn_relu, "lstm": torch.lstm,
          "gru": torch.gru}


def _n_gates(mode):
    try:
        return _GATES[mode]
    except KeyError:
        raise ValueError(mode) from None


def rnn_param_size(mode, input_size, state_size, num_layers=1, bidirectional=False):
    """Length of the packed flat parameter vector the ``RNN`` op consumes
    (the reference's GetRnnParamSize, [U:src/operator/rnn-inl.h])."""
    n_gates = _n_gates(mode)
    dirs = 2 if bidirectional else 1
    H = int(state_size)
    total = 0
    for layer in range(int(num_layers)):
        in_dim = int(input_size) if layer == 0 else H * dirs
        total += dirs * (n_gates * H * (in_dim + H)  # i2h + h2h weights
                         + 2 * n_gates * H)          # i2h + h2h biases
    return total


def _unpack_rnn_params(parameters, mode, input_size, state_size, num_layers,
                       bidirectional):
    """Views of the flat vector, per layer and direction (w_i2h, w_h2h,
    b_i2h, b_h2h): every weight first (layer-major, direction-minor, i2h
    before h2h), then every bias in the same order."""
    n_gates = _n_gates(mode)
    dirs = 2 if bidirectional else 1
    H = int(state_size)
    offset = 0

    def take(*shape):
        nonlocal offset
        n = 1
        for s in shape:
            n *= s
        out = parameters[offset:offset + n].reshape(shape)
        offset += n
        return out

    groups = []
    for layer in range(int(num_layers)):
        in_dim = int(input_size) if layer == 0 else H * dirs
        for _ in range(dirs):
            groups.append([take(n_gates * H, in_dim), take(n_gates * H, H)])
    for g in groups:
        g.append(take(n_gates * H))  # b_i2h
        g.append(take(n_gates * H))  # b_h2h
    if offset != parameters.shape[0]:
        raise ValueError(
            f"RNN parameters length {parameters.shape[0]} != expected {offset} "
            f"for mode={mode} input_size={input_size} state_size={state_size} "
            f"num_layers={num_layers} bidirectional={bidirectional}")
    return [w for g in groups for w in g]


@register("RNN")
def rnn_mega(data, parameters, state=None, state_cell=None, *, mode="lstm",
             state_size=0, num_layers=1, bidirectional=False, p=0.0,
             state_outputs=False, training=False, key=None,
             projection_size=None, lstm_state_clip_min=None,
             lstm_state_clip_max=None, lstm_state_clip_nan=False,
             use_sequence_length=False, sequence_length=None):
    """The reference's fused RNN op under its name and signature: ``data``
    (T, N, C), ``parameters`` the packed flat vector (see
    ``_unpack_rnn_params``), ``state`` (L*dirs, N, H), ``state_cell``
    likewise for LSTM.  ``p`` is the dropout between layers, applied when
    ``training`` and a generator ``key`` are given.  Returns ``out``, or
    with ``state_outputs`` ``(out, h_n)`` / ``(out, h_n, c_n)`` for LSTM."""
    if projection_size is not None:
        raise NotImplementedError(
            "RNN projection_size (LSTMP) is not supported; use an explicit "
            "Dense projection after the layer")
    if lstm_state_clip_min is not None or lstm_state_clip_max is not None \
            or lstm_state_clip_nan:
        raise NotImplementedError("RNN lstm_state_clip_* is not supported")
    if use_sequence_length:
        # the flag, not a sequence_length tensor alone, is what the
        # reference acts on
        raise NotImplementedError(
            "RNN use_sequence_length is not supported; mask outputs with "
            "SequenceMask instead")
    H = int(state_size)
    flat = _unpack_rnn_params(parameters, mode, data.shape[2], H,
                              num_layers, bidirectional)
    dirs = 2 if bidirectional else 1
    if mode == "lstm" and (state is None) != (state_cell is None):
        raise ValueError(
            "LSTM mode takes BOTH state and state_cell, or neither "
            "(omitting both synthesizes zero initial states)")
    if state is None:  # zero initial states, the ONNX default
        state = torch.zeros((int(num_layers) * dirs, data.shape[1], H),
                            dtype=data.dtype, device=data.device)
        if mode == "lstm":
            state_cell = torch.zeros_like(state)
    c0 = state_cell if mode == "lstm" else state  # unused outside LSTM
    res = rnn_fused(data, state, c0, *flat, mode=mode, num_layers=int(num_layers),
                    hidden_size=H, bidirectional=bool(bidirectional), dropout=float(p),
                    training=training, key=key)
    if state_outputs:
        return res
    return res[0]


def _fused_call(mode, x, h0, c0, weights, num_layers, bidirectional):
    hx = [h0, c0] if mode == "lstm" else h0
    # ``train`` keeps cuDNN's reserve space for the backward (the dropout
    # between layers is this module's, so PyTorch's is 0)
    return _FUSED[mode](x, hx, list(weights), True, num_layers, 0.0,
                        torch.is_grad_enabled(), bidirectional, False)


@register("RNNFused")
def rnn_fused(data, h0, c0, *weights, mode="lstm", num_layers=1, hidden_size=0,
              bidirectional=False, dropout=0.0, training=False, key=None):
    """data: (T, N, C); h0/c0: (num_layers*dirs, N, H); weights: per layer,
    per direction: i2h_w, h2h_w, i2h_b, h2h_b.  Returns (out, h_n[, c_n]).
    With ``dropout``, ``training`` and a generator ``key`` the layers run
    one at a time, a mask drawn from ``key`` between two of them."""
    _n_gates(mode)
    dirs = 2 if bidirectional else 1
    if not (dropout > 0 and training and key is not None and num_layers > 1):
        return tuple(_fused_call(mode, data, h0, c0, weights, num_layers, bidirectional))
    x, h_n, c_n = data, [], []
    per = 4 * dirs
    for layer in range(num_layers):
        rows = slice(layer * dirs, (layer + 1) * dirs)
        out = _fused_call(mode, x, h0[rows], c0[rows], weights[layer * per:(layer + 1) * per],
                          1, bidirectional)
        x = out[0]
        h_n.append(out[1])
        if mode == "lstm":
            c_n.append(out[2])
        if layer < num_layers - 1:
            keep = torch.empty(x.shape, device=x.device).bernoulli_(
                1 - dropout, generator=key).to(x.dtype)
            x = x * keep / (1 - dropout)
    if mode == "lstm":
        return x, torch.cat(h_n), torch.cat(c_n)
    return x, torch.cat(h_n)
