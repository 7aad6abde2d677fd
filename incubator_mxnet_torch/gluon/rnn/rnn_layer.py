"""Fused RNN layers (parity: [U:python/mxnet/gluon/rnn/rnn_layer.py] —
``rnn.RNN/LSTM/GRU`` over the ``RNNFused`` op of ``ops/rnn_ops.py``, cuDNN
on the card).  Counterpart of the JAX package's ``gluon/rnn/rnn_layer.py``;
parameter naming matches the reference (``{l|r}{k}_i2h_weight`` ...) so
checkpoints transfer, and ``convert.load_numpy_params`` carries them by
structural key.  Dropout between layers draws from the port's generator of
the input's device."""
from __future__ import annotations

import torch

from ... import autograd
from ...random import get_generator
from ..block import HybridBlock

__all__ = ["RNN", "LSTM", "GRU"]


class _RNNLayer(HybridBlock):
    def __init__(self, hidden_size, num_layers, layout, dropout, bidirectional,
                 input_size, i2h_weight_initializer, h2h_weight_initializer,
                 i2h_bias_initializer, h2h_bias_initializer, mode, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        assert layout in ("TNC", "NTC"), f"Invalid layout {layout}; must be TNC or NTC"
        self._hidden_size = hidden_size
        self._num_layers = num_layers
        self._mode = mode
        self._layout = layout
        self._dropout = dropout
        self._dir = 2 if bidirectional else 1
        self._input_size = input_size
        self._gates = {"rnn_relu": 1, "rnn_tanh": 1, "lstm": 4, "gru": 3}[mode]
        ng, ni, nh = self._gates, input_size, hidden_size
        with self.name_scope():
            for i in range(num_layers):
                for j in ["l", "r"][: self._dir]:
                    name = f"{j}{i}_"
                    setattr(self, f"{name}i2h_weight", self.params.get(
                        f"{name}i2h_weight", shape=(ng * nh, ni if i == 0 else nh * self._dir),
                        init=i2h_weight_initializer, allow_deferred_init=True))
                    setattr(self, f"{name}h2h_weight", self.params.get(
                        f"{name}h2h_weight", shape=(ng * nh, nh),
                        init=h2h_weight_initializer, allow_deferred_init=True))
                    setattr(self, f"{name}i2h_bias", self.params.get(
                        f"{name}i2h_bias", shape=(ng * nh,),
                        init=i2h_bias_initializer, allow_deferred_init=True))
                    setattr(self, f"{name}h2h_bias", self.params.get(
                        f"{name}h2h_bias", shape=(ng * nh,),
                        init=h2h_bias_initializer, allow_deferred_init=True))

    def state_info(self, batch_size=0):
        if self._mode == "lstm":
            return [
                {"shape": (self._num_layers * self._dir, batch_size, self._hidden_size), "__layout__": "LNC"},
                {"shape": (self._num_layers * self._dir, batch_size, self._hidden_size), "__layout__": "LNC"},
            ]
        return [{"shape": (self._num_layers * self._dir, batch_size, self._hidden_size), "__layout__": "LNC"}]

    def begin_state(self, batch_size=0, func=None, **kwargs):
        from ... import ndarray as nd

        if func is None:
            func = nd.zeros
        return [func(info["shape"], **kwargs) for info in self.state_info(batch_size)]

    def _shape_inference(self, x, *args):
        in_size = x.shape[-1]
        ng, nh = self._gates, self._hidden_size
        for i in range(self._num_layers):
            for j in ["l", "r"][: self._dir]:
                name = f"{j}{i}_"
                getattr(self, f"{name}i2h_weight")._finish_deferred_init(
                    (ng * nh, in_size if i == 0 else nh * self._dir))
                getattr(self, f"{name}h2h_weight")._finish_deferred_init((ng * nh, nh))
                getattr(self, f"{name}i2h_bias")._finish_deferred_init((ng * nh,))
                getattr(self, f"{name}h2h_bias")._finish_deferred_init((ng * nh,))

    def hybrid_forward(self, F, inputs, states=None, **params):
        if self._layout == "NTC":
            inputs = F.swapaxes(inputs, 0, 1)
        batch = inputs.shape[1]
        skip_states = states is None
        if states is None:
            states = [torch.zeros(info["shape"], dtype=inputs.dtype, device=inputs.device)
                      for info in self.state_info(batch)]
        if not isinstance(states, (list, tuple)):
            states = [states]
        h0 = states[0]
        c0 = states[1] if self._mode == "lstm" else states[0]
        weights = []
        for i in range(self._num_layers):
            for j in ["l", "r"][: self._dir]:
                name = f"{j}{i}_"
                weights.extend([
                    params[f"{name}i2h_weight"],
                    params[f"{name}h2h_weight"],
                    params[f"{name}i2h_bias"],
                    params[f"{name}h2h_bias"],
                ])
        training = autograd.is_training()
        out = F.RNNFused(
            inputs, h0, c0, *weights,
            mode=self._mode, num_layers=self._num_layers, hidden_size=self._hidden_size,
            bidirectional=self._dir == 2, dropout=self._dropout, training=training,
            key=get_generator(inputs.device) if (self._dropout > 0 and training) else None,
        )
        if self._mode == "lstm":
            output, h_n, c_n = out
            out_states = [h_n, c_n]
        else:
            output, h_n = out
            out_states = [h_n]
        if self._layout == "NTC":
            output = F.swapaxes(output, 0, 1)
        if skip_states:
            return output
        return output, out_states

    def __repr__(self):
        return (f"{type(self).__name__}({self._input_size or '?'} -> {self._hidden_size}, "
                f"{self._layout}, layers={self._num_layers}"
                + (", bidirectional" if self._dir == 2 else "") + ")")


class RNN(_RNNLayer):
    """Parity: ``rnn.RNN``."""

    def __init__(self, hidden_size, num_layers=1, activation="relu", layout="TNC", dropout=0,
                 bidirectional=False, i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros", input_size=0,
                 prefix=None, params=None):
        super().__init__(hidden_size, num_layers, layout, dropout, bidirectional, input_size,
                         i2h_weight_initializer, h2h_weight_initializer, i2h_bias_initializer,
                         h2h_bias_initializer, "rnn_" + activation, prefix=prefix, params=params)


class LSTM(_RNNLayer):
    """Parity: ``rnn.LSTM`` (the fused op; cuDNN on the card)."""

    def __init__(self, hidden_size, num_layers=1, layout="TNC", dropout=0, bidirectional=False,
                 input_size=0, i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros", prefix=None, params=None):
        super().__init__(hidden_size, num_layers, layout, dropout, bidirectional, input_size,
                         i2h_weight_initializer, h2h_weight_initializer, i2h_bias_initializer,
                         h2h_bias_initializer, "lstm", prefix=prefix, params=params)


class GRU(_RNNLayer):
    """Parity: ``rnn.GRU``."""

    def __init__(self, hidden_size, num_layers=1, layout="TNC", dropout=0, bidirectional=False,
                 input_size=0, i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros", prefix=None, params=None):
        super().__init__(hidden_size, num_layers, layout, dropout, bidirectional, input_size,
                         i2h_weight_initializer, h2h_weight_initializer, i2h_bias_initializer,
                         h2h_bias_initializer, "gru", prefix=prefix, params=params)
