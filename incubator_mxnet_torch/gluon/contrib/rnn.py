"""``gluon.contrib.rnn`` — experimental recurrent-cell extras.

Counterpart of the JAX package's ``gluon/contrib/rnn.py`` (parity target:
[U:python/mxnet/gluon/contrib/rnn/rnn_cell.py] and
[U:python/mxnet/gluon/contrib/rnn/conv_rnn_cell.py]):
``VariationalDropoutCell`` (one dropout mask shared across every time
step, Gal & Ghahramani 2016), ``LSTMPCell`` (LSTM with a hidden-state
projection, the LSTMP of Sak et al. 2014) and the 2-D convolutional cells
``Conv2DRNNCell``, ``Conv2DLSTMCell`` and ``Conv2DGRUCell``; the 1-D and
3-D ones are not in either package.  The variational masks are drawn once
a sequence from the port's generator and then reused.
"""
from __future__ import annotations

from ..rnn.rnn_cell import RecurrentCell, _ModifierCell

__all__ = ["VariationalDropoutCell", "LSTMPCell", "Conv2DRNNCell",
           "Conv2DLSTMCell", "Conv2DGRUCell"]


class VariationalDropoutCell(_ModifierCell):
    """Apply fixed dropout masks to inputs/states/outputs across all time
    steps of a sequence (parity: ``contrib.rnn.VariationalDropoutCell``).

    Masks are (re)drawn on the first call after ``reset()`` — one mask per
    role, shared by every subsequent step, so the same units are dropped
    for the whole sequence."""

    def __init__(self, base_cell, drop_inputs=0.0, drop_states=0.0, drop_outputs=0.0):
        super().__init__(base_cell)
        self.drop_inputs = drop_inputs
        self.drop_states = drop_states
        self.drop_outputs = drop_outputs
        self._input_mask = None
        self._state_mask = None
        self._output_mask = None

    def reset(self):
        super().reset()
        self._input_mask = None
        self._state_mask = None
        self._output_mask = None

    @staticmethod
    def _mask(p, like):
        from ... import ndarray as nd

        # Dropout of ones == scaled keep-mask (values 0 or 1/(1-p)); reusing
        # it IS the variational trick.
        return nd.Dropout(nd.ones_like(like), p=p, training=True)

    def __call__(self, inputs, states):
        from ... import autograd

        if not autograd.is_training():
            return self.base_cell(inputs, states)
        if self.drop_inputs:
            if self._input_mask is None:
                self._input_mask = self._mask(self.drop_inputs, inputs)
            inputs = inputs * self._input_mask
        if self.drop_states:
            if self._state_mask is None:
                self._state_mask = self._mask(self.drop_states, states[0])
            states = [states[0] * self._state_mask] + list(states[1:])
        output, next_states = self.base_cell(inputs, states)
        if self.drop_outputs:
            if self._output_mask is None:
                self._output_mask = self._mask(self.drop_outputs, output)
            output = output * self._output_mask
        return output, next_states

    def _alias(self):
        return "vardrop"

    def hybrid_forward(self, F, inputs, states):
        raise NotImplementedError  # stateful masks: dispatch is in __call__

    def __repr__(self):
        return (f"VariationalDropoutCell(p_in={self.drop_inputs}, "
                f"p_state={self.drop_states}, p_out={self.drop_outputs})")


class LSTMPCell(RecurrentCell):
    """LSTM cell with hidden-state projection (parity:
    ``contrib.rnn.LSTMPCell``).  Gate math matches :class:`LSTMCell`
    (order [i, f, g, o]); the output hidden state is ``r = W_r h`` with
    ``W_r`` of shape (projection_size, hidden_size), shrinking the
    recurrent matmul to (4h × p) — the Sak et al. LSTMP."""

    def __init__(self, hidden_size, projection_size,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 h2r_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 input_size=0, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._hidden_size = hidden_size
        self._projection_size = projection_size
        self._input_size = input_size
        with self.name_scope():
            self.i2h_weight = self.params.get(
                "i2h_weight", shape=(4 * hidden_size, input_size),
                init=i2h_weight_initializer, allow_deferred_init=True)
            self.h2h_weight = self.params.get(
                "h2h_weight", shape=(4 * hidden_size, projection_size),
                init=h2h_weight_initializer, allow_deferred_init=True)
            self.h2r_weight = self.params.get(
                "h2r_weight", shape=(projection_size, hidden_size),
                init=h2r_weight_initializer, allow_deferred_init=True)
            self.i2h_bias = self.params.get(
                "i2h_bias", shape=(4 * hidden_size,),
                init=i2h_bias_initializer, allow_deferred_init=True)
            self.h2h_bias = self.params.get(
                "h2h_bias", shape=(4 * hidden_size,),
                init=h2h_bias_initializer, allow_deferred_init=True)

    def state_info(self, batch_size=0):
        return [
            {"shape": (batch_size, self._projection_size), "__layout__": "NC"},
            {"shape": (batch_size, self._hidden_size), "__layout__": "NC"},
        ]

    def _alias(self):
        return "lstmp"

    def _shape_inference(self, x, *args):
        self.i2h_weight._finish_deferred_init((4 * self._hidden_size, x.shape[-1]))
        self.h2h_weight._finish_deferred_init((4 * self._hidden_size, self._projection_size))
        self.h2r_weight._finish_deferred_init((self._projection_size, self._hidden_size))
        self.i2h_bias._finish_deferred_init((4 * self._hidden_size,))
        self.h2h_bias._finish_deferred_init((4 * self._hidden_size,))

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight, h2r_weight,
                       i2h_bias, h2h_bias):
        prev_r, prev_c = states
        i2h = F.FullyConnected(inputs, i2h_weight, i2h_bias,
                               num_hidden=4 * self._hidden_size)
        h2h = F.FullyConnected(prev_r, h2h_weight, h2h_bias,
                               num_hidden=4 * self._hidden_size)
        gates = i2h + h2h
        slices = F.split(gates, num_outputs=4, axis=1)
        in_gate = F.sigmoid(slices[0])
        forget_gate = F.sigmoid(slices[1])
        in_transform = F.tanh(slices[2])
        out_gate = F.sigmoid(slices[3])
        next_c = forget_gate * prev_c + in_gate * in_transform
        hidden = out_gate * F.tanh(next_c)
        next_r = F.FullyConnected(hidden, h2r_weight, no_bias=True,
                                  num_hidden=self._projection_size)
        return next_r, [next_r, next_c]

    def __repr__(self):
        return (f"LSTMPCell({self._hidden_size} -> {self._projection_size})")


class _ConvRNNBase(RecurrentCell):
    """Shared machinery for the convolutional recurrent cells (parity:
    [U:python/mxnet/gluon/contrib/rnn/conv_rnn_cell.py]).  2-D variants
    (the Conv2D*Cell family): inputs [B, C, H, W].  Upstream conventions:
    ``i2h_pad`` defaults to VALID (0, 0) padding — the state's H/W is the
    i2h conv's output size — while the h2h conv is auto-'same'-padded over
    the state (odd h2h kernels required, as upstream's auto-pad assumes)."""

    def __init__(self, input_shape, hidden_channels, i2h_kernel, h2h_kernel,
                 n_gates, i2h_pad=(0, 0), activation="tanh", prefix=None,
                 params=None):
        super().__init__(prefix=prefix, params=params)
        self._input_shape = tuple(input_shape)  # (C, H, W)
        self._hc = hidden_channels
        self._gates = n_gates
        self._activation = activation

        def _pair(k):
            return (k, k) if isinstance(k, int) else tuple(k)

        self._i2h_kernel = _pair(i2h_kernel)
        self._h2h_kernel = _pair(h2h_kernel)
        for k in self._h2h_kernel:
            if k % 2 == 0:
                raise ValueError(
                    f"Conv cells need odd h2h kernels for same-padding, got {k}")
        self._i2h_pad = _pair(i2h_pad)
        self._h2h_pad = tuple(k // 2 for k in self._h2h_kernel)
        # state spatial dims = i2h conv output dims (upstream convention)
        self._state_hw = tuple(
            d + 2 * p - k + 1 for d, p, k in zip(
                self._input_shape[1:], self._i2h_pad, self._i2h_kernel))
        c = self._input_shape[0]
        with self.name_scope():
            self.i2h_weight = self.params.get(
                "i2h_weight",
                shape=(n_gates * hidden_channels, c) + self._i2h_kernel)
            self.h2h_weight = self.params.get(
                "h2h_weight",
                shape=(n_gates * hidden_channels, hidden_channels) + self._h2h_kernel)
            self.i2h_bias = self.params.get(
                "i2h_bias", shape=(n_gates * hidden_channels,), init="zeros")
            self.h2h_bias = self.params.get(
                "h2h_bias", shape=(n_gates * hidden_channels,), init="zeros")

    def state_info(self, batch_size=0):
        h, w = self._state_hw
        return [{"shape": (batch_size, self._hc, h, w), "__layout__": "NCHW"}
                for _ in range(self._n_states)]

    def _convs(self, F, inputs, state, i2h_weight, h2h_weight, i2h_bias, h2h_bias):
        i2h = F.Convolution(inputs, i2h_weight, i2h_bias,
                            kernel=self._i2h_kernel, pad=self._i2h_pad,
                            num_filter=self._gates * self._hc)
        h2h = F.Convolution(state, h2h_weight, h2h_bias,
                            kernel=self._h2h_kernel, pad=self._h2h_pad,
                            num_filter=self._gates * self._hc)
        return i2h, h2h


class Conv2DRNNCell(_ConvRNNBase):
    """Convolutional vanilla RNN cell (parity: ``contrib.rnn.Conv2DRNNCell``)."""

    _n_states = 1

    def __init__(self, input_shape, hidden_channels, i2h_kernel=(3, 3),
                 h2h_kernel=(3, 3), i2h_pad=(0, 0), activation="tanh",
                 prefix=None, params=None):
        super().__init__(input_shape, hidden_channels, i2h_kernel, h2h_kernel,
                         n_gates=1, i2h_pad=i2h_pad,
                         activation=activation, prefix=prefix, params=params)

    def _alias(self):
        return "conv_rnn"

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        i2h, h2h = self._convs(F, inputs, states[0], i2h_weight, h2h_weight,
                               i2h_bias, h2h_bias)
        out = self._get_activation(F, i2h + h2h, self._activation)
        return out, [out]


class Conv2DLSTMCell(_ConvRNNBase):
    """ConvLSTM (Shi et al. 2015; parity: ``contrib.rnn.Conv2DLSTMCell``);
    gate order [i, f, g, o] like :class:`LSTMCell`."""

    _n_states = 2

    def __init__(self, input_shape, hidden_channels, i2h_kernel=(3, 3),
                 h2h_kernel=(3, 3), i2h_pad=(0, 0), activation="tanh",
                 prefix=None, params=None):
        super().__init__(input_shape, hidden_channels, i2h_kernel, h2h_kernel,
                         n_gates=4, i2h_pad=i2h_pad,
                         activation=activation, prefix=prefix, params=params)

    def _alias(self):
        return "conv_lstm"

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        prev_h, prev_c = states
        i2h, h2h = self._convs(F, inputs, prev_h, i2h_weight, h2h_weight,
                               i2h_bias, h2h_bias)
        gates = i2h + h2h
        sl = F.split(gates, num_outputs=4, axis=1)
        i = F.sigmoid(sl[0])
        f = F.sigmoid(sl[1])
        g = self._get_activation(F, sl[2], self._activation)
        o = F.sigmoid(sl[3])
        next_c = f * prev_c + i * g
        next_h = o * self._get_activation(F, next_c, self._activation)
        return next_h, [next_h, next_c]


class Conv2DGRUCell(_ConvRNNBase):
    """ConvGRU (parity: ``contrib.rnn.Conv2DGRUCell``); gate order
    [r, z, n] like :class:`GRUCell`."""

    _n_states = 1

    def __init__(self, input_shape, hidden_channels, i2h_kernel=(3, 3),
                 h2h_kernel=(3, 3), i2h_pad=(0, 0), activation="tanh",
                 prefix=None, params=None):
        super().__init__(input_shape, hidden_channels, i2h_kernel, h2h_kernel,
                         n_gates=3, i2h_pad=i2h_pad,
                         activation=activation, prefix=prefix, params=params)

    def _alias(self):
        return "conv_gru"

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        prev_h = states[0]
        i2h, h2h = self._convs(F, inputs, prev_h, i2h_weight, h2h_weight,
                               i2h_bias, h2h_bias)
        i_sl = F.split(i2h, num_outputs=3, axis=1)
        h_sl = F.split(h2h, num_outputs=3, axis=1)
        r = F.sigmoid(i_sl[0] + h_sl[0])
        z = F.sigmoid(i_sl[1] + h_sl[1])
        n = self._get_activation(F, i_sl[2] + r * h_sl[2], self._activation)
        next_h = (1 - z) * n + z * prev_h
        return next_h, [next_h]
