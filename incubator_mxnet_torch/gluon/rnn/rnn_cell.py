"""Recurrent cells (parity: [U:python/mxnet/gluon/rnn/rnn_cell.py]).

Counterpart of the JAX package's ``gluon/rnn/rnn_cell.py``.  Gate orders
match the reference exactly (LSTM: [i, f, g, o] with the forget-gate slice
at [h:2h] — the contract LSTMBias init depends on; GRU: [r, z, n]), so
checkpoints and ported code behave identically.  Cells unroll as Python
loops of eager steps; the fused path is ``rnn_layer.py``.  ``unroll``
takes NDArrays or tensors and gives back the same kind (the ``mx.nd``
currency rule).
"""
from __future__ import annotations

import torch

from ...ndarray.ndarray import _ctx_of
from ..block import HybridBlock

__all__ = [
    "RecurrentCell",
    "RNNCell",
    "LSTMCell",
    "GRUCell",
    "SequentialRNNCell",
    "DropoutCell",
    "ResidualCell",
    "BidirectionalCell",
    "ZoneoutCell",
]


def _context(x):
    """The context of an NDArray or a tensor."""
    return x.context if hasattr(x, "context") else _ctx_of(x.device)


def _like_inputs(states, x):
    """``states`` as tensors when the input ``x`` is a tensor."""
    if isinstance(x, torch.Tensor):
        return [getattr(s, "_data", s) for s in states]
    return states


def _cells_state_info(cells, batch_size):
    return sum([c.state_info(batch_size) for c in cells], [])


def _cells_begin_state(cells, **kwargs):
    return sum([c.begin_state(**kwargs) for c in cells], [])


class RecurrentCell(HybridBlock):
    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._modified = False
        self.reset()

    def reset(self):
        self._init_counter = -1
        self._counter = -1
        for _, cell in self._child_blocks():
            if isinstance(cell, RecurrentCell):
                cell.reset()

    def state_info(self, batch_size=0):
        raise NotImplementedError

    def begin_state(self, batch_size=0, func=None, **kwargs):
        from ... import ndarray as nd

        if func is None:
            func = nd.zeros
        states = []
        for info in self.state_info(batch_size):
            self._init_counter += 1
            info = dict(info)
            shape = info.pop("shape")
            info.pop("__layout__", None)
            states.append(func(shape, **{**info, **kwargs}))
        return states

    def __call__(self, inputs, states, *args):
        self._counter += 1
        return super().__call__(inputs, states, *args)

    def forward(self, inputs, states):
        from ..block import HybridBlock as _HB

        return _HB.forward(self, inputs, states)

    def unroll(self, length, inputs, begin_state=None, layout="NTC", merge_outputs=None,
               valid_length=None):
        """Unroll over time (parity: ``RecurrentCell.unroll``)."""
        from ... import ndarray as nd

        self.reset()
        axis = layout.find("T")
        if not isinstance(inputs, (list, tuple)):
            inputs = [
                nd.squeeze(nd.slice_axis(inputs, axis=axis, begin=i, end=i + 1), axis=axis)
                for i in range(length)
            ]
        if begin_state is None:
            batch = inputs[0].shape[0]
            begin_state = _like_inputs(
                self.begin_state(batch_size=batch, ctx=_context(inputs[0])), inputs[0])
        states = begin_state
        outputs = []
        for i in range(length):
            out, states = self(inputs[i], states)
            outputs.append(out)
        if valid_length is not None:
            stacked = nd.stack(*outputs, axis=axis)
            stacked = nd.SequenceMask(
                stacked if axis == 0 else nd.swapaxes(stacked, 0, 1),
                sequence_length=valid_length,
                use_sequence_length=True,
            )
            if axis != 0:
                stacked = nd.swapaxes(stacked, 0, 1)
            outputs = stacked
            if merge_outputs is False:
                outputs = [
                    nd.squeeze(nd.slice_axis(outputs, axis=axis, begin=i, end=i + 1), axis=axis)
                    for i in range(length)
                ]
        elif merge_outputs or merge_outputs is None:
            outputs = nd.stack(*outputs, axis=axis)
        return outputs, states

    def _get_activation(self, F, inputs, activation, **kwargs):
        if isinstance(activation, str):
            return F.Activation(inputs, act_type=activation, **kwargs)
        return activation(inputs)


class RNNCell(RecurrentCell):
    """Vanilla RNN cell (parity: ``rnn.RNNCell``)."""

    def __init__(self, hidden_size, activation="tanh", i2h_weight_initializer=None,
                 h2h_weight_initializer=None, i2h_bias_initializer="zeros",
                 h2h_bias_initializer="zeros", input_size=0, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._hidden_size = hidden_size
        self._activation = activation
        self._input_size = input_size
        with self.name_scope():
            self.i2h_weight = self.params.get("i2h_weight", shape=(hidden_size, input_size),
                                              init=i2h_weight_initializer, allow_deferred_init=True)
            self.h2h_weight = self.params.get("h2h_weight", shape=(hidden_size, hidden_size),
                                              init=h2h_weight_initializer, allow_deferred_init=True)
            self.i2h_bias = self.params.get("i2h_bias", shape=(hidden_size,),
                                            init=i2h_bias_initializer, allow_deferred_init=True)
            self.h2h_bias = self.params.get("h2h_bias", shape=(hidden_size,),
                                            init=h2h_bias_initializer, allow_deferred_init=True)

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size), "__layout__": "NC"}]

    def _alias(self):
        return "rnn"

    def _shape_inference(self, x, *args):
        self.i2h_weight._finish_deferred_init((self._hidden_size, x.shape[-1]))
        self.h2h_weight._finish_deferred_init((self._hidden_size, self._hidden_size))
        self.i2h_bias._finish_deferred_init((self._hidden_size,))
        self.h2h_bias._finish_deferred_init((self._hidden_size,))

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight, i2h_bias, h2h_bias):
        i2h = F.FullyConnected(inputs, i2h_weight, i2h_bias, num_hidden=self._hidden_size)
        h2h = F.FullyConnected(states[0], h2h_weight, h2h_bias, num_hidden=self._hidden_size)
        output = self._get_activation(F, i2h + h2h, self._activation)
        return output, [output]


class LSTMCell(RecurrentCell):
    """LSTM cell, gate order [i, f, g, o] (parity: ``rnn.LSTMCell``)."""

    def __init__(self, hidden_size, i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros", input_size=0,
                 activation="tanh", recurrent_activation="sigmoid", prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._hidden_size = hidden_size
        self._input_size = input_size
        self._activation = activation
        self._recurrent_activation = recurrent_activation
        with self.name_scope():
            self.i2h_weight = self.params.get("i2h_weight", shape=(4 * hidden_size, input_size),
                                              init=i2h_weight_initializer, allow_deferred_init=True)
            self.h2h_weight = self.params.get("h2h_weight", shape=(4 * hidden_size, hidden_size),
                                              init=h2h_weight_initializer, allow_deferred_init=True)
            self.i2h_bias = self.params.get("i2h_bias", shape=(4 * hidden_size,),
                                            init=i2h_bias_initializer, allow_deferred_init=True)
            self.h2h_bias = self.params.get("h2h_bias", shape=(4 * hidden_size,),
                                            init=h2h_bias_initializer, allow_deferred_init=True)

    def state_info(self, batch_size=0):
        return [
            {"shape": (batch_size, self._hidden_size), "__layout__": "NC"},
            {"shape": (batch_size, self._hidden_size), "__layout__": "NC"},
        ]

    def _alias(self):
        return "lstm"

    def _shape_inference(self, x, *args):
        self.i2h_weight._finish_deferred_init((4 * self._hidden_size, x.shape[-1]))
        self.h2h_weight._finish_deferred_init((4 * self._hidden_size, self._hidden_size))
        self.i2h_bias._finish_deferred_init((4 * self._hidden_size,))
        self.h2h_bias._finish_deferred_init((4 * self._hidden_size,))

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight, i2h_bias, h2h_bias):
        i2h = F.FullyConnected(inputs, i2h_weight, i2h_bias, num_hidden=4 * self._hidden_size)
        h2h = F.FullyConnected(states[0], h2h_weight, h2h_bias, num_hidden=4 * self._hidden_size)
        gates = i2h + h2h
        slices = F.split(gates, num_outputs=4, axis=1)
        in_gate = self._get_activation(F, slices[0], self._recurrent_activation)
        forget_gate = self._get_activation(F, slices[1], self._recurrent_activation)
        in_transform = self._get_activation(F, slices[2], self._activation)
        out_gate = self._get_activation(F, slices[3], self._recurrent_activation)
        next_c = forget_gate * states[1] + in_gate * in_transform
        next_h = out_gate * self._get_activation(F, next_c, self._activation)
        return next_h, [next_h, next_c]


class GRUCell(RecurrentCell):
    """GRU cell, gate order [r, z, n] (parity: ``rnn.GRUCell``)."""

    def __init__(self, hidden_size, i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros", input_size=0,
                 prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._hidden_size = hidden_size
        self._input_size = input_size
        with self.name_scope():
            self.i2h_weight = self.params.get("i2h_weight", shape=(3 * hidden_size, input_size),
                                              init=i2h_weight_initializer, allow_deferred_init=True)
            self.h2h_weight = self.params.get("h2h_weight", shape=(3 * hidden_size, hidden_size),
                                              init=h2h_weight_initializer, allow_deferred_init=True)
            self.i2h_bias = self.params.get("i2h_bias", shape=(3 * hidden_size,),
                                            init=i2h_bias_initializer, allow_deferred_init=True)
            self.h2h_bias = self.params.get("h2h_bias", shape=(3 * hidden_size,),
                                            init=h2h_bias_initializer, allow_deferred_init=True)

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size), "__layout__": "NC"}]

    def _alias(self):
        return "gru"

    def _shape_inference(self, x, *args):
        self.i2h_weight._finish_deferred_init((3 * self._hidden_size, x.shape[-1]))
        self.h2h_weight._finish_deferred_init((3 * self._hidden_size, self._hidden_size))
        self.i2h_bias._finish_deferred_init((3 * self._hidden_size,))
        self.h2h_bias._finish_deferred_init((3 * self._hidden_size,))

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight, i2h_bias, h2h_bias):
        prev_h = states[0]
        i2h = F.FullyConnected(inputs, i2h_weight, i2h_bias, num_hidden=3 * self._hidden_size)
        h2h = F.FullyConnected(prev_h, h2h_weight, h2h_bias, num_hidden=3 * self._hidden_size)
        i2h_r, i2h_z, i2h_n = F.split(i2h, num_outputs=3, axis=1)
        h2h_r, h2h_z, h2h_n = F.split(h2h, num_outputs=3, axis=1)
        reset = F.sigmoid(i2h_r + h2h_r)
        update = F.sigmoid(i2h_z + h2h_z)
        nextg = F.tanh(i2h_n + reset * h2h_n)
        next_h = (1.0 - update) * nextg + update * prev_h
        return next_h, [next_h]


class SequentialRNNCell(RecurrentCell):
    """Stack cells (parity: ``rnn.SequentialRNNCell``)."""

    def add(self, cell):
        self.register_child(cell)

    def state_info(self, batch_size=0):
        return _cells_state_info(self._cells(), batch_size)

    def begin_state(self, **kwargs):
        return _cells_begin_state(self._cells(), **kwargs)

    def _cells(self):
        return [c for _, c in self._child_blocks()]

    def __call__(self, inputs, states):
        self._counter += 1
        next_states = []
        p = 0
        for cell in self._cells():
            n = len(cell.state_info())
            state = states[p : p + n]
            p += n
            inputs, state = cell(inputs, state)
            next_states.extend(state)
        return inputs, next_states

    def __len__(self):
        return len(self._cells())

    def __getitem__(self, i):
        return self._cells()[i]

    def hybrid_forward(self, *args, **kwargs):
        raise NotImplementedError


class DropoutCell(RecurrentCell):
    def __init__(self, rate, axes=(), prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._rate = rate
        self._axes = axes

    def state_info(self, batch_size=0):
        return []

    def _alias(self):
        return "dropout"

    def hybrid_forward(self, F, inputs, states):
        if self._rate > 0:
            inputs = F.Dropout(inputs, p=self._rate, axes=self._axes)
        return inputs, states


class _ModifierCell(RecurrentCell):
    def __init__(self, base_cell):
        super().__init__(prefix=None, params=None)
        self.base_cell = base_cell

    def state_info(self, batch_size=0):
        return self.base_cell.state_info(batch_size)

    def begin_state(self, **kwargs):
        return self.base_cell.begin_state(**kwargs)


class ResidualCell(_ModifierCell):
    """Parity: ``rnn.ResidualCell``."""

    def __call__(self, inputs, states):
        output, states = self.base_cell(inputs, states)
        return output + inputs, states

    def hybrid_forward(self, F, inputs, states):
        raise NotImplementedError


class ZoneoutCell(_ModifierCell):
    """Parity: ``rnn.ZoneoutCell`` — stochastic state preservation."""

    def __init__(self, base_cell, zoneout_outputs=0.0, zoneout_states=0.0):
        super().__init__(base_cell)
        self.zoneout_outputs = zoneout_outputs
        self.zoneout_states = zoneout_states
        self._prev_output = None

    def reset(self):
        super().reset()
        self._prev_output = None

    def __call__(self, inputs, states):
        from ... import ndarray as nd
        from ... import autograd

        next_output, next_states = self.base_cell(inputs, states)
        if not autograd.is_training():
            return next_output, next_states
        po, ps = self.zoneout_outputs, self.zoneout_states

        def mask(p, like):
            return nd.Dropout(nd.ones_like(like), p=p, training=True)

        prev_output = self._prev_output if self._prev_output is not None else nd.zeros_like(next_output)
        output = (
            nd.where(mask(po, next_output), next_output, prev_output) if po > 0 else next_output
        )
        new_states = (
            [nd.where(mask(ps, ns), ns, s) for ns, s in zip(next_states, states)]
            if ps > 0
            else next_states
        )
        self._prev_output = output
        return output, new_states

    def hybrid_forward(self, F, inputs, states):
        raise NotImplementedError


class BidirectionalCell(RecurrentCell):
    """Parity: ``rnn.BidirectionalCell`` (unroll-only, like the reference)."""

    def __init__(self, l_cell, r_cell, output_prefix="bi_"):
        super().__init__(prefix=None, params=None)
        self.register_child(l_cell, "l_cell")
        self.register_child(r_cell, "r_cell")
        self._output_prefix = output_prefix

    def state_info(self, batch_size=0):
        return _cells_state_info([self.l_cell, self.r_cell], batch_size)

    def begin_state(self, **kwargs):
        return _cells_begin_state([self.l_cell, self.r_cell], **kwargs)

    def __call__(self, inputs, states):
        raise NotImplementedError("Bidirectional cannot be stepped. Please use unroll")

    def unroll(self, length, inputs, begin_state=None, layout="NTC", merge_outputs=None, valid_length=None):
        from ... import ndarray as nd

        self.reset()
        axis = layout.find("T")
        if not isinstance(inputs, (list, tuple)):
            inputs = [
                nd.squeeze(nd.slice_axis(inputs, axis=axis, begin=i, end=i + 1), axis=axis)
                for i in range(length)
            ]
        batch = inputs[0].shape[0]
        l_cell, r_cell = self.l_cell, self.r_cell
        if begin_state is None:
            begin_state = _like_inputs(
                self.begin_state(batch_size=batch, ctx=_context(inputs[0])), inputs[0])
        n_l = len(l_cell.state_info())
        l_out, l_states = l_cell.unroll(
            length, inputs, begin_state[:n_l], layout, merge_outputs=False, valid_length=valid_length
        )

        def _reverse_seq(seq):
            """Reverse only the valid prefix per sample when valid_length is
            given (parity: upstream uses SequenceReverse)."""
            if valid_length is None:
                return list(reversed(seq))
            stacked = nd.stack(*seq, axis=0)  # (T, B, ...)
            rev = nd.SequenceReverse(stacked, sequence_length=valid_length, use_sequence_length=True)
            return [
                nd.squeeze(nd.slice_axis(rev, axis=0, begin=i, end=i + 1), axis=0)
                for i in range(length)
            ]

        r_out, r_states = r_cell.unroll(
            length, _reverse_seq(inputs), begin_state[n_l:], layout, merge_outputs=False,
            valid_length=valid_length,
        )
        if isinstance(r_out, list):
            r_out = _reverse_seq(r_out)
        outputs = [nd.concat(lo, ro, dim=1) for lo, ro in zip(l_out, r_out)]
        if merge_outputs or merge_outputs is None:
            outputs = nd.stack(*outputs, axis=axis)
        return outputs, l_states + r_states

    def hybrid_forward(self, F, inputs, states):
        raise NotImplementedError
