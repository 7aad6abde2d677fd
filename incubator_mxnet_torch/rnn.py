"""``mx.rnn`` — the legacy symbolic RNN cell API (pre-Gluon NLP stack).

Counterpart of the JAX package's ``rnn.py`` (parity target:
[U:python/mxnet/rnn/rnn_cell.py] + [U:python/mxnet/rnn/io.py]) — the
Module/BucketingModule era API: cells build Symbol graphs step by step
(``unroll``), parameters follow the reference naming convention
(``{prefix}i2h_weight`` / ``h2h_weight`` / ``*_bias``), ``FusedRNNCell``
wraps the ``sym.RNN`` op with ``unpack_weights``/``pack_weights``
converters between the packed vector and per-cell dicts, and
``BucketSentenceIter`` feeds bucketed batches (CPU NDArrays, shuffled with
numpy's global generator as the JAX package shuffles them, so one
``np.random.seed`` gives both packages the same batches).

Divergence (documented, as in the JAX package): ``begin_state()`` needs an
explicit ``batch_size`` when called outside ``unroll`` — the reference's
``shape=(0, H)`` placeholder relies on nnvm's 0-means-unknown inference;
inside ``unroll`` initial states are synthesized from the input symbol,
which covers the standard flows.
"""
from __future__ import annotations

import numpy as _np
import torch

from . import symbol as S
from . import io as _io
from .io.io import host_array as _host_array
from .ndarray.ndarray import _ctx_of, _wrap
from .ops.rnn_ops import rnn_param_size

__all__ = [
    "BaseRNNCell", "RNNCell", "LSTMCell", "GRUCell", "FusedRNNCell",
    "SequentialRNNCell", "BidirectionalCell", "DropoutCell", "ResidualCell",
    "ZoneoutCell", "BucketSentenceIter",
]


def _zeros_like_state(x, num_hidden, name):
    """[B, H] zeros with batch taken from the [B, D] input symbol."""
    col = S.slice_axis(S.zeros_like(x), axis=1, begin=0, end=1,
                       name=f"{name}_col")
    return S.tile(col, reps=(1, num_hidden), name=f"{name}_zeros")


class BaseRNNCell:
    def __init__(self, prefix=""):
        self._prefix = prefix
        self._counter = -1

    @property
    def prefix(self):
        return self._prefix

    @property
    def state_info(self):
        raise NotImplementedError

    def __call__(self, inputs, states):
        raise NotImplementedError

    def reset(self):
        self._counter = -1

    def _next_name(self, hint):
        self._counter += 1
        return f"{self._prefix}{hint}{self._counter}"

    def begin_state(self, func=None, batch_size=None, **kwargs):
        """Initial states.  With ``batch_size``: static zeros symbols.
        Without: raises (see module docstring) unless ``func`` builds the
        state symbols itself."""
        def _shape(info):
            # the 0 slot marks the batch dim (NC / LNC layouts alike)
            return tuple(batch_size if d == 0 else d for d in info["shape"])

        if func is not None:
            return [func(shape=_shape(info), **kwargs)
                    for info in self.state_info]
        if batch_size is None:
            raise ValueError(
                "begin_state() outside unroll needs batch_size= (the "
                "reference's shape-(0,H) placeholder is nnvm-specific); "
                "unroll() synthesizes initial states automatically")
        return [S.zeros(shape=_shape(info),
                        name=f"{self._prefix}begin_state_{i}")
                for i, info in enumerate(self.state_info)]

    def _begin_from_input(self, x):
        return [_zeros_like_state(x, info["shape"][1],
                                  f"{self._prefix}init{i}")
                for i, info in enumerate(self.state_info)]

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        """Unroll ``length`` steps.  ``inputs``: one [B, T, D] (NTC) /
        [T, B, D] (TNC) symbol, or a list of T [B, D] symbols.  Returns
        (outputs, states) with outputs merged to one symbol when
        ``merge_outputs`` (stacked on the layout's time axis)."""
        self.reset()
        if isinstance(inputs, (list, tuple)):
            steps = list(inputs)
        else:
            t_axis = 1 if layout == "NTC" else 0
            steps = [
                S.squeeze(S.slice_axis(inputs, axis=t_axis, begin=t, end=t + 1),
                          axis=t_axis)
                for t in range(length)
            ]
        if len(steps) != length:
            raise ValueError(f"unroll: got {len(steps)} inputs for length {length}")
        states = begin_state if begin_state is not None else \
            self._begin_from_input(steps[0])
        outputs = []
        for x in steps:
            out, states = self(x, states)
            outputs.append(out)
        if merge_outputs:
            t_axis = 1 if layout == "NTC" else 0
            outputs = S.stack(*outputs, axis=t_axis)
        return outputs, states


class RNNCell(BaseRNNCell):
    """Vanilla tanh/relu cell ([U:python/mxnet/rnn/rnn_cell.py] RNNCell)."""

    _mode = "rnn_tanh"
    _n_gates = 1

    def __init__(self, num_hidden, activation="tanh", prefix="rnn_"):
        super().__init__(prefix)
        self._num_hidden = num_hidden
        self._activation = activation
        # ONE weight/bias variable per cell, shared by every unrolled step
        # (a bare name= per step would create a new variable each call)
        self._iW = S.var(f"{prefix}i2h_weight")
        self._ib = S.var(f"{prefix}i2h_bias")
        self._hW = S.var(f"{prefix}h2h_weight")
        self._hb = S.var(f"{prefix}h2h_bias")

    @property
    def state_info(self):
        return [{"shape": (0, self._num_hidden), "__layout__": "NC"}]

    def _i2h(self, x, step_name):
        return S.FullyConnected(x, self._iW, self._ib,
                                num_hidden=self._n_gates * self._num_hidden,
                                name=f"{step_name}_i2h")

    def _h2h(self, h, step_name):
        return S.FullyConnected(h, self._hW, self._hb,
                                num_hidden=self._n_gates * self._num_hidden,
                                name=f"{step_name}_h2h")

    def _fc(self, x, h, step_name):
        return self._i2h(x, step_name) + self._h2h(h, step_name)

    def __call__(self, inputs, states):
        name = self._next_name("t")
        z = self._fc(inputs, states[0], name)
        out = S.Activation(z, act_type=self._activation, name=f"{name}_out")
        return out, [out]


class LSTMCell(RNNCell):
    """LSTM cell; gate order [i, f, c, o] (the reference convention)."""

    _mode = "lstm"
    _n_gates = 4

    def __init__(self, num_hidden, prefix="lstm_", forget_bias=1.0):
        super().__init__(num_hidden, prefix=prefix)
        self._forget_bias = forget_bias
        # the reference realizes forget_bias through the i2h_bias
        # INITIALIZER (init.LSTMBias), not a forward-time addition — so
        # checkpoints and fused/unfused weight sharing stay numerically
        # identical
        from . import initializer as _init

        self._ib = S.var(f"{prefix}i2h_bias",
                         init=_init.LSTMBias(forget_bias=forget_bias))

    @property
    def state_info(self):
        return [{"shape": (0, self._num_hidden), "__layout__": "NC"},
                {"shape": (0, self._num_hidden), "__layout__": "NC"}]

    def __call__(self, inputs, states):
        name = self._next_name("t")
        gates = self._fc(inputs, states[0], name)
        i, f, c, o = S.split(gates, num_outputs=4, axis=1)
        in_gate = S.sigmoid(i, name=f"{name}_i")
        forget = S.sigmoid(f, name=f"{name}_f")
        c_in = S.tanh(c, name=f"{name}_c")
        out_gate = S.sigmoid(o, name=f"{name}_o")
        next_c = forget * states[1] + in_gate * c_in
        next_h = out_gate * S.tanh(next_c, name=f"{name}_tc")
        return next_h, [next_h, next_c]


class GRUCell(RNNCell):
    """GRU cell; gate order [r, z, n] (the reference convention)."""

    _mode = "gru"
    _n_gates = 3

    def __init__(self, num_hidden, prefix="gru_"):
        super().__init__(num_hidden, prefix=prefix)

    def __call__(self, inputs, states):
        name = self._next_name("t")
        i2h = self._i2h(inputs, name)
        h2h = self._h2h(states[0], name)
        i2h_r, i2h_z, i2h_n = S.split(i2h, num_outputs=3, axis=1)
        h2h_r, h2h_z, h2h_n = S.split(h2h, num_outputs=3, axis=1)
        r = S.sigmoid(i2h_r + h2h_r, name=f"{name}_r")
        z = S.sigmoid(i2h_z + h2h_z, name=f"{name}_z")
        nn = S.tanh(i2h_n + r * h2h_n, name=f"{name}_n")
        next_h = (1.0 - z) * nn + z * states[0]
        return next_h, [next_h]


class FusedRNNCell(BaseRNNCell):
    """The ``sym.RNN`` op as a cell (parity: FusedRNNCell) — one packed
    parameter vector in the reference's layout (``ops/rnn_ops.py``).
    ``unpack_weights``/``pack_weights`` convert a params dict between the
    packed vector and the per-layer i2h/h2h entries the unfused cells use."""

    def __init__(self, num_hidden, num_layers=1, mode="lstm",
                 bidirectional=False, dropout=0.0, prefix=None):
        super().__init__(prefix if prefix is not None else f"{mode}_")
        self._num_hidden = num_hidden
        self._num_layers = num_layers
        self._mode = mode
        self._bidirectional = bidirectional
        self._dropout = dropout

    @property
    def state_info(self):
        dirs = 2 if self._bidirectional else 1
        n = self._num_layers * dirs
        infos = [{"shape": (n, 0, self._num_hidden), "__layout__": "LNC"}]
        if self._mode == "lstm":
            infos.append({"shape": (n, 0, self._num_hidden), "__layout__": "LNC"})
        return infos

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        if isinstance(inputs, (list, tuple)):
            t_axis = 1 if layout == "NTC" else 0
            inputs = S.stack(*inputs, axis=t_axis)
        data = inputs if layout == "TNC" else S.transpose(
            inputs, axes=(1, 0, 2), name=f"{self._prefix}tnc")
        params = S.var(f"{self._prefix}parameters")
        kwargs = {}
        if begin_state is not None:
            kwargs["state"] = begin_state[0]
            if self._mode == "lstm":
                kwargs["state_cell"] = begin_state[1]
        out = S.RNN(data, params, mode=self._mode,
                    state_size=self._num_hidden,
                    num_layers=self._num_layers,
                    bidirectional=self._bidirectional, p=self._dropout,
                    name=f"{self._prefix}rnn", **kwargs)
        if layout == "NTC":
            out = S.transpose(out, axes=(1, 0, 2), name=f"{self._prefix}ntc")
        if merge_outputs is False:
            t_axis = 1 if layout == "NTC" else 0
            out = [S.squeeze(S.slice_axis(out, axis=t_axis, begin=t, end=t + 1),
                             axis=t_axis) for t in range(length)]
        return out, []

    # -- packed <-> per-cell parameter conversion ----------------------
    def _gate_count(self):
        return {"lstm": 4, "gru": 3, "rnn_tanh": 1, "rnn_relu": 1}[self._mode]

    def _slices(self, input_size):
        """Yield (name, shape, offset) over the packed layout (weights for
        every layer/direction first? No — the reference packs per
        layer/direction: i2h_w, h2h_w then all biases after all weights,
        matching ops/rnn_ops.py's unpacker: per layer/dir [Wi, Wh], then
        per layer/dir [bi, bh])."""
        G, H = self._gate_count(), self._num_hidden
        dirs = 2 if self._bidirectional else 1
        off = 0
        names = []
        for layer in range(self._num_layers):
            in_dim = input_size if layer == 0 else H * dirs
            for d in range(dirs):
                dtag = ("l", "r")[d]
                names.append((f"{self._prefix}{dtag}{layer}_i2h_weight",
                              (G * H, in_dim)))
                names.append((f"{self._prefix}{dtag}{layer}_h2h_weight",
                              (G * H, H)))
        for layer in range(self._num_layers):
            for d in range(dirs):
                dtag = ("l", "r")[d]
                names.append((f"{self._prefix}{dtag}{layer}_i2h_bias", (G * H,)))
                names.append((f"{self._prefix}{dtag}{layer}_h2h_bias", (G * H,)))
        for name, shape in names:
            size = int(_np.prod(shape))
            yield name, shape, off
            off += size

    def unpack_weights(self, args):
        """Split ``{prefix}parameters`` into per-layer i2h/h2h entries, on
        the packed array's device (a numpy array gives CPU NDArrays)."""
        args = dict(args)
        flat, ctx = _flat_tensor(args.pop(f"{self._prefix}parameters"))
        # input size falls out of the packed length
        in_dim = self._infer_input_size(flat.numel())
        for name, shape, off in self._slices(in_dim):
            size = int(_np.prod(shape))
            args[name] = _wrap(flat[off:off + size].reshape(shape).clone(), ctx)
        return args

    def pack_weights(self, args):
        """The per-layer entries back into one float32
        ``{prefix}parameters``, on the first entry's device."""
        args = dict(args)
        w, ctx = _flat_tensor(args[f"{self._prefix}l0_i2h_weight"])
        in_dim = w.shape[1]
        flat = torch.zeros(rnn_param_size(self._mode, in_dim, self._num_hidden,
                                          self._num_layers, self._bidirectional),
                           dtype=torch.float32, device=w.device)
        for name, shape, off in self._slices(in_dim):
            size = int(_np.prod(shape))
            v, _ = _flat_tensor(args.pop(name))
            flat[off:off + size] = v.reshape(-1).to(device=w.device, dtype=torch.float32)
        args[f"{self._prefix}parameters"] = _wrap(flat, ctx)
        return args

    def _infer_input_size(self, packed_size):
        """packed_size is affine in input_size: invert exactly."""
        base = rnn_param_size(self._mode, 0, self._num_hidden,
                              self._num_layers, self._bidirectional)
        per_in = (rnn_param_size(self._mode, 1, self._num_hidden,
                                 self._num_layers, self._bidirectional) - base)
        rem = packed_size - base
        if per_in <= 0 or rem <= 0 or rem % per_in:
            raise ValueError(
                f"cannot infer input size from packed length {packed_size}")
        return rem // per_in


def _flat_tensor(v):
    """``(tensor, context)`` of an NDArray, a tensor or an array-like (an
    array-like goes to the CPU)."""
    v = getattr(v, "_data", v)
    if not isinstance(v, torch.Tensor):
        v = _host_array(v)._data
    return v.detach(), _ctx_of(v.device)


class SequentialRNNCell(BaseRNNCell):
    def __init__(self):
        super().__init__("")
        self._cells = []

    def add(self, cell):
        self._cells.append(cell)

    def reset(self):
        super().reset()
        for c in self._cells:
            c.reset()

    @property
    def state_info(self):
        return [info for c in self._cells for info in c.state_info]

    def __call__(self, inputs, states):
        next_states = []
        pos = 0
        for cell in self._cells:
            n = len(cell.state_info)
            inputs, st = cell(inputs, states[pos:pos + n])
            next_states.extend(st)
            pos += n
        return inputs, next_states

    def _begin_from_input(self, x):
        return [s for c in self._cells for s in c._begin_from_input(x)]


class BidirectionalCell(BaseRNNCell):
    """Runs l_cell forward and r_cell backward over the sequence and
    concatenates per-step outputs (unroll-only, like the reference)."""

    def __init__(self, l_cell, r_cell):
        super().__init__("bi_")
        self._l, self._r = l_cell, r_cell

    def reset(self):
        super().reset()
        self._l.reset()
        self._r.reset()

    @property
    def state_info(self):
        return self._l.state_info + self._r.state_info

    def __call__(self, inputs, states):
        raise NotImplementedError("BidirectionalCell supports unroll() only")

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        if not isinstance(inputs, (list, tuple)):
            t_axis = 1 if layout == "NTC" else 0
            inputs = [
                S.squeeze(S.slice_axis(inputs, axis=t_axis, begin=t, end=t + 1),
                          axis=t_axis) for t in range(length)
            ]
        nl = len(self._l.state_info)
        bl = begin_state[:nl] if begin_state is not None else None
        br = begin_state[nl:] if begin_state is not None else None
        lo, ls = self._l.unroll(length, list(inputs), begin_state=bl,
                                layout=layout, merge_outputs=False)
        ro, rs = self._r.unroll(length, list(inputs)[::-1], begin_state=br,
                                layout=layout, merge_outputs=False)
        outs = [S.concat(l, r, dim=1) for l, r in zip(lo, ro[::-1])]
        if merge_outputs:
            t_axis = 1 if layout == "NTC" else 0
            outs = S.stack(*outs, axis=t_axis)
        return outs, ls + rs


class ModifierCell(BaseRNNCell):
    def __init__(self, base):
        super().__init__(base.prefix)
        self.base_cell = base

    def reset(self):
        super().reset()
        self.base_cell.reset()

    @property
    def state_info(self):
        return self.base_cell.state_info

    def _begin_from_input(self, x):
        return self.base_cell._begin_from_input(x)


class DropoutCell(BaseRNNCell):
    """Applies dropout to its input each step (stateless)."""

    def __init__(self, dropout, prefix="dropout_"):
        super().__init__(prefix)
        self._rate = dropout

    @property
    def state_info(self):
        return []

    def __call__(self, inputs, states):
        if self._rate:
            inputs = S.Dropout(inputs, p=self._rate,
                               name=self._next_name("drop"))
        return inputs, states


class ResidualCell(ModifierCell):
    def __call__(self, inputs, states):
        out, states = self.base_cell(inputs, states)
        return out + inputs, states


class ZoneoutCell(ModifierCell):
    """Zoneout regularization: randomly keep previous states
    ([U:python/mxnet/rnn/rnn_cell.py] ZoneoutCell)."""

    def __init__(self, base, zoneout_outputs=0.0, zoneout_states=0.0):
        super().__init__(base)
        self._zo, self._zs = zoneout_outputs, zoneout_states
        self._prev_out = None

    def __call__(self, inputs, states):
        out, next_states = self.base_cell(inputs, states)

        def mask(rate, new, old):
            if not rate:
                return new
            if old is None:
                # step 0 blends with zeros, matching the reference's
                # prev_output=zeros initialization — skipping zoneout at
                # step 0 would shift the regularizer's noise distribution
                old = S.zeros_like(new)
            # Dropout is inverted (kept values are 1/(1-p)); rescale back
            # to an exact 0/1 keep mask so this is a SELECT, not a blend
            keep = S.Dropout(S.ones_like(new), p=rate) * (1.0 - rate)
            return keep * new + (1.0 - keep) * old

        prev = self._prev_out
        out_z = mask(self._zo, out, prev)
        # the reference carries the MIXED output forward, not the raw one
        self._prev_out = out_z
        states_z = [mask(self._zs, n, o) for n, o in zip(next_states, states)]
        return out_z, states_z

    def reset(self):
        super().reset()
        self.base_cell.reset()
        self._prev_out = None


class BucketSentenceIter(_io.DataIter):
    """Bucketed sentence iterator (parity: [U:python/mxnet/rnn/io.py]):
    sorts tokenized sentences into length buckets, pads to the bucket
    length, yields batches with ``bucket_key`` for BucketingModule."""

    def __init__(self, sentences, batch_size, buckets=None, invalid_label=-1,
                 data_name="data", label_name="softmax_label"):
        super().__init__(batch_size)
        if buckets is None:
            lens = sorted({len(s) for s in sentences})
            buckets = [l for l in lens if
                       sum(len(s) <= l for s in sentences) >= batch_size]
            buckets = buckets or [max(lens)]
        self._buckets = sorted(buckets)
        self._data_name, self._label_name = data_name, label_name
        self._invalid = invalid_label
        self._bucket_data = {b: [] for b in self._buckets}
        discarded = 0
        for s in sentences:
            for b in self._buckets:
                if len(s) <= b:
                    padded = list(s) + [invalid_label] * (b - len(s))
                    self._bucket_data[b].append(padded)
                    break
            else:
                discarded += 1
        if discarded:
            import logging

            logging.getLogger(__name__).warning(
                "BucketSentenceIter: discarded %d sentence(s) longer than "
                "the largest bucket (%d)", discarded, self._buckets[-1])
        self._plan = []
        for b, rows in self._bucket_data.items():
            for i in range(0, len(rows) - batch_size + 1, batch_size):
                self._plan.append((b, i))
        self.default_bucket_key = max(self._buckets)
        self.reset()

    @property
    def provide_data(self):
        return [_io.DataDesc(self._data_name,
                             (self.batch_size, self.default_bucket_key))]

    @property
    def provide_label(self):
        return [_io.DataDesc(self._label_name,
                             (self.batch_size, self.default_bucket_key))]

    def reset(self):
        self._cursor = 0
        _np.random.shuffle(self._plan)

    def next(self):
        if self._cursor >= len(self._plan):
            raise StopIteration
        b, i = self._plan[self._cursor]
        self._cursor += 1
        rows = _np.asarray(self._bucket_data[b][i:i + self.batch_size],
                           dtype=_np.float32)
        data = rows
        label = _np.concatenate(
            [rows[:, 1:], _np.full((rows.shape[0], 1), self._invalid,
                                   _np.float32)], axis=1)
        batch = _io.DataBatch(data=[_host_array(data)], label=[_host_array(label)],
                              provide_data=[_io.DataDesc(self._data_name, data.shape)],
                              provide_label=[_io.DataDesc(self._label_name, label.shape)])
        batch.bucket_key = b
        return batch
