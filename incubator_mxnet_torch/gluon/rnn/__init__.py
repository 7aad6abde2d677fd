"""``gluon.rnn`` (parity: [U:python/mxnet/gluon/rnn/]), the counterpart of
the JAX package's ``gluon/rnn/``."""
from .rnn_cell import (
    RecurrentCell,
    RNNCell,
    LSTMCell,
    GRUCell,
    SequentialRNNCell,
    DropoutCell,
    ResidualCell,
    BidirectionalCell,
    ZoneoutCell,
)
from .rnn_layer import RNN, LSTM, GRU

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
    "RNN",
    "LSTM",
    "GRU",
]

# reference alias: the hybridizable sequential container shares the
# implementation here (cells are already hybrid-safe)
HybridSequentialRNNCell = SequentialRNNCell  # noqa: F405
