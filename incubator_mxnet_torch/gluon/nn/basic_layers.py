"""Basic layers: Sequential, HybridSequential, Dense, Dropout, BatchNorm,
LayerNorm, GroupNorm, InstanceNorm, Embedding, Flatten, Identity,
Lambda/HybridLambda and Concatenate/HybridConcatenate.

Counterpart of the matching layers in
the JAX package's ``gluon/nn/basic_layers.py``: same parameter names,
shapes (Dense weight ``[out, in]``), default initializers and deferred
``in_units``/``in_channels``.
"""
from __future__ import annotations

import math

import torch

from ... import autograd
from ...base import dtype_name
from ..block import Block, HybridBlock, collect_aux_update

__all__ = ["Sequential", "HybridSequential", "Dense", "Dropout", "BatchNorm", "LayerNorm",
           "GroupNorm", "InstanceNorm", "Embedding", "Flatten", "Identity", "Lambda",
           "HybridLambda", "Concatenate", "HybridConcatenate"]


class Sequential(Block):
    """Runs its children in the order they were added."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)

    def add(self, *blocks):
        for b in blocks:
            self.register_child(b)

    def forward(self, x, *args):
        for child in self._modules.values():
            x = child(x, *args)
            args = ()
        return x

    def __len__(self):
        return len(self._modules)

    def __getitem__(self, key):
        layers = list(self._modules.values())
        if isinstance(key, slice):
            net = type(self)()
            net.add(*layers[key])
            return net
        return layers[key]


class HybridSequential(Sequential, HybridBlock):
    """Sequential whose children are HybridBlocks; ``hybridize`` changes
    nothing in the port (see ``gluon/block.py``)."""


class Dense(HybridBlock):
    """Fully-connected layer; ``in_units`` may be deferred."""

    def __init__(self, units, activation=None, use_bias=True, flatten=True,
                 dtype="float32", weight_initializer=None, bias_initializer="zeros",
                 in_units=0, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._units = units
        self._flatten = flatten
        self._use_bias = use_bias
        self._act_type = activation
        with self.name_scope():
            self.weight = self.params.get(
                "weight", shape=(units, in_units), dtype=dtype, init=weight_initializer,
                allow_deferred_init=True)
            if use_bias:
                self.bias = self.params.get(
                    "bias", shape=(units,), dtype=dtype, init=bias_initializer,
                    allow_deferred_init=True)

    def _shape_inference(self, x, *args):
        in_units = math.prod(x.shape[1:]) if self._flatten else x.shape[-1]
        self.weight._finish_deferred_init((self._units, in_units))
        if self._use_bias:
            self.bias._finish_deferred_init((self._units,))

    def hybrid_forward(self, F, x, weight, bias=None):
        out = F.FullyConnected(x, weight, bias, num_hidden=self._units,
                               no_bias=bias is None, flatten=self._flatten)
        if self._act_type is not None:
            out = F.Activation(out, act_type=self._act_type)
        return out


class Dropout(HybridBlock):
    def __init__(self, rate, axes=(), prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._rate = rate
        self._axes = axes

    def hybrid_forward(self, F, x):
        return F.Dropout(x, p=self._rate, axes=self._axes)


class BatchNorm(HybridBlock):
    """Batch normalization with running statistics.  In training the batch
    statistics normalize and the running ones move as
    ``running·momentum + batch·(1 − momentum)`` (biased batch variance);
    otherwise, or with ``use_global_stats``, the running ones normalize."""

    def __init__(self, axis=1, momentum=0.9, epsilon=1e-5, center=True, scale=True,
                 use_global_stats=False, beta_initializer="zeros", gamma_initializer="ones",
                 running_mean_initializer="zeros", running_variance_initializer="ones",
                 in_channels=0, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._axis = axis
        self._momentum = momentum
        self._epsilon = epsilon
        self._scale = scale
        self._use_global_stats = use_global_stats
        self.in_channels = in_channels
        with self.name_scope():
            self.gamma = self.params.get(
                "gamma", grad_req="write" if scale else "null", shape=(in_channels,),
                init=gamma_initializer, allow_deferred_init=True, differentiable=scale)
            self.beta = self.params.get(
                "beta", grad_req="write" if center else "null", shape=(in_channels,),
                init=beta_initializer, allow_deferred_init=True, differentiable=center)
            self.running_mean = self.params.get(
                "running_mean", grad_req="null", shape=(in_channels,),
                init=running_mean_initializer, allow_deferred_init=True, differentiable=False)
            self.running_var = self.params.get(
                "running_var", grad_req="null", shape=(in_channels,),
                init=running_variance_initializer, allow_deferred_init=True,
                differentiable=False)

    def _shape_inference(self, x, *args):
        c = x.shape[self._axis]
        for p in (self.gamma, self.beta, self.running_mean, self.running_var):
            p._finish_deferred_init((c,))

    def cast(self, dtype):
        if dtype_name(dtype) in ("float16", "bfloat16"):
            dtype = "float32"  # the statistics and their parameters stay fp32
        return super().cast(dtype)

    def hybrid_forward(self, F, x, gamma, beta, running_mean, running_var):
        use_global = self._use_global_stats or not autograd.is_training()
        out, batch_mean, batch_var = F.BatchNorm(
            x, gamma, beta, running_mean, running_var, eps=self._epsilon,
            momentum=self._momentum, fix_gamma=not self._scale, use_global_stats=use_global,
            axis=self._axis)
        if not use_global:
            m = self._momentum
            with torch.no_grad():
                collect_aux_update(self.running_mean, running_mean * m + batch_mean * (1 - m))
                collect_aux_update(self.running_var, running_var * m + batch_var * (1 - m))
        return out


class LayerNorm(HybridBlock):
    def __init__(self, axis=-1, epsilon=1e-5, center=True, scale=True,
                 beta_initializer="zeros", gamma_initializer="ones", in_channels=0,
                 prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._axis = axis
        self._epsilon = epsilon
        with self.name_scope():
            self.gamma = self.params.get(
                "gamma", grad_req="write" if scale else "null", shape=(in_channels,),
                init=gamma_initializer, allow_deferred_init=True)
            self.beta = self.params.get(
                "beta", grad_req="write" if center else "null", shape=(in_channels,),
                init=beta_initializer, allow_deferred_init=True)

    def _shape_inference(self, x, *args):
        c = x.shape[self._axis]
        self.gamma._finish_deferred_init((c,))
        self.beta._finish_deferred_init((c,))

    def hybrid_forward(self, F, x, gamma, beta):
        return F.LayerNorm(x, gamma, beta, axis=self._axis, eps=self._epsilon)


class Embedding(HybridBlock):
    """Lookup of rows of a ``(input_dim, output_dim)`` weight, the
    reference's parameters in its order.  ``sparse_grad=True`` makes the
    weight ``row_sparse``: its gradient is held densely, and SGD and Adam
    then update it lazily, as the reference updates a row-sparse gradient:
    a row no lookup of the batch touched keeps its value and its optimizer
    state (no momentum decay, no weight decay)."""

    def __init__(self, input_dim, output_dim, dtype="float32", weight_initializer=None,
                 sparse_grad=False, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._input_dim = input_dim
        self._output_dim = output_dim
        with self.name_scope():
            self.weight = self.params.get(
                "weight", shape=(input_dim, output_dim), dtype=dtype,
                init=weight_initializer, stype="row_sparse" if sparse_grad else "default")

    def hybrid_forward(self, F, x, weight):
        return F.Embedding(x, weight, input_dim=self._input_dim, output_dim=self._output_dim)


class Flatten(HybridBlock):
    """To 2-D, keeping the batch axis."""

    def hybrid_forward(self, F, x):
        return F.Flatten(x)


class _ChannelNorm(HybridBlock):
    """gamma and beta of the input's channel count (axis 1), deferred."""

    def __init__(self, epsilon, center, scale, beta_initializer, gamma_initializer,
                 in_channels, prefix, params):
        super().__init__(prefix=prefix, params=params)
        self._epsilon = epsilon
        with self.name_scope():
            self.gamma = self.params.get(
                "gamma", grad_req="write" if scale else "null", shape=(in_channels,),
                init=gamma_initializer, allow_deferred_init=True)
            self.beta = self.params.get(
                "beta", grad_req="write" if center else "null", shape=(in_channels,),
                init=beta_initializer, allow_deferred_init=True)

    def _shape_inference(self, x, *args):
        c = x.shape[1]
        self.gamma._finish_deferred_init((c,))
        self.beta._finish_deferred_init((c,))


class GroupNorm(_ChannelNorm):
    """Normalization over groups of channels (``F.GroupNorm``)."""

    def __init__(self, num_groups=1, epsilon=1e-5, center=True, scale=True,
                 beta_initializer="zeros", gamma_initializer="ones", in_channels=0,
                 prefix=None, params=None):
        super().__init__(epsilon, center, scale, beta_initializer, gamma_initializer,
                         in_channels, prefix, params)
        self._num_groups = num_groups

    def hybrid_forward(self, F, x, gamma, beta):
        return F.GroupNorm(x, gamma, beta, num_groups=self._num_groups, eps=self._epsilon)


class InstanceNorm(_ChannelNorm):
    """Normalization of each sample's channel over its spatial axes
    (``F.InstanceNorm``); ``axis`` is taken for the reference's signature,
    as in the JAX package, which normalizes with the channel at axis 1."""

    def __init__(self, axis=1, epsilon=1e-5, center=True, scale=False,
                 beta_initializer="zeros", gamma_initializer="ones", in_channels=0,
                 prefix=None, params=None):
        super().__init__(epsilon, center, scale, beta_initializer, gamma_initializer,
                         in_channels, prefix, params)

    def hybrid_forward(self, F, x, gamma, beta):
        return F.InstanceNorm(x, gamma, beta, eps=self._epsilon)


class Identity(HybridBlock):
    def hybrid_forward(self, F, x):
        return x


class Lambda(Block):
    """A function (or the name of an ``mx.nd`` op) as a Block."""

    def __init__(self, function, prefix=None):
        super().__init__(prefix=prefix)
        if isinstance(function, str):
            from ... import ndarray as nd

            function = getattr(nd, function)
        self._func = function

    def forward(self, *args):
        return self._func(*args)


class HybridLambda(HybridBlock):
    """A function ``fn(F, *args)`` (or the name of an op of ``F``) as a
    HybridBlock."""

    def __init__(self, function, prefix=None):
        super().__init__(prefix=prefix)
        if isinstance(function, str):
            self._func = lambda F, *args: getattr(F, function)(*args)
        else:
            self._func = function

    def hybrid_forward(self, F, x, *args):
        return self._func(F, x, *args)


class Concatenate(Sequential):
    """Runs every child on the same input and concatenates their outputs on
    ``axis``."""

    def __init__(self, axis=-1, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self.axis = axis

    def forward(self, x):
        from ...ops.registry import nd

        return nd.concat(*(child(x) for child in self._modules.values()), dim=self.axis)


class HybridConcatenate(Concatenate, HybridBlock):
    """Concatenate of HybridBlocks."""
