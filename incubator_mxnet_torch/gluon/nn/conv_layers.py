"""Convolution and pooling layers.

Counterpart of the JAX package's ``gluon/nn/conv_layers.py``: Conv1D/2D/3D
and Conv1D/2D/3DTranspose with deferred ``in_channels``,
Max/Avg/GlobalMax/GlobalAvg pooling in one to three dimensions, and
ReflectionPad2D; NC(D)HW data, OI(D)HW convolution weights and
``[in, out/groups, *kernel]`` transposed-convolution weights.
"""
from __future__ import annotations

from ..block import HybridBlock

__all__ = ["Conv1D", "Conv2D", "Conv3D", "Conv1DTranspose", "Conv2DTranspose",
           "Conv3DTranspose", "MaxPool1D", "MaxPool2D", "MaxPool3D", "AvgPool1D",
           "AvgPool2D", "AvgPool3D", "GlobalMaxPool1D", "GlobalMaxPool2D", "GlobalMaxPool3D",
           "GlobalAvgPool1D", "GlobalAvgPool2D", "GlobalAvgPool3D", "ReflectionPad2D"]


def _tup(v, n):
    if isinstance(v, int):
        return (v,) * n
    return tuple(v)


class _Conv(HybridBlock):
    """A convolution (``op_name="Convolution"``, weight ``[out, in/groups,
    *k]``) or a transposed one (``"Deconvolution"``, weight ``[in,
    out/groups, *k]``, ``adj`` its output padding); ``in_channels=0``
    leaves the weight's input side to the first forward."""

    def __init__(self, channels, kernel_size, strides, padding, dilation, groups, layout,
                 in_channels=0, activation=None, use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", op_name="Convolution", adj=None, prefix=None,
                 params=None):
        super().__init__(prefix=prefix, params=params)
        self._channels = channels
        self._kernel = kernel_size
        self._stride = strides
        self._pad = padding
        self._dilate = dilation
        self._groups = groups
        self._act_type = activation
        self._op_name = op_name
        self._adj = adj
        with self.name_scope():
            self.weight = self.params.get("weight", shape=self._weight_shape(in_channels),
                                          init=weight_initializer, allow_deferred_init=True)
            self.bias = (self.params.get("bias", shape=(channels,), init=bias_initializer)
                         if use_bias else None)

    def _weight_shape(self, c_in):
        if self._op_name == "Convolution":
            return (self._channels, c_in // self._groups if c_in else 0) + self._kernel
        return (c_in if c_in else 0, self._channels // self._groups) + self._kernel

    def _shape_inference(self, x, *args):
        self.weight._finish_deferred_init(self._weight_shape(x.shape[1]))

    def hybrid_forward(self, F, x, weight, bias=None):
        kwargs = dict(kernel=self._kernel, stride=self._stride, dilate=self._dilate,
                      pad=self._pad, num_filter=self._channels, num_group=self._groups,
                      no_bias=bias is None)
        if self._op_name == "Deconvolution":
            out = F.Deconvolution(x, weight, bias, adj=self._adj, **kwargs)
        else:
            out = F.Convolution(x, weight, bias, **kwargs)
        if self._act_type is not None:
            out = F.Activation(out, act_type=self._act_type)
        return out


class Conv1D(_Conv):
    def __init__(self, channels, kernel_size, strides=1, padding=0, dilation=1, groups=1,
                 layout="NCW", in_channels=0, activation=None, use_bias=True,
                 weight_initializer=None, bias_initializer="zeros", prefix=None, params=None):
        super().__init__(channels, _tup(kernel_size, 1), _tup(strides, 1), _tup(padding, 1),
                         _tup(dilation, 1), groups, layout, in_channels, activation, use_bias,
                         weight_initializer, bias_initializer, prefix=prefix, params=params)


class Conv2D(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1), padding=(0, 0),
                 dilation=(1, 1), groups=1, layout="NCHW", in_channels=0, activation=None,
                 use_bias=True, weight_initializer=None, bias_initializer="zeros", prefix=None,
                 params=None):
        super().__init__(channels, _tup(kernel_size, 2), _tup(strides, 2), _tup(padding, 2),
                         _tup(dilation, 2), groups, layout, in_channels, activation, use_bias,
                         weight_initializer, bias_initializer, prefix=prefix, params=params)


class Conv3D(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1, 1), padding=(0, 0, 0),
                 dilation=(1, 1, 1), groups=1, layout="NCDHW", in_channels=0,
                 activation=None, use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", prefix=None, params=None):
        super().__init__(channels, _tup(kernel_size, 3), _tup(strides, 3), _tup(padding, 3),
                         _tup(dilation, 3), groups, layout, in_channels, activation, use_bias,
                         weight_initializer, bias_initializer, prefix=prefix, params=params)


class Conv1DTranspose(_Conv):
    def __init__(self, channels, kernel_size, strides=1, padding=0, output_padding=0,
                 dilation=1, groups=1, layout="NCW", in_channels=0, activation=None,
                 use_bias=True, weight_initializer=None, bias_initializer="zeros", prefix=None,
                 params=None):
        super().__init__(channels, _tup(kernel_size, 1), _tup(strides, 1), _tup(padding, 1),
                         _tup(dilation, 1), groups, layout, in_channels, activation, use_bias,
                         weight_initializer, bias_initializer, op_name="Deconvolution",
                         adj=_tup(output_padding, 1), prefix=prefix, params=params)


class Conv2DTranspose(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1), padding=(0, 0),
                 output_padding=(0, 0), dilation=(1, 1), groups=1, layout="NCHW",
                 in_channels=0, activation=None, use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", prefix=None, params=None):
        super().__init__(channels, _tup(kernel_size, 2), _tup(strides, 2), _tup(padding, 2),
                         _tup(dilation, 2), groups, layout, in_channels, activation, use_bias,
                         weight_initializer, bias_initializer, op_name="Deconvolution",
                         adj=_tup(output_padding, 2), prefix=prefix, params=params)


class Conv3DTranspose(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1, 1), padding=(0, 0, 0),
                 output_padding=(0, 0, 0), dilation=(1, 1, 1), groups=1, layout="NCDHW",
                 in_channels=0, activation=None, use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", prefix=None, params=None):
        super().__init__(channels, _tup(kernel_size, 3), _tup(strides, 3), _tup(padding, 3),
                         _tup(dilation, 3), groups, layout, in_channels, activation, use_bias,
                         weight_initializer, bias_initializer, op_name="Deconvolution",
                         adj=_tup(output_padding, 3), prefix=prefix, params=params)


class _Pooling(HybridBlock):
    def __init__(self, pool_size, strides, padding, ceil_mode, global_pool, pool_type,
                 count_include_pad=None, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._kwargs = dict(kernel=pool_size, stride=pool_size if strides is None else strides,
                            pad=padding, global_pool=global_pool, pool_type=pool_type,
                            pooling_convention="full" if ceil_mode else "valid")
        if count_include_pad is not None:
            self._kwargs["count_include_pad"] = count_include_pad

    def hybrid_forward(self, F, x):
        return F.Pooling(x, **self._kwargs)


class MaxPool1D(_Pooling):
    def __init__(self, pool_size=2, strides=None, padding=0, layout="NCW", ceil_mode=False,
                 prefix=None, params=None):
        super().__init__(_tup(pool_size, 1), None if strides is None else _tup(strides, 1),
                         _tup(padding, 1), ceil_mode, False, "max", prefix=prefix,
                         params=params)


class MaxPool2D(_Pooling):
    def __init__(self, pool_size=(2, 2), strides=None, padding=0, layout="NCHW",
                 ceil_mode=False, prefix=None, params=None):
        super().__init__(_tup(pool_size, 2), None if strides is None else _tup(strides, 2),
                         _tup(padding, 2), ceil_mode, False, "max", prefix=prefix,
                         params=params)


class MaxPool3D(_Pooling):
    def __init__(self, pool_size=(2, 2, 2), strides=None, padding=0, layout="NCDHW",
                 ceil_mode=False, prefix=None, params=None):
        super().__init__(_tup(pool_size, 3), None if strides is None else _tup(strides, 3),
                         _tup(padding, 3), ceil_mode, False, "max", prefix=prefix,
                         params=params)


class AvgPool1D(_Pooling):
    def __init__(self, pool_size=2, strides=None, padding=0, layout="NCW", ceil_mode=False,
                 count_include_pad=True, prefix=None, params=None):
        super().__init__(_tup(pool_size, 1), None if strides is None else _tup(strides, 1),
                         _tup(padding, 1), ceil_mode, False, "avg", count_include_pad,
                         prefix=prefix, params=params)


class AvgPool2D(_Pooling):
    def __init__(self, pool_size=(2, 2), strides=None, padding=0, layout="NCHW",
                 ceil_mode=False, count_include_pad=True, prefix=None, params=None):
        super().__init__(_tup(pool_size, 2), None if strides is None else _tup(strides, 2),
                         _tup(padding, 2), ceil_mode, False, "avg", count_include_pad,
                         prefix=prefix, params=params)


class AvgPool3D(_Pooling):
    def __init__(self, pool_size=(2, 2, 2), strides=None, padding=0, layout="NCDHW",
                 ceil_mode=False, count_include_pad=True, prefix=None, params=None):
        super().__init__(_tup(pool_size, 3), None if strides is None else _tup(strides, 3),
                         _tup(padding, 3), ceil_mode, False, "avg", count_include_pad,
                         prefix=prefix, params=params)


class GlobalMaxPool1D(_Pooling):
    def __init__(self, layout="NCW", prefix=None, params=None):
        super().__init__((1,), None, (0,), False, True, "max", prefix=prefix, params=params)


class GlobalMaxPool2D(_Pooling):
    def __init__(self, layout="NCHW", prefix=None, params=None):
        super().__init__((1, 1), None, (0, 0), False, True, "max", prefix=prefix,
                         params=params)


class GlobalMaxPool3D(_Pooling):
    def __init__(self, layout="NCDHW", prefix=None, params=None):
        super().__init__((1, 1, 1), None, (0, 0, 0), False, True, "max", prefix=prefix,
                         params=params)


class GlobalAvgPool1D(_Pooling):
    def __init__(self, layout="NCW", prefix=None, params=None):
        super().__init__((1,), None, (0,), False, True, "avg", prefix=prefix, params=params)


class GlobalAvgPool2D(_Pooling):
    def __init__(self, layout="NCHW", prefix=None, params=None):
        super().__init__((1, 1), None, (0, 0), False, True, "avg", prefix=prefix,
                         params=params)


class GlobalAvgPool3D(_Pooling):
    def __init__(self, layout="NCDHW", prefix=None, params=None):
        super().__init__((1, 1, 1), None, (0, 0, 0), False, True, "avg", prefix=prefix,
                         params=params)


class ReflectionPad2D(HybridBlock):
    """Parity: ``nn.ReflectionPad2D``: an int pads H and W by that much on
    each side; a tuple is the ``pad`` op's flat ``pad_width``."""

    def __init__(self, padding=0, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        if isinstance(padding, int):
            padding = (0, 0, 0, 0, padding, padding, padding, padding)
        self._padding = padding

    def hybrid_forward(self, F, x):
        return F.pad(x, mode="reflect", pad_width=self._padding)
