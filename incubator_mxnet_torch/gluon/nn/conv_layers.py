"""Convolution and pooling layers.

Counterpart of the JAX package's ``gluon/nn/conv_layers.py``: Conv1D/2D/3D
with deferred ``in_channels``, Max/Avg/GlobalMax/GlobalAvg pooling in one
to three dimensions; NC(D)HW data and OI(D)HW weights.  The transposed
convolutions and ReflectionPad2D are not ported yet.
"""
from __future__ import annotations

from ..block import HybridBlock

__all__ = ["Conv1D", "Conv2D", "Conv3D", "MaxPool1D", "MaxPool2D", "MaxPool3D", "AvgPool1D",
           "AvgPool2D", "AvgPool3D", "GlobalMaxPool1D", "GlobalMaxPool2D", "GlobalMaxPool3D",
           "GlobalAvgPool1D", "GlobalAvgPool2D", "GlobalAvgPool3D"]


def _tup(v, n):
    if isinstance(v, int):
        return (v,) * n
    return tuple(v)


class _Conv(HybridBlock):
    def __init__(self, channels, kernel_size, strides, padding, dilation, groups, layout,
                 in_channels=0, activation=None, use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._channels = channels
        self._kernel = kernel_size
        self._stride = strides
        self._pad = padding
        self._dilate = dilation
        self._groups = groups
        self._act_type = activation
        with self.name_scope():
            wshape = (channels, in_channels // groups if in_channels else 0) + kernel_size
            self.weight = self.params.get("weight", shape=wshape, init=weight_initializer,
                                          allow_deferred_init=True)
            self.bias = (self.params.get("bias", shape=(channels,), init=bias_initializer)
                         if use_bias else None)

    def _shape_inference(self, x, *args):
        c_in = x.shape[1]
        self.weight._finish_deferred_init((self._channels, c_in // self._groups) + self._kernel)

    def hybrid_forward(self, F, x, weight, bias=None):
        out = F.Convolution(x, weight, bias, kernel=self._kernel, stride=self._stride,
                            dilate=self._dilate, pad=self._pad, num_filter=self._channels,
                            num_group=self._groups, no_bias=bias is None)
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
