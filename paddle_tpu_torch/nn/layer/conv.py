"""Convolution layers (counterpart of ``paddle_tpu/nn/layer/conv.py``):
paddle's parameter names and shapes (``weight`` ``[out, in/groups, *k]``,
for the transposes ``[in, out/groups, *k]``; ``bias`` ``[out]``), both drawn
from ``Uniform(-1/sqrt(fan_in), 1/sqrt(fan_in))`` with ``fan_in = in/groups
* prod(k)``, as the JAX layers draw them. Only ``padding_mode="zeros"``
is taken (the JAX layers ignore the others)."""
from __future__ import annotations

import math

from .. import functional as F
from .. import initializer as I
from .layers import Layer

__all__ = ["Conv1D", "Conv2D", "Conv3D", "Conv1DTranspose", "Conv2DTranspose",
           "Conv3DTranspose"]


class _ConvNd(Layer):
    def __init__(self, in_channels, out_channels, kernel_size, n,
                 transposed=False, stride=1, padding=0, output_padding=0,
                 dilation=1, groups=1, padding_mode="zeros", weight_attr=None,
                 bias_attr=None, data_format="NCHW"):
        super().__init__()
        if padding_mode != "zeros":
            raise NotImplementedError(
                f"padding_mode={padding_mode!r}: only 'zeros' is supported "
                f"(the JAX reference ignores padding_mode)")
        if isinstance(kernel_size, int):
            kernel_size = (kernel_size,) * n
        self._in_channels = in_channels
        self._out_channels = out_channels
        self._kernel_size = tuple(kernel_size)
        self._stride = stride
        self._padding = padding
        self._output_padding = output_padding
        self._dilation = dilation
        self._groups = groups
        self._data_format = data_format
        if transposed:
            w_shape = [in_channels, out_channels // groups, *kernel_size]
        else:
            w_shape = [out_channels, in_channels // groups, *kernel_size]
        fan_in = (in_channels // groups) * math.prod(kernel_size)
        k = 1.0 / math.sqrt(fan_in) if fan_in else 1.0
        self.weight = self.create_parameter(
            w_shape, attr=weight_attr, default_initializer=I.Uniform(-k, k))
        self.bias = self.create_parameter(
            [out_channels], attr=bias_attr, is_bias=True,
            default_initializer=I.Uniform(-k, k))

    def extra_repr(self):
        return (f"{self._in_channels}, {self._out_channels}, "
                f"kernel_size={list(self._kernel_size)}, "
                f"stride={self._stride}")


class _Conv(_ConvNd):
    _n, _fn, _format = None, None, None

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format=None):
        super().__init__(in_channels, out_channels, kernel_size, self._n,
                         False, stride, padding, 0, dilation, groups,
                         padding_mode, weight_attr, bias_attr,
                         data_format or self._format)

    def forward(self, x):
        return getattr(F, self._fn)(x, self.weight, self.bias, self._stride,
                                    self._padding, self._dilation,
                                    self._groups, self._data_format)


class _ConvTranspose(_ConvNd):
    _n, _fn, _format = None, None, None

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, groups=1, dilation=1,
                 weight_attr=None, bias_attr=None, data_format=None):
        super().__init__(in_channels, out_channels, kernel_size, self._n,
                         True, stride, padding, output_padding, dilation,
                         groups, "zeros", weight_attr, bias_attr,
                         data_format or self._format)

    def forward(self, x, output_size=None):
        return getattr(F, self._fn)(x, self.weight, self.bias, self._stride,
                                    self._padding, self._output_padding,
                                    self._groups, self._dilation, output_size,
                                    self._data_format)


class Conv1D(_Conv):
    _n, _fn, _format = 1, "conv1d", "NCL"


class Conv2D(_Conv):
    _n, _fn, _format = 2, "conv2d", "NCHW"


class Conv3D(_Conv):
    _n, _fn, _format = 3, "conv3d", "NCDHW"


class Conv1DTranspose(_ConvTranspose):
    _n, _fn, _format = 1, "conv1d_transpose", "NCL"


class Conv2DTranspose(_ConvTranspose):
    _n, _fn, _format = 2, "conv2d_transpose", "NCHW"


class Conv3DTranspose(_ConvTranspose):
    _n, _fn, _format = 3, "conv3d_transpose", "NCDHW"
