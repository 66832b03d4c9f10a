"""Activation functions (counterpart of
``paddle_tpu/nn/functional/activation.py``): each a torch expression of
the JAX one, run through the facade's dispatch under the JAX op name (so
``auto_cast`` casts where the JAX tape casts). The random ones (``rrelu``
in training, ``gumbel_softmax``) draw from the facade's generator of the
input's device."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ...framework import random as random_mod
from ...framework.dtype import to_torch_dtype
from ...ops._dispatch import apply

__all__ = [
    "relu", "relu_", "relu6", "elu", "selu", "celu", "gelu", "sigmoid",
    "hardsigmoid", "hardswish", "hardtanh", "hardshrink", "softshrink",
    "tanhshrink", "leaky_relu", "prelu", "rrelu", "log_sigmoid", "maxout",
    "silu", "swish", "mish", "softplus", "softsign", "tanh", "softmax",
    "log_softmax", "gumbel_softmax", "glu", "thresholded_relu",
]


def _zero(v):
    return torch.zeros((), dtype=v.dtype, device=v.device)


def relu(x, name=None):
    return apply(torch.relu, x, op_name="relu")


def relu_(x, name=None):
    return x._inplace_assign(relu(x))


def relu6(x, name=None):
    return apply(lambda v: v.clamp(0.0, 6.0), x, op_name="relu6")


def elu(x, alpha=1.0, name=None):
    return apply(lambda v: torch.where(v > 0, v, alpha * torch.expm1(v)), x,
                 op_name="elu")


def selu(x, scale=1.0507009873554805, alpha=1.6732632423543772, name=None):
    return apply(lambda v: scale * torch.where(v > 0, v,
                                               alpha * torch.expm1(v)), x)


def celu(x, alpha=1.0, name=None):
    return apply(lambda v: F.celu(v, alpha), x, op_name="celu")


def gelu(x, approximate=False, name=None):
    """GELU: the exact (erf) form, or the tanh form with ``approximate``."""
    mode = "tanh" if approximate else "none"
    return apply(lambda v: F.gelu(v, approximate=mode), x, op_name="gelu")


def sigmoid(x, name=None):
    return apply(torch.sigmoid, x, op_name="sigmoid")


def hardsigmoid(x, slope=0.1666667, offset=0.5, name=None):
    return apply(lambda v: (slope * v + offset).clamp(0.0, 1.0), x)


def hardswish(x, name=None):
    return apply(lambda v: v * (v + 3.0).clamp(0.0, 6.0) / 6.0, x)


def hardtanh(x, min=-1.0, max=1.0, name=None):
    return apply(lambda v: v.clamp(min, max), x, op_name="hardtanh")


def hardshrink(x, threshold=0.5, name=None):
    return apply(lambda v: torch.where(v.abs() > threshold, v, _zero(v)), x)


def softshrink(x, threshold=0.5, name=None):
    return apply(lambda v: torch.sign(v) * (v.abs() - threshold).clamp_min(
        0.0), x)


def tanhshrink(x, name=None):
    return apply(lambda v: v - torch.tanh(v), x)


def leaky_relu(x, negative_slope=0.01, name=None):
    return apply(lambda v: torch.where(v >= 0, v, negative_slope * v), x,
                 op_name="leaky_relu")


def prelu(x, weight, data_format="NCHW", name=None):
    def f(v, w):
        if w.numel() == 1:
            return torch.where(v > 0, v, w.reshape(()) * v)
        shape = [1] * v.ndim
        ch_axis = 1 if data_format.startswith("NC") else v.ndim - 1
        shape[ch_axis] = w.numel()
        return torch.where(v > 0, v, w.reshape(shape) * v)
    return apply(f, x, weight, op_name="prelu")


def rrelu(x, lower=0.125, upper=0.3333333, training=False, name=None):
    """Randomized leaky ReLU: in training the negative slope is uniform in
    ``[lower, upper]`` per element; otherwise their mean."""
    if training:
        def f(v):
            a = torch.empty_like(v).uniform_(
                lower, upper, generator=random_mod.generator(v.device))
            return torch.where(v >= 0, v, a * v)
        return apply(f, x, op_name="rrelu")
    mid = (lower + upper) / 2.0
    return apply(lambda v: torch.where(v >= 0, v, mid * v), x,
                 op_name="rrelu")


def log_sigmoid(x, name=None):
    return apply(F.logsigmoid, x, op_name="log_sigmoid")


def maxout(x, groups, axis=1, name=None):
    def f(v):
        ax = axis % v.ndim
        c = v.shape[ax]
        shape = list(v.shape[:ax]) + [c // groups, groups] \
            + list(v.shape[ax + 1:])
        return v.reshape(shape).amax(ax + 1)
    return apply(f, x, op_name="maxout")


def silu(x, name=None):
    return apply(F.silu, x, op_name="silu")


def swish(x, name=None):
    return silu(x)


def _softplus(v):
    return torch.logaddexp(v, _zero(v))


def mish(x, name=None):
    return apply(lambda v: v * torch.tanh(_softplus(v)), x, op_name="mish")


def softplus(x, beta=1.0, threshold=20.0, name=None):
    return apply(lambda v: torch.where(
        beta * v > threshold, v, (1.0 / beta) * torch.log1p(
            torch.exp(beta * v))), x)


def softsign(x, name=None):
    return apply(lambda v: v / (1 + v.abs()), x, op_name="softsign")


def tanh(x, name=None):
    return apply(torch.tanh, x, op_name="tanh")


def _softmax_fn(fn, axis, dtype):
    td = to_torch_dtype(dtype) if dtype is not None else None

    def f(v):
        if td is not None:
            v = v.to(td)
        return fn(v, axis)
    return f


def softmax(x, axis=-1, dtype=None, name=None):
    return apply(_softmax_fn(torch.softmax, axis, dtype), x,
                 op_name="softmax")


def log_softmax(x, axis=-1, dtype=None, name=None):
    return apply(_softmax_fn(torch.log_softmax, axis, dtype), x,
                 op_name="log_softmax")


def gumbel_softmax(x, temperature=1.0, hard=False, axis=-1, name=None):
    """Softmax of ``(x + g) / temperature``, g Gumbel noise; ``hard`` gives
    the one-hot of its argmax forward and the soft gradient backward."""
    def f(v):
        tiny = torch.finfo(v.dtype).tiny
        u = torch.empty_like(v).uniform_(
            tiny, 1.0, generator=random_mod.generator(v.device))
        g = -torch.log(-torch.log(u))
        y = torch.softmax((v + g) / temperature, axis)
        if hard:
            idx = y.argmax(axis, keepdim=True)
            y_hard = torch.zeros_like(y).scatter_(axis, idx, 1.0)
            y = y + (y_hard - y).detach()
        return y
    return apply(f, x, op_name="gumbel_softmax")


def glu(x, axis=-1, name=None):
    def f(v):
        a, b = v.chunk(2, axis)
        return a * torch.sigmoid(b)
    return apply(f, x, op_name="glu")


def thresholded_relu(x, threshold=1.0, name=None):
    return apply(lambda v: torch.where(v > threshold, v, _zero(v)), x)
