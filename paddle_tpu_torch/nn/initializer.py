"""Parameter initializers (counterpart of ``paddle_tpu/nn/initializer.py``).

An initializer is called as ``init(shape, dtype)`` and returns a
``torch.Tensor`` on the current place (the card unless
``set_device("cpu")``). The random ones draw from the facade's generator
of that device (:func:`paddle_tpu_torch.framework.random.generator`), so
``paddle.seed`` makes them repeat; they draw other numbers than the JAX
ones from one seed, with the same distributions.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..framework import random as random_mod
from ..framework.dtype import to_torch_dtype
from ..framework.place import to_torch_device

__all__ = ["Initializer", "Constant", "Normal", "TruncatedNormal", "Uniform",
           "XavierNormal", "XavierUniform", "KaimingNormal", "KaimingUniform",
           "Assign", "Orthogonal", "Dirac", "calculate_gain"]


def _empty(shape, dtype):
    dev = to_torch_device()
    return torch.empty(tuple(shape), dtype=to_torch_dtype(dtype),
                       device=dev), random_mod.generator(dev)


def _normal(shape, dtype, mean, std):
    t, gen = _empty(shape, dtype)
    return t.normal_(mean, std, generator=gen)


def _uniform(shape, dtype, low, high):
    t, gen = _empty(shape, dtype)
    return t.uniform_(low, high, generator=gen)


class Initializer:
    def __call__(self, shape, dtype):
        raise NotImplementedError


class Constant(Initializer):
    def __init__(self, value=0.0):
        self.value = value

    def __call__(self, shape, dtype):
        return torch.full(tuple(shape), self.value,
                          dtype=to_torch_dtype(dtype),
                          device=to_torch_device())


class Normal(Initializer):
    def __init__(self, mean=0.0, std=1.0):
        self.mean, self.std = mean, std

    def __call__(self, shape, dtype):
        return _normal(shape, dtype, self.mean, self.std)


class TruncatedNormal(Initializer):
    """``mean + std * z``, z standard normal cut to [-2, 2] (inverse CDF of
    a uniform draw between the cut's CDF values)."""

    def __init__(self, mean=0.0, std=1.0):
        self.mean, self.std = mean, std

    def __call__(self, shape, dtype):
        lo, hi = (0.5 * (1.0 + math.erf(b / math.sqrt(2.0)))
                  for b in (-2.0, 2.0))
        u = _uniform(shape, "float32", 2.0 * lo - 1.0, 2.0 * hi - 1.0)
        z = (torch.erfinv(u) * math.sqrt(2.0)).clamp_(-2.0, 2.0)
        return (self.mean + self.std * z).to(to_torch_dtype(dtype))


class Uniform(Initializer):
    def __init__(self, low=-1.0, high=1.0):
        self.low, self.high = low, high

    def __call__(self, shape, dtype):
        return _uniform(shape, dtype, self.low, self.high)


def _fans(shape):
    shape = tuple(shape)
    if len(shape) == 0:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        return shape[0], shape[1]
    receptive = int(np.prod(shape[2:]))
    return shape[1] * receptive, shape[0] * receptive


class XavierNormal(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def __call__(self, shape, dtype):
        fi, fo = _fans(shape)
        fi = self.fan_in if self.fan_in is not None else fi
        fo = self.fan_out if self.fan_out is not None else fo
        return _normal(shape, dtype, 0.0,
                       self.gain * math.sqrt(2.0 / (fi + fo)))


class XavierUniform(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def __call__(self, shape, dtype):
        fi, fo = _fans(shape)
        fi = self.fan_in if self.fan_in is not None else fi
        fo = self.fan_out if self.fan_out is not None else fo
        limit = self.gain * math.sqrt(6.0 / (fi + fo))
        return _uniform(shape, dtype, -limit, limit)


def _kaiming_gain(negative_slope, nonlinearity):
    if nonlinearity == "leaky_relu":
        return math.sqrt(2.0 / (1 + negative_slope ** 2))
    return math.sqrt(2.0)


class KaimingNormal(Initializer):
    def __init__(self, fan_in=None, negative_slope=0.0, nonlinearity="relu"):
        self.fan_in = fan_in
        self.negative_slope = negative_slope
        self.nonlinearity = nonlinearity

    def __call__(self, shape, dtype):
        fi = self.fan_in if self.fan_in is not None else _fans(shape)[0]
        gain = _kaiming_gain(self.negative_slope, self.nonlinearity)
        return _normal(shape, dtype, 0.0, gain / math.sqrt(fi))


class KaimingUniform(Initializer):
    def __init__(self, fan_in=None, negative_slope=0.0, nonlinearity="relu"):
        self.fan_in = fan_in
        self.negative_slope = negative_slope
        self.nonlinearity = nonlinearity

    def __call__(self, shape, dtype):
        fi = self.fan_in if self.fan_in is not None else _fans(shape)[0]
        gain = _kaiming_gain(self.negative_slope, self.nonlinearity)
        limit = gain * math.sqrt(3.0 / fi)
        return _uniform(shape, dtype, -limit, limit)


class Assign(Initializer):
    """The given value (array, list, Tensor), reshaped to ``shape``."""

    def __init__(self, value):
        self.value = value

    def __call__(self, shape, dtype):
        from ..framework.tensor import _as_value
        v = _as_value(self.value, dtype).to(to_torch_device())
        if tuple(v.shape) != tuple(shape):
            v = v.reshape(tuple(shape))
        return v.clone()


class Orthogonal(Initializer):
    """``gain`` times an orthogonal matrix over (rows = all dims but the
    last, columns = the last), as ``jax.nn.initializers.orthogonal``: the
    Q of a normal matrix's QR, its columns' signs set by R's diagonal."""

    def __init__(self, gain=1.0):
        self.gain = gain

    def __call__(self, shape, dtype):
        shape = tuple(shape)
        n_cols = shape[-1]
        n_rows = int(np.prod(shape)) // n_cols
        tall = (max(n_rows, n_cols), min(n_rows, n_cols))
        a = _normal(tall, "float32", 0.0, 1.0)
        q, r = torch.linalg.qr(a)
        q = q * torch.sign(torch.diagonal(r))
        if n_rows < n_cols:
            q = q.T
        return (self.gain * q.reshape(shape)).to(to_torch_dtype(dtype))


class Dirac(Initializer):
    def __init__(self, groups=1):
        self.groups = groups

    def __call__(self, shape, dtype):
        out = np.zeros(tuple(shape), np.float32)
        oc, ic = shape[0], shape[1]
        per = oc // self.groups
        for g in range(self.groups):
            for i in range(min(per, ic)):
                idx = (g * per + i, i) + tuple(s // 2 for s in shape[2:])
                out[idx] = 1.0
        return torch.from_numpy(out).to(to_torch_device(),
                                        to_torch_dtype(dtype))


# paddle's defaults for weights and biases
def _default_weight_init():
    return XavierNormal()


def _default_bias_init():
    return Constant(0.0)


def calculate_gain(nonlinearity, param=None):
    gains = {
        "sigmoid": 1.0, "linear": 1.0, "conv1d": 1.0, "conv2d": 1.0,
        "conv3d": 1.0, "tanh": 5.0 / 3.0, "relu": math.sqrt(2.0),
        "leaky_relu": math.sqrt(
            2.0 / (1 + (param if param is not None else 0.01) ** 2)),
        "selu": 3.0 / 4.0,
    }
    return gains[nonlinearity]
