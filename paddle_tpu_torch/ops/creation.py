"""Tensor creation ops (counterpart of ``paddle_tpu/ops/creation.py``).

New tensors land on the current place (the card unless
``set_device("cpu")``). Random ops draw from the facade's generator of
that device (:func:`paddle_tpu_torch.framework.random.generator`).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ._dispatch import apply, unwrap, wrap
from ..framework import random as random_mod
from ..framework.dtype import default_dtype, to_torch_dtype
from ..framework.place import to_torch_device
from ..framework.tensor import Tensor, to_tensor

__all__ = [
    "to_tensor", "zeros", "ones", "full", "empty", "zeros_like", "ones_like",
    "full_like", "empty_like", "arange", "linspace", "logspace", "eye",
    "rand", "randn", "randint", "randint_like", "randperm", "uniform",
    "normal", "standard_normal", "multinomial", "bernoulli", "poisson",
    "tril_indices", "triu_indices", "one_hot", "clone", "complex",
]


def _shape(shape):
    if isinstance(shape, Tensor):
        return tuple(int(s) for s in shape.tolist())
    if isinstance(shape, (int, np.integer)):
        return (int(shape),)
    return tuple(int(unwrap(s)) if isinstance(s, Tensor) else int(s)
                 for s in shape)


def _dt(dtype, default=None):
    if dtype is None:
        return to_torch_dtype(default or default_dtype())
    return to_torch_dtype(dtype)


def _dev():
    return to_torch_device()


def _gen(dev):
    return random_mod.generator(dev)


def _scalar(v):
    v = unwrap(v)
    return v.item() if isinstance(v, torch.Tensor) else v


def zeros(shape, dtype=None, name=None):
    return wrap(torch.zeros(_shape(shape), dtype=_dt(dtype), device=_dev()))


def ones(shape, dtype=None, name=None):
    return wrap(torch.ones(_shape(shape), dtype=_dt(dtype), device=_dev()))


def full(shape, fill_value, dtype=None, name=None):
    fv = _scalar(fill_value)
    if dtype is None and isinstance(fill_value, bool):
        return wrap(torch.full(_shape(shape), fv, dtype=torch.bool,
                               device=_dev()))
    return wrap(torch.full(_shape(shape), fv, dtype=_dt(dtype),
                           device=_dev()))


def empty(shape, dtype=None, name=None):
    return zeros(shape, dtype)


def zeros_like(x, dtype=None, name=None):
    v = unwrap(x)
    return wrap(torch.zeros_like(v, dtype=_dt(dtype, v.dtype)))


def ones_like(x, dtype=None, name=None):
    v = unwrap(x)
    return wrap(torch.ones_like(v, dtype=_dt(dtype, v.dtype)))


def full_like(x, fill_value, dtype=None, name=None):
    v = unwrap(x)
    return wrap(torch.full_like(v, _scalar(fill_value),
                                dtype=_dt(dtype, v.dtype)))


def empty_like(x, dtype=None, name=None):
    return zeros_like(x, dtype)


def clone(x, name=None):
    from .manipulation import assign
    return assign(x)


def arange(start=0, end=None, step=1, dtype=None, name=None):
    vals = [unwrap(v) for v in (start, end, step)]
    if dtype is None:
        is_float = any(
            isinstance(v, float) or (isinstance(v, torch.Tensor)
                                     and v.is_floating_point())
            for v in vals)
        dtype = "float32" if is_float else "int64"
    start, end, step = (_scalar(v) if v is not None else None for v in vals)
    if end is None:
        start, end = 0, start
    return wrap(torch.arange(start, end, step, dtype=to_torch_dtype(dtype),
                             device=_dev()))


def linspace(start, stop, num, dtype=None, name=None):
    return wrap(torch.linspace(_scalar(start), _scalar(stop),
                               int(_scalar(num)), dtype=_dt(dtype),
                               device=_dev()))


def logspace(start, stop, num, base=10.0, dtype=None, name=None):
    return wrap(torch.logspace(_scalar(start), _scalar(stop),
                               int(_scalar(num)), base=_scalar(base),
                               dtype=_dt(dtype), device=_dev()))


def eye(num_rows, num_columns=None, dtype=None, name=None):
    n = int(num_rows)
    m = int(num_columns) if num_columns is not None else n
    return wrap(torch.eye(n, m, dtype=_dt(dtype), device=_dev()))


def complex(real, imag, name=None):
    return apply(torch.complex, real, imag, op_name="complex")


# ---- random ------------------------------------------------------------------

def rand(shape, dtype=None, name=None):
    return uniform(shape, dtype=dtype, min=0.0, max=1.0)


def randn(shape, dtype=None, name=None):
    dev = _dev()
    return wrap(torch.randn(_shape(shape), dtype=_dt(dtype), device=dev,
                            generator=_gen(dev)))


standard_normal = randn


def normal(mean=0.0, std=1.0, shape=None, name=None):
    if isinstance(mean, Tensor) or isinstance(std, Tensor):
        m, s = unwrap(mean), unwrap(std)
        ref = m if isinstance(m, torch.Tensor) else s
        out_shape = torch.broadcast_shapes(
            getattr(m, "shape", ()), getattr(s, "shape", ()))
        dt = m.dtype if isinstance(m, torch.Tensor) else torch.float32
        z = torch.randn(out_shape, dtype=dt, device=ref.device,
                        generator=_gen(ref.device))
        return wrap(m + s * z)
    dev = _dev()
    z = torch.randn(_shape(shape or [1]), dtype=_dt(None), device=dev,
                    generator=_gen(dev))
    return wrap(mean + std * z)


def uniform(shape, dtype=None, min=-1.0, max=1.0, seed=0, name=None):
    dev = _dev()
    gen = _gen(dev)
    if seed:
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed))
    u = torch.rand(_shape(shape), dtype=_dt(dtype), device=dev,
                   generator=gen)
    return wrap(u * (_scalar(max) - _scalar(min)) + _scalar(min))


def randint(low=0, high=None, shape=(1,), dtype=None, name=None):
    if high is None:
        low, high = 0, low
    dev = _dev()
    return wrap(torch.randint(int(low), int(high), _shape(shape),
                              dtype=_dt(dtype, "int64"), device=dev,
                              generator=_gen(dev)))


def randint_like(x, low=0, high=None, dtype=None, name=None):
    v = unwrap(x)
    if high is None:
        low, high = 0, low
    return wrap(torch.randint(int(low), int(high), tuple(v.shape),
                              dtype=_dt(dtype, v.dtype), device=v.device,
                              generator=_gen(v.device)))


def randperm(n, dtype="int64", name=None):
    dev = _dev()
    return wrap(torch.randperm(int(n), device=dev, generator=_gen(dev))
                .to(to_torch_dtype(dtype)))


def multinomial(x, num_samples=1, replacement=False, name=None):
    v = unwrap(x)
    out = torch.multinomial(v, int(num_samples), replacement=replacement,
                            generator=_gen(v.device))
    return wrap(out.to(torch.int64))


def bernoulli(x, name=None):
    v = unwrap(x)
    return wrap(torch.bernoulli(v.detach(), generator=_gen(v.device)))


def poisson(x, name=None):
    v = unwrap(x)
    return wrap(torch.poisson(v.detach(), generator=_gen(v.device)))


def tril_indices(row, col=None, offset=0, dtype="int64", name=None):
    col = col if col is not None else row
    return wrap(torch.tril_indices(int(row), int(col), int(offset),
                                   device=_dev()).to(to_torch_dtype(dtype)))


def triu_indices(row, col=None, offset=0, dtype="int64", name=None):
    col = col if col is not None else row
    return wrap(torch.triu_indices(int(row), int(col), int(offset),
                                   device=_dev()).to(to_torch_dtype(dtype)))


def one_hot(x, num_classes, name=None):
    n = int(num_classes)
    return apply(lambda v: F.one_hot(v.long(), n).to(torch.float32), x,
                 op_name="one_hot")
