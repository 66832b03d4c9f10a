"""Pooling (counterpart of ``paddle_tpu/nn/functional/pooling.py``) over
``torch.nn.functional``'s pools, with the JAX functions' semantics:

- max pools pad with -inf (an integer input with its dtype's minimum);
- avg pools sum over the window; with ``exclusive`` (the default) and a
  nonzero pad they divide by the count of real elements, else by the
  window's size;
- ``"SAME"`` padding is XLA's (the extra element on the high side);
- adaptive pools take paddle's bins, ``start = floor(i * in / out)``,
  ``end = ceil((i + 1) * in / out)`` (torch's own), ``None`` keeping an
  axis; channel-last inputs reduce their spatial axes (the JAX function
  reduces the last ``n`` axes whatever the layout).

Pooling is on neither ``auto_cast`` list: it keeps its input's dtype.
``ceil_mode=True``, ``return_mask=True`` and ``divisor_override`` raise
``NotImplementedError``: the JAX functions ignore them and return another
shape or value than paddle's.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as TF

from ...ops._dispatch import apply
from .conv import _CHANNEL_LAST, _norm_padding, _norm_tuple, _pad_arg, \
    _same_pads

__all__ = [
    "avg_pool1d", "avg_pool2d", "avg_pool3d", "max_pool1d", "max_pool2d",
    "max_pool3d", "adaptive_avg_pool1d", "adaptive_avg_pool2d",
    "adaptive_avg_pool3d", "adaptive_max_pool1d", "adaptive_max_pool2d",
    "adaptive_max_pool3d",
]

_MAX = (None, TF.max_pool1d, TF.max_pool2d, TF.max_pool3d)
_AVG = (None, TF.avg_pool1d, TF.avg_pool2d, TF.avg_pool3d)
_ADAPTIVE = {"avg": (None, TF.adaptive_avg_pool1d, TF.adaptive_avg_pool2d,
                     TF.adaptive_avg_pool3d),
             "max": (None, TF.adaptive_max_pool1d, TF.adaptive_max_pool2d,
                     TF.adaptive_max_pool3d)}


def _unsupported(what, fn):
    raise NotImplementedError(
        f"{fn}: {what} is not supported: the JAX reference ignores it "
        f"(paddle_tpu/nn/functional/pooling.py) and would return another "
        f"result than paddle's")


def _fits_torch(pads, kernel):
    """Can torch's own ``padding`` express these pads (one symmetric value
    per axis, at most half the window)?"""
    return all(lo == hi and 0 <= lo <= k // 2
               for (lo, hi), k in zip(pads, kernel))


def _window_max(v, kernel, stride):
    """The max over each window of an already padded NC* input, by views
    (torch's max pools take no integer input on every device)."""
    n = len(kernel)
    for i, (k, s) in enumerate(zip(kernel, stride)):
        v = v.unfold(2 + i, k, s)
    return v.amax(tuple(range(-n, 0)))


def _pool(x, kernel, stride, padding, n, mode, exclusive, data_format):
    channel_last = data_format in _CHANNEL_LAST
    kernel = _norm_tuple(kernel, n)
    stride = _norm_tuple(stride if stride is not None else kernel, n)
    pad = _norm_padding(padding, n, channel_last)

    def f(v):
        if channel_last:
            # contiguous: on CUDA, torch's avg_pool2d backward of a
            # channels-last-strided input disagrees with the CPU's and with
            # its own on the contiguous copy (kernel 3, stride 3, pad 1)
            v = v.movedim(-1, 1).contiguous()
        if pad == "VALID":
            pads = ((0, 0),) * n
        elif pad == "SAME":
            pads = _same_pads(v.shape[2:], kernel, stride, (1,) * n)
        else:
            pads = tuple(pad)
        fits = _fits_torch(pads, kernel)
        if mode == "max":
            if not v.is_floating_point():
                fill = torch.iinfo(v.dtype).min
                out = _window_max(TF.pad(v, _pad_arg(pads), value=fill),
                                  kernel, stride)
            elif fits:
                out = _MAX[n](v, kernel, stride, [lo for lo, _ in pads])
            else:
                out = _MAX[n](TF.pad(v, _pad_arg(pads), value=-math.inf),
                              kernel, stride)
        elif fits:
            out = _AVG[n](v, kernel, stride, [lo for lo, _ in pads],
                          count_include_pad=not exclusive)
        else:
            # the window means of the zero-padded input; exclusive divides
            # by the share of real elements in each window instead
            out = _AVG[n](TF.pad(v, _pad_arg(pads)), kernel, stride)
            if exclusive and any(lo or hi for lo, hi in pads):
                ones = torch.ones((1, 1) + tuple(v.shape[2:]), dtype=v.dtype,
                                  device=v.device)
                out = out / _AVG[n](TF.pad(ones, _pad_arg(pads)), kernel,
                                    stride)
        return out.movedim(1, -1) if channel_last else out

    return apply(f, x, op_name=f"{mode}_pool{n}d")


def _check(fn, ceil_mode=False, return_mask=False, divisor_override=None):
    if ceil_mode:
        _unsupported("ceil_mode=True", fn)
    if return_mask:
        _unsupported("return_mask=True", fn)
    if divisor_override is not None:
        _unsupported("divisor_override", fn)


def avg_pool1d(x, kernel_size, stride=None, padding=0, exclusive=True,
               ceil_mode=False, data_format="NCL", name=None):
    _check("avg_pool1d", ceil_mode)
    fmt = "NWC" if data_format in ("NLC", "NWC") else "NCW"
    return _pool(x, kernel_size, stride, padding, 1, "avg", exclusive, fmt)


def avg_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCHW",
               name=None):
    _check("avg_pool2d", ceil_mode, divisor_override=divisor_override)
    return _pool(x, kernel_size, stride, padding, 2, "avg", exclusive,
                 data_format)


def avg_pool3d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCDHW",
               name=None):
    _check("avg_pool3d", ceil_mode, divisor_override=divisor_override)
    return _pool(x, kernel_size, stride, padding, 3, "avg", exclusive,
                 data_format)


def max_pool1d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCL", name=None):
    _check("max_pool1d", ceil_mode, return_mask)
    fmt = "NWC" if data_format in ("NLC", "NWC") else "NCW"
    return _pool(x, kernel_size, stride, padding, 1, "max", True, fmt)


def max_pool2d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCHW", name=None):
    _check("max_pool2d", ceil_mode, return_mask)
    return _pool(x, kernel_size, stride, padding, 2, "max", True,
                 data_format)


def max_pool3d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCDHW", name=None):
    _check("max_pool3d", ceil_mode, return_mask)
    return _pool(x, kernel_size, stride, padding, 3, "max", True,
                 data_format)


def _adaptive_bins_max(v, sizes):
    """Adaptive max over paddle's bins, one axis at a time (for the integer
    inputs torch's adaptive max pools do not take)."""
    for i, out in enumerate(sizes):
        ax = 2 + i
        size = v.shape[ax]
        v = torch.cat([v.narrow(ax, j * size // out,
                                -(-(j + 1) * size // out) - j * size // out)
                       .amax(ax, keepdim=True) for j in range(out)], ax)
    return v


def _adaptive(x, output_size, n, mode, data_format):
    channel_last = data_format in _CHANNEL_LAST
    out_sizes = (output_size,) * n if output_size is None \
        or isinstance(output_size, int) else tuple(output_size)

    def f(v):
        if channel_last:
            v = v.movedim(-1, 1)
        sizes = tuple(int(v.shape[2 + i]) if s is None else int(s)
                      for i, s in enumerate(out_sizes))
        if mode == "max" and not v.is_floating_point():
            out = _adaptive_bins_max(v, sizes)
        else:
            out = _ADAPTIVE[mode][n](v, sizes)
        return out.movedim(1, -1) if channel_last else out

    return apply(f, x, op_name=f"adaptive_{mode}_pool{n}d")


def adaptive_avg_pool1d(x, output_size, name=None):
    return _adaptive(x, output_size, 1, "avg", "NCL")


def adaptive_avg_pool2d(x, output_size, data_format="NCHW", name=None):
    return _adaptive(x, output_size, 2, "avg", data_format)


def adaptive_avg_pool3d(x, output_size, data_format="NCDHW", name=None):
    return _adaptive(x, output_size, 3, "avg", data_format)


def adaptive_max_pool1d(x, output_size, return_mask=False, name=None):
    _check("adaptive_max_pool1d", return_mask=return_mask)
    return _adaptive(x, output_size, 1, "max", "NCL")


def adaptive_max_pool2d(x, output_size, return_mask=False, name=None):
    _check("adaptive_max_pool2d", return_mask=return_mask)
    return _adaptive(x, output_size, 2, "max", "NCHW")


def adaptive_max_pool3d(x, output_size, return_mask=False, name=None):
    _check("adaptive_max_pool3d", return_mask=return_mask)
    return _adaptive(x, output_size, 3, "max", "NCDHW")
