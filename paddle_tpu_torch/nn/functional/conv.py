"""Convolutions (counterpart of ``paddle_tpu/nn/functional/conv.py``) over
``torch.nn.functional.conv*d`` and ``conv_transpose*d`` (cuDNN on the
card), with the JAX functions' semantics:

- paddle's weight layouts, ``[out, in/groups, *k]`` and for the transposes
  ``[in, out/groups, *k]`` (torch's own); ``groups`` and ``dilation``;
- NC* and channel-last inputs (channel-last is a permute around the torch
  call, as the JAX function transposes the weight to *IO);
- padding as an int, one per axis, ``2n`` values, paddle's
  ``[[0, 0], [0, 0], [t, b], [l, r]]`` form, or ``"SAME"``/``"VALID"``.
  ``"SAME"`` is XLA's: the total pad split low/high with the extra on the
  high side, at any stride. Pads that are not one symmetric value per
  axis are applied with ``F.pad`` first (torch's ``padding="same"`` takes
  stride 1 only);
- the transposes' per-side pads, ``output_padding`` and ``output_size``:
  the torch call runs with no padding and its result is cut (or extended
  by zeros) to the JAX extents, then the bias is added.

The op names stay ``conv1d`` ... ``conv3d_transpose``, so that
``auto_cast``'s O1 white list casts them as it does in the JAX package.
"""
from __future__ import annotations

import torch.nn.functional as TF

from ...ops._dispatch import apply

__all__ = ["conv1d", "conv2d", "conv3d", "conv1d_transpose",
           "conv2d_transpose", "conv3d_transpose"]

_CHANNEL_LAST = ("NHWC", "NWC", "NDHWC", "NLC")
_CONV = (None, TF.conv1d, TF.conv2d, TF.conv3d)
_CONV_T = (None, TF.conv_transpose1d, TF.conv_transpose2d,
           TF.conv_transpose3d)


def _norm_tuple(v, n):
    if isinstance(v, int):
        return (v,) * n
    return tuple(int(x) for x in v)


def _norm_padding(padding, n, channel_last=False):
    """``((lo, hi), ...)`` per spatial axis, or the string ``"SAME"`` /
    ``"VALID"``. Paddle's per-dimension form (``n + 2`` pairs) names the
    spatial pairs by the layout: the last ``n`` for NC*, the middle ``n``
    for channel-last. (The JAX function reads ``2n`` pairs as ``2n`` ints
    and fails at 2-D, and takes the last ``n`` pairs for channel-last.)"""
    if isinstance(padding, str):
        return padding.upper()
    if isinstance(padding, int):
        return tuple((padding, padding) for _ in range(n))
    padding = list(padding)
    if all(isinstance(p, (list, tuple)) for p in padding):
        pairs = [tuple(int(v) for v in p) for p in padding if len(p) == 2]
        if channel_last and len(pairs) == n + 2:
            return tuple(pairs[1:1 + n])
        return tuple(pairs[-n:])
    if len(padding) == n:
        return tuple((int(p), int(p)) for p in padding)
    if len(padding) == 2 * n:
        return tuple((int(padding[2 * i]), int(padding[2 * i + 1]))
                     for i in range(n))
    raise ValueError(f"bad padding {padding!r}")


def _same_pads(sizes, window, stride, dilation):
    """XLA's ``"SAME"``: out = ceil(in / stride), the total pad split with
    the extra element on the high side."""
    pads = []
    for size, k, s, d in zip(sizes, window, stride, dilation):
        k_eff = d * (k - 1) + 1
        out = -(-size // s)
        total = max((out - 1) * s + k_eff - size, 0)
        pads.append((total // 2, total - total // 2))
    return tuple(pads)


def _resolve(pad, sizes, window, stride, dilation):
    if pad == "VALID":
        return ((0, 0),) * len(sizes)
    if pad == "SAME":
        return _same_pads(sizes, window, stride, dilation)
    return tuple(pad)


def _pad_arg(pads):
    """``F.pad``'s argument for per-axis ``(lo, hi)`` pairs (last axis
    first)."""
    return [p for lo_hi in reversed(pads) for p in lo_hi]


def _symmetric(pads):
    return all(lo == hi and lo >= 0 for lo, hi in pads)


def _conv(x, weight, bias, stride, padding, dilation, groups, n, data_format):
    channel_last = data_format in _CHANNEL_LAST
    stride = _norm_tuple(stride, n)
    dilation = _norm_tuple(dilation, n)
    pad = _norm_padding(padding, n, channel_last)

    def f(v, w, *b):
        if channel_last:
            v = v.movedim(-1, 1)
        pads = _resolve(pad, v.shape[2:], w.shape[2:], stride, dilation)
        if not _symmetric(pads):
            v = TF.pad(v, _pad_arg(pads))
            pads = ((0, 0),) * n
        out = _CONV[n](v, w, b[0] if b else None, stride,
                       [lo for lo, _ in pads], dilation, groups)
        return out.movedim(1, -1) if channel_last else out

    if bias is not None:
        return apply(f, x, weight, bias, op_name=f"conv{n}d")
    return apply(f, x, weight, op_name=f"conv{n}d")


def conv1d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCL", name=None):
    fmt = "NWC" if data_format in ("NLC", "NWC") else "NCW"
    return _conv(x, weight, bias, stride, padding, dilation, groups, 1, fmt)


def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCHW", name=None):
    return _conv(x, weight, bias, stride, padding, dilation, groups, 2,
                 data_format)


def conv3d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCDHW", name=None):
    return _conv(x, weight, bias, stride, padding, dilation, groups, 3,
                 data_format)


def _transpose_pads(pad, window, stride, dilation):
    """The JAX function's pads of a transpose: ``"SAME"`` is
    ``(k_eff - stride + 1) // 2`` on both sides."""
    n = len(window)
    if pad == "VALID":
        return ((0, 0),) * n
    if pad == "SAME":
        return tuple(((dilation[i] * (window[i] - 1) + 1 - stride[i] + 1)
                      // 2,) * 2 for i in range(n))
    return tuple(pad)


def _conv_transpose(x, weight, bias, stride, padding, output_padding, dilation,
                    groups, n, data_format, output_size=None):
    channel_last = data_format in _CHANNEL_LAST
    stride = _norm_tuple(stride, n)
    dilation = _norm_tuple(dilation, n)
    out_pad = _norm_tuple(output_padding, n)
    window = [int(s) for s in weight.shape[2:2 + n]]
    pads = _transpose_pads(_norm_padding(padding, n, channel_last), window,
                           stride, dilation)

    if output_size is not None:
        # output_size picks the size within the stride-sized window of
        # sizes by setting output_padding (the JAX function's contract)
        if any(out_pad):
            raise ValueError(
                "pass either output_size or output_padding, not both")
        osz = list(output_size) if isinstance(output_size, (list, tuple)) \
            else [int(output_size)] * n
        in_sp = [int(s) for s in
                 (x.shape[1:1 + n] if channel_last else x.shape[2:2 + n])]
        expected = [(in_sp[i] - 1) * stride[i] - pads[i][0] - pads[i][1]
                    + dilation[i] * (window[i] - 1) + 1 for i in range(n)]
        out_pad = tuple(int(osz[i]) - expected[i] for i in range(n))
        for i in range(n):
            if not 0 <= out_pad[i] < max(stride[i], 1):
                raise ValueError(
                    f"output_size {osz} unreachable: axis {i} expects a "
                    f"size in [{expected[i]}, "
                    f"{expected[i] + max(stride[i], 1) - 1}]")

    # the full transposed convolution (no padding) is (in - 1) * s + k_eff
    # long; the JAX extents cut lo from its start and hi - output_padding
    # from its end (a negative cut extends it by zeros)
    cut = tuple((-lo, op - hi) for (lo, hi), op in zip(pads, out_pad))

    def f(v, w, *b):
        if channel_last:
            v = v.movedim(-1, 1)
        out = _CONV_T[n](v, w, None, stride, 0, 0, groups, dilation)
        if any(c for c in cut):
            out = TF.pad(out, _pad_arg(cut))
        if b:
            out = out + b[0].reshape((1, -1) + (1,) * n)
        return out.movedim(1, -1) if channel_last else out

    if bias is not None:
        return apply(f, x, weight, bias, op_name=f"conv{n}d_transpose")
    return apply(f, x, weight, op_name=f"conv{n}d_transpose")


def conv1d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1, output_size=None,
                     data_format="NCL", name=None):
    fmt = "NWC" if data_format in ("NLC", "NWC") else "NCW"
    return _conv_transpose(x, weight, bias, stride, padding, output_padding,
                           dilation, groups, 1, fmt, output_size)


def conv2d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1, output_size=None,
                     data_format="NCHW", name=None):
    return _conv_transpose(x, weight, bias, stride, padding, output_padding,
                           dilation, groups, 2, data_format, output_size)


def conv3d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1, output_size=None,
                     data_format="NCDHW", name=None):
    return _conv_transpose(x, weight, bias, stride, padding, output_padding,
                           dilation, groups, 3, data_format, output_size)
