"""Normalization functionals (counterpart of
``paddle_tpu/nn/functional/norm.py``).

``layer_norm`` keeps the port's numerics (those of
:func:`paddle_tpu_torch.nn._torch_layers.layer_norm` and the JAX function):
the mean and the biased variance over the normalized dims, ``(x - mean) /
sqrt(var + eps)``, then the weight and bias, in the input's dtype.
``batch_norm`` in training updates the running statistics in place
(``new = momentum * old + (1 - momentum) * batch``, the biased batch
variance, as the JAX function), so a captured graph keeps them current;
in a static program the update is recorded
(:func:`paddle_tpu_torch.static.program.record_buffer_update`) and the
Executor writes it into the statistics after each run.
"""
from __future__ import annotations

import torch

from ...framework.tensor import LazyTensor, Tensor
from ...ops._dispatch import apply

__all__ = ["batch_norm", "layer_norm", "instance_norm", "group_norm",
           "normalize", "local_response_norm", "rms_norm"]


def _affine(out, wb, shape, weight, bias):
    """``out * weight + bias`` for the ones given (``wb`` their values),
    each reshaped to ``shape`` when it is not None."""
    i = 0
    if weight is not None:
        out = out * (wb[i] if shape is None else wb[i].reshape(shape))
        i += 1
    if bias is not None:
        out = out + (wb[i] if shape is None else wb[i].reshape(shape))
    return out


def batch_norm(x, running_mean, running_var, weight=None, bias=None,
               training=False, momentum=0.9, epsilon=1e-5, data_format="NCHW",
               use_global_stats=None, name=None):
    channel_axis = 1 if data_format.startswith("NC") else -1
    use_stats = (not training) if use_global_stats is None \
        else use_global_stats
    args = [a for a in (weight, bias) if a is not None]

    def stats_shape(v):
        s = [1] * v.ndim
        s[channel_axis] = v.shape[channel_axis]
        return s

    if use_stats:
        rm, rv = running_mean._value.detach(), running_var._value.detach()

        def f(v, *wb):
            s = stats_shape(v)
            out = (v - rm.reshape(s)) / torch.sqrt(rv.reshape(s) + epsilon)
            return _affine(out, wb, s, weight, bias)
        return apply(f, x, *args, op_name="batch_norm")

    def g(v, *wb):
        axes = tuple(a for a in range(v.ndim) if a != channel_axis % v.ndim)
        mean = v.mean(axes)
        var = v.var(axes, unbiased=False)
        s = stats_shape(v)
        out = (v - mean.reshape(s)) / torch.sqrt(var.reshape(s) + epsilon)
        return _affine(out, wb, s, weight, bias), (mean, var)

    out, (bm, bv) = apply(g, x, *args, op_name="batch_norm", has_aux=True)
    if not isinstance(running_mean, Tensor):
        return out

    def update(b, r):
        return momentum * r + (1.0 - momentum) * b

    if isinstance(bm, LazyTensor):
        # a static program: the update is an op of the program, chained
        # off the buffer's latest update in it (a layer applied twice
        # compounds within one run); the Executor copies it into the
        # buffer after each run, so it compounds across runs too
        from ...static.program import (latest_buffer_value,
                                       record_buffer_update)
        for run, batch in ((running_mean, bm), (running_var, bv)):
            record_buffer_update(run, apply(
                update, batch, latest_buffer_value(run),
                op_name="bn_stats_update"))
        return out
    with torch.no_grad():
        for run, batch in ((running_mean, bm), (running_var, bv)):
            run._value.copy_(update(batch._value, run._value))
    return out


def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-5,
               name=None):
    if isinstance(normalized_shape, int):
        normalized_shape = [normalized_shape]
    n = len(tuple(normalized_shape))

    def f(v, *wb):
        axes = tuple(range(v.ndim - n, v.ndim))
        mean = v.mean(axes, keepdim=True)
        var = v.var(axes, keepdim=True, unbiased=False)
        out = (v - mean) / torch.sqrt(var + epsilon)
        return _affine(out, wb, None, weight, bias)

    args = [a for a in (weight, bias) if a is not None]
    return apply(f, x, *args, op_name="layer_norm")


def rms_norm(x, weight=None, epsilon=1e-6, name=None):
    def f(v, *w):
        out = v * torch.rsqrt(v.square().mean(-1, keepdim=True) + epsilon)
        return out * w[0] if w else out
    args = [weight] if weight is not None else []
    return apply(f, x, *args, op_name="rms_norm")


def instance_norm(x, running_mean=None, running_var=None, weight=None,
                  bias=None, use_input_stats=True, momentum=0.9, eps=1e-5,
                  data_format="NCHW", name=None):
    channel_axis = 1 if data_format.startswith("NC") else -1

    def f(v, *wb):
        axes = tuple(range(2, v.ndim)) if channel_axis == 1 else \
            tuple(range(1, v.ndim - 1))
        mean = v.mean(axes, keepdim=True)
        var = v.var(axes, keepdim=True, unbiased=False)
        out = (v - mean) / torch.sqrt(var + eps)
        s = [1] * v.ndim
        s[channel_axis] = v.shape[channel_axis]
        return _affine(out, wb, s, weight, bias)

    args = [a for a in (weight, bias) if a is not None]
    return apply(f, x, *args, op_name="instance_norm")


def group_norm(x, num_groups, epsilon=1e-5, weight=None, bias=None,
               data_format="NCHW", name=None):
    channel_last = not data_format.startswith("NC")

    def f(v, *wb):
        v2 = v.movedim(-1, 1) if channel_last else v
        n, c = v2.shape[0], v2.shape[1]
        r = v2.reshape((n, num_groups, c // num_groups) + tuple(v2.shape[2:]))
        axes = tuple(range(2, r.ndim))
        mean = r.mean(axes, keepdim=True)
        var = r.var(axes, keepdim=True, unbiased=False)
        out = ((r - mean) / torch.sqrt(var + epsilon)).reshape(v2.shape)
        s = [1] * v2.ndim
        s[1] = c
        out = _affine(out, wb, s, weight, bias)
        return out.movedim(1, -1) if channel_last else out

    args = [a for a in (weight, bias) if a is not None]
    return apply(f, x, *args, op_name="group_norm")


def normalize(x, p=2, axis=1, epsilon=1e-12, name=None):
    def f(v):
        nrm = v.abs().pow(p).sum(axis, keepdim=True).pow(1.0 / p)
        return v / nrm.clamp_min(epsilon)
    return apply(f, x, op_name="normalize")


def local_response_norm(x, size, alpha=1e-4, beta=0.75, k=1.0,
                        data_format="NCHW", name=None):
    """``x / (k + alpha * s) ** beta``, ``s`` the sum of squares over a
    window of ``size`` channels (zero-padded)."""
    def f(v):
        ch = 1 if data_format.startswith("NC") else v.ndim - 1
        c = v.shape[ch]
        half = size // 2
        pads = [0, 0] * v.ndim
        pos = 2 * (v.ndim - 1 - ch)      # F.pad lists the last dim first
        pads[pos], pads[pos + 1] = half, size - half - 1
        sq = torch.nn.functional.pad(v.square(), pads)
        s = sum(sq.narrow(ch, i, c) for i in range(size))
        return v / (k + alpha * s).pow(beta)
    return apply(f, x, op_name="local_response_norm")
