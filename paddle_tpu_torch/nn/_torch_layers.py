"""Torch-level ``Linear`` and ``LayerNorm`` with paddle's conventions, the
``torch.nn.Module`` building blocks of the GPT and ERNIE-MoE models, the
MoE layers and the engines (counterparts of
``paddle_tpu/nn/layer/common.py`` and ``paddle_tpu/nn/layer/norm.py``; the
paddle-level layers are :mod:`paddle_tpu_torch.nn`).

``Linear`` keeps paddle's ``[in_features, out_features]`` weight layout,
so a JAX ``state_dict`` loads as it is and ``y = x @ W + b``.
:func:`layer_norm` is ``paddle_tpu/nn/functional/norm.py``'s form: the
mean and the biased variance over the last dim, ``(x - mean) /
sqrt(var + eps)``, then the weight and bias, in the input dtype.

Parameters are drawn from an explicit ``torch.Generator`` on its device.
Under :func:`paddle_tpu_torch.amp.auto_cast` both cast their inputs as the
JAX ops "linear" (white list) and "layer_norm" (black list) do.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from ..amp import amp_cast

__all__ = ["Linear", "LayerNorm", "layer_norm"]


def layer_norm(x, weight, bias, eps):
    """Paddle's layer norm over the last dim (var + sqrt)."""
    x, weight, bias = amp_cast("layer_norm", x, weight, bias)
    mu = x.mean(-1, keepdim=True)
    var = x.var(-1, keepdim=True, unbiased=False)
    return (x - mu) / torch.sqrt(var + eps) * weight + bias


class Linear(nn.Module):
    """``y = x @ weight + bias`` with ``weight [in_features,
    out_features]``. The weight is normal with ``std`` (paddle's default,
    Xavier normal ``sqrt(2 / (in + out))``, when ``std`` is None) and the
    bias zero."""

    def __init__(self, in_features, out_features, *,
                 generator: torch.Generator, std=None):
        super().__init__()
        if std is None:
            std = math.sqrt(2.0 / (in_features + out_features))
        dev = generator.device
        w = torch.empty(in_features, out_features, device=dev)
        w.normal_(0.0, std, generator=generator)
        self.weight = nn.Parameter(w)
        self.bias = nn.Parameter(torch.zeros(out_features, device=dev))

    def forward(self, x):
        x, w, b = amp_cast("linear", x, self.weight, self.bias)
        return x @ w + b


class LayerNorm(nn.Module):
    """Paddle's ``LayerNorm`` over the last dim (weight 1, bias 0)."""

    def __init__(self, normalized_shape, epsilon=1e-5, *, device=None):
        super().__init__()
        self.epsilon = float(epsilon)
        self.weight = nn.Parameter(torch.ones(normalized_shape, device=device))
        self.bias = nn.Parameter(torch.zeros(normalized_shape, device=device))

    def forward(self, x):
        return layer_norm(x, self.weight, self.bias, self.epsilon)
