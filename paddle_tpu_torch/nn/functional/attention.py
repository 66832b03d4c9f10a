"""Attention functional (counterpart of
``paddle_tpu/nn/functional/attention.py``).

:func:`scaled_dot_product_attention` takes the JAX package's gate: with no
mask, ``dropout_p == 0`` and shapes the flash kernel takes
(:func:`paddle_tpu_torch.kernels.flash_attention.supported`: S >= 64,
d <= 128), attention is the FlashAttention kernel (forward, dQ and dK/dV
on CUDA; their plain versions for CPU tensors); otherwise it is the dense
:func:`_sdpa_ref`, with its dropout on the probabilities in training. The
gate reads ``dropout_p``, not ``training``, so a model built with
attention dropout takes the dense form in eval too, as in JAX.

One function for both kinds of input: facade Tensors go through the
facade's dispatch (``auto_cast`` casts them as the JAX ops
"flash_attention" and "scaled_dot_product_attention", both on the white
list); ``torch.Tensor``\\s (the torch-level models) are cast the same way
by :func:`~paddle_tpu_torch.amp.amp_cast`. A mask is a constant of the op
(no gradient), as the JAX function unwraps it. Dropout draws from the
facade's generator of the inputs' device.
"""
from __future__ import annotations

import torch

from ...amp import amp_cast
from ...framework import random as random_mod
from ...framework.tensor import Tensor
from ...kernels.flash_attention import flash_attention_bshd, supported
from ...ops._dispatch import apply, unwrap

__all__ = ["scaled_dot_product_attention"]

_NEG_INF = -1e30


def _sdpa_ref(q, k, v, mask=None, is_causal=False, scale=None,
              dropout_p=0.0, training=False):
    """Dense attention on ``[B, S, N, d]``: scores times ``scale`` (``1 /
    sqrt(d)``), KV heads repeated for MQA/GQA, a causal mask and a bool
    ``mask`` as -1e30 where False, a float ``mask`` added; the softmax in
    f32, cast to q's dtype; in training with ``dropout_p`` each
    probability kept with ``1 - dropout_p`` and divided by it."""
    s = 1.0 / q.shape[-1] ** 0.5 if scale is None else scale
    g = q.shape[2] // k.shape[2]
    if g > 1:
        k, v = k.repeat_interleave(g, 2), v.repeat_interleave(g, 2)
    logits = torch.einsum("bshd,bthd->bhst", q, k) * s
    if is_causal:
        sq, sk = logits.shape[-2:]
        keep = torch.ones(sq, sk, dtype=torch.bool,
                          device=q.device).tril(sk - sq)
        logits = logits.masked_fill(~keep, _NEG_INF)
    if mask is not None:
        if mask.dtype == torch.bool:
            logits = logits.masked_fill(~mask, _NEG_INF)
        else:
            logits = logits + mask.to(logits.dtype)
    probs = torch.softmax(logits.float(), -1).to(q.dtype)
    if dropout_p > 0.0 and training:
        u = torch.rand(probs.shape, device=probs.device,
                       generator=random_mod.generator(probs.device))
        probs = torch.where(u < 1.0 - dropout_p, probs / (1.0 - dropout_p),
                            torch.zeros((), dtype=probs.dtype,
                                        device=probs.device))
    return torch.einsum("bhst,bthd->bshd", probs, v)


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False, scale=None,
                                 training=True, name=None):
    """``[B, S, N, d]`` in and out (k/v ``[B, Sk, Nkv, d]``), facade
    Tensors or torch tensors (see the module docstring)."""
    facade = isinstance(query, Tensor)
    mask = unwrap(attn_mask)
    if mask is None and dropout_p == 0.0 and supported(
            tuple(query.shape), tuple(key.shape), tuple(value.shape),
            causal=is_causal):
        def flash(q, k, v):
            return flash_attention_bshd(q, k, v, causal=is_causal,
                                        scale=scale)
        if facade:
            return apply(flash, query, key, value, op_name="flash_attention")
        return flash(*amp_cast("flash_attention", query, key, value))

    def dense(q, k, v):
        return _sdpa_ref(q, k, v, mask, is_causal, scale, dropout_p,
                         training)
    if facade:
        return apply(dense, query, key, value,
                     op_name="scaled_dot_product_attention")
    return dense(*amp_cast("scaled_dot_product_attention", query, key,
                           value))
