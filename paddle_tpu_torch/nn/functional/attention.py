"""Attention functional (counterpart of
``paddle_tpu/nn/functional/attention.py``).

:func:`scaled_dot_product_attention` takes the JAX package's gate: with no
mask and no dropout, and shapes the flash kernel takes
(:func:`paddle_tpu_torch.kernels.flash_attention.supported`: S >= 64,
d <= 128), attention is the FlashAttention kernel (forward, dQ and dK/dV
on CUDA; their plain versions for CPU tensors); otherwise it is the dense
:func:`_sdpa_ref`. Under ``auto_cast`` the inputs cast as the JAX ops
"flash_attention" and "scaled_dot_product_attention" cast them (both on
the white list).
"""
from __future__ import annotations

import torch

from ...amp import amp_cast
from ...kernels.flash_attention import flash_attention_bshd, supported

__all__ = ["scaled_dot_product_attention"]

_NEG_INF = -1e30


def _sdpa_ref(q, k, v, mask=None, is_causal=False, scale=None):
    """Dense attention on ``[B, S, N, d]`` (the JAX ``_sdpa_ref`` without
    dropout): scores times ``scale`` (``1 / sqrt(d)``), KV heads repeated
    for MQA/GQA, a causal mask and a bool ``mask`` as -1e30 where False, a
    float ``mask`` added; the softmax in f32, cast to q's dtype."""
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
    return torch.einsum("bhst,bthd->bshd", probs, v)


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False, scale=None,
                                 training=True, name=None):
    """``[B, S, N, d]`` in and out (k/v ``[B, Sk, Nkv, d]``). Dropout is not
    ported: ``dropout_p > 0`` in training raises."""
    if dropout_p > 0.0 and training:
        raise NotImplementedError(f"attention dropout {dropout_p} is not "
                                  f"ported (the ported configs have none)")
    if attn_mask is None and dropout_p == 0.0 and supported(
            query.shape, key.shape, value.shape, causal=is_causal):
        q, k, v = amp_cast("flash_attention", query, key, value)
        return flash_attention_bshd(q, k, v, causal=is_causal, scale=scale)
    q, k, v = amp_cast("scaled_dot_product_attention", query, key, value)
    return _sdpa_ref(q, k, v, attn_mask, is_causal, scale)
