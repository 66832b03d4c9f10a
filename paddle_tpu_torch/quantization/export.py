"""Weight-only int8 for the serving engine's stacked GPT weights
(counterpart of ``paddle_tpu/quantization/export.py``, its stacked-weight
part: ``quantize_stacked_gpt_weights`` and ``dequantize_stacked_weight``).

Scales are per OUTPUT channel: the reduced axes are the contraction axes
of each decode matmul, so the scale multiplies the matmul's result
(``y = (x @ q) * s``) and the int8 weight feeds the product directly.
The leading axis is the stacked layer axis and is never reduced, so every
layer quantizes on its own. ``wte``/``wpe`` reduce their hidden axis: one
scale per row serves both the embedding gather and the logits product.

The quantization runs on the host in f32, with the JAX package's
operations, so the int8 values and scales are bit-equal to its; the leaves
then move to the weights' device.
"""
from __future__ import annotations

import torch

__all__ = ["quantize_stacked_gpt_weights", "dequantize_stacked_weight",
           "is_quantized"]

_STACKED_REDUCE_AXES = {
    "wqkv": (1,),      # [L, H, 3, nh, d] -> s [L, 3, nh, d]
    "wo":   (1, 2),    # [L, nh, d, H]    -> s [L, H]
    "w1":   (1,),      # [L, H, F]        -> s [L, F]
    "w2":   (1,),      # [L, F, H]        -> s [L, H]
}
_EMB_KEYS = ("wte", "wpe")   # [rows, H] -> s [rows]


def is_quantized(w) -> bool:
    """A weight-only-int8 leaf: ``{"q": int8, "s": float32}``."""
    return isinstance(w, dict) and "q" in w


def _quantize_channelwise(w, axes, bits=8):
    """``w`` (f32, on the host) to int8 with one scale per kept index: the
    JAX package's numpy steps as torch operations, which round the same
    (IEEE f32 division, round half to even), so the int8 values and the
    scales are bit-equal to its."""
    qmax = float(2 ** (bits - 1) - 1)
    scale = w.abs().amax(dim=axes, keepdim=True) / qmax
    scale = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = torch.clamp(torch.round(w / scale), -qmax - 1, qmax).to(torch.int8)
    return q, scale.squeeze(axes)


def _leaf(w, axes, bits):
    q, s = _quantize_channelwise(w.detach().float().cpu(), axes, bits)
    return {"q": q.to(w.device), "s": s.to(w.device)}


def quantize_stacked_gpt_weights(params, bits=8):
    """Quantize a :func:`~paddle_tpu_torch.models.gpt.stack_gpt_weights`
    dict to weight-only int8 with per-channel scales: ``wqkv``/``wo``/
    ``w1``/``w2`` of every stacked layer, and ``wte``/``wpe``, become
    ``{"q": int8, "s": float32}`` on the weights' device; biases and the
    layer norms stay float."""
    out = {"blocks": {}}
    for k, v in params["blocks"].items():
        axes = _STACKED_REDUCE_AXES.get(k)
        out["blocks"][k] = v if axes is None else _leaf(v, axes, bits)
    for k, v in params.items():
        if k == "blocks":
            continue
        out[k] = _leaf(v, (1,), bits) if k in _EMB_KEYS else v
    return out


def dequantize_stacked_weight(w, dtype=None):
    """One quantized stacked leaf back to float (f32 unless ``dtype``); a
    float leaf passes through. The reduced axes follow axis 0, so the
    scale broadcasts as ``s.shape[:1] + (1,) * n_reduced + s.shape[1:]``."""
    if not is_quantized(w):
        return w if dtype is None else w.to(dtype)
    q, s = w["q"], w["s"]
    n_reduced = q.dim() - s.dim()
    bshape = tuple(s.shape[:1]) + (1,) * n_reduced + tuple(s.shape[1:])
    out = q.float() * s.reshape(bshape)
    return out if dtype is None else out.to(dtype)
