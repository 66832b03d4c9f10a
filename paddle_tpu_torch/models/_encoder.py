"""The torch-level encoder pieces ERNIE-MoE is built from (counterparts
of ``paddle_tpu/models/bert.py``'s embeddings and of the encoder layers of
``paddle_tpu/nn/layer/transformer.py``), as ``torch.nn.Module``s.

Only what ERNIE needs: :class:`BertEmbeddings` (word + position, plus token
type only when ids are given, then LayerNorm),
:func:`additive_attention_mask`, and the post-LN
:class:`TransformerEncoderLayer` with its :class:`MultiHeadAttention`, in
paddle's ``[in, out]`` weight layout. Attention is
:func:`paddle_tpu_torch.nn.functional.scaled_dot_product_attention`, as in
the JAX layer: the flash kernel without a mask, the dense ``_sdpa_ref``
with one (the eager generator's causal bool mask, a padding mask).
Dropout is not ported here (every ERNIE-MoE config has it at 0). The
paddle-level BERT, built from :mod:`paddle_tpu_torch.nn`, is
:mod:`paddle_tpu_torch.models.bert`.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..nn._torch_layers import LayerNorm, Linear
from ..nn.functional import scaled_dot_product_attention
from .bert import BertConfig

__all__ = ["BertEmbeddings", "MultiHeadAttention", "TransformerEncoderLayer",
           "additive_attention_mask"]


def _no_dropout(p, what):
    if p:
        raise NotImplementedError(f"{what} dropout {p} is not ported (the "
                                  f"ERNIE-MoE configs have none)")


def additive_attention_mask(attention_mask):
    """``[B, S]`` 1/0 padding mask → additive ``[B, 1, 1, S]`` (0 or -1e4,
    f32); a 3-D/4-D mask (e.g. a causal bool mask) passes through; None
    stays None."""
    if attention_mask is None or attention_mask.dim() > 2:
        return attention_mask
    m = attention_mask[:, None, None, :].float()
    return (1.0 - m) * -1e4


class _Embedding(nn.Module):
    """A ``[num, dim]`` table, normal(0, ``std``) from ``generator``."""

    def __init__(self, num, dim, *, generator, std):
        super().__init__()
        w = torch.empty(num, dim, device=generator.device)
        w.normal_(0.0, std, generator=generator)
        self.weight = nn.Parameter(w)

    def forward(self, ids):
        return self.weight[ids.long()]


class BertEmbeddings(nn.Module):
    def __init__(self, cfg: BertConfig, *, generator: torch.Generator):
        super().__init__()
        _no_dropout(cfg.hidden_dropout_prob, "hidden")
        std = cfg.initializer_range
        self.word_embeddings = _Embedding(cfg.vocab_size, cfg.hidden_size,
                                          generator=generator, std=std)
        self.position_embeddings = _Embedding(
            cfg.max_position_embeddings, cfg.hidden_size,
            generator=generator, std=std)
        self.token_type_embeddings = _Embedding(
            cfg.type_vocab_size, cfg.hidden_size, generator=generator,
            std=std)
        self.layer_norm = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps,
                                    device=generator.device)

    def forward(self, input_ids, token_type_ids=None):
        S = input_ids.shape[-1]
        pos = torch.arange(S, device=input_ids.device)
        emb = self.word_embeddings(input_ids) + self.position_embeddings(pos)
        if token_type_ids is not None:
            emb = emb + self.token_type_embeddings(token_type_ids)
        return self.layer_norm(emb)


class MultiHeadAttention(nn.Module):
    """Self-attention with paddle's q/k/v/out ``Linear``s ``[in, out]``;
    ``attn_mask`` broadcasts to ``[B, H, Sq, Sk]``."""

    def __init__(self, embed_dim, num_heads, dropout=0.0, *,
                 generator: torch.Generator, std=None):
        super().__init__()
        _no_dropout(dropout, "attention")
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        kw = dict(generator=generator, std=std)
        self.q_proj = Linear(embed_dim, embed_dim, **kw)
        self.k_proj = Linear(embed_dim, embed_dim, **kw)
        self.v_proj = Linear(embed_dim, embed_dim, **kw)
        self.out_proj = Linear(embed_dim, embed_dim, **kw)

    def forward(self, query, key=None, value=None, attn_mask=None):
        key = query if key is None else key
        value = key if value is None else value
        b, s = query.shape[:2]
        split = lambda t: t.reshape(t.shape[0], t.shape[1], self.num_heads,
                                    self.head_dim)
        out = scaled_dot_product_attention(
            split(self.q_proj(query)), split(self.k_proj(key)),
            split(self.v_proj(value)), attn_mask, training=self.training)
        return self.out_proj(out.reshape(b, s, self.embed_dim))


class TransformerEncoderLayer(nn.Module):
    """Post-LN encoder layer: ``norm1(x + attn(x))``, then ``norm2(x +
    linear2(gelu(linear1(x))))``; the norms keep paddle's default eps
    (1e-5), as the JAX layer does."""

    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="gelu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, *, generator: torch.Generator,
                 std=None):
        super().__init__()
        if activation != "gelu" or normalize_before:
            raise NotImplementedError("only the post-LN gelu encoder layer "
                                      "is ported")
        _no_dropout(dropout, "hidden")
        _no_dropout(act_dropout, "activation")
        kw = dict(generator=generator, std=std)
        self.self_attn = MultiHeadAttention(
            d_model, nhead, dropout if attn_dropout is None else attn_dropout,
            **kw)
        self.linear1 = Linear(d_model, dim_feedforward, **kw)
        self.linear2 = Linear(dim_feedforward, d_model, **kw)
        dev = generator.device
        self.norm1 = LayerNorm(d_model, device=dev)
        self.norm2 = LayerNorm(d_model, device=dev)

    def forward(self, src, src_mask=None):
        src = self.norm1(src + self.self_attn(src, src, src, src_mask))
        return self.norm2(src + self.linear2(F.gelu(self.linear1(src))))
