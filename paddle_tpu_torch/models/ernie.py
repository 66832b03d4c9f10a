"""ERNIE-MoE model family (counterpart of ``paddle_tpu/models/ernie.py``):
a BERT-shaped post-LN encoder whose every ``moe_every``-th FFN is an
``MoELayer`` of GELU experts with the GShard gate, and an MLM head tied to
the word embedding.

Names and layouts are the JAX model's, so a JAX ``state_dict`` loads
through :func:`paddle_tpu_torch.models.convert.ernie_moe_state_dict_from_numpy`.
:func:`stack_ernie_moe_weights` gives the serving engine's ``(params,
kinds)`` layout and :class:`ErnieMoeGenerator` is its eager oracle.

Eval only: the MLM loss and the gates' aux loss wait for the MoE training
slice (ROADMAP.md, Queue 1, item 1); a forward in training mode raises.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from ..framework.random import make_generator
from ..incubate.distributed.models.moe import ExpertLayer, MoELayer
from ..nn import LayerNorm, Linear
from .bert import (BertConfig, BertEmbeddings, MultiHeadAttention,
                   TransformerEncoderLayer, additive_attention_mask)

__all__ = ["ErnieMoeConfig", "ernie_moe_tiny_config", "ernie_moe_base_config",
           "ErnieMoeModel", "ErnieMoeForPretraining", "ErnieMoeGenerator",
           "stack_ernie_moe_weights"]


@dataclass
class ErnieMoeConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    num_experts: int = 8
    top_k: int = 2
    moe_every: int = 2          # every 2nd layer's FFN is MoE (ERNIE/GShard)
    capacity_factor: float = None   # None = gate default (1.2/2.4)
    fused_dispatch: bool = False    # the fused CUDA dispatch/combine
    hidden_act: str = "gelu"
    hidden_dropout_prob: float = 0.0
    attention_probs_dropout_prob: float = 0.0
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    initializer_range: float = 0.02

    @property
    def head_dim(self):
        return self.hidden_size // self.num_attention_heads


def ernie_moe_tiny_config(**kw):
    base = dict(vocab_size=1024, hidden_size=64, num_hidden_layers=4,
                num_attention_heads=2, intermediate_size=128,
                num_experts=4, max_position_embeddings=128)
    base.update(kw)
    return ErnieMoeConfig(**base)


def ernie_moe_base_config(**kw):
    return ErnieMoeConfig(**kw)


class _MoeFfnBlock(nn.Module):
    """Post-LN encoder block with an MoE FFN: ``ln1(x + attn(x))``, then
    ``ln2(x + moe(x))``."""

    def __init__(self, cfg: ErnieMoeConfig, generator: torch.Generator):
        super().__init__()
        std, dev = cfg.initializer_range, generator.device
        self.attn = MultiHeadAttention(
            cfg.hidden_size, cfg.num_attention_heads,
            cfg.attention_probs_dropout_prob, generator=generator, std=std)
        self.ln1 = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps, device=dev)
        self.moe = MoELayer(
            cfg.hidden_size,
            [ExpertLayer(cfg.hidden_size, cfg.intermediate_size,
                         act=cfg.hidden_act, generator=generator, std=std)
             for _ in range(cfg.num_experts)],
            gate={"type": "gshard", "top_k": cfg.top_k},
            capacity_factor=cfg.capacity_factor,
            fused_dispatch=cfg.fused_dispatch, generator=generator, std=std)
        self.ln2 = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps, device=dev)

    def forward(self, x, src_mask=None):
        x = self.ln1(x + self.attn(x, x, x, attn_mask=src_mask))
        return self.ln2(x + self.moe(x))


class _DenseBlock(nn.Module):
    def __init__(self, cfg: ErnieMoeConfig, generator: torch.Generator):
        super().__init__()
        self.inner = TransformerEncoderLayer(
            cfg.hidden_size, cfg.num_attention_heads, cfg.intermediate_size,
            dropout=cfg.hidden_dropout_prob, activation=cfg.hidden_act,
            attn_dropout=cfg.attention_probs_dropout_prob, act_dropout=0.0,
            normalize_before=False, generator=generator,
            std=cfg.initializer_range)

    def forward(self, x, src_mask=None):
        return self.inner(x, src_mask=src_mask)


class ErnieMoeModel(nn.Module):
    """Embeddings and the dense/MoE encoder stack; returns hidden states
    ``[B, S, H]``. Parameters are made on ``device`` (CUDA unless ``"cpu"``
    is asked for) from a generator seeded with ``seed``: every ``Linear``
    and embedding weight normal(0, ``initializer_range``), biases 0,
    LayerNorms 1 and 0 (the JAX ``_init_weights``)."""

    def __init__(self, cfg: ErnieMoeConfig, *, seed: int = 0, device=None):
        super().__init__()
        self.config = cfg
        self.seed = int(seed)
        gen = make_generator(seed, resolve_device(device))
        bcfg = BertConfig(
            vocab_size=cfg.vocab_size, hidden_size=cfg.hidden_size,
            max_position_embeddings=cfg.max_position_embeddings,
            type_vocab_size=cfg.type_vocab_size,
            hidden_dropout_prob=cfg.hidden_dropout_prob,
            layer_norm_eps=cfg.layer_norm_eps,
            initializer_range=cfg.initializer_range)
        self.embeddings = BertEmbeddings(bcfg, generator=gen)
        self.layers = nn.ModuleList(
            _MoeFfnBlock(cfg, gen)
            if cfg.moe_every and (i + 1) % cfg.moe_every == 0
            else _DenseBlock(cfg, gen)
            for i in range(cfg.num_hidden_layers))

    def forward(self, input_ids, token_type_ids=None, attention_mask=None):
        attention_mask = additive_attention_mask(attention_mask)
        h = self.embeddings(input_ids, token_type_ids)
        for blk in self.layers:
            h = blk(h, src_mask=attention_mask)
        return h


class ErnieMoeForPretraining(nn.Module):
    """The MLM head over the MoE encoder, tied to the word embedding:
    ``forward`` returns the logits ``layer_norm(gelu(transform(h))) @
    wte^T + decoder_bias``. ``transform`` is drawn (Xavier normal, paddle's
    default) from a generator seeded with ``seed`` (the model's seed + 1
    when None)."""

    def __init__(self, model: ErnieMoeModel, *, seed=None):
        super().__init__()
        self.ernie = model
        cfg = model.config
        wte = model.embeddings.word_embeddings.weight
        gen = make_generator(model.seed + 1 if seed is None else seed,
                             wte.device)
        self.transform = Linear(cfg.hidden_size, cfg.hidden_size,
                                generator=gen)
        self.layer_norm = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps,
                                    device=wte.device)
        self.decoder_weight = wte
        self.decoder_bias = nn.Parameter(torch.zeros(cfg.vocab_size,
                                                     device=wte.device))

    @property
    def config(self):
        return self.ernie.config

    def forward(self, input_ids, token_type_ids=None, attention_mask=None):
        h = self.ernie(input_ids, token_type_ids, attention_mask)
        h = self.layer_norm(F.gelu(self.transform(h)))
        return h @ self.decoder_weight.t() + self.decoder_bias


# ---------------------------------------------------------------------------
# serving-side weight stacking + eager generation oracle
# ---------------------------------------------------------------------------

def stack_ernie_moe_weights(model):
    """The decode-side weights of an :class:`ErnieMoeForPretraining`
    (detached copies), as the JAX function lays them out: ``params =
    {"wte", "wpe", "eln_w", "eln_b", "layers": (dict, ...), "head": {...}}``
    and ``kinds``, a tuple of ``"dense" | "moe"``. Each layer dict holds the
    q/k/v/out projections and the two LayerNorms, then the dense FFN
    (``w1/b1/w2/b2``) or the MoE gate and stacked experts (``gate_w/gate_b/
    ew1/eb1/ew2/eb2``, the expert dim leading)."""
    if not isinstance(model, ErnieMoeForPretraining):
        raise TypeError("stack_ernie_moe_weights needs an "
                        "ErnieMoeForPretraining (the LM head is part "
                        "of the decode program)")
    ernie = model.ernie
    emb = ernie.embeddings
    v = lambda p: p.detach().clone()   # noqa: E731

    def attn_block(attn, ln1, ln2):
        return {
            "wq": v(attn.q_proj.weight), "bq": v(attn.q_proj.bias),
            "wk": v(attn.k_proj.weight), "bk": v(attn.k_proj.bias),
            "wv": v(attn.v_proj.weight), "bv": v(attn.v_proj.bias),
            "wo": v(attn.out_proj.weight), "bo": v(attn.out_proj.bias),
            "ln1_w": v(ln1.weight), "ln1_b": v(ln1.bias),
            "ln2_w": v(ln2.weight), "ln2_b": v(ln2.bias),
        }

    layers, kinds = [], []
    with torch.no_grad():
        for blk in ernie.layers:
            if isinstance(blk, _MoeFfnBlock):
                p = attn_block(blk.attn, blk.ln1, blk.ln2)
                moe = blk.moe
                p.update({
                    "gate_w": v(moe.gate.gate.weight),
                    "gate_b": v(moe.gate.gate.bias),
                    "ew1": torch.stack([v(e.htoh4.weight) for e in moe.experts]),
                    "eb1": torch.stack([v(e.htoh4.bias) for e in moe.experts]),
                    "ew2": torch.stack([v(e.h4toh.weight) for e in moe.experts]),
                    "eb2": torch.stack([v(e.h4toh.bias) for e in moe.experts]),
                })
                kinds.append("moe")
            else:
                inner = blk.inner
                p = attn_block(inner.self_attn, inner.norm1, inner.norm2)
                p.update({
                    "w1": v(inner.linear1.weight), "b1": v(inner.linear1.bias),
                    "w2": v(inner.linear2.weight), "b2": v(inner.linear2.bias),
                })
                kinds.append("dense")
            layers.append(p)
        params = {
            "wte": v(emb.word_embeddings.weight),
            "wpe": v(emb.position_embeddings.weight),
            "eln_w": v(emb.layer_norm.weight),
            "eln_b": v(emb.layer_norm.bias),
            "layers": tuple(layers),
            "head": {
                "tw": v(model.transform.weight), "tb": v(model.transform.bias),
                "ln_w": v(model.layer_norm.weight),
                "ln_b": v(model.layer_norm.bias),
                "dw": v(model.decoder_weight), "db": v(model.decoder_bias),
            },
        }
    return params, tuple(kinds)


class ErnieMoeGenerator:
    """Eager greedy generation over :class:`ErnieMoeForPretraining` run as a
    causal decoder: each step re-runs the whole forward under a
    lower-triangular bool mask and takes the argmax of the last position's
    logits. No KV cache: the token-for-token oracle of
    :class:`paddle_tpu_torch.serving.moe_engine.MoEServingEngine`.

    Incremental decode routes each token through the experts once, full
    recompute routes the whole prefix every step: the two agree only when no
    token is capacity-dropped, so build the model with a no-drop
    ``capacity_factor`` (the engine sizes capacity at the token count)."""

    def __init__(self, model: ErnieMoeForPretraining):
        self.model = model
        self.cfg = model.ernie.config

    def __call__(self, input_ids, max_new_tokens=16):
        was_training = self.model.training
        self.model.eval()
        dev = self.model.decoder_weight.device
        try:
            ids = torch.as_tensor(np.asarray(input_ids, dtype=np.int64),
                                  device=dev)
            if ids.dim() == 1:
                ids = ids[None, :]
            with torch.no_grad():
                for _ in range(int(max_new_tokens)):
                    S = ids.shape[1]
                    causal = torch.ones(S, S, dtype=torch.bool,
                                        device=dev).tril()[None, None]
                    logits = self.model(ids, attention_mask=causal)
                    nxt = torch.argmax(logits[:, -1], -1)
                    ids = torch.cat([ids, nxt[:, None]], 1)
            return ids[:, -int(max_new_tokens):].cpu().numpy()
        finally:
            if was_training:
                self.model.train()
