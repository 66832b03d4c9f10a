"""BERT built from :mod:`paddle_tpu_torch.nn` (counterpart of
``paddle_tpu/models/bert.py``): ``BertModel`` (embeddings, a post-LN
``nn.TransformerEncoder``, the pooler), ``BertForPretraining`` (masked-LM
head tied to the word embeddings, and the next-sentence head) and the
pretraining criterion.

The layers and their structured names are the JAX model's, so a JAX
``state_dict()`` (as numpy arrays, bf16 too) loads with
``set_state_dict`` as it is. The MLM decoder is the word embedding's
``Parameter`` itself: one leaf, one gradient (the sum over both uses), one
update, one entry in ``state_dict`` (``bert.embeddings.word_embeddings.
weight``). Attention takes the JAX gate
(:func:`paddle_tpu_torch.nn.functional.scaled_dot_product_attention`): the
flash kernels where the attention dropout is 0, the dense form with its
dropout otherwise (BERT-base's published 0.1), in training and eval alike.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from .. import nn, ops
from ..framework.tape import apply
from .gpt import fused_mlm_cross_entropy

__all__ = ["BertConfig", "bert_tiny_config", "bert_base_config",
           "additive_attention_mask", "BertEmbeddings", "BertPooler",
           "BertModel", "BertPretrainingHeads", "BertForPretraining",
           "BertPretrainingCriterion"]


@dataclass
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    hidden_act: str = "gelu"
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    initializer_range: float = 0.02


def bert_tiny_config(**kw):
    base = dict(vocab_size=1024, hidden_size=64, num_hidden_layers=2,
                num_attention_heads=2, intermediate_size=128,
                max_position_embeddings=128, type_vocab_size=2,
                hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    base.update(kw)
    return BertConfig(**base)


def bert_base_config(**kw):
    return BertConfig(**kw)


@torch.no_grad()
def _init_weights(root: nn.Layer, std: float):
    """BERT's init: every Linear and Embedding weight normal(0, ``std``),
    the Linear biases 0, the LayerNorms as built (ones, zeros); written
    into the parameters' leaves."""
    init = nn.initializer.Normal(0.0, std)
    for m in root.sublayers(include_self=True):
        if isinstance(m, (nn.Linear, nn.Embedding)):
            w = m.weight._value
            w.copy_(init(list(w.shape), m.weight.dtype))
            if isinstance(m, nn.Linear) and m.bias is not None:
                m.bias._value.zero_()


def additive_attention_mask(attention_mask):
    """``[B, S]`` 1/0 padding mask → additive ``[B, 1, 1, S]`` (0 or -1e4,
    f32); a 3-D/4-D mask (e.g. a causal bool mask) passes through; None
    stays None."""
    if attention_mask is None:
        return None
    if len(attention_mask.shape) > 2:
        return attention_mask
    m = ops.unsqueeze(ops.unsqueeze(attention_mask, 1), 1)
    return (1.0 - ops.cast(m, "float32")) * -1e4


def _mlm_head_loss(cls_head, seq, masked_lm_labels):
    """The MLM head's transform, then the chunked cross entropy over the
    tied decoder weight and its bias (``-100`` labels ignored), as one op
    "fused_mlm_loss" (on neither ``auto_cast`` list)."""
    h = cls_head.layer_norm(cls_head.activation(cls_head.transform(seq)))
    return apply(fused_mlm_cross_entropy, h, cls_head.decoder_weight,
                 cls_head.decoder_bias, masked_lm_labels,
                 op_name="fused_mlm_loss")


def _damp_loss_spike(loss, threshold=15.0):
    """A loss above ``threshold`` compressed logarithmically (reads the
    loss on the host: an eager-only option)."""
    if float(loss) > threshold:
        return threshold + ops.log1p(loss - threshold)
    return loss


class BertEmbeddings(nn.Layer):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.word_embeddings = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embeddings = nn.Embedding(cfg.max_position_embeddings,
                                                cfg.hidden_size)
        self.token_type_embeddings = nn.Embedding(cfg.type_vocab_size,
                                                  cfg.hidden_size)
        self.layer_norm = nn.LayerNorm(cfg.hidden_size,
                                       epsilon=cfg.layer_norm_eps)
        self.dropout = nn.Dropout(cfg.hidden_dropout_prob)

    def forward(self, input_ids, token_type_ids=None):
        S = input_ids.shape[-1]
        pos = ops.arange(0, S, dtype="int64").to(input_ids.place)
        emb = self.word_embeddings(input_ids) + self.position_embeddings(pos)
        if token_type_ids is not None:
            emb = emb + self.token_type_embeddings(token_type_ids)
        return self.dropout(self.layer_norm(emb))


class BertPooler(nn.Layer):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.dense = nn.Linear(cfg.hidden_size, cfg.hidden_size)
        self.activation = nn.Tanh()

    def forward(self, hidden):
        return self.activation(self.dense(hidden[:, 0]))


class BertModel(nn.Layer):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.config = cfg
        self.embeddings = BertEmbeddings(cfg)
        enc_layer = nn.TransformerEncoderLayer(
            cfg.hidden_size, cfg.num_attention_heads, cfg.intermediate_size,
            dropout=cfg.hidden_dropout_prob, activation=cfg.hidden_act,
            attn_dropout=cfg.attention_probs_dropout_prob,
            act_dropout=0.0, normalize_before=False)
        self.encoder = nn.TransformerEncoder(enc_layer, cfg.num_hidden_layers)
        self.pooler = BertPooler(cfg)
        _init_weights(self, cfg.initializer_range)

    def encode(self, input_ids, token_type_ids=None, attention_mask=None):
        """The sequence output alone (no pooler): the MLM loss's input."""
        attention_mask = additive_attention_mask(attention_mask)
        h = self.embeddings(input_ids, token_type_ids)
        return self.encoder(h, src_mask=attention_mask)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None):
        h = self.encode(input_ids, token_type_ids, attention_mask)
        return h, self.pooler(h)


class BertPretrainingHeads(nn.Layer):
    def __init__(self, cfg: BertConfig, embedding_weights=None):
        super().__init__()
        self.transform = nn.Linear(cfg.hidden_size, cfg.hidden_size)
        self.activation = getattr(nn.functional, cfg.hidden_act)
        self.layer_norm = nn.LayerNorm(cfg.hidden_size,
                                       epsilon=cfg.layer_norm_eps)
        self.decoder_weight = embedding_weights  # tied to word embeddings
        self.decoder_bias = self.create_parameter([cfg.vocab_size],
                                                  is_bias=True)
        self.seq_relationship = nn.Linear(cfg.hidden_size, 2)

    def forward(self, sequence_output, pooled_output):
        h = self.layer_norm(self.activation(self.transform(sequence_output)))
        logits = ops.matmul(h, self.decoder_weight, transpose_y=True) \
            + self.decoder_bias
        return logits, self.seq_relationship(pooled_output)


class BertForPretraining(nn.Layer):
    def __init__(self, bert: BertModel):
        super().__init__()
        self.bert = bert
        self.cls = BertPretrainingHeads(
            bert.config, bert.embeddings.word_embeddings.weight)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None):
        seq, pooled = self.bert(input_ids, token_type_ids, attention_mask)
        return self.cls(seq, pooled)

    def forward_with_mlm_loss(self, input_ids, masked_lm_labels,
                              token_type_ids=None, attention_mask=None,
                              loss_spike_damping=False):
        """The mean MLM loss over the labels that are not ``-100``, without
        forming the ``[B, S, V]`` logits (the port's chunked cross
        entropy, ``gpt.fused_mlm_cross_entropy``) or the pooler.
        ``loss_spike_damping`` compresses a loss above 15 (reads the loss
        on the host)."""
        seq = self.bert.encode(input_ids, token_type_ids, attention_mask)
        loss = _mlm_head_loss(self.cls, seq, masked_lm_labels)
        if loss_spike_damping:
            loss = _damp_loss_spike(loss)
        return loss


class BertPretrainingCriterion(nn.Layer):
    """Masked-LM (``ignore_index=-100``) plus next-sentence loss."""

    def __init__(self, vocab_size):
        super().__init__()
        self.vocab_size = vocab_size
        self.ce = nn.CrossEntropyLoss(ignore_index=-100)

    def forward(self, prediction_scores, seq_relationship_score,
                masked_lm_labels, next_sentence_labels=None):
        mlm = self.ce(ops.reshape(prediction_scores, [-1, self.vocab_size]),
                      ops.reshape(masked_lm_labels, [-1]))
        if next_sentence_labels is None:
            return mlm
        nsp = self.ce(seq_relationship_score,
                      ops.reshape(next_sentence_labels, [-1]))
        return mlm + nsp
