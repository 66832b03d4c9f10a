"""GPT decoder language-model family (counterpart of ``paddle_tpu/models/gpt.py``).

One functional decoder block, :func:`gpt_block`, is the math of every path:
the ``nn.Module`` layers call it, the serving engine calls it for prefill,
and :class:`GPTHybridTrainStep` calls it for training. It copies the JAX
block's numerics: a hand-written layer norm in the input dtype
(:func:`_ln`), tanh GELU, dense attention that divides by sqrt(d) in the
compute dtype, masks with -1e30 and takes the softmax in f32; with
``use_flash`` the attention core is the FlashAttention kernel.

Parameter names, shapes and layouts are the JAX model's
(``wqkv [H, 3, nh, d]``, ``wo [nh, d, H]``, ...), so a JAX ``state_dict``
loads through :func:`paddle_tpu_torch.models.convert.gpt_state_dict_from_numpy`.
The LM head is tied to the word embedding.
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..device import resolve_device
from ..framework.graphs import (StagedInputs, add_counts, capturing_on,
                               counted, eager_step, no_gc, pool_bytes,
                               sync_is_error)
from ..framework.random import make_generator
from ..kernels._build import MAX_HEAD_DIM
from ..kernels.flash_attention import flash_attention_bshd

__all__ = [
    "GPTConfig", "GPTDecoderLayer", "GPTEmbeddings", "GPTModel",
    "GPTForPretraining", "GPTPretrainingCriterion", "GPTHybridTrainStep",
    "stack_gpt_weights", "sample_logits", "flash_attention_gate", "gpt_block",
    "gpt_stacked_param_shapes", "model_flops_per_token",
    "parallel_cross_entropy", "vocab_parallel_cross_entropy",
    "fused_mlm_cross_entropy",
    "gpt_tiny_config", "gpt_345m_config", "gpt_1p3b_config", "gpt_13b_config",
]


@dataclass
class GPTConfig:
    vocab_size: int = 50304
    hidden_size: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    intermediate_size: int = 0  # 0 -> 4*hidden
    max_position_embeddings: int = 1024
    layer_norm_epsilon: float = 1e-5
    initializer_range: float = 0.02

    def __post_init__(self):
        if self.intermediate_size == 0:
            self.intermediate_size = 4 * self.hidden_size
        if self.hidden_size % self.num_heads:
            raise ValueError(f"hidden_size {self.hidden_size} is not a "
                             f"multiple of num_heads {self.num_heads}")

    @property
    def head_dim(self):
        return self.hidden_size // self.num_heads


def _cfg(defaults, kw):
    return GPTConfig(**{**defaults, **kw})


def gpt_tiny_config(**kw):
    return _cfg(dict(vocab_size=256, hidden_size=64, num_layers=4,
                     num_heads=4, max_position_embeddings=128), kw)


def gpt_345m_config(**kw):
    # 16 heads (d_head=64) is Megatron's GPT-345M; num_heads=8 gives
    # d_head=128, the configuration the serving benchmark runs
    return _cfg(dict(hidden_size=1024, num_layers=24, num_heads=16), kw)


def gpt_1p3b_config(**kw):
    return _cfg(dict(hidden_size=2048, num_layers=24, num_heads=16,
                     max_position_embeddings=2048), kw)


def gpt_13b_config(**kw):
    return _cfg(dict(hidden_size=5120, num_layers=40, num_heads=40,
                     max_position_embeddings=2048), kw)


def model_flops_per_token(cfg, seq_len):
    """Standard 6N + attention estimate (FLOPs/token, fwd+bwd).

    N counts the matmul params: qkv (3H^2) + out (H^2) + mlp (2*H*F) per
    layer plus the (tied) head V*H and position table. Returns
    ``(flops_per_token, n_params)``."""
    H, L, V = cfg.hidden_size, cfg.num_layers, cfg.vocab_size
    per_layer = 4 * H * H + 2 * H * cfg.intermediate_size
    n_params = V * H + cfg.max_position_embeddings * H + L * per_layer
    matmul_flops = 6 * n_params  # fwd 2N + bwd 4N
    attn_flops = 12 * L * H * seq_len  # qk^T + av, fwd+bwd
    return matmul_flops + attn_flops, n_params


# ---------------------------------------------------------------------------
# the functional decoder block
# ---------------------------------------------------------------------------

_BLOCK_KEYS = ("ln1_w", "ln1_b", "wqkv", "bqkv", "wo", "bo",
               "ln2_w", "ln2_b", "w1", "b1", "w2", "b2")


def block_shapes(config: GPTConfig) -> dict:
    """Shape of every decoder-block parameter, by name."""
    H, nh, d, Fm = (config.hidden_size, config.num_heads, config.head_dim,
                    config.intermediate_size)
    return {"ln1_w": (H,), "ln1_b": (H,), "wqkv": (H, 3, nh, d),
            "bqkv": (3, nh, d), "wo": (nh, d, H), "bo": (H,),
            "ln2_w": (H,), "ln2_b": (H,), "w1": (H, Fm), "b1": (Fm,),
            "w2": (Fm, H), "b2": (H,)}


def _ln(x, w, b, eps):
    # by hand in x's dtype, as the JAX block does: F.layer_norm computes
    # in f32 internally and rounds bf16 differently
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).square().mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * w + b


def gpt_block(p, x, eps, use_flash=False, return_kv=False):
    """One pre-LN decoder block on ``x [B, S, H]``; ``p`` maps the
    ``_BLOCK_KEYS`` to tensors in the JAX layouts. With ``return_kv`` also
    returns this block's K and V ``[B, S, nh, d]`` (the prefill cache)."""
    B, S, H = x.shape
    _, _, nh, d = p["wqkv"].shape
    h = _ln(x, p["ln1_w"], p["ln1_b"], eps)
    qkv = (h @ p["wqkv"].reshape(H, 3 * nh * d)).reshape(B, S, 3, nh, d) \
        + p["bqkv"]
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]   # [B,S,nh,d] views
    if use_flash:
        attn = flash_attention_bshd(q, k, v, causal=True)
    else:
        logits = torch.einsum("bsnd,btnd->bnst", q, k) / math.sqrt(d)
        causal = torch.ones(S, S, dtype=torch.bool, device=x.device).tril()
        logits = logits.masked_fill(~causal, -1e30)
        probs = torch.softmax(logits.float(), -1).to(x.dtype)
        attn = torch.einsum("bnst,btnd->bsnd", probs, v)
    o = attn.reshape(B, S, nh * d) @ p["wo"].reshape(nh * d, H)
    x = x + o + p["bo"]
    h = _ln(x, p["ln2_w"], p["ln2_b"], eps)
    u = F.gelu(h @ p["w1"] + p["b1"], approximate="tanh")
    out = x + u @ p["w2"] + p["b2"]
    if return_kv:
        return out, k, v
    return out


def flash_attention_gate(S, head_dim, use_flash=None, device=None):
    """ONE flash-attention gate for the GPT paths. ``use_flash=None``
    approves the kernel on CUDA for every S >= 64 and keeps the plain path
    on the CPU (the JAX gate's TPU threshold of S >= 512 was measured on a
    v5e and does not carry over). ``use_flash=True`` forces it wherever
    the shape allows (on the CPU the flash wrapper then runs its plain
    version). On both devices the head dim must be ``0 < d <= 128``, the
    JAX gate's rule."""
    on_cuda = device is not None and torch.device(device).type == "cuda"
    if use_flash is None:
        use_flash = on_cuda
    return bool(use_flash) and S >= 64 and 0 < head_dim <= MAX_HEAD_DIM


# ---------------------------------------------------------------------------
# the LM-head loss
# ---------------------------------------------------------------------------

_CE_CHUNK = 2048  # tokens per chunk of the chunked path


def parallel_cross_entropy(logits, labels, ignore_index=-100, mp_axis=None):
    """Per-token softmax cross entropy over the class dim, in f32 (a copy
    of ``paddle_tpu/distributed/fleet/mpu.py`` ``parallel_cross_entropy``
    for one vocab shard; the port's ``mpu`` module is not ported yet).

    The port holds the whole vocabulary on one device, so an ``mp_axis``
    has size 1: its pmax/psum are the identity and the result does not
    depend on it. ``labels`` are class ids, ``[...]`` or ``[..., 1]``."""
    lg = logits.float()
    if labels.dim() == lg.dim() and labels.shape[-1] == 1:
        labels = labels[..., 0]
    labels = labels.long()
    v_local = lg.shape[-1]
    m = lg.detach().amax(-1)            # stop_gradient, as in JAX
    sumexp = torch.exp(lg - m[..., None]).sum(-1)
    lse = torch.log(sumexp) + m
    in_range = (labels >= 0) & (labels < v_local)
    picked = lg.gather(-1, labels.clamp(0, v_local - 1)[..., None])[..., 0]
    tgt = torch.where(in_range, picked, 0.0)
    loss = lse - tgt
    if ignore_index is not None:
        loss = torch.where(labels == ignore_index, 0.0, loss)
    return loss


def vocab_parallel_cross_entropy(h, wte_local, labels, mp_axis=None,
                                 loss_mask=None, bias=None):
    """LM head + softmax cross entropy, the mean over (masked) tokens.

    ``h [B, S, H]``, ``wte_local [V, H]``, ``labels [B, S]``. Two branches,
    as in JAX: without ``mp_axis``, with more than ``_CE_CHUNK`` tokens and
    V >= 16384, the tokens go through in chunks of 2048 (padded with mask-0
    tokens), each under its own checkpoint, so the ``[tokens, V]`` f32
    logits never exist whole. Otherwise the full logits are formed (the
    head's product in the input dtype, then cast to f32) and go through
    :func:`parallel_cross_entropy`: the path of the train step, which
    passes ``mp_axis="mp"``."""
    B, S, _ = h.shape
    N = B * S
    if mp_axis is None and N > _CE_CHUNK and wte_local.shape[0] >= 16384:
        v_total = wte_local.shape[0]
        hf = h.reshape(N, -1)
        lf = labels.reshape(N).long()
        mf = loss_mask.reshape(N).float() if loss_mask is not None \
            else torch.ones(N, dtype=torch.float32, device=h.device)
        pad = (-N) % _CE_CHUNK
        if pad:
            hf = torch.cat([hf, hf.new_zeros(pad, hf.shape[1])])
            lf = torch.cat([lf, lf.new_zeros(pad)])
            mf = torch.cat([mf, mf.new_zeros(pad)])

        def per_chunk(hc, lc, mc):
            lg = (hc @ wte_local.t()).float()
            if bias is not None:
                lg = lg + bias.float()
            mx = lg.detach().amax(-1)
            lse = torch.log(torch.exp(lg - mx[:, None]).sum(-1)) + mx
            # out-of-range ids (e.g. -1 padding) contribute tgt = 0
            in_r = (lc >= 0) & (lc < v_total)
            safe = lc.clamp(0, v_total - 1)
            tgt = torch.where(in_r, lg.gather(-1, safe[:, None])[:, 0], 0.0)
            return ((lse - tgt) * mc).sum(), mc.sum()

        sums, counts = zip(*(
            checkpoint(per_chunk, hf[i:i + _CE_CHUNK], lf[i:i + _CE_CHUNK],
                       mf[i:i + _CE_CHUNK], use_reentrant=False)
            for i in range(0, N + pad, _CE_CHUNK)))
        return torch.stack(sums).sum() / torch.stack(counts).sum().clamp_min(
            1.0)

    logits = (h @ wte_local.t()).float()
    if bias is not None:
        logits = logits + bias.float()
    loss = parallel_cross_entropy(logits, labels, ignore_index=None,
                                  mp_axis=mp_axis)
    if loss_mask is not None:
        loss_mask = loss_mask.to(loss.dtype)
        return (loss * loss_mask).sum() / loss_mask.sum().clamp_min(1.0)
    return loss.mean()


def fused_mlm_cross_entropy(h, weight, bias, labels):
    """The encoders' MLM head + cross entropy (BERT/ERNIE): ``h [B, S, H]``
    the transformed hidden state, ``weight [V, H]`` the tied embedding,
    ``bias [V]``, ``labels [B, S]`` with ``-100`` ignored through the loss
    mask (those labels become -1, whose target term the cross entropy
    zeroes). Over :func:`vocab_parallel_cross_entropy`, so more than 2048
    tokens at V >= 16384 go through in checkpointed chunks. Paddle's
    "fused_mlm_loss" is on neither ``auto_cast`` list: it runs in h's
    dtype."""
    labels = labels.long()
    ignore = labels == -100
    return vocab_parallel_cross_entropy(
        h, weight.to(h.dtype), torch.where(ignore, -1, labels),
        loss_mask=(~ignore).float(), bias=bias)


# ---------------------------------------------------------------------------
# nn.Module path
# ---------------------------------------------------------------------------

def _normal(shape, std, gen, dev):
    t = torch.empty(shape, device=dev)
    t.normal_(0.0, std, generator=gen)
    return nn.Parameter(t)


class GPTDecoderLayer(nn.Module):
    """One decoder block; parameters in the JAX layouts and names, drawn
    from ``generator`` with the JAX init scheme (normal(0, 0.02), scaled
    residual projections, LN weights 1, biases 0)."""

    def __init__(self, config: GPTConfig, generator: torch.Generator):
        super().__init__()
        self.config = config
        dev = generator.device
        std = config.initializer_range
        res_std = std / math.sqrt(2.0 * config.num_layers)
        init = {"wqkv": std, "wo": res_std, "w1": std, "w2": res_std}
        for name, shape in block_shapes(config).items():
            if name in init:
                param = _normal(shape, init[name], generator, dev)
            elif name.endswith("_w"):
                param = nn.Parameter(torch.ones(shape, device=dev))
            else:
                param = nn.Parameter(torch.zeros(shape, device=dev))
            setattr(self, name, param)

    def forward(self, x):
        return gpt_block({k: getattr(self, k) for k in _BLOCK_KEYS}, x,
                         self.config.layer_norm_epsilon)


class GPTEmbeddings(nn.Module):
    """Tied word embedding + learned positions."""

    def __init__(self, config: GPTConfig, generator: torch.Generator):
        super().__init__()
        std, dev = config.initializer_range, generator.device
        self.word_embeddings = _normal(
            (config.vocab_size, config.hidden_size), std, generator, dev)
        self.position_embeddings = _normal(
            (config.max_position_embeddings, config.hidden_size), std,
            generator, dev)

    def forward(self, input_ids, position_ids=None):
        if position_ids is None:
            position_ids = torch.arange(input_ids.shape[-1],
                                        device=input_ids.device)
        return (self.word_embeddings[input_ids.long()]
                + self.position_embeddings[position_ids.long()])


class GPTModel(nn.Module):
    """Decoder stack -> final LayerNorm; returns hidden states [B,S,H].
    Parameters are made on ``device`` (CUDA unless ``"cpu"`` is asked for)
    from a generator seeded with ``seed``."""

    def __init__(self, config: GPTConfig, *, seed: int = 0, device=None):
        super().__init__()
        self.config = config
        gen = make_generator(seed, resolve_device(device))
        self.embeddings = GPTEmbeddings(config, gen)
        self.layers = nn.ModuleList(
            [GPTDecoderLayer(config, gen) for _ in range(config.num_layers)])
        self.lnf_w = nn.Parameter(torch.ones(config.hidden_size,
                                             device=gen.device))
        self.lnf_b = nn.Parameter(torch.zeros(config.hidden_size,
                                              device=gen.device))

    def forward(self, input_ids, position_ids=None):
        x = self.embeddings(input_ids, position_ids)
        for layer in self.layers:
            x = layer(x)
        return _ln(x, self.lnf_w, self.lnf_b, self.config.layer_norm_epsilon)


class GPTForPretraining(nn.Module):
    """LM head tied to the word embedding; ``forward`` returns logits."""

    def __init__(self, gpt: GPTModel):
        super().__init__()
        self.gpt = gpt

    @property
    def config(self):
        return self.gpt.config

    def forward(self, input_ids, position_ids=None):
        h = self.gpt(input_ids, position_ids)
        return h @ self.gpt.embeddings.word_embeddings.t()


class GPTPretrainingCriterion(nn.Module):
    """Masked token-mean cross entropy over logits, in f32."""

    def forward(self, prediction_scores, masked_lm_labels, loss_mask=None):
        lg = prediction_scores.float()
        lse = torch.logsumexp(lg, -1)
        tgt = lg.gather(-1, masked_lm_labels.long()[..., None])[..., 0]
        loss = lse - tgt
        if loss_mask is not None:
            loss_mask = loss_mask.to(loss.dtype)
            return (loss * loss_mask).sum() / loss_mask.sum().clamp_min(1.0)
        return loss.mean()


# ---------------------------------------------------------------------------
# the pretraining step (one device: dp = mp = pp = 1)
# ---------------------------------------------------------------------------

def gpt_stacked_param_shapes(config: GPTConfig):
    """Shapes of the train step's stacked parameter tree."""
    H, L, V = config.hidden_size, config.num_layers, config.vocab_size
    return {
        "blocks": {k: (L,) + shape
                   for k, shape in block_shapes(config).items()},
        "wte": (V, H),
        "wpe": (config.max_position_embeddings, H),
        "lnf_w": (H,), "lnf_b": (H,),
    }


# the products ``remat="dots"`` keeps: 2-D weight products, what
# jax.checkpoint_policies.dots_with_no_batch_dims_saveable keeps. Batched
# attention products (bmm) and the flash kernel are recomputed.
_DOTS_SAVED = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)
# where the options GPTHybridTrainStep does not take yet are queued, by the
# items' titles
_HYBRID_ITEM = "ROADMAP.md Queue 1, 'Hybrid parallel'"
_ANALYSIS_ITEM = ("ROADMAP.md Queue 1, 'Analysis, planner and auto-fusion "
                  "over torch.fx graphs'")


def _dots_policy(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS_SAVED
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _dots_context():
    return create_selective_checkpoint_contexts(_dots_policy)


def _tree_items(tree, prefix=()):
    """``(path, leaf)`` pairs of a nested dict, in insertion order."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _tree_items(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _tree_map(fn, tree):
    """The nested dict ``tree`` with ``fn`` applied to every leaf."""
    return {k: _tree_map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def _as_dtype(name):
    return None if name is None else getattr(torch, str(name))


# the training steps' eager switch (framework.graphs.eager_step): the
# yardstick chip_smoke.py and the card tests hold the captured step against
_eager_step = eager_step


class _TrainGraph:
    """One batch shape's captured step: the graph, its staged inputs, its
    loss (overwritten by every replay) and the launches a replay stands
    for."""

    def __init__(self, graph, inputs, loss, counts):
        self.graph, self.inputs = graph, inputs
        self.loss, self.counts = loss, counts


class GPTHybridTrainStep:
    """One GPT pretraining step on one device (counterpart of the JAX
    ``GPTHybridTrainStep`` at dp = mp = pp = 1).

    The per-layer parameters of ``model`` (a ``GPTForPretraining`` or
    ``GPTModel``) are stacked into ``[L, ...]`` masters on the model's
    device, with AdamW moments beside them. A call runs the forward (the
    embedding, the blocks in a layer loop, the tied LM head and the
    full-logits vocab cross entropy, averaged over ``n_micro``
    micro-batches), the backward by autograd, and the AdamW update written
    out as the JAX step writes it: global-norm clipping, bias correction,
    decoupled decay on the matmul weights and embeddings, the update in
    f32 stored back to ``param_dtype``/``moment_dtype``.

    ``compute_dtype`` casts the blocks and embeddings for the forward (the
    masters stay in their own dtype); the final layer norm's weights are
    not cast, so the head's layer norm runs in f32 and is cast to the
    embedding's dtype, as in JAX. ``remat``: False keeps every activation;
    True checkpoints each block; ``"dots"`` keeps only the outputs of the
    2-D weight products and recomputes the rest of each block.
    ``use_flash=None`` asks :func:`flash_attention_gate`. ``lr`` is a
    float or a callable (an :class:`paddle_tpu_torch.optimizer.lr.
    LRScheduler`), read and then stepped once a call; the update takes it
    and the step count as 0-d f32 device tensors, as the JAX step takes
    its traced ``lr`` and ``t``.

    On CUDA the step is the counterpart of the JAX step's single jit: the
    first call with a ``[B, S]`` shape runs the step eagerly on a side
    stream and then captures forward, backward, clipping and AdamW as one
    CUDA graph; later calls of that shape stage ids, labels, lr and t
    into the graph's static inputs and replay it. A new shape captures
    another graph (``jax.jit`` recompiles for a new shape); a step's graphs
    share one memory pool. A capture that fails raises. On the CPU the
    step runs eagerly, with the same device formulas.

    The mesh axes are not ported: an ``hcg`` with a degree above 1,
    ``pipeline_schedule="1f1b"``, ``virtual_pp_degree > 1`` and
    ``validate=True`` raise ``NotImplementedError``.
    """

    def __init__(self, model, config: GPTConfig, hcg=None, *, n_micro=None,
                 lr=1e-4, beta1=0.9, beta2=0.95, eps=1e-8, weight_decay=0.01,
                 grad_clip_norm=1.0, remat=True, compute_dtype=None,
                 use_flash=None, virtual_pp_degree=1,
                 pipeline_schedule="gpipe", param_dtype=None,
                 moment_dtype=None, validate=False):
        for axis in ("data", "model", "pipe", "sharding", "sep"):
            degree = getattr(hcg, f"get_{axis}_parallel_world_size",
                             lambda: 1)()
            if degree > 1:
                raise NotImplementedError(
                    f"{axis}-parallel degree {degree}: the port trains on "
                    f"one device ({_HYBRID_ITEM})")
        if pipeline_schedule not in ("gpipe", "1f1b"):
            raise ValueError(f"unknown pipeline_schedule "
                             f"{pipeline_schedule!r}")
        if pipeline_schedule == "1f1b":
            raise NotImplementedError(
                f"pipeline_schedule='1f1b' is not ported ({_HYBRID_ITEM})")
        if int(virtual_pp_degree or 1) > 1:
            raise NotImplementedError(
                f"virtual_pp_degree > 1 is not ported ({_HYBRID_ITEM})")
        if validate:
            raise NotImplementedError(
                f"validate=True is not ported ({_ANALYSIS_ITEM})")
        if remat not in (False, True, "dots"):
            raise ValueError(f"remat must be False, True or 'dots', got "
                             f"{remat!r}")
        gpt = model.gpt if isinstance(model, GPTForPretraining) else model
        self.model, self.gpt, self.config = model, gpt, config
        self.n_micro = n_micro or 1
        self.hyper = (lr, beta1, beta2, eps, weight_decay, grad_clip_norm)
        self.remat = remat
        self.compute_dtype = _as_dtype(compute_dtype)
        self.param_dtype = _as_dtype(param_dtype)
        self.moment_dtype = _as_dtype(moment_dtype) or torch.float32
        self.use_flash = use_flash
        self.flops_per_token = None
        self._t = 0
        self._graphs = {}             # (B, S) -> _TrainGraph
        self._pool = None
        self.capture_s = 0.0          # wall time of the captures

        self._layer_refs = {k: [getattr(layer, k) for layer in gpt.layers]
                            for k in _BLOCK_KEYS}
        emb = gpt.embeddings
        with torch.no_grad():
            params = {
                "blocks": {k: torch.stack([p.detach() for p in refs])
                           for k, refs in self._layer_refs.items()},
                "wte": emb.word_embeddings.detach(),
                "wpe": emb.position_embeddings.detach(),
                "lnf_w": gpt.lnf_w.detach(),
                "lnf_b": gpt.lnf_b.detach(),
            }
            got = _tree_map(lambda v: tuple(v.shape), params)
            want = gpt_stacked_param_shapes(config)
            if got != want:
                raise ValueError(f"stacked shapes {got} != config {want}")
            # always a real copy, never the model's own storage
            self.params = _tree_map(
                lambda v: v.to(self.param_dtype or v.dtype,
                               copy=True).requires_grad_(), params)
            zeros = lambda v: torch.zeros_like(v, dtype=self.moment_dtype)
            self.opt_state = {"m": _tree_map(zeros, self.params),
                              "v": _tree_map(zeros, self.params)}

    # ------------------------------------------------------------------
    def _cast_params(self, params):
        """Master -> compute dtype for the blocks and embeddings; the final
        layer norm's weights stay as they are."""
        if self.compute_dtype is None:
            return params
        cast = lambda v: v.to(self.compute_dtype)
        return dict(params,
                    blocks={k: cast(v) for k, v in params["blocks"].items()},
                    wte=cast(params["wte"]), wpe=cast(params["wpe"]))

    def _check_shape(self, B, S):
        if B % self.n_micro:
            raise ValueError(f"batch {B} must divide into {self.n_micro} "
                             f"micro-batches")
        if S > self.config.max_position_embeddings:
            raise ValueError(
                f"sequence length {S} exceeds max_position_embeddings "
                f"{self.config.max_position_embeddings}")

    def _use_flash(self, S):
        return flash_attention_gate(S, self.config.head_dim, self.use_flash,
                                    self.params["wte"].device)

    def _block_fn(self, eps, use_flash):
        def run(p, x):
            return gpt_block(p, x, eps, use_flash=use_flash)
        # the step draws no random numbers, so the RNG state need not be
        # kept for the recompute (reading it is not allowed in a capture)
        if self.remat == "dots":
            return lambda p, x: checkpoint(run, p, x, use_reentrant=False,
                                           context_fn=_dots_context,
                                           preserve_rng_state=False)
        if self.remat:
            return lambda p, x: checkpoint(run, p, x, use_reentrant=False,
                                           preserve_rng_state=False)
        return run

    def _loss_fn(self, params, ids, labels):
        """The forward: embed -> blocks -> final LN -> vocab CE, averaged
        over the micro-batches."""
        cfg = self.config
        B, S = ids.shape
        self._check_shape(B, S)
        mb = B // self.n_micro
        cp = self._cast_params(params)
        eps = cfg.layer_norm_epsilon
        blk = self._block_fn(eps, self._use_flash(S))
        # unbind's backward stacks the per-layer gradients in one op
        layers = [dict(zip(_BLOCK_KEYS, vals)) for vals in
                  zip(*(cp["blocks"][k].unbind(0) for k in _BLOCK_KEYS))]
        pos = torch.arange(S, device=ids.device)
        h = cp["wte"][ids] + cp["wpe"][pos]
        total = None
        for m in range(self.n_micro):
            x = h[m * mb:(m + 1) * mb]
            for p in layers:
                x = blk(p, x)
            x = _ln(x, cp["lnf_w"], cp["lnf_b"], eps).to(cp["wte"].dtype)
            loss = vocab_parallel_cross_entropy(
                x, cp["wte"], labels[m * mb:(m + 1) * mb], mp_axis="mp")
            total = loss if total is None else total + loss
        return total if self.n_micro == 1 else total / self.n_micro

    def _decay_mask(self):
        """Weight decay on the matmul weights and embeddings, never on
        layer-norm scales or biases."""
        return {"blocks": {k: k in ("wqkv", "wo", "w1", "w2")
                           for k in self.params["blocks"]},
                "wte": True, "wpe": True, "lnf_w": False, "lnf_b": False}

    def _inputs(self, *arrays):
        """Numpy arrays or tensors -> int64 tensors on the masters' device."""
        return tuple((a if isinstance(a, torch.Tensor)
                      else torch.from_numpy(np.asarray(a))).to(
                          self.params["wte"].device, torch.long)
                     for a in arrays)

    def loss_and_grads(self, input_ids, labels):
        """The loss (0-d f32) and the gradient of every master, as a tree
        shaped like ``params``; nothing is updated."""
        loss, grads = self._loss_and_grads(*self._inputs(input_ids, labels))
        grads = iter(grads)
        return loss, _tree_map(lambda _: next(grads), self.params)

    def _loss_and_grads(self, ids, labels):
        leaves = [v for _, v in _tree_items(self.params)]
        with torch.enable_grad():
            loss = self._loss_fn(self.params, ids, labels)
            grads = torch.autograd.grad(loss, leaves)
        return loss.detach(), grads

    def _scalars(self, lr, t):
        """``lr`` and the step count ``t`` as 0-d f32 tensors on the
        masters' device (the eager step's; a graph stages its own)."""
        return torch.tensor([lr, t], dtype=torch.float32,
                            device=self.params["wte"].device).unbind()

    @torch.no_grad()
    def _adamw(self, grads, lr, t):
        """The AdamW update of every master and moment, in place, as the
        JAX step writes it: global-norm clipping, bias corrections
        ``1 - b ** t`` and the decay factor ``1 - lr * wd`` computed in f32
        on the device from the 0-d f32 tensors ``lr`` and ``t``. ``grads``
        are the gradients in the order of ``_tree_items(self.params)``."""
        _, b1, b2, eps, wd, clip = self.hyper
        if clip is not None and clip > 0:
            gnorm = torch.stack([g.float().square().sum()
                                 for g in grads]).sum().sqrt()
            scale = (clip / gnorm.clamp_min(1e-6)).clamp_max(1.0)
        else:
            scale = 1.0
        bc1 = 1 - torch.pow(b1, t)
        bc2 = 1 - torch.pow(b2, t)
        keep = 1 - lr * wd
        decays = dict(_tree_items(self._decay_mask()))
        for (path, p), g, (_, m), (_, v) in zip(
                _tree_items(self.params), grads,
                _tree_items(self.opt_state["m"]),
                _tree_items(self.opt_state["v"])):
            g = g.float() * scale
            m2 = b1 * m.float() + (1 - b1) * g
            v2 = b2 * v.float() + (1 - b2) * g.square()
            mhat = m2 / bc1
            vhat = v2 / bc2
            p32 = p.float() * keep if decays[path] else p.float()
            p.copy_(p32 - lr * mhat / (vhat.sqrt() + eps))
            m.copy_(m2)
            v.copy_(v2)

    def _step(self, ids, labels, lr, t):
        """Forward, backward and the update on device tensors; returns the
        loss before the update. What a graph captures."""
        loss, grads = self._loss_and_grads(ids, labels)
        self._adamw(grads, lr, t)
        return loss

    def __call__(self, input_ids, labels):
        """One step on ``[B, S]`` ids and labels (numpy arrays or tensors);
        returns the loss before the update as a 0-d f32 tensor that no
        later call overwrites."""
        B, S = input_ids.shape
        self._check_shape(B, S)
        self.flops_per_token = model_flops_per_token(self.config, S)[0]
        self._t += 1
        # a callable lr (an LR schedule) is read, then stepped, per call
        lr_src = self.hyper[0]
        if callable(lr_src):
            lr = float(lr_src())
            if hasattr(lr_src, "step"):
                lr_src.step()
        else:
            lr = lr_src
        if capturing_on(self.params["wte"].device):
            return self._captured(input_ids, labels, lr, (B, S))
        ids, labs = self._inputs(input_ids, labels)
        return self._step(ids, labs, *self._scalars(lr, self._t))

    def _captured(self, input_ids, labels, lr, key):
        graph = self._graphs.get(key)
        if graph is None:
            return self._capture(input_ids, labels, lr, key)
        graph.inputs.stage((input_ids, labels), (lr, self._t))
        graph.graph.replay()
        add_counts(graph.counts)
        return graph.loss.clone()

    def _capture(self, input_ids, labels, lr, key):
        """This call's step, run eagerly on a side stream (it primes the
        allocator, cuBLAS and the kernel library, and counts its launches
        as any step does), then captured as the graph of ``key``: the
        capture records the same work and runs none of it, so the state
        moves by one step. Returns the step's loss."""
        dev = self.params["wte"].device
        inputs = StagedInputs([(key, torch.int64)] * 2, 2, dev)
        inputs.stage((input_ids, labels), (lr, self._t))
        args = (*inputs.tensors, *inputs.scalars)
        stream = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(stream)
        with torch.cuda.stream(side), sync_is_error():
            loss = self._step(*args)
        stream.wait_stream(side)
        loss.record_stream(stream)
        t0 = time.perf_counter()
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()

        def capture():
            with no_gc(), torch.cuda.graph(graph, pool=self._pool):
                return self._step(*args)
        out, counts = counted(capture)
        self._graphs[key] = _TrainGraph(graph, inputs, out, counts)
        self.capture_s += time.perf_counter() - t0
        return loss

    @property
    def captured_shapes(self):
        """The ``(B, S)`` shapes that have a captured graph."""
        return sorted(self._graphs)

    def graph_pool_bytes(self):
        """Device bytes the step's graphs' pool holds (0 with none
        captured; None where the allocator does not name pools)."""
        return 0 if self._pool is None else pool_bytes(self._pool)

    train_batch = __call__

    @torch.no_grad()
    def sync_params_to_model(self):
        """Write the trained masters back into the model's parameters."""
        for k, refs in self._layer_refs.items():
            for p, value in zip(refs, self.params["blocks"][k]):
                p.copy_(value)
        g = self.gpt
        g.embeddings.word_embeddings.copy_(self.params["wte"])
        g.embeddings.position_embeddings.copy_(self.params["wpe"])
        g.lnf_w.copy_(self.params["lnf_w"])
        g.lnf_b.copy_(self.params["lnf_b"])


def stack_gpt_weights(model) -> dict:
    """Stack a GPT model's per-layer parameters into the ``[n_layers, ...]``
    decode-side dict the serving engine consumes: ``{"blocks": {key:
    [L, ...]}, "wte", "wpe", "lnf_w", "lnf_b"}`` (detached copies)."""
    gpt = model.gpt if hasattr(model, "gpt") else model
    with torch.no_grad():
        return {
            "blocks": {k: torch.stack([getattr(l, k).detach()
                                       for l in gpt.layers])
                       for k in _BLOCK_KEYS},
            "wte": gpt.embeddings.word_embeddings.detach().clone(),
            "wpe": gpt.embeddings.position_embeddings.detach().clone(),
            "lnf_w": gpt.lnf_w.detach().clone(),
            "lnf_b": gpt.lnf_b.detach().clone(),
        }


def sample_logits(logits, generator=None, temperature=0.0, top_k=0):
    """Greedy (``temperature <= 0``: argmax, first maximum on ties, as
    ``jnp.argmax``) or temperature + optional top-k sampling drawn from
    ``generator``. Sampled tokens cannot match ``jax.random`` bit for bit."""
    if temperature <= 0.0:
        return torch.argmax(logits, -1)
    logits = logits.float() / temperature
    if top_k > 0:
        kth = torch.sort(logits, -1).values[..., -top_k, None]
        logits = logits.masked_fill(logits < kth, -1e30)
    probs = torch.softmax(logits, -1)
    flat = probs.reshape(-1, probs.shape[-1])
    out = torch.multinomial(flat, 1, generator=generator)
    return out.reshape(probs.shape[:-1])
