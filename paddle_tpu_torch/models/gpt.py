"""GPT decoder language-model family (counterpart of ``paddle_tpu/models/gpt.py``).

One functional decoder block, :func:`gpt_block`, is the math of every path:
the ``nn.Module`` layers call it, and the serving engine calls it for
prefill. It copies the JAX block's numerics: a hand-written layer norm in
the input dtype (:func:`_ln`), tanh GELU, dense attention that divides by
sqrt(d) in the compute dtype, masks with -1e30 and takes the softmax in
f32; with ``use_flash`` the attention core is the FlashAttention kernel.

Parameter names, shapes and layouts are the JAX model's
(``wqkv [H, 3, nh, d]``, ``wo [nh, d, H]``, ...), so a JAX ``state_dict``
loads through :func:`paddle_tpu_torch.models.convert.gpt_state_dict_from_numpy`.
The LM head is tied to the word embedding.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from ..framework.random import make_generator
from ..kernels.flash_attention import KERNEL_HEAD_DIMS, flash_attention_bshd

__all__ = [
    "GPTConfig", "GPTDecoderLayer", "GPTEmbeddings", "GPTModel",
    "GPTForPretraining", "stack_gpt_weights", "sample_logits",
    "flash_attention_gate", "gpt_block",
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
    approves the kernel on CUDA for every S >= 64 with a head dim the
    kernel takes, and keeps the plain path on the CPU (the JAX gate's TPU
    threshold of S >= 512 was measured on a v5e and does not carry over).
    ``use_flash=True`` forces it wherever the shape allows (on the CPU the
    flash wrapper then runs its plain version)."""
    on_cuda = device is not None and torch.device(device).type == "cuda"
    if use_flash is None:
        use_flash = on_cuda
    dims_ok = head_dim in KERNEL_HEAD_DIMS if on_cuda else head_dim <= 128
    return bool(use_flash) and S >= 64 and dims_ok


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
