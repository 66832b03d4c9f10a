"""MoE serving engine: ERNIE-MoE over the paged KV pool (counterpart of
``paddle_tpu/serving/moe_engine.py``).

``MoEServingEngine`` is the MoE sibling of
:class:`~.engine.ServingEngine`: the stacked ERNIE-MoE weights
(:func:`~paddle_tpu_torch.models.ernie.stack_ernie_moe_weights`), the same
:class:`~.kv_pool.PagePool`, the paged decode kernel, and closed sets of
prefill buckets (prompt lengths) and decode buckets (batch sizes); a shape
outside them raises :class:`~.engine.EngineShapeError`. What differs is the
FFN: every ``moe_every``-th layer routes its tokens through the fused MoE
dispatch kernel, the batched expert FFN and the fused combine kernel
(:mod:`paddle_tpu_torch.kernels.moe_dispatch`); ``use_fused_moe=False``
takes the gather-based plain versions instead, as in JAX.

The layers are a Python loop over dense and MoE kinds. Post-LN blocks as
the eager model, with one LayerNorm form for every norm (:func:`_eln`:
var + sqrt, the config's eps, as the JAX engine). Prefill attention is
dense causal attention in plain PyTorch with the JAX numerics (scores
divided by sqrt(d), -1e30 mask, f32 softmax cast back); decode attends
through the paged decode kernel.

Capacity: every step sizes the experts' capacity at its token count, the
per-expert no-drop bound (a token's k choices are distinct experts), so
incremental decode equals eager full-recompute generation
(:class:`~paddle_tpu_torch.models.ernie.ErnieMoeGenerator`).

Greedy by default; the pool's tensors are updated in place; the
continuous-batching scheduler drives this engine unchanged. ``aot`` is
the GPT engine's: on CUDA, by default, every decode bucket's step and
every prefill bucket's is captured as a CUDA graph and replayed (the MoE
dispatch in one launch at decode sizes and in three passes for prefills of
more than 128 tokens, both inside the graphs).
:meth:`MoEServingEngine.from_checkpoint` is the warm start from a
``paddle.save``d ERNIE-MoE state dict. ``autofuse`` is not ported and
raises ``NotImplementedError``.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..framework.random import make_generator
from ..kernels.moe_dispatch import (fused_moe_combine, fused_moe_dispatch,
                                    reference_moe_combine,
                                    reference_moe_dispatch)
from ..kernels.paged_attention import paged_attention_decode
from ..models.ernie import (ErnieMoeConfig, ErnieMoeForPretraining,
                            stack_ernie_moe_weights)
from ..models.gpt import sample_logits
from ..nn._torch_layers import layer_norm
from .engine import (ServingEngine, _resolve_aot, _row_before, _to_device,
                     default_prefill_buckets)
from .kv_pool import PagePool

__all__ = ["MoEServingEngine", "moe_decode_step_fn", "moe_prefill_fn"]

_NEG_INF = -1e30
_ITEM = "ROADMAP.md, Queue 1, item 1 (MoE: autofuse)"

# the eager model's LayerNorm (var + sqrt), not GPT's rsqrt form
_eln = layer_norm


def _gelu(x):
    """The exact (erf) GELU of ``nn.functional.gelu``."""
    return F.gelu(x)


def _moe_ffn(flat, p, *, top_k, use_fused):
    """The MoE FFN over flat tokens ``[N, H]``: dispatch → batched expert
    FFN → combine, with capacity ``C = N`` (no single expert can receive
    more than N rows, so no token is dropped)."""
    E = p["ew1"].shape[0]
    N, H = flat.shape
    C = N
    dispatch = fused_moe_dispatch if use_fused else reference_moe_dispatch
    ei, comb, val, _, _ = dispatch(
        flat, p["gate_w"], p["gate_b"], num_expert=E, capacity=C,
        top_k=top_k, gate_kind="gshard")
    ei = ei.to(flat.dtype)
    h = _gelu(torch.bmm(ei, p["ew1"]) + p["eb1"][:, None, :])
    eo = torch.bmm(h, p["ew2"]) + p["eb2"][:, None, :]
    combine = fused_moe_combine if use_fused else reference_moe_combine
    return combine(eo.reshape(E * C, H), val, comb)


def _attn_proj(x, p, nh, d):
    """q/k/v projections ``[B, S, H]`` → ``[B, S, nh, d]`` (paddle's
    ``[in, out]`` weights)."""
    B, S, _ = x.shape
    q = (x @ p["wq"] + p["bq"]).reshape(B, S, nh, d)
    k = (x @ p["wk"] + p["bk"]).reshape(B, S, nh, d)
    v = (x @ p["wv"] + p["bv"]).reshape(B, S, nh, d)
    return q, k, v


def _ffn(x, kind, p, top_k, use_fused_moe):
    """The layer's FFN on ``x [B, S, H]``: dense, or MoE over its B*S
    tokens."""
    if kind == "moe":
        B, S, H = x.shape
        return _moe_ffn(x.reshape(B * S, H), p, top_k=top_k,
                        use_fused=use_fused_moe).reshape(B, S, H)
    return _gelu(x @ p["w1"] + p["b1"]) @ p["w2"] + p["b2"]


def _head_logits(h, hd, eps):
    """The MLM head on ``h [B, 1, H]`` → logits ``[B, V]``."""
    h = _eln(_gelu(h @ hd["tw"] + hd["tb"]), hd["ln_w"], hd["ln_b"], eps)
    return (h @ hd["dw"].t())[:, 0] + hd["db"]


def moe_decode_step_fn(params, k_pages, v_pages, tokens, positions,
                       page_table, seq_lens, generator=None, *, kinds, eps,
                       top_k, temperature, topk_sample, use_fused_moe=True):
    """One continuous-batching decode step of the ERNIE-MoE stack: embed
    each slot's last token, per layer write its K/V into the slot's page row
    and attend over the page table (the paged decode kernel), then the
    dense or MoE FFN, finally the MLM head. ``tokens``/``positions``/``seq_lens`` ``[B]``,
    ``page_table [B, pages_per_seq]`` (idle slots: length 0, an all-sink
    table). ``k_pages``/``v_pages`` are updated in place. Returns the next
    tokens ``[B]`` int32."""
    B = tokens.shape[0]
    ps, nkv, d = k_pages.shape[2:]
    pos = positions.long().clamp_min(0)
    page_table = page_table.to(torch.int32)
    seq_lens = seq_lens.to(torch.int32)
    x = (params["wte"][tokens.long()] + params["wpe"][pos])[:, None, :]
    x = _eln(x, params["eln_w"], params["eln_b"], eps)
    # idle slots all write row 0 of the sink page (never read unmasked)
    rows = page_table[torch.arange(B, device=pos.device), pos // ps].long() \
        * ps + pos % ps
    for li, (kind, p) in enumerate(zip(kinds, params["layers"])):
        q, k, v = _attn_proj(x, p, nkv, d)             # [B, 1, nh, d]
        k_pages[li].view(-1, nkv, d).index_copy_(0, rows,
                                                 k[:, 0].to(k_pages.dtype))
        v_pages[li].view(-1, nkv, d).index_copy_(0, rows,
                                                 v[:, 0].to(v_pages.dtype))
        attn = paged_attention_decode(q[:, 0], k_pages[li], v_pages[li],
                                      page_table, seq_lens)
        o = attn.reshape(B, 1, nkv * d) @ p["wo"] + p["bo"]
        x = _eln(x + o, p["ln1_w"], p["ln1_b"], eps)
        x = _eln(x + _ffn(x, kind, p, top_k, use_fused_moe), p["ln2_w"],
                 p["ln2_b"], eps)
    logits = _head_logits(x, params["head"], eps)
    return sample_logits(logits, generator, temperature,
                         topk_sample).to(torch.int32)


def moe_prefill_fn(params, k_pages, v_pages, ids, true_len, dest_rows,
                   generator=None, *, kinds, eps, top_k, temperature,
                   topk_sample, use_fused_moe=True):
    """Prefill one request (batch 1, ``ids [1, S]`` padded to a bucket
    length): the full causal forward through the dense/MoE stack, each
    layer's K/V scattered into the pool at ``dest_rows [S]`` (padding rows
    → the sink page), then the first token sampled at ``true_len - 1``. MoE
    capacity is the bucket length: padded positions route too but cannot
    take a real token's slot. ``true_len`` is an int or a one-element int
    tensor on the device. Updates the pages in place and returns the token
    ``[1]`` int32."""
    s = ids.shape[1]
    nkv, d = k_pages.shape[3:]
    x = params["wte"][ids.long()] \
        + params["wpe"][torch.arange(s, device=ids.device)][None]
    x = _eln(x, params["eln_w"], params["eln_b"], eps)
    rows = dest_rows.long()
    causal = torch.ones(s, s, dtype=torch.bool, device=ids.device).tril()
    for li, (kind, p) in enumerate(zip(kinds, params["layers"])):
        q, k, v = _attn_proj(x, p, nkv, d)             # [1, s, nh, d]
        k_pages[li].view(-1, nkv, d).index_copy_(0, rows,
                                                 k[0].to(k_pages.dtype))
        v_pages[li].view(-1, nkv, d).index_copy_(0, rows,
                                                 v[0].to(v_pages.dtype))
        logits = torch.einsum("bsnd,btnd->bnst", q, k) / math.sqrt(d)
        logits = logits.masked_fill(~causal, _NEG_INF)
        probs = torch.softmax(logits.float(), -1).to(x.dtype)
        attn = torch.einsum("bnst,btnd->bsnd", probs, v)
        o = attn.reshape(1, s, nkv * d) @ p["wo"] + p["bo"]
        x = _eln(x + o, p["ln1_w"], p["ln1_b"], eps)
        x = _eln(x + _ffn(x, kind, p, top_k, use_fused_moe), p["ln2_w"],
                 p["ln2_b"], eps)
    logits = _head_logits(_row_before(x, true_len), params["head"], eps)
    return sample_logits(logits, generator, temperature,
                         topk_sample).to(torch.int32)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, tuple):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


class MoEServingEngine:
    """See the module docstring. ``model`` is an
    :class:`~paddle_tpu_torch.models.ernie.ErnieMoeForPretraining`; its
    weights' dtype is the compute dtype. ``device`` is CUDA unless
    ``"cpu"`` is asked for. Greedy by default."""

    # one implementation of the bucket lookups, the prompt check, the
    # upload, the decode step's host side and the bucket graphs across the
    # engines
    prefill_bucket = ServingEngine.prefill_bucket
    decode_bucket = ServingEngine.decode_bucket
    decode_signatures = ServingEngine.decode_signatures
    _check_prompt = ServingEngine._check_prompt
    _put = ServingEngine._put
    _decode_inputs = ServingEngine._decode_inputs
    _launch_decode = ServingEngine._launch_decode
    decode = ServingEngine.decode
    prefill = ServingEngine.prefill          # bucketed: no prefill_chunk
    _step_programs = ServingEngine._step_programs
    compile_buckets = ServingEngine.compile_buckets
    graph_pool_bytes = ServingEngine.graph_pool_bytes
    _upload = ServingEngine._upload
    _run = ServingEngine._run

    def __init__(self, model, config: ErnieMoeConfig | None = None, *,
                 page_size=16, num_pages=None, max_seq_len=None,
                 decode_buckets=(1, 2, 4, 8), prefill_buckets=None,
                 temperature=0.0, top_k=0, seed=0, use_fused_moe=True,
                 autofuse=None, device=None, aot=None):
        if not isinstance(model, ErnieMoeForPretraining):
            raise TypeError("MoEServingEngine needs ErnieMoeForPretraining")
        if autofuse:
            raise NotImplementedError(
                f"autofuse={autofuse!r} is not ported yet ({_ITEM})")
        self.device = resolve_device(device)
        self.aot = _resolve_aot(aot, self.device)
        self.cfg = config or model.ernie.config
        cfg = self.cfg
        params, self.kinds = stack_ernie_moe_weights(model)
        self.params = _to_device(params, self.device)
        self.compute_dtype = self.params["wte"].dtype
        self.moe_top_k = int(cfg.top_k)
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self.use_fused_moe = bool(use_fused_moe)
        self.autofuse = False
        self.prefill_chunk = None      # the scheduler probes this (classic)
        max_seq_len = int(max_seq_len or cfg.max_position_embeddings)
        if max_seq_len > cfg.max_position_embeddings:
            raise ValueError("max_seq_len exceeds the position table")
        self.max_seq_len = max_seq_len
        self.decode_buckets = tuple(sorted(set(int(b)
                                               for b in decode_buckets)))
        self.prefill_buckets = tuple(sorted(set(
            int(b) for b in (prefill_buckets or default_prefill_buckets(
                page_size, max_seq_len)))))
        if self.prefill_buckets[-1] < max_seq_len:
            raise ValueError("largest prefill bucket must cover "
                             "max_seq_len")
        pages_per_seq = math.ceil(max_seq_len / page_size)
        if num_pages is None:
            num_pages = self.decode_buckets[-1] * pages_per_seq + 1
        self.pool = PagePool(num_pages, page_size,
                             num_layers=cfg.num_hidden_layers,
                             num_kv_heads=cfg.num_attention_heads,
                             head_dim=cfg.head_dim,
                             dtype=self.compute_dtype,
                             max_seq_len=max_seq_len, device=self.device)
        self._generator = make_generator(seed, self.device)
        self._last_token: dict = {}
        self._programs = self._step_programs()
        self._graphs = None
        self.compile_s = 0.0
        if self.aot:
            self.compile_buckets()

    @classmethod
    def from_checkpoint(cls, path, config: ErnieMoeConfig, **kw):
        """Checkpoint → engine: ``path`` is a ``paddle.save``d ERNIE-MoE
        state dict (``ErnieMoeForPretraining`` keys, or bare
        ``ErnieMoeModel`` keys, which get the ``ernie.`` prefix), written
        by the port or by the JAX package. With bare keys the MLM head
        keeps the freshly built model's weights (seed 0), as the JAX
        engine's does. The model is built on the engine's device, loaded
        in f32, put in eval mode and handed with ``kw`` to the
        constructor."""
        from ..framework.io import load
        from ..models.convert import ernie_moe_state_dict_from_numpy
        from ..models.ernie import ErnieMoeModel
        resolve_device(kw.get("device"))     # no card: raise before reading
        state = load(path, return_numpy=True)
        model = ErnieMoeForPretraining(
            ErnieMoeModel(config, device=kw.get("device")))
        word = "ernie.embeddings.word_embeddings.weight"
        if not any(k.startswith("ernie.") for k in state):
            state = {f"ernie.{k}": v for k, v in state.items()}
            head = {k: v.detach().cpu().numpy()
                    for k, v in model.state_dict().items()
                    if not k.startswith("ernie.")}
            if word in state:
                head["decoder_weight"] = state[word]
            state = {**head, **state}
        # the port's own state dict holds the tied embedding under both
        # names; the JAX one once, as decoder_weight
        tied = state.pop(word, None)
        if tied is not None:
            if "decoder_weight" not in state:
                state["decoder_weight"] = tied
            elif not np.array_equal(tied, state["decoder_weight"]):
                raise ValueError(f"{word} differs from decoder_weight: the "
                                 f"embedding is tied")
        model.load_state_dict(ernie_moe_state_dict_from_numpy(state),
                              strict=True)
        model.eval()
        return cls(model, config, **kw)

    # -------------------------------------------------------------- info
    def prefill_signatures(self) -> set:
        """The closed set of prefill shapes: ``(1, bucket)`` per bucket."""
        return {(1, sb) for sb in self.prefill_buckets}

    def weight_bytes(self) -> int:
        """Device bytes of the stacked decode weights."""
        return int(sum(t.numel() * t.element_size()
                       for t in _leaves(self.params)))

    def status(self) -> dict:
        """Engine-side JSON snapshot; ``aot_programs`` counts the CUDA
        graphs held (one a decode bucket and one a prefill bucket)."""
        return {
            "model": "ernie_moe",
            "device": str(self.device),
            "compute_dtype": str(self.compute_dtype).replace("torch.", ""),
            "num_experts": self.cfg.num_experts,
            "moe_top_k": self.moe_top_k,
            "moe_layers": sum(1 for k in self.kinds if k == "moe"),
            "fused_moe_dispatch": self.use_fused_moe,
            "autofuse": self.autofuse,
            "weights_mb": round(self.weight_bytes() / 2 ** 20, 2),
            "decode_buckets": list(self.decode_buckets),
            "prefill_buckets": list(self.prefill_buckets),
            "max_seq_len": self.max_seq_len,
            "compile_s": round(self.compile_s, 3),
            "aot_programs": len(self._graphs or ()),
            "pool": self.pool.stats(),
        }

    # ------------------------------------------------------------- steps
    def _step_kw(self):
        return dict(kinds=self.kinds, eps=self.cfg.layer_norm_eps,
                    top_k=self.moe_top_k, temperature=self.temperature,
                    topk_sample=self.top_k,
                    use_fused_moe=self.use_fused_moe)

    def _prefill_call(self, ids, true_len, rows):
        return moe_prefill_fn(
            self.params, self.pool.k_pages, self.pool.v_pages, ids, true_len,
            rows, self._generator, **self._step_kw())

    def _decode_call(self, tokens, positions, table, lens):
        return moe_decode_step_fn(
            self.params, self.pool.k_pages, self.pool.v_pages, tokens,
            positions, table, lens, self._generator, **self._step_kw())

    def release(self, seq_id, token_ids=None):
        """Free a finished sequence (``token_ids`` is accepted for the
        scheduler's call; there is no prefix cache to publish to)."""
        self._last_token.pop(seq_id, None)
        self.pool.free(seq_id)

