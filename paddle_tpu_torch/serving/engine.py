"""Serving engine: GPT weights → paged-KV prefill/decode
(counterpart of ``paddle_tpu/serving/engine.py``, default mode).

``ServingEngine`` owns the stacked decode weights
(:func:`~paddle_tpu_torch.models.gpt.stack_gpt_weights`), a
:class:`~.kv_pool.PagePool` of fixed-size KV pages, and closed sets of
prefill buckets (prompt lengths) and decode buckets (batch sizes): a shape
outside them raises :class:`EngineShapeError`.

Prefill runs a prompt padded to its bucket through the decoder blocks
(attention through the FlashAttention kernel where
:func:`~paddle_tpu_torch.models.gpt.flash_attention_gate` approves),
scatters each layer's K/V into the pool, and samples the first token.
Decode runs one token per live sequence: each layer writes the new K/V
into its page row, then attends over the page table with the paged
decode kernel. The pool's tensors are updated in place.

Modes of the JAX engine that are not ported yet (int8 weights, chunked
prefill, the prefix cache, disaggregated prefill, auto-fusion,
``from_checkpoint``) raise ``NotImplementedError``.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..framework.random import make_generator
from ..kernels.paged_attention import paged_attention_decode
from ..models.gpt import (GPTConfig, _ln, flash_attention_gate, gpt_block,
                          sample_logits, stack_gpt_weights)
from .kv_pool import PagePool

__all__ = ["ServingEngine", "EngineShapeError", "decode_step_fn",
           "prefill_fn", "default_prefill_buckets"]

_MODES_ITEM = "ROADMAP.md, Queue 1, 'Serving: the other engine modes'"


class EngineShapeError(RuntimeError):
    """A shape outside the engine's bucket set was requested."""


def _layer(blocks, i):
    return {k: v[i] for k, v in blocks.items()}


def decode_step_fn(params, k_pages, v_pages, tokens, positions, page_table,
                   seq_lens, generator=None, *, eps, temperature, top_k):
    """One continuous-batching decode step: for every (possibly idle)
    batch slot, embed the last token, write its K/V into the slot's page
    row, attend over the page table, and sample the next token.

    ``tokens``/``positions`` ``[B]`` (position = seq_len - 1);
    ``page_table`` ``[B, pages_per_seq]``; ``seq_lens`` ``[B]`` (0 = idle
    slot). ``k_pages``/``v_pages`` are updated in place. Returns the next
    tokens ``[B]`` int32."""
    blocks, wte, wpe = params["blocks"], params["wte"], params["wpe"]
    B = tokens.shape[0]
    L, np_, ps, nkv, d = k_pages.shape
    H = wte.shape[1]
    nh = blocks["wqkv"].shape[3]
    pos = positions.long().clamp_min(0)
    page_table = page_table.to(torch.int32)
    seq_lens = seq_lens.to(torch.int32)
    x = (wte[tokens.long()] + wpe[pos])[:, None, :]
    # destination page row of the token being decoded. Idle slots (pos 0,
    # an all-sink table) all write row 0 of the sink page, so the index
    # repeats and which write lands is unspecified: harmless only because
    # page 0 is never read unmasked.
    rows = page_table[torch.arange(B, device=pos.device), pos // ps].long() \
        * ps + pos % ps
    for i in range(L):
        p = _layer(blocks, i)
        h = _ln(x, p["ln1_w"], p["ln1_b"], eps)
        qkv = (h @ p["wqkv"].reshape(H, 3 * nh * d)).reshape(
            B, 1, 3, nh, d) + p["bqkv"]
        q, k, v = qkv[:, 0, 0], qkv[:, 0, 1], qkv[:, 0, 2]   # [B, nh, d]
        # the new K/V enter the pool before attention reads it
        k_pages[i].view(np_ * ps, nkv, d).index_copy_(
            0, rows, k.to(k_pages.dtype))
        v_pages[i].view(np_ * ps, nkv, d).index_copy_(
            0, rows, v.to(v_pages.dtype))
        attn = paged_attention_decode(q, k_pages[i], v_pages[i],
                                      page_table, seq_lens)
        o = attn.to(x.dtype).reshape(B, nh * d) @ p["wo"].reshape(nh * d, H)
        x = x + o[:, None, :] + p["bo"]
        h2 = _ln(x, p["ln2_w"], p["ln2_b"], eps)
        u = F.gelu(h2 @ p["w1"] + p["b1"], approximate="tanh")
        x = x + u @ p["w2"] + p["b2"]
    h = _ln(x, params["lnf_w"], params["lnf_b"], eps)
    logits = (h @ wte.t())[:, 0]
    return sample_logits(logits, generator, temperature,
                         top_k).to(torch.int32)


def prefill_fn(params, k_pages, v_pages, ids, true_len, dest_rows,
               generator=None, *, eps, temperature, top_k, use_flash):
    """Prefill one request (batch 1, prompt ``ids [1, S]`` padded to a
    bucket length): full causal forward, each layer's K/V scattered into
    the pool at ``dest_rows [S]`` (padding rows → sink page), first token
    sampled from position ``true_len - 1``. Updates the pages in place and
    returns the token ``[1]`` int32."""
    blocks, wte, wpe = params["blocks"], params["wte"], params["wpe"]
    s = ids.shape[1]
    L, np_, ps, nkv, d = k_pages.shape
    rows = dest_rows.long()
    h = wte[ids.long()] + wpe[torch.arange(s, device=ids.device)]
    for i in range(L):
        h, k, v = gpt_block(_layer(blocks, i), h, eps, use_flash=use_flash,
                            return_kv=True)
        # pad positions all map into the sink page (repeated rows, any
        # write may land): page 0 is never read unmasked
        k_pages[i].view(np_ * ps, nkv, d).index_copy_(
            0, rows, k[0].to(k_pages.dtype))
        v_pages[i].view(np_ * ps, nkv, d).index_copy_(
            0, rows, v[0].to(v_pages.dtype))
    last = max(int(true_len) - 1, 0)
    h_last = _ln(h[:, last:last + 1], params["lnf_w"], params["lnf_b"], eps)
    logits = (h_last @ wte.t())[:, 0]
    return sample_logits(logits, generator, temperature,
                         top_k).to(torch.int32)


def default_prefill_buckets(page_size, max_seq_len):
    """Doubling page-multiple prompt buckets covering max_seq_len."""
    buckets, b = [], max(int(page_size), 1)
    while b < max_seq_len:
        buckets.append(b)
        b *= 2
    buckets.append(int(max_seq_len))
    return tuple(sorted(set(buckets)))


class ServingEngine:
    """See the module docstring. ``model`` is a GPT model (or anything
    :func:`stack_gpt_weights` takes); its weights' dtype is the compute
    dtype. ``device`` is CUDA unless ``"cpu"`` is asked for."""

    def __init__(self, model, config=None, *, page_size=16, num_pages=None,
                 max_seq_len=None, decode_buckets=(1, 2, 4, 8),
                 prefill_buckets=None, temperature=0.0, top_k=0, seed=0,
                 use_flash=None, device=None,
                 quantize=None, prefill_chunk=None, prefix_cache=False,
                 disaggregated=False, autofuse=None):
        for name, value in (("quantize", quantize),
                            ("prefill_chunk", prefill_chunk),
                            ("prefix_cache", prefix_cache),
                            ("disaggregated", disaggregated),
                            ("autofuse", autofuse)):
            if value:
                raise NotImplementedError(
                    f"{name}={value!r} is not ported yet ({_MODES_ITEM})")
        self.device = resolve_device(device)
        gpt = model.gpt if hasattr(model, "gpt") else model
        self.cfg: GPTConfig = config or gpt.config
        cfg = self.cfg
        self.params = _to_device(stack_gpt_weights(model), self.device)
        self.compute_dtype = self.params["wte"].dtype
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        max_seq_len = int(max_seq_len or cfg.max_position_embeddings)
        if max_seq_len > cfg.max_position_embeddings:
            raise ValueError("max_seq_len exceeds the position table")
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
            # every slot of the widest bucket at full length, plus the sink
            num_pages = self.decode_buckets[-1] * pages_per_seq + 1
        self.pool = PagePool(num_pages, page_size,
                             num_layers=cfg.num_layers,
                             num_kv_heads=cfg.num_heads,
                             head_dim=cfg.head_dim,
                             dtype=self.compute_dtype,
                             max_seq_len=max_seq_len, device=self.device)
        self.max_seq_len = max_seq_len
        self._generator = make_generator(seed, self.device)
        self._use_flash = {sb: flash_attention_gate(sb, cfg.head_dim,
                                                    use_flash, self.device)
                           for sb in self.prefill_buckets}
        # each sequence's pending token: sampled, its K/V not yet cached
        self._last_token: dict = {}

    @classmethod
    def from_checkpoint(cls, path, config, **kw):
        raise NotImplementedError(
            f"from_checkpoint needs framework/io, not ported yet "
            f"({_MODES_ITEM})")

    # -------------------------------------------------------------- info
    def weight_bytes(self) -> int:
        """Device bytes of the stacked decode weights."""
        leaves = list(self.params["blocks"].values()) + [
            self.params[k] for k in ("wte", "wpe", "lnf_w", "lnf_b")]
        return int(sum(t.numel() * t.element_size() for t in leaves))

    def status(self) -> dict:
        """Engine-side JSON snapshot: weights, buckets, pool occupancy."""
        return {
            "device": str(self.device),
            "compute_dtype": str(self.compute_dtype).replace("torch.", ""),
            "quantize": None,
            "weights_mb": round(self.weight_bytes() / 2 ** 20, 2),
            "decode_buckets": list(self.decode_buckets),
            "prefill_buckets": list(self.prefill_buckets),
            "flash_prefill_buckets": [sb for sb, on in
                                      self._use_flash.items() if on],
            "max_seq_len": self.max_seq_len,
            "pool": self.pool.stats(),
        }

    def prefill_bucket(self, prompt_len: int) -> int:
        for sb in self.prefill_buckets:
            if prompt_len <= sb:
                return sb
        raise EngineShapeError(
            f"prompt of {prompt_len} tokens exceeds the largest prefill "
            f"bucket {self.prefill_buckets[-1]}")

    def decode_bucket(self, n_active: int) -> int:
        for b in self.decode_buckets:
            if n_active <= b:
                return b
        raise EngineShapeError(
            f"{n_active} active sequences exceed the largest decode "
            f"bucket {self.decode_buckets[-1]}")

    # ------------------------------------------------------------- steps
    def _put(self, arr):
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)

    def prefill(self, seq_id, prompt_ids) -> int:
        """Allocate pages for ``prompt_ids``, run the bucketed prefill,
        return the first generated token."""
        prompt = np.asarray(prompt_ids, dtype=np.int32).reshape(-1)
        n = int(prompt.shape[0])
        if n + 1 > self.max_seq_len:
            raise EngineShapeError(
                f"prompt of {n} tokens leaves no room to decode within "
                f"max_seq_len {self.max_seq_len}")
        if n and (prompt.min() < 0 or prompt.max() >= self.cfg.vocab_size):
            raise ValueError(f"prompt token ids must lie in [0, "
                             f"{self.cfg.vocab_size})")
        sb = self.prefill_bucket(n)
        self.pool.alloc(seq_id, n)
        ids = np.zeros((1, sb), np.int32)
        ids[0, :n] = prompt
        rows = self.pool.prefill_rows(seq_id, sb)
        with torch.no_grad():
            tok = prefill_fn(
                self.params, self.pool.k_pages, self.pool.v_pages,
                self._put(ids), n, self._put(rows), self._generator,
                eps=self.cfg.layer_norm_epsilon,
                temperature=self.temperature, top_k=self.top_k,
                use_flash=self._use_flash[sb])
        tok = int(tok[0])
        self._last_token[seq_id] = tok
        return tok

    def decode(self, seq_ids, bucket=None):
        """One decode step for ``seq_ids`` (each already holding its new
        position via ``pool.extend``), padded to ``bucket`` with idle
        slots. Returns the next token per live sequence."""
        nxt = self._launch_decode(self._decode_inputs(seq_ids, bucket))
        out = [int(t) for t in nxt[:len(seq_ids)].tolist()]
        for sid, t in zip(seq_ids, out):
            self._last_token[sid] = t
        return out

    def _decode_inputs(self, seq_ids, bucket=None):
        """Check the bucket and upload a decode step's host state: the
        last tokens, positions, page table and lengths ``[bucket, ...]``.
        The uploads are blocking copies, so they wait for the stream."""
        n = len(seq_ids)
        bucket = self.decode_bucket(n) if bucket is None else bucket
        if bucket not in self.decode_buckets:
            raise EngineShapeError(f"decode batch {bucket} is not a bucket "
                                   f"{self.decode_buckets}")
        if n > bucket:
            raise EngineShapeError(f"{n} sequences > bucket {bucket}")
        slots = list(seq_ids) + [None] * (bucket - n)
        lens = self.pool.lens_array(slots)
        table = self.pool.table_array(slots)
        tokens = np.asarray([self._last_token.get(sid, 0) for sid in slots],
                            np.int32)
        positions = np.maximum(lens - 1, 0).astype(np.int32)
        return tuple(self._put(a) for a in (tokens, positions, table, lens))

    def _launch_decode(self, inputs):
        """Launch one decode step on uploaded ``inputs``; returns the next
        tokens ``[bucket]`` on the device without waiting for them."""
        with torch.no_grad():
            return decode_step_fn(
                self.params, self.pool.k_pages, self.pool.v_pages, *inputs,
                self._generator, eps=self.cfg.layer_norm_epsilon,
                temperature=self.temperature, top_k=self.top_k)

    def release(self, seq_id, token_ids=None):
        """Free a finished sequence's pages. ``token_ids`` is accepted for
        the scheduler's call shape (the prefix cache that would publish
        them is not ported)."""
        self._last_token.pop(seq_id, None)
        self.pool.free(seq_id)


def _to_device(params, device):
    return {k: (_to_device(v, device) if isinstance(v, dict)
                else v.to(device))
            for k, v in params.items()}
