"""Serving engine: GPT weights → paged-KV prefill/decode
(counterpart of ``paddle_tpu/serving/engine.py``).

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

Modes, alone or combined:

- ``prefill_chunk=C``: prompts prefill in chunks of ``C`` tokens through
  one chunk program (:func:`chunk_prefill_fn`) whose attention is the
  ragged chunk-prefill kernel over the page table at a runtime offset;
  the scheduler interleaves chunks with decode steps.
- ``prefix_cache=True`` (implies chunking): a
  :class:`~.prefix_cache.PrefixCache` maps cached prompt pages into new
  sequences, copies a shared boundary page on a mid-page match, and
  prefills only the rest.
- ``quantize="int8"``: weight-only int8 with per-channel f32 scales
  (:mod:`paddle_tpu_torch.quantization.export`). The decode and chunk
  matmuls and every logits product run the int8 dequant-matmul kernel;
  the bucketed prefill dequantizes one layer at a time and runs the
  float block.

``aot`` (the JAX engine's ahead-of-time bucket closure): on CUDA, by
default, :meth:`ServingEngine.compile_buckets` captures every decode
bucket's step and every prefill bucket's (or the one chunk program) as a
CUDA graph (:mod:`.graphs`) before the engine serves, and each step
replays its bucket's graph. ``aot=False`` runs the step functions eagerly,
as the CPU always does. The step functions take their per-request scalars
(true length, chunk offset and length) as device tensors, so a graph
serves every request of its bucket.

:meth:`ServingEngine.from_checkpoint` builds the engine from a
``paddle.save``d GPT state dict (the port's or the JAX package's file,
:mod:`paddle_tpu_torch.framework.io`), the warm start a fleet replica
takes.

The JAX engine reaches the chunk-prefill and int8 kernels through its
auto-fusion rewrite, on by default; the port's step functions call them
where the rewrite puts them. Disaggregated prefill and ``autofuse`` are
not ported and raise ``NotImplementedError``.
"""
from __future__ import annotations

import math
import time

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..framework.random import make_generator
from ..kernels.int8_matmul import int8_matmul
from ..kernels.paged_attention import (paged_attention_decode,
                                       ragged_prefill_attention)
from ..models.gpt import (GPTConfig, _ln, flash_attention_gate, gpt_block,
                          sample_logits, stack_gpt_weights)
from ..quantization.export import (is_quantized,
                                   quantize_stacked_gpt_weights)
from .graphs import BucketGraphs, unpack
from .kv_pool import PagePool
from .prefix_cache import PrefixCache

__all__ = ["ServingEngine", "EngineShapeError", "decode_step_fn",
           "prefill_fn", "chunk_prefill_fn", "default_prefill_buckets"]

_MODES_ITEM = "ROADMAP.md, Queue 1, 'Serving: the other engine modes'"


class EngineShapeError(RuntimeError):
    """A shape outside the engine's bucket set was requested."""


def _layer(blocks, i):
    return {k: ({"q": v["q"][i], "s": v["s"][i]} if is_quantized(v)
                else v[i]) for k, v in blocks.items()}


def _kn(w, k):
    """A weight leaf as a ``[K, N]`` matrix (views, no copies)."""
    if is_quantized(w):
        return {"q": w["q"].reshape(k, -1), "s": w["s"].reshape(-1)}
    return w.reshape(k, -1)


def _mm(x, w):
    """``x [..., K]`` times a ``[K, N]`` weight leaf. A float leaf of
    another dtype than ``x`` promotes both, as ``jnp.einsum`` does (a
    compute dtype below the weights'). An int8 leaf runs the dequant-matmul
    kernel (f32 sums, the f32 scale on the sum, one rounding to ``x``'s
    dtype), where the JAX engine's auto-fusion puts ``int8_matmul``."""
    if not is_quantized(w):
        dt = torch.promote_types(x.dtype, w.dtype)
        return x.to(dt) @ w.to(dt)
    y = int8_matmul(x.reshape(-1, x.shape[-1]), w["q"], w["s"])
    return y.reshape(*x.shape[:-1], y.shape[-1])


def _logits(h, wte):
    """Logits ``[B, V]`` of ``h [B, 1, H]`` against the embedding table
    ``[V, H]``, read in its stored layout."""
    if not is_quantized(wte):
        return _mm(h, wte.t())[:, 0]
    return int8_matmul(h[:, 0], wte["q"], wte["s"], layout="nk")


def _emb(w, idx, dt):
    """Embedding rows, dequantized per row for an int8 leaf."""
    if not is_quantized(w):
        return w[idx]
    return w["q"][idx].to(dt) * w["s"][idx][..., None].to(dt)


def _dequant_block(p, dt):
    """One layer's int8 leaves back to ``dt`` (the bucketed prefill runs
    the float block on them, one layer at a time). With the layer axis
    sliced off, the reduced axes lead each leaf."""
    def dq(w):
        if not is_quantized(w):
            return w
        q, s = w["q"], w["s"]
        bshape = (1,) * (q.dim() - s.dim()) + tuple(s.shape)
        return (q.float() * s.reshape(bshape)).to(dt)
    return {k: dq(v) for k, v in p.items()}


def _row_before(x, n):
    """``x[:, n - 1:n]`` of ``x [1, S, H]`` (row 0 when ``n <= 0``), for
    ``n`` an int or a one-element integer tensor on x's device, picked on
    the device (nothing waits for the host)."""
    idx = torch.as_tensor(n, device=x.device).reshape(1).long()
    return x.index_select(1, (idx - 1).clamp_min(0))


def _compute_dtype(params, compute_dtype):
    if compute_dtype is not None:
        return compute_dtype
    wte = params["wte"]
    return wte["s"].dtype if is_quantized(wte) else wte.dtype


def _paged_layer(p, x, rows, k_pages, v_pages, attend, eps):
    """One decoder layer of the paged step functions on ``x [B, T, H]``:
    the new K/V (``T`` rows of each of ``B`` sequences) enter the layer's
    pages at ``rows [B * T]`` before ``attend(q, k_pages, v_pages)``
    (``q [B, T, nh, d]`` -> ``[B, T, nh, d]``) reads them; the block
    matmuls go through :func:`_mm`. ``k_pages``/``v_pages`` are one
    layer's pages, updated in place. Returns the layer's output."""
    B, T, H = x.shape
    nh, d = k_pages.shape[2:]
    h = _ln(x, p["ln1_w"], p["ln1_b"], eps)
    qkv = _mm(h, _kn(p["wqkv"], H)).reshape(B, T, 3, nh, d) + p["bqkv"]
    q, k, v = qkv.unbind(2)                              # [B, T, nh, d]
    k_pages.view(-1, nh, d).index_copy_(
        0, rows, k.reshape(-1, nh, d).to(k_pages.dtype))
    v_pages.view(-1, nh, d).index_copy_(
        0, rows, v.reshape(-1, nh, d).to(v_pages.dtype))
    attn = attend(q, k_pages, v_pages)
    o = _mm(attn.to(x.dtype).reshape(B, T, nh * d), _kn(p["wo"], nh * d))
    x = x + o + p["bo"]
    h2 = _ln(x, p["ln2_w"], p["ln2_b"], eps)
    u = F.gelu(_mm(h2, p["w1"]) + p["b1"], approximate="tanh")
    return x + _mm(u, p["w2"]) + p["b2"]


def decode_step_fn(params, k_pages, v_pages, tokens, positions, page_table,
                   seq_lens, generator=None, *, eps, temperature, top_k,
                   compute_dtype=None):
    """One continuous-batching decode step: for every (possibly idle)
    batch slot, embed the last token, write its K/V into the slot's page
    row, attend over the page table, and sample the next token.

    ``tokens``/``positions`` ``[B]`` (position = seq_len - 1);
    ``page_table`` ``[B, pages_per_seq]``; ``seq_lens`` ``[B]`` (0 = idle
    slot). ``k_pages``/``v_pages`` are updated in place. ``params`` may
    hold int8 leaves: the block matmuls and the logits then run the int8
    kernel. Returns the next tokens ``[B]`` int32."""
    blocks, wte, wpe = params["blocks"], params["wte"], params["wpe"]
    dt = _compute_dtype(params, compute_dtype)
    B = tokens.shape[0]
    ps = k_pages.shape[2]
    pos = positions.long().clamp_min(0)
    page_table = page_table.to(torch.int32)
    seq_lens = seq_lens.to(torch.int32)
    x = (_emb(wte, tokens.long(), dt) + _emb(wpe, pos, dt)).to(dt)[:, None, :]
    # destination page row of the token being decoded. Idle slots (pos 0,
    # an all-sink table) all write row 0 of the sink page, so the index
    # repeats and which write lands is unspecified: harmless only because
    # page 0 is never read unmasked.
    rows = page_table[torch.arange(B, device=pos.device), pos // ps].long() \
        * ps + pos % ps

    def attend(q, kp, vp):
        return paged_attention_decode(q[:, 0], kp, vp, page_table,
                                      seq_lens)[:, None]
    for i in range(k_pages.shape[0]):
        x = _paged_layer(_layer(blocks, i), x, rows, k_pages[i], v_pages[i],
                         attend, eps)
    h = _ln(x, params["lnf_w"], params["lnf_b"], eps)
    return sample_logits(_logits(h, wte), generator, temperature,
                         top_k).to(torch.int32)


def prefill_fn(params, k_pages, v_pages, ids, true_len, dest_rows,
               generator=None, *, eps, temperature, top_k, use_flash,
               compute_dtype=None):
    """Prefill one request (batch 1, prompt ``ids [1, S]`` padded to a
    bucket length): full causal forward, each layer's K/V scattered into
    the pool at ``dest_rows [S]`` (padding rows → sink page), first token
    sampled from position ``true_len - 1`` (an int or a one-element int
    tensor on the device). Int8 leaves are dequantized one layer at a time
    for the float block; the logits run the int8 kernel. Updates the pages
    in place and returns the token ``[1]`` int32."""
    blocks, wte, wpe = params["blocks"], params["wte"], params["wpe"]
    dt = _compute_dtype(params, compute_dtype)
    s = ids.shape[1]
    L, np_, ps, nkv, d = k_pages.shape
    rows = dest_rows.long()
    h = (_emb(wte, ids.long(), dt)
         + _emb(wpe, torch.arange(s, device=ids.device), dt)).to(dt)
    for i in range(L):
        h, k, v = gpt_block(_dequant_block(_layer(blocks, i), dt), h, eps,
                            use_flash=use_flash, return_kv=True)
        # pad positions all map into the sink page (repeated rows, any
        # write may land): page 0 is never read unmasked
        k_pages[i].view(np_ * ps, nkv, d).index_copy_(
            0, rows, k[0].to(k_pages.dtype))
        v_pages[i].view(np_ * ps, nkv, d).index_copy_(
            0, rows, v[0].to(v_pages.dtype))
    h_last = _ln(_row_before(h, true_len), params["lnf_w"], params["lnf_b"],
                 eps)
    return sample_logits(_logits(h_last, wte), generator, temperature,
                         top_k).to(torch.int32)


def chunk_prefill_fn(params, k_pages, v_pages, ids, q_offset, chunk_len,
                     page_table, dest_rows, generator=None, *, eps,
                     temperature, top_k, compute_dtype=None):
    """Prefill one chunk of a prompt (batch 1, ``ids [1, C]`` padded to the
    engine's chunk length): embed the chunk at absolute positions
    ``q_offset + i``, scatter its K/V into the sequence's pages
    (``dest_rows``; padding rows → sink), attend over the page table with
    the ragged chunk-prefill kernel (row ``i`` sees positions ``<=
    q_offset + i``, cached prefix pages included, so this one program is
    both the chunked-prefill tick and the prefix-cache suffix prefill),
    and sample a token at local index ``chunk_len - 1`` (meaningful on the
    last chunk only). ``q_offset``/``chunk_len`` are ints or one-element
    int tensors on the device, read there (the chunk kernel reads the
    offset from device memory), so one captured graph serves every chunk.
    Updates the pages in place and returns the token ``[1]`` int32."""
    blocks, wte, wpe = params["blocks"], params["wte"], params["wpe"]
    dt = _compute_dtype(params, compute_dtype)
    C = ids.shape[1]
    q_offset = torch.as_tensor(q_offset, dtype=torch.int32,
                               device=ids.device).reshape(1)
    max_pos = (wpe["q"] if is_quantized(wpe) else wpe).shape[0]
    positions = (q_offset.long() + torch.arange(C, device=ids.device)
                 ).clamp_max(max_pos - 1)
    x = (_emb(wte, ids.long(), dt) + _emb(wpe, positions, dt)[None]).to(dt)
    rows = dest_rows.long()
    page_table = page_table.to(torch.int32)

    def attend(q, kp, vp):
        return ragged_prefill_attention(q, kp, vp, page_table, q_offset)
    for i in range(k_pages.shape[0]):
        x = _paged_layer(_layer(blocks, i), x, rows, k_pages[i], v_pages[i],
                         attend, eps)
    h_last = _ln(_row_before(x, chunk_len), params["lnf_w"], params["lnf_b"],
                 eps)
    return sample_logits(_logits(h_last, wte), generator, temperature,
                         top_k).to(torch.int32)


def default_prefill_buckets(page_size, max_seq_len):
    """Doubling page-multiple prompt buckets covering max_seq_len."""
    buckets, b = [], max(int(page_size), 1)
    while b < max_seq_len:
        buckets.append(b)
        b *= 2
    buckets.append(int(max_seq_len))
    return tuple(sorted(set(buckets)))


def _resolve_aot(aot, device):
    """``aot=None`` → capture on CUDA, run eagerly on the CPU; ``aot=True``
    needs CUDA (CUDA graphs)."""
    if aot is None:
        return device.type == "cuda"
    if aot and device.type != "cuda":
        raise ValueError(f"aot=True captures CUDA graphs; device {device} "
                         f"runs eagerly (aot=False)")
    return bool(aot)


class ServingEngine:
    """See the module docstring. ``model`` is a GPT model (or anything
    :func:`stack_gpt_weights` takes); its weights' dtype is the compute
    dtype. ``device`` is CUDA unless ``"cpu"`` is asked for. ``aot`` (None:
    True on CUDA) captures the bucket programs as CUDA graphs at
    construction (:meth:`compile_buckets`)."""

    def __init__(self, model, config=None, *, page_size=16, num_pages=None,
                 max_seq_len=None, decode_buckets=(1, 2, 4, 8),
                 prefill_buckets=None, temperature=0.0, top_k=0, seed=0,
                 use_flash=None, device=None, aot=None,
                 quantize=None, prefill_chunk=None, prefix_cache=False,
                 disaggregated=False, autofuse=None):
        for name, value in (("disaggregated", disaggregated),
                            ("autofuse", autofuse)):
            if value:
                raise NotImplementedError(
                    f"{name}={value!r} is not ported yet ({_MODES_ITEM})")
        if quantize is not None and quantize != "int8":
            raise ValueError(f"quantize={quantize!r}: only 'int8' is "
                             f"supported")
        self.device = resolve_device(device)
        self.aot = _resolve_aot(aot, self.device)
        gpt = model.gpt if hasattr(model, "gpt") else model
        self.cfg: GPTConfig = config or gpt.config
        cfg = self.cfg
        self.params = _to_device(stack_gpt_weights(model), self.device)
        self.compute_dtype = self.params["wte"].dtype
        # quantize="int8": every matmul weight as int8 + per-channel f32
        # scales, so the weight-bound decode step streams int8
        self.quantize = quantize
        if quantize is not None:
            self.params = quantize_stacked_gpt_weights(self.params)
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
        # a suffix prefill starts mid-prompt, which only the offset-aware
        # chunk program does: prefix_cache implies chunking
        if prefix_cache and prefill_chunk is None:
            prefill_chunk = min(8 * page_size, self.prefill_buckets[-1])
        self.prefill_chunk = None
        if prefill_chunk is not None:
            c = int(prefill_chunk)
            if c < 1 or c % page_size:
                raise ValueError(
                    f"prefill_chunk {c} must be a positive multiple of "
                    f"page_size {page_size} (chunks scatter whole page "
                    f"rows)")
            self.prefill_chunk = c
        self.prefix_cache = PrefixCache(self.pool) if prefix_cache else None
        self._chunk_state: dict = {}   # seq_id -> in-flight chunked prefill
        self._cached_len: dict = {}    # seq_id -> prefix tokens reused
        # each sequence's pending token: sampled, its K/V not yet cached
        self._last_token: dict = {}
        self._programs = self._step_programs()
        self._graphs = None
        self.compile_s = 0.0
        if self.aot:
            self.compile_buckets()

    @classmethod
    def from_checkpoint(cls, path, config: GPTConfig, **kw):
        """Checkpoint → engine: ``path`` is a ``paddle.save``d GPT state
        dict (``GPTForPretraining`` keys, or bare ``GPTModel`` keys, which
        get the ``gpt.`` prefix), written by the port or by the JAX
        package. The model is built on the engine's device (``kw``'s
        ``device``, the card by default), loaded in f32 and handed with
        ``kw`` (``quantize="int8"`` and the rest) to the constructor."""
        from ..framework.io import load
        from ..models.convert import gpt_state_dict_from_numpy
        from ..models.gpt import GPTForPretraining, GPTModel
        resolve_device(kw.get("device"))     # no card: raise before reading
        state = load(path, return_numpy=True)
        if not any(k.startswith("gpt.") for k in state):
            state = {f"gpt.{k}": v for k, v in state.items()}
        model = GPTForPretraining(GPTModel(config, device=kw.get("device")))
        model.load_state_dict(gpt_state_dict_from_numpy(state), strict=True)
        return cls(model, config, **kw)

    # -------------------------------------------------------------- info
    def weight_bytes(self) -> int:
        """Device bytes of the stacked decode weights (int8 and scales
        when ``quantize="int8"``)."""
        leaves = []
        for v in list(self.params["blocks"].values()) + [
                self.params[k] for k in ("wte", "wpe", "lnf_w", "lnf_b")]:
            leaves += [v["q"], v["s"]] if is_quantized(v) else [v]
        return int(sum(t.numel() * t.element_size() for t in leaves))

    def decode_signatures(self) -> set:
        """The closed set of decode step shapes: ``(bucket,
        pages_per_seq)`` per decode bucket."""
        return {(b, self.pool.max_pages_per_seq)
                for b in self.decode_buckets}

    def prefill_signatures(self) -> set:
        """The closed set of prefill shapes this engine runs: ``("chunk",
        C, pages_per_seq)`` when chunked, else ``(1, bucket)`` per prefill
        bucket."""
        if self.prefill_chunk is not None:
            return {("chunk", self.prefill_chunk,
                     self.pool.max_pages_per_seq)}
        return {(1, sb) for sb in self.prefill_buckets}

    # ---------------------------------------------------- bucket programs
    def _step_programs(self):
        """The input shapes of every step program this engine serves, by
        key: ``("decode", bucket)``, and ``("prefill", bucket)`` or the one
        ``("chunk", C)``. The inputs are int32 tensors (views of one flat
        upload); ``self._<kind>_call(*inputs)`` runs the step and returns
        its tokens on the device. (Only shapes are kept on the engine: a
        bound method kept there would make the engine a reference cycle,
        freed by the garbage collector at any later moment, also in the
        middle of another engine's capture, which a graph's destruction
        invalidates.)"""
        pps = self.pool.max_pages_per_seq
        progs = {("decode", b): ((b,), (b,), (b, pps), (b,))
                 for b in self.decode_buckets}
        if self.prefill_chunk is not None:
            C = self.prefill_chunk
            progs["chunk", C] = ((1, C), (1,), (1,), (1, pps), (C,))
        else:
            for sb in self.prefill_buckets:
                progs["prefill", sb] = ((1, sb), (1,), (sb,))
        return progs

    def compile_buckets(self):
        """Capture every decode bucket's step and every prefill bucket's
        (on a chunked engine the one chunk program instead) as a CUDA
        graph, so that serving replays them (the JAX engine's AOT
        compile). Adds the wall time to ``compile_s``. The engine's
        generator and the kernels' launch counters are left where they
        were. A capture that fails raises; nothing falls back to eager
        execution. The prefix cache's copy-on-write page copy (two
        ``copy_`` calls) is not captured."""
        if self.device.type != "cuda":
            raise ValueError(f"compile_buckets captures CUDA graphs; device "
                             f"{self.device} runs eagerly")
        t0 = time.perf_counter()
        if self._graphs is None:
            self._graphs = BucketGraphs(
                self.device,
                self._generator if self.temperature > 0 else None)
        state = self._generator.get_state()
        try:
            for key, shapes in self._programs.items():
                if key not in self._graphs:
                    self._graphs.capture(key, shapes,
                                         getattr(self, f"_{key[0]}_call"))
        finally:
            self._generator.set_state(state)
        torch.cuda.synchronize(self.device)
        self.compile_s += time.perf_counter() - t0

    def graph_pool_bytes(self):
        """Device bytes held by the captured graphs' memory pool (0 with
        none captured; None where the allocator does not name pools)."""
        return 0 if self._graphs is None else self._graphs.pool_bytes()

    def _upload(self, key, flat):
        """The int32 inputs of program ``key``, packed in one flat array:
        staged into the static inputs of its graph when it has one, else
        copied to the device (a blocking copy, which waits for the
        stream). Returns the inputs, views of one buffer."""
        graph = None if self._graphs is None else self._graphs.get(key)
        if graph is not None:
            return graph.stage(flat)
        return unpack(self._put(flat), self._programs[key])

    def _run(self, key, inputs):
        """Program ``key`` on ``inputs``: its graph replayed when they are
        the graph's static inputs, else its step function run eagerly."""
        graph = None if self._graphs is None else self._graphs.get(key)
        if graph is not None and inputs is graph.inputs:
            return graph.replay()
        with torch.no_grad():
            return getattr(self, f"_{key[0]}_call")(*inputs)

    def status(self) -> dict:
        """Engine-side JSON snapshot: weights, buckets, modes, capture
        accounting (``compile_s``; ``aot_programs``, the graphs held: one a
        decode bucket, plus one a prefill bucket or the one chunk program;
        with the prefix cache one fewer than the JAX engine counts, whose
        copy-on-write page copy is a program of its own), pool occupancy and
        the prefix cache."""
        st = {
            "device": str(self.device),
            "compute_dtype": str(self.compute_dtype).replace("torch.", ""),
            "quantize": self.quantize,
            "weights_mb": round(self.weight_bytes() / 2 ** 20, 2),
            "decode_buckets": list(self.decode_buckets),
            "prefill_buckets": list(self.prefill_buckets),
            "flash_prefill_buckets": [sb for sb, on in
                                      self._use_flash.items() if on],
            "prefill_chunk": self.prefill_chunk,
            "max_seq_len": self.max_seq_len,
            "compile_s": round(self.compile_s, 3),
            "aot_programs": len(self._graphs or ()),
            "pool": self.pool.stats(),
        }
        if self.prefix_cache is not None:
            st["prefix_cache"] = self.prefix_cache.stats()
        return st

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

    def reclaim_cache_pages(self, n_pages: int) -> int:
        """Evict LRU prefix-cache entries until ``n_pages`` went back to
        the free list (0 without a cache): cached pages are free capacity
        until a request needs them."""
        if self.prefix_cache is None:
            return 0
        return self.prefix_cache.reclaim(int(n_pages))

    # ------------------------------------------------------------- steps
    def _put(self, arr):
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)

    def _check_prompt(self, prompt_ids) -> np.ndarray:
        prompt = np.asarray(prompt_ids, dtype=np.int32).reshape(-1)
        n = int(prompt.shape[0])
        if n + 1 > self.max_seq_len:
            raise EngineShapeError(
                f"prompt of {n} tokens leaves no room to decode within "
                f"max_seq_len {self.max_seq_len}")
        if n and (prompt.min() < 0 or prompt.max() >= self.cfg.vocab_size):
            raise ValueError(f"prompt token ids must lie in [0, "
                             f"{self.cfg.vocab_size})")
        return prompt

    def _step_kw(self):
        return dict(eps=self.cfg.layer_norm_epsilon,
                    temperature=self.temperature, top_k=self.top_k,
                    compute_dtype=self.compute_dtype)

    def prefill(self, seq_id, prompt_ids) -> int:
        """Allocate pages for ``prompt_ids``, run the prefill (bucketed, or
        chunk by chunk on a chunked engine), return the first generated
        token."""
        if self.prefill_chunk is not None:
            self.prefill_begin(seq_id, prompt_ids)
            while True:
                _, done, tok = self.prefill_step(seq_id)
                if done:
                    return tok
        prompt = self._check_prompt(prompt_ids)
        n = int(prompt.shape[0])
        sb = self.prefill_bucket(n)
        self.pool.alloc(seq_id, n)
        flat = np.zeros(2 * sb + 1, np.int32)      # ids, true_len, rows
        flat[:n] = prompt
        flat[sb] = n
        flat[sb + 1:] = self.pool.prefill_rows(seq_id, sb)
        key = ("prefill", sb)
        tok = int(self._run(key, self._upload(key, flat))[0])
        self._last_token[seq_id] = tok
        return tok

    def _prefill_call(self, ids, true_len, rows):
        return prefill_fn(
            self.params, self.pool.k_pages, self.pool.v_pages, ids, true_len,
            rows, self._generator, use_flash=self._use_flash[ids.shape[1]],
            **self._step_kw())

    def _chunk_call(self, ids, q_offset, chunk_len, table, rows):
        return chunk_prefill_fn(
            self.params, self.pool.k_pages, self.pool.v_pages, ids, q_offset,
            chunk_len, table, rows, self._generator, **self._step_kw())

    def _decode_call(self, tokens, positions, table, lens):
        return decode_step_fn(
            self.params, self.pool.k_pages, self.pool.v_pages, tokens,
            positions, table, lens, self._generator, **self._step_kw())

    # ----------------------------------------- chunked / cached prefill
    def prefill_begin(self, seq_id, prompt_ids) -> int:
        """Start a chunked prefill: match the prefix cache (the longest
        cached prefix maps into the new page table; a mid-page match copies
        the boundary page), allocate the remaining pages, and queue the
        rest of the prompt for :meth:`prefill_step`. Returns the cached
        prefix length (0 without a cache or on a miss)."""
        if self.prefill_chunk is None:
            raise EngineShapeError("prefill_begin requires a chunked engine "
                                   "(prefill_chunk=...)")
        prompt = self._check_prompt(prompt_ids)
        n = int(prompt.shape[0])
        cached_len = 0
        if self.prefix_cache is not None:
            cache = self.prefix_cache
            nodes, boundary, cached_len = cache.match(prompt)
            pages = cache.map_into(seq_id, nodes, boundary)
            cow = None
            try:
                if boundary is not None:
                    cow = self.pool._take_page()
                    src = boundary[0].page
                    for t in (self.pool.k_pages, self.pool.v_pages):
                        t[:, cow].copy_(t[:, src])
                    pages = pages + [cow]
                self.pool.alloc_prefixed(seq_id, n, pages, cached_len)
            except Exception:
                # the shared pages stay the cache's (map_into only pinned
                # them); only the copy-on-write page goes back
                cache.release(seq_id)
                if cow is not None:
                    self.pool.decref([cow])
                raise
            if cow is not None:
                # alloc_prefixed took the sequence's reference on the copy;
                # drop the engine's, so the copy is the sequence's alone
                self.pool.decref([cow])
        else:
            self.pool.note_prefix_lookup(0)
            self.pool.alloc(seq_id, n)
        self._chunk_state[seq_id] = {"prompt": prompt, "pos": cached_len,
                                     "n": n}
        self._cached_len[seq_id] = cached_len
        return cached_len

    def prefill_step(self, seq_id):
        """Run one chunk of an in-flight prefill. Returns ``(tokens
        processed, done, first token or None)``: the scheduler spends its
        per-tick prefill budget on these, so a long prompt interleaves with
        decode steps instead of stalling them."""
        st = self._chunk_state[seq_id]
        C = self.prefill_chunk
        start, n = st["pos"], st["n"]
        clen = min(C, n - start)
        pps = self.pool.max_pages_per_seq
        # ids, q_offset, chunk_len, page table, rows
        flat = np.zeros(2 * C + 2 + pps, np.int32)
        flat[:clen] = st["prompt"][start:start + clen]
        flat[C:C + 2] = start, clen
        flat[C + 2:C + 2 + pps] = self.pool.table_array([seq_id])[0]
        flat[C + 2 + pps:] = self.pool.chunk_rows(seq_id, start, C)
        key = ("chunk", C)
        tok = self._run(key, self._upload(key, flat))
        st["pos"] = start + clen
        if st["pos"] < n:
            return clen, False, None
        tok = int(tok[0])
        self._last_token[seq_id] = tok
        del self._chunk_state[seq_id]
        if self.prefix_cache is not None:
            # the prompt's full pages now hold their K/V: publish them so
            # queued requests with the same prefix hit them
            self.prefix_cache.insert(st["prompt"], self.pool.table(seq_id))
        return clen, True, tok

    def cached_prefix_len(self, seq_id) -> int:
        """Tokens this sequence reused from the prefix cache."""
        return self._cached_len.get(seq_id, 0)

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
        last tokens, positions, page table and lengths ``[bucket, ...]``,
        in one copy (:meth:`_upload`: into the bucket's graph inputs, or a
        blocking copy that waits for the stream)."""
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
        flat = np.concatenate([tokens, positions, table.reshape(-1), lens])
        return self._upload(("decode", bucket), flat)

    def _launch_decode(self, inputs):
        """Launch one decode step on uploaded ``inputs`` (replaying the
        bucket's graph when they are its inputs); returns the next tokens
        ``[bucket]`` on the device without waiting for them."""
        return self._run(("decode", inputs[0].shape[0]), inputs)

    def release(self, seq_id, token_ids=None):
        """Free a finished sequence. With a prefix cache, ``token_ids``
        (the prompt and the generated tokens whose K/V entered the pool:
        all but the last sampled one) first publishes the sequence's full
        pages, so follow-up turns and repeated completions hit them."""
        self._last_token.pop(seq_id, None)
        self._chunk_state.pop(seq_id, None)
        self._cached_len.pop(seq_id, None)
        if self.prefix_cache is not None:
            if token_ids is not None and len(token_ids):
                ids = np.asarray(token_ids, np.int32).reshape(-1)
                valid = min(int(ids.shape[0]), self.pool.seq_len(seq_id))
                self.prefix_cache.insert(ids[:valid],
                                         self.pool.table(seq_id))
            self.prefix_cache.release(seq_id)
        self.pool.free(seq_id)


def _to_device(tree, device):
    """A tree of dicts and tuples of tensors, moved to ``device``."""
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_to_device(v, device) for v in tree)
    return tree.to(device)
