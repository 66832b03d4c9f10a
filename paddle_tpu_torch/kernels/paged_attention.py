"""Ragged paged-attention decode: a hand-written CUDA kernel and its plain
version.

Counterpart of ``paddle_tpu/kernels/paged_attention.py`` (the decode kernel;
the chunk-prefill kernel is still to be ported). The kernel is
``csrc/paged_attention_decode.cu``; it replaces the Pallas
``_decode_kernel``.

Layout contract, as in the JAX package:

- ``q`` ``[B, num_heads, d]`` — the new token's queries (unit stride
  along d; a slice of the fused QKV projection goes in without a copy);
- ``k_pages``/``v_pages`` ``[num_pages, page_size, num_kv_heads, d]`` —
  one layer of the pool. Page 0 is the pool's sink page, never read
  unmasked;
- ``page_table`` ``[B, pages_per_seq]`` int32;
- ``seq_lens`` ``[B]`` int32 — true lengths including the token being
  decoded (its K/V already written); 0 marks an idle slot whose output row
  is finite and discarded.

The TPU wrapper's pool-wide pad of d to 128 lanes is not ported.

Dispatch: CPU tensors take :func:`paged_attention_reference`; CUDA tensors
launch the kernel or raise. ``launches`` counts kernel launches.
"""
from __future__ import annotations

import math

import torch

from . import _build

__all__ = ["paged_attention_decode", "paged_attention_reference",
           "KERNEL_HEAD_DIMS"]

KERNEL_HEAD_DIMS = (64, 128)
_NEG_INF = -1e30
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_SMEM = 232448           # bytes of shared memory a block may use (H100)

# kernel launches since the counter was last set to 0
launches = 0


def paged_attention_reference(q, k_pages, v_pages, page_table, seq_lens,
                              scale=None):
    """Plain PyTorch version (mirrors the JAX ``paged_attention_reference``):
    gather the pages dense, repeat KV heads for GQA, f32 scores, mask to
    each sequence's length, f32 softmax, f32 P.V, cast to q's dtype."""
    B, nh, d = q.shape
    _, ps, nkv, _ = k_pages.shape
    if nh % nkv:
        raise ValueError(f"num_heads {nh} must be a multiple of "
                         f"num_kv_heads {nkv}")
    g = nh // nkv
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    t = page_table.shape[1] * ps
    idx = page_table.long()
    k = k_pages[idx].reshape(B, t, nkv, d)
    v = v_pages[idx].reshape(B, t, nkv, d)
    if g > 1:
        k = k.repeat_interleave(g, dim=2)
        v = v.repeat_interleave(g, dim=2)
    s = torch.einsum("bnd,btnd->bnt", q.float(), k.float()) * scale
    mask = (torch.arange(t, device=q.device)[None, None, :]
            < seq_lens.long()[:, None, None])
    s = torch.where(mask, s, torch.full_like(s, _NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bnt,btnd->bnd", p, v.float()).to(q.dtype)


def _smem_bytes(g, d, ps):
    return 4 * (g * d + ps * (d + 1) + ps * d + g * ps + g * d + 2 * g)


def _launch(q, k_pages, v_pages, page_table, seq_lens, scale):
    global launches
    B, nh, d = q.shape
    num_pages, ps, nkv, _ = k_pages.shape
    dev = q.device
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages),
                    ("page_table", page_table), ("seq_lens", seq_lens)):
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, q on {dev}")
    if q.dtype not in _DTYPE_CODES or k_pages.dtype != q.dtype \
            or v_pages.dtype != q.dtype:
        raise TypeError(f"paged decode kernel takes float32 or bfloat16 "
                        f"q and pages of one dtype, got {q.dtype}, "
                        f"{k_pages.dtype}, {v_pages.dtype}")
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {KERNEL_HEAD_DIMS}")
    if k_pages.shape != v_pages.shape or k_pages.shape[3] != d:
        raise ValueError(f"pages {tuple(k_pages.shape)} / "
                         f"{tuple(v_pages.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if not (k_pages.is_contiguous() and v_pages.is_contiguous()):
        raise ValueError("paged decode kernel needs contiguous pages")
    if page_table.dtype != torch.int32 or seq_lens.dtype != torch.int32 \
            or not page_table.is_contiguous() \
            or not seq_lens.is_contiguous():
        raise TypeError("page_table and seq_lens must be contiguous int32")
    if page_table.dim() != 2 or page_table.shape[0] != B \
            or tuple(seq_lens.shape) != (B,):
        raise ValueError(f"page_table {tuple(page_table.shape)} / seq_lens "
                         f"{tuple(seq_lens.shape)} do not match batch {B}")
    vec = 16 // q.element_size()
    if q.stride(-1) != 1 or any(t.data_ptr() % 16
                                for t in (k_pages, v_pages)):
        raise ValueError("paged decode kernel needs unit stride along d "
                         "and 16-byte aligned pages")
    if k_pages.numel() >= 2 ** 40 or d % vec:
        raise ValueError("pool too large or head dim not a 16-byte multiple")
    smem = _smem_bytes(nh // nkv, d, ps)
    if smem > _MAX_SMEM:
        raise ValueError(f"page_size {ps} x head dim {d} needs {smem} bytes "
                         f"of shared memory (> {_MAX_SMEM})")
    if B >= 65536:
        raise ValueError(f"batch {B} exceeds the grid limit")
    out = torch.empty((B, nh, d), dtype=q.dtype, device=dev)
    lib = _build.load_library()
    with torch.cuda.device(dev):
        err = lib.ptt_paged_attention_decode(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            page_table.data_ptr(), seq_lens.data_ptr(), out.data_ptr(),
            _DTYPE_CODES[q.dtype], B, nh, nkv, d, ps, page_table.shape[1],
            q.stride(0), q.stride(1), float(scale),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "paged_attention_decode")
    launches += 1
    return out


def paged_attention_decode(q, k_pages, v_pages, page_table, seq_lens,
                           scale=None):
    """Single-token decode attention over a paged KV cache. ``q`` ``[B,
    num_heads, d]``; pages ``[num_pages, page_size, num_kv_heads, d]``
    (num_kv_heads may divide num_heads); ``page_table`` ``[B,
    pages_per_seq]`` int32; ``seq_lens`` ``[B]`` int32 (0 = idle slot).
    Returns ``[B, num_heads, d]``."""
    nh, nkv = q.shape[1], k_pages.shape[2]
    if nh % nkv:
        raise ValueError(f"num_heads {nh} must be a multiple of "
                         f"num_kv_heads {nkv}")
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    ts = (q, k_pages, v_pages, page_table, seq_lens)
    if all(t.device.type == "cpu" for t in ts):
        return paged_attention_reference(q, k_pages, v_pages, page_table,
                                         seq_lens, scale)
    if not q.is_cuda:
        raise ValueError(f"paged decode runs on CUDA or CPU tensors, got "
                         f"{q.device}")
    return _launch(q, k_pages, v_pages, page_table, seq_lens, scale)
