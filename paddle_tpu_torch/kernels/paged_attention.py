"""Paged attention over the serving pool: hand-written CUDA kernels and
their plain versions.

Counterpart of ``paddle_tpu/kernels/paged_attention.py``. Two kernels
replace the two Pallas kernels there:

- ``csrc/paged_attention_decode.cu`` (``_decode_kernel``): one new token
  per sequence, :func:`paged_attention_decode`;
- ``csrc/paged_attention_prefill.cu`` (``_prefill_kernel``): a prompt
  chunk at a runtime offset, :func:`ragged_prefill_attention`, whose
  plain version is the XLA path :func:`paged_prefill_attention`;
  :func:`ragged_prefill_reference` is a second plain version that keeps
  the kernel's own rounding points, to hold the bf16 kernel tightly.
  bf16 runs P V on the tensor cores (``csrc/attention_fwd_tc.cuh``), f32
  the CUDA-core kernel of ``csrc/paged_attention_prefill.cuh``.

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

The TPU wrapper's pool-wide pad of d to 128 lanes is not ported: the
kernels take any head dim ``0 < d <= 128`` and mask the columns past d
inside (``_build.instance_head_dim``).

Dispatch: CPU tensors take the plain version; CUDA tensors launch the
kernel or raise. ``launches`` counts decode kernel launches,
``prefill_launches`` chunk-prefill kernel launches.
"""
from __future__ import annotations

import math

import torch

from . import _build

__all__ = ["paged_attention_decode", "paged_attention_reference",
           "ragged_prefill_attention", "paged_prefill_attention",
           "ragged_prefill_reference"]

_NEG_INF = -1e30
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_SMEM = 232448           # bytes of shared memory a block may use (H100)

# kernel launches since each counter was last set to 0: decode, chunk prefill
launches = 0
prefill_launches = 0


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
    kd = _build.instance_head_dim(d)
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
    # at an instance's own width the pages are read with 16-byte loads
    if q.stride(-1) != 1 or (d == kd and any(t.data_ptr() % 16
                                             for t in (k_pages, v_pages))):
        raise ValueError("paged decode kernel needs unit stride along d "
                         "and 16-byte aligned pages")
    if k_pages.numel() >= 2 ** 40:
        raise ValueError("pool too large for the kernel's indexing")
    smem = _smem_bytes(nh // nkv, kd, ps)
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


# ------------------------------------------------------------ chunk prefill

def paged_prefill_attention(q, k_pages, v_pages, page_table, q_offset,
                            scale=None):
    """Chunk prefill attention over the pool, plain PyTorch: the JAX XLA
    path line by line. ``q`` ``[B, C, num_heads, d]``, row ``i`` at
    absolute position ``q_offset + i``; pages and table as for decode.
    Row ``i`` attends the positions ``<= q_offset + i``; the chunk's own
    K/V must already be in the pages. The pages are gathered dense, the
    scores divided by sqrt(d) in the compute dtype (or times ``scale``),
    masked with -1e30, softmaxed in f32 and cast back before P.V."""
    B, C, nh, d = q.shape
    _, ps, nkv, _ = k_pages.shape
    g = nh // nkv
    t = page_table.shape[1] * ps
    idx = page_table.long()
    k = k_pages[idx].reshape(B, t, nkv, d)
    v = v_pages[idx].reshape(B, t, nkv, d)
    if g > 1:
        k = k.repeat_interleave(g, dim=2)
        v = v.repeat_interleave(g, dim=2)
    logits = torch.einsum("bsnd,btnd->bnst", q, k)
    logits = logits / math.sqrt(d) if scale is None else logits * scale
    row = int(q_offset) + torch.arange(C, device=q.device)[:, None]
    col = torch.arange(t, device=q.device)[None, :]
    logits = logits.masked_fill(~(col <= row), _NEG_INF)
    probs = torch.softmax(logits.float(), -1).to(q.dtype)
    return torch.einsum("bnst,btnd->bsnd", probs, v)


def ragged_prefill_reference(q, k_pages, v_pages, page_table, q_offset,
                             scale=None, block=64, round_p=True):
    """Plain PyTorch version of the chunk-prefill kernel with the kernel's
    own rounding points (same arguments as :func:`paged_prefill_attention`,
    ``num_heads == num_kv_heads``): positions in blocks of ``block`` (the
    CUDA kernel's tile; the TPU kernel's block is a page), an f32 online
    softmax over the blocks, S = Q.K^T in f32 times ``scale`` in f32, P =
    exp(S - m) rounded to V's dtype before P.V while l sums the unrounded
    P, O = acc / max(l, 1e-30) rounded once. ``round_p=False`` keeps P in
    f32: a control that a bf16 limit must tell from the kernel."""
    B, C, nh, d = q.shape
    ps = k_pages.shape[1]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    t = min(page_table.shape[1] * ps, int(q_offset) + C)
    idx = page_table.long()
    k = k_pages[idx].reshape(B, -1, nh, d)[:, :t].float()
    v = v_pages[idx].reshape(B, -1, nh, d)[:, :t]
    qf = q.float()
    row = int(q_offset) + torch.arange(C, device=q.device)[:, None]
    m = torch.full((B, nh, C, 1), _NEG_INF, device=q.device)
    l = torch.zeros((B, nh, C, 1), device=q.device)
    acc = torch.zeros((B, nh, C, d), device=q.device)
    for k0 in range(0, t, block):
        s = torch.einsum("bsnd,btnd->bnst", qf, k[:, k0:k0 + block]) * scale
        col = k0 + torch.arange(s.shape[-1], device=q.device)[None, :]
        s = s.masked_fill(~(col <= row), _NEG_INF)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.exp(s - m_new)
        corr = torch.exp(m - m_new)
        l = corr * l + p.sum(-1, keepdim=True)
        pv = p.to(v.dtype).float() if round_p else p
        acc = corr * acc + torch.einsum("bnst,btnd->bnsd", pv,
                                        v[:, k0:k0 + block].float())
        m = m_new
    return (acc / l.clamp_min(1e-30)).transpose(1, 2).to(q.dtype)


def _launch_prefill(q, k_pages, v_pages, page_table, q_offset, scale):
    global prefill_launches
    B, C, nh, d = q.shape
    num_pages, ps, nkv, _ = k_pages.shape
    dev = q.device
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages),
                    ("page_table", page_table)):
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, q on {dev}")
    if q.dtype not in _DTYPE_CODES or k_pages.dtype != q.dtype \
            or v_pages.dtype != q.dtype:
        raise TypeError(f"chunk prefill kernel takes float32 or bfloat16 "
                        f"q and pages of one dtype, got {q.dtype}, "
                        f"{k_pages.dtype}, {v_pages.dtype}")
    kd = _build.instance_head_dim(d)
    if k_pages.shape != v_pages.shape or k_pages.shape[3] != d:
        raise ValueError(f"pages {tuple(k_pages.shape)} / "
                         f"{tuple(v_pages.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if not (k_pages.is_contiguous() and v_pages.is_contiguous()):
        raise ValueError("chunk prefill kernel needs contiguous pages")
    if page_table.dtype != torch.int32 or not page_table.is_contiguous() \
            or page_table.dim() != 2 or page_table.shape[0] != B:
        raise TypeError(f"page_table must be a contiguous int32 [{B}, "
                        f"pages_per_seq], got {page_table.dtype} "
                        f"{tuple(page_table.shape)}")
    # at an instance's own width q's rows and the pages are read with
    # 16-byte loads
    vec = 16 // q.element_size()
    if q.stride(-1) != 1 or d == kd and (
            any(s % vec for s in q.stride()[:3])
            or any(t.data_ptr() % 16 for t in (q, k_pages, v_pages))):
        raise ValueError("chunk prefill kernel needs q with unit stride "
                         "along d, 16-byte aligned rows and pages")
    if k_pages.numel() >= 2 ** 40 or max(q.stride()[:3]) * max(B, C, nh) \
            >= 2 ** 31:
        raise ValueError("pool or q too large for the kernel's indexing")
    if B * nh >= 65536:
        raise ValueError(f"batch x heads {B * nh} exceeds the grid limit")
    out = torch.empty((B, C, nh, d), dtype=q.dtype, device=dev)
    lib = _build.load_library()
    with torch.cuda.device(dev):
        err = lib.ptt_paged_attention_prefill(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            page_table.data_ptr(), out.data_ptr(), _DTYPE_CODES[q.dtype], B,
            C, nh, d, ps, page_table.shape[1], q.stride(0), q.stride(1),
            q.stride(2), int(q_offset), float(scale),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "ragged_prefill_attention")
    prefill_launches += 1
    return out


def ragged_prefill_attention(q, k_pages, v_pages, page_table, q_offset,
                             scale=None):
    """Chunk prefill attention through the page table, the kernel path of
    :func:`paged_prefill_attention` (same arguments): on CUDA the kernel
    walks each sequence's pages up to the last position its chunk can see
    and never gathers the pool dense; the scale multiplies the f32 scores
    and P is rounded to V's dtype before P.V, as in the TPU kernel. Needs
    ``num_heads == num_kv_heads``. ``q_offset`` is an int (>= 0)."""
    nh, nkv = q.shape[2], k_pages.shape[2]
    if nh != nkv:
        raise ValueError(f"ragged_prefill_attention needs num_heads ({nh}) "
                         f"== num_kv_heads ({nkv})")
    if int(q_offset) < 0:
        raise ValueError(f"q_offset {q_offset} must be >= 0")
    ts = (q, k_pages, v_pages, page_table)
    if all(t.device.type == "cpu" for t in ts):
        return paged_prefill_attention(q, k_pages, v_pages, page_table,
                                       q_offset, scale)
    if not q.is_cuda:
        raise ValueError(f"chunk prefill runs on CUDA or CPU tensors, got "
                         f"{q.device}")
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    return _launch_prefill(q, k_pages, v_pages, page_table, q_offset, scale)
