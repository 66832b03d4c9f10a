"""Paged attention over the serving pool: hand-written CUDA kernels and
their plain versions.

Counterpart of ``paddle_tpu/kernels/paged_attention.py``. Two kernels
replace the two Pallas kernels there:

- ``csrc/paged_attention_decode.cu(h)`` (``_decode_kernel``): one new
  token per sequence, :func:`paged_attention_decode`, each page walk split
  over blocks (flash-decoding); :func:`paged_decode_split_reference` is a
  second plain version in the kernel's own form (its splits, its warps'
  states, where P is rounded and the order of the merges);
- ``csrc/paged_attention_prefill.cu`` (``_prefill_kernel``): a prompt
  chunk at an offset that the kernel reads from device memory (the TPU
  kernel's scalar-prefetch operand), :func:`ragged_prefill_attention`, whose
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
           "paged_decode_split_reference",
           "ragged_prefill_attention", "paged_prefill_attention",
           "ragged_prefill_reference"]

_NEG_INF = -1e30
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_SMEM = 49152            # static shared memory a block may use

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


# the decode kernel (csrc/paged_attention_decode.cuh): warps a block, the
# blocks a decode step should give each SM where the pages allow (4, timed
# alone, ran bucket 8 faster than 2, but inside the serving engine's
# decode step it took 6.49 ms of 16 steps' device time against 5.57 with
# 2 on an H100: PERF.md), and the most blocks a walk is split over (a
# thread-block cluster)
_DECODE_WARPS = 4
_BLOCKS_PER_SM = 2
_MAX_SPLIT = 8


def _head_instance(g):
    """The query heads a decode block takes for a group of ``g`` (the
    kernel's ``head_instance``): 1, 2, 4 or 8; larger groups run in
    ``ceil(g / 8)`` blocks of 8."""
    return 1 if g <= 1 else 2 if g <= 2 else 4 if g <= 4 else 8


def _decode_step(itemsize, d, g):
    """Positions a warp takes at a time (the kernel's ``Walk::STEP``) for
    elements of ``itemsize`` bytes, head dim ``d`` (its instance) and group
    ``g``: 16-byte loads, ``d / vec`` lanes to a row, up to 16 rows a step
    and ``8 / G`` load instructions a lane."""
    vec = 16 // itemsize
    rpi = 32 // (_build.instance_head_dim(d) // vec)
    return max(1, min(8 // _head_instance(g), 16 // rpi)) * rpi


def _decode_split(B, nkv, g, pps, sms):
    """Blocks each (sequence, KV head) walk is split over, from host-known
    shapes only (never ``seq_lens``, which live on the device): at least
    ``_BLOCKS_PER_SM`` blocks an SM where the table's pages and the
    cluster's ``_MAX_SPLIT`` blocks allow, each split a whole number of
    pages."""
    units = B * nkv * -(-g // _head_instance(g))
    want = min(pps, _MAX_SPLIT, -(-_BLOCKS_PER_SM * sms // units))
    if want <= 1:
        return 1
    per = max(pps // want, -(-pps // _MAX_SPLIT))     # pages a split
    return -(-pps // per)


_sm_counts: dict = {}


def _sm_count(dev):
    if dev not in _sm_counts:
        _sm_counts[dev] = torch.cuda.get_device_properties(
            dev).multi_processor_count
    return _sm_counts[dev]


def _smem_bytes(g, d, ps):
    """Shared memory of a decode block: each warp's (m, l, acc[d]) for the
    block's query heads, and the block's merged state that the cluster
    reads. No page is staged, so the page size ``ps`` does not enter."""
    return 4 * (_DECODE_WARPS + 1) * _head_instance(g) * (d + 2)


def paged_decode_split_reference(q, k_pages, v_pages, page_table, seq_lens,
                                 scale=None, n_split=1, step=None):
    """Plain PyTorch version of the decode kernel in its own form (same
    arguments as :func:`paged_attention_decode`): each (sequence, KV head)
    walk cut into ``n_split`` splits of ``ceil(pps / n_split)`` pages, each
    split's positions taken ``step`` at a time (default: the kernel's
    ``_decode_step``) by 4 warps in turn, each warp an f32 online softmax of
    its own whose P = exp(S - m) is rounded to V's dtype against that
    warp's running max before P.V (l sums the unrounded P); the warps'
    states merged in warp order, then the splits' in split order (m the
    max, l and acc rescaled by exp(m_i - m)); O = acc / max(l, 1e-30)
    rounded once. f32 scores scaled after the product, -1e30 for masked
    keys; a length past the table's reach reads only the table's pages."""
    B, nh, d = q.shape
    _, ps, nkv, _ = k_pages.shape
    g = nh // nkv
    pps = page_table.shape[1]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    if step is None:
        step = _decode_step(q.element_size(), d, g)
    t = pps * ps
    span = -(-pps // n_split) * ps
    idx = page_table.long()
    k = k_pages[idx].reshape(B, t, nkv, d)
    v = v_pages[idx].reshape(B, t, nkv, d)
    if g > 1:
        k = k.repeat_interleave(g, dim=2)
        v = v.repeat_interleave(g, dim=2)
    s_all = torch.einsum("bnd,btnd->bnt", q.float(), k.float()) * scale
    vf = v.float().transpose(1, 2)                           # [B, nh, t, d]
    tmax = seq_lens.long().clamp(max=t)[:, None, None]       # [B, 1, 1]
    dev = q.device

    def empty():
        return (torch.full((B, nh, 1), _NEG_INF, device=dev),
                torch.zeros((B, nh, 1), device=dev),
                torch.zeros((B, nh, d), device=dev))

    def merge(states):
        mm = torch.stack([m for m, _, _ in states]).amax(0)
        ll, aa = torch.zeros_like(mm), torch.zeros((B, nh, d), device=dev)
        for m, l, a in states:
            e = torch.exp(m - mm)
            ll = ll + e * l
            aa = aa + e * a
        return mm, ll, aa

    splits = []
    for t0 in range(0, t, span):
        t1 = min(t0 + span, t)
        warps = [empty() for _ in range(_DECODE_WARPS)]
        for j, base in enumerate(range(t0, t1, step)):
            m, l, a = warps[j % _DECODE_WARPS]
            pos = torch.arange(base, min(base + step, t1), device=dev)
            live = pos[None, None, :] < tmax                 # [B, 1, r]
            s = torch.where(live, s_all[:, :, pos], _NEG_INF)
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            p = torch.exp(s - m_new)
            corr = torch.exp(m - m_new)
            vv = torch.where(live[..., None], vf[:, :, pos], 0.0)
            pv = torch.einsum("bnt,bntd->bnd", p.to(v.dtype).float(), vv)
            ran = base < tmax                                # [B, 1, 1]
            warps[j % _DECODE_WARPS] = (
                torch.where(ran, m_new, m),
                torch.where(ran, corr * l + p.sum(-1, keepdim=True), l),
                torch.where(ran, corr * a + pv, a))
        splits.append(merge(warps))
    _, ll, aa = merge(splits)
    return (aa / ll.clamp_min(1e-30)).to(q.dtype)


def _launch(q, k_pages, v_pages, page_table, seq_lens, scale, n_split=None):
    """Launch the decode kernel; ``n_split`` overrides the wrapper's split
    of each page walk (``_decode_split``)."""
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
        raise ValueError(f"head dim {d} x group {nh // nkv} needs {smem} "
                         f"bytes of shared memory (> {_MAX_SMEM})")
    pps = page_table.shape[1]
    g = nh // nkv
    if B >= 65536 or nkv * -(-g // _head_instance(g)) >= 65536:
        raise ValueError(f"batch {B} or KV heads {nkv} exceed the grid limit")
    if n_split is None:
        n_split = _decode_split(B, nkv, g, pps, _sm_count(dev))
    if not 1 <= n_split <= min(pps, _MAX_SPLIT):
        raise ValueError(f"n_split {n_split} outside 1..{min(pps, _MAX_SPLIT)}")
    out = torch.empty((B, nh, d), dtype=q.dtype, device=dev)
    lib = _build.load_library()
    with torch.cuda.device(dev):
        err = lib.ptt_paged_attention_decode(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            page_table.data_ptr(), seq_lens.data_ptr(), out.data_ptr(),
            _DTYPE_CODES[q.dtype], B, nh, nkv, d, ps, pps, n_split,
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

def _rows_at(q_offset, C, device):
    """The absolute positions ``[C, 1]`` of a chunk's rows, ``q_offset``
    an int or a 0-d or one-element integer tensor on ``device`` (read
    there, never on the host)."""
    if isinstance(q_offset, torch.Tensor):
        q_offset = q_offset.reshape(-1)[0].long()
    return (q_offset + torch.arange(C, device=device))[:, None]


def paged_prefill_attention(q, k_pages, v_pages, page_table, q_offset,
                            scale=None):
    """Chunk prefill attention over the pool, plain PyTorch: the JAX XLA
    path line by line. ``q`` ``[B, C, num_heads, d]``, row ``i`` at
    absolute position ``q_offset + i`` (an int or a 0-d or one-element
    integer tensor on q's device); pages and table as for decode.
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
    row = _rows_at(q_offset, C, q.device)
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
    f32: a control that a bf16 limit must tell from the kernel.

    An int offset stops the walk at the chunk's last visible position, as
    the kernel does. A tensor offset is never read on the host, so every
    block of the table is walked: a block past the chunk's last row is
    masked whole, its P is 0 and its rescale 1."""
    B, C, nh, d = q.shape
    ps = k_pages.shape[1]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    t = page_table.shape[1] * ps
    if not isinstance(q_offset, torch.Tensor):
        t = min(t, int(q_offset) + C)
    idx = page_table.long()
    k = k_pages[idx].reshape(B, -1, nh, d)[:, :t].float()
    v = v_pages[idx].reshape(B, -1, nh, d)[:, :t]
    qf = q.float()
    row = _rows_at(q_offset, C, q.device)
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
    if not isinstance(q_offset, torch.Tensor):
        # an int offset is written to the device by a fill kernel (no copy
        # from the host, no wait on the stream)
        q_offset = torch.full((1,), q_offset, dtype=torch.int32, device=dev)
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages),
                    ("page_table", page_table), ("q_offset", q_offset)):
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, q on {dev}")
    if q_offset.dtype != torch.int32 or q_offset.numel() != 1:
        raise TypeError(f"q_offset must be one int32 on the device, got "
                        f"{q_offset.dtype} {tuple(q_offset.shape)}")
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
            q.stride(2), q_offset.data_ptr(), float(scale),
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
    ``num_heads == num_kv_heads``. ``q_offset`` (>= 0) is an int, or an
    int32 tensor of one element on q's device, which the kernel reads
    there: a CUDA graph captured around the call then serves every offset
    written into that tensor. A tensor's value is not checked (that would
    wait for the device)."""
    nh, nkv = q.shape[2], k_pages.shape[2]
    if nh != nkv:
        raise ValueError(f"ragged_prefill_attention needs num_heads ({nh}) "
                         f"== num_kv_heads ({nkv})")
    if not isinstance(q_offset, torch.Tensor) and int(q_offset) < 0:
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
