"""FlashAttention-2 forward: a hand-written CUDA kernel and its plain version.

Counterpart of ``paddle_tpu/kernels/flash_attention.py`` (forward only;
the backward kernels come with the training slice). The kernel is
``csrc/flash_attention_fwd.cu``; it replaces the Pallas ``_fwd_kernel``.

Layout contract, as in the JAX package: ``flash_attention_bshd`` takes
``[B, S, N, D]`` (k/v ``[B, Sk, Nkv, D]``, Nkv dividing N for MQA/GQA) and
``flash_attention`` takes head-major ``[BN, S, D]`` (k/v ``[BN // g, Sk,
D]``). The kernel reads strided views (unit stride along D only), so the
q/k/v slices of a fused QKV projection go in without a copy, and ragged
lengths are masked inside the kernel: the TPU wrapper's pad-to-128 copies
are not ported.

Dispatch: a CPU tensor takes :func:`flash_attention_reference`; a CUDA
tensor launches the kernel or raises. ``launches`` counts kernel launches.
"""
from __future__ import annotations

import math

import torch

from . import _build

__all__ = ["flash_attention", "flash_attention_bshd", "flash_attention_fwd",
           "flash_attention_reference", "supported", "KERNEL_HEAD_DIMS"]

MIN_SEQ = 64                 # the JAX gate's MIN_BLOCK // 2 profit threshold
KERNEL_HEAD_DIMS = (64, 128)
_NEG_INF = -1e30
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# kernel launches since the counter was last set to 0
launches = 0


def supported(q_shape, k_shape=None, v_shape=None, causal=False,
              q_offset=None) -> bool:
    """Does the kernel take these ``[B, S, N, D]`` shapes? Same rules as
    the JAX gate (self/cross attention, GQA, causal with a query offset),
    with the kernel's head dims (64 or 128) in place of the TPU's
    ``d <= 128`` lane padding."""
    if len(q_shape) != 4:
        return False
    b, sq, n, d = q_shape
    if sq < MIN_SEQ or d not in KERNEL_HEAD_DIMS:
        return False
    if q_offset is not None:
        sk_eff = k_shape[1] if k_shape is not None and len(k_shape) == 4 \
            else sq
        if not causal or not 0 <= int(q_offset) <= sk_eff - sq:
            return False
    for other in (k_shape, v_shape):
        if other is None:
            continue
        if len(other) != 4:
            return False
        bk, sk, nkv, dk = other
        if (bk, dk) != (b, d) or nkv <= 0 or n % nkv or sk < 1:
            return False
        if causal and sk != sq and q_offset is None:
            return False
    if k_shape is not None and v_shape is not None \
            and tuple(k_shape) != tuple(v_shape):
        return False
    return True


def _check_shapes(q, k, v, causal, q_offset) -> int:
    """Validate ``[B, S, N, D]`` operands; returns the causal offset."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash attention takes 4-D [B, S, N, D] operands")
    if k.shape != v.shape:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} differ")
    b, sq, n, d = q.shape
    if k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} "
                         f"disagree on batch or head dim")
    if n % k.shape[2]:
        raise ValueError(f"query heads {n} must be a multiple of kv heads "
                         f"{k.shape[2]}")
    if sq < 1 or k.shape[1] < 1:
        raise ValueError("empty sequence")
    offset = 0 if q_offset is None else int(q_offset)
    if q_offset is not None and not causal:
        raise ValueError("q_offset requires causal=True")
    if causal:
        if q_offset is None:
            if k.shape[1] != sq:
                raise ValueError(
                    "causal flash attention with unequal q/k lengths "
                    "requires q_offset (absolute position of query row 0)")
        elif offset < 0 or offset + sq > k.shape[1]:
            raise ValueError(f"q_offset {offset} + Sq {sq} must stay within "
                             f"Sk {k.shape[1]}")
    return offset


def flash_attention_reference(q, k, v, causal=False, scale=None,
                              q_offset=None):
    """Plain PyTorch version of the kernel on ``[B, S, N, D]``: dense
    attention with the kernel's mask rules (-1e30, causal with
    ``q_offset``), f32 scores and softmax, P rounded to V's dtype before
    P.V. Returns ``(o [B, Sq, N, D] in q's dtype, lse [B, N, Sq] f32)``."""
    offset = _check_shapes(q, k, v, causal, q_offset)
    b, sq, n, d = q.shape
    sk, nkv = k.shape[1], k.shape[2]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    if n != nkv:
        k = k.repeat_interleave(n // nkv, dim=2)
        v = v.repeat_interleave(n // nkv, dim=2)
    s = torch.einsum("bsnd,btnd->bnst", q.float(), k.float()) * scale
    if causal:
        row = offset + torch.arange(sq, device=q.device)[:, None]
        col = torch.arange(sk, device=q.device)[None, :]
        s = s.masked_fill(col > row, _NEG_INF)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    o = torch.einsum("bnst,btnd->bnsd", p.to(v.dtype).float(), v.float()) / l
    lse = (m + torch.log(l))[..., 0]
    return o.transpose(1, 2).to(q.dtype), lse


def _check_cuda(ts):
    dev = ts[0].device
    for t in ts:
        if t.device != dev:
            raise ValueError(f"operands on {t.device} and {dev}")
        if t.dtype not in _DTYPE_CODES or t.dtype != ts[0].dtype:
            raise TypeError(f"flash attention kernel takes float32 or "
                            f"bfloat16 operands of one dtype, got {t.dtype}")
        if t.shape[-1] not in KERNEL_HEAD_DIMS:
            raise ValueError(f"head dim {t.shape[-1]} not in "
                             f"{KERNEL_HEAD_DIMS}")
        if t.stride(-1) != 1:
            raise ValueError("flash attention kernel needs unit stride "
                             "along the head dim")
        vec = 16 // t.element_size()
        if t.data_ptr() % 16 or any(st % vec for st in t.stride()[:3]):
            raise ValueError("flash attention kernel needs 16-byte aligned "
                             "rows (strides a multiple of 16 bytes)")
        if max(t.stride()[:3]) >= 2 ** 31 or t.numel() >= 2 ** 40:
            raise ValueError("tensor too large for int32 strides")


def _launch(q, k, v, causal, scale, offset):
    global launches
    _check_cuda((q, k, v))
    b, sq, n, d = q.shape
    sk, nkv = k.shape[1], k.shape[2]
    if b * n >= 65536:
        raise ValueError(f"batch*heads {b * n} exceeds the grid limit")
    o = torch.empty((b, sq, n, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, n, sq), dtype=torch.float32, device=q.device)
    lib = _build.load_library()
    strides = [s for t in (q, k, v, o) for s in t.stride()[:3]]
    with torch.cuda.device(q.device):
        err = lib.ptt_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), _DTYPE_CODES[q.dtype], b, n, nkv, sq, sk, d,
            *strides, int(bool(causal)), offset, float(scale),
            torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_attention_fwd")
    launches += 1
    return o, lse


def flash_attention_fwd(q, k, v, causal=False, scale=None, q_offset=None):
    """``[B, S, N, D]`` forward returning ``(o, lse)``: the kernel for
    CUDA tensors, the plain version for CPU tensors."""
    if all(t.device.type == "cpu" for t in (q, k, v)):
        return flash_attention_reference(q, k, v, causal, scale, q_offset)
    if not all(t.is_cuda for t in (q, k, v)):
        raise ValueError(f"flash attention runs on CUDA or CPU tensors, got "
                         f"{q.device}, {k.device}, {v.device}")
    offset = _check_shapes(q, k, v, causal, q_offset)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    return _launch(q, k, v, causal, scale, offset)


def flash_attention_bshd(q, k, v, causal=False, scale=None, q_offset=None):
    """``[B, Sq, N, D]`` (k/v ``[B, Sk, Nkv, D]``) → ``[B, Sq, N, D]``."""
    return flash_attention_fwd(q, k, v, causal, scale, q_offset)[0]


def flash_attention(q, k, v, causal=False, scale=None, q_offset=None):
    """Head-major ``[BN, Sq, D]`` (k/v ``[BN // g, Sk, D]``) →
    ``[BN, Sq, D]``; query head i reads KV head ``i // g``, as the JAX
    kernel's ``b // g`` index map does."""
    if q.shape[0] % k.shape[0]:
        raise ValueError(f"query heads {q.shape[0]} must be a multiple of "
                         f"kv heads {k.shape[0]}")
    as4 = lambda t: t.transpose(0, 1).unsqueeze(0)   # [1, S, BN, D] view
    o = flash_attention_bshd(as4(q), as4(k), as4(v), causal, scale, q_offset)
    return o[0].transpose(0, 1)
