"""FlashAttention-2: hand-written CUDA kernels and their plain versions.

Counterpart of ``paddle_tpu/kernels/flash_attention.py``. Three kernels
replace the three Pallas kernels there: ``csrc/flash_attention_fwd.cu``
(``_fwd_kernel``) and the dQ and dK/dV passes of
``csrc/flash_attention_bwd.cu`` (``_bwd_dq_kernel``, ``_bwd_dkv_kernel``).
bf16 runs on the tensor cores (``csrc/attention_fwd_tc.cuh``,
``csrc/flash_attention_bwd_tc.cuh``), f32 on the CUDA cores.
One ``torch.autograd.Function`` joins forward and backward, as the JAX
``_flash`` ``custom_vjp`` does: it saves ``q, k, v, o, lse`` and its
backward recomputes P from the LSE.

Layout contract, as in the JAX package: ``flash_attention_bshd`` takes
``[B, S, N, D]`` (k/v ``[B, Sk, Nkv, D]``, Nkv dividing N for MQA/GQA) and
``flash_attention`` takes head-major ``[BN, S, D]`` (k/v ``[BN // g, Sk,
D]``). The kernels read strided views (unit stride along D only), so the
q/k/v slices of a fused QKV projection go in without a copy, and ragged
lengths and head dims below 128 are masked inside the kernels: the TPU
wrapper's pad-to-128 copies are not ported. Any head dim ``0 < d <= 128``
runs (``_build.instance_head_dim``).

Dispatch: a CPU tensor takes the plain version
(:func:`flash_attention_reference`, :func:`flash_attention_bwd_reference`);
a CUDA tensor launches the kernel or raises. ``launches``,
``dq_launches`` and ``dkv_launches`` count kernel launches.

Routes (:func:`kernel_route`, the C launch's rule from shapes and strides):
bf16 forward and dK/dV launches whose loaded views TMA can describe run
the ``wgmma`` kernels (``csrc/flash_attention_fwd_wg.cu``,
``csrc/flash_attention_bwd_wg.cu``), other bf16 views the ``mma.sync``
ones, f32 the CUDA-core ones; the dQ pass is ``mma.sync`` in bf16.
"""
from __future__ import annotations

import contextlib
import math

import torch

from . import _build

__all__ = ["flash_attention", "flash_attention_bshd", "flash_attention_fwd",
           "flash_attention_bwd", "flash_attention_reference",
           "flash_attention_bwd_reference", "supported", "kernel_route",
           "fwd_query_rows"]

MIN_SEQ = 64                 # the JAX gate's MIN_BLOCK // 2 profit threshold
_NEG_INF = -1e30
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# kernel launches since each counter was last set to 0: the forward, the
# dQ pass and the dK/dV pass
launches = 0
dq_launches = 0
dkv_launches = 0


H100_SMS = 132


def _tma_view(t) -> bool:
    """Can a TMA tensor map describe this ``[B, S, N, D]`` view: a 16-byte
    aligned base and batch, row and head strides that are positive
    multiples of 16 bytes (``csrc/hopper.cuh`` ``tma_view``)?"""
    return t.data_ptr() % 16 == 0 and all(
        s > 0 and s * t.element_size() % 16 == 0 for s in t.stride()[:3])


def kernel_route(*views) -> str:
    """The kernel a forward launch on ``q, k, v`` or a dK/dV launch on
    ``q, k, v, do`` takes, by the C launch's rule (``csrc/attention_wg.cuh``
    ``takes``): ``"cuda_core"`` for f32; for bf16 ``"wgmma"`` where TMA can
    describe every view, else ``"mma_sync"`` (also inside
    :func:`_mma_sync_route`, a flag the loaded library holds)."""
    if views[0].dtype != torch.bfloat16:
        return "cuda_core"
    lib = _build._lib          # no library loaded: the flag cannot be set
    if (lib is not None and lib.ptt_attention_force_mma_sync(-1)) \
            or not all(_tma_view(t) for t in views):
        return "mma_sync"
    return "wgmma"


def fwd_query_rows(b, n, sq, num_sms=H100_SMS) -> int:
    """Query rows a block of the ``wgmma`` forward owns: 128 (two consumer
    warpgroups) when those blocks fill the ``num_sms`` SMs, else 64
    (``csrc/attention_wg.cuh`` ``fwd_warpgroups``)."""
    return 128 if b * n * -(-sq // 128) >= num_sms else 64


@contextlib.contextmanager
def _mma_sync_route():
    """Every bf16 forward and dK/dV launch inside runs the ``mma.sync``
    kernels: the yardstick the ``wgmma`` ones are timed and checked
    against by ``chip_smoke.py``, the card tests and the statistics
    tools. No launch of the program sets it."""
    lib = _build.load_library()
    lib.ptt_attention_force_mma_sync(1)
    try:
        yield
    finally:
        lib.ptt_attention_force_mma_sync(0)


def supported(q_shape, k_shape=None, v_shape=None, causal=False,
              q_offset=None) -> bool:
    """Does the kernel take these ``[B, S, N, D]`` shapes? The JAX gate's
    rules: self/cross attention, GQA, causal with a query offset, S >= 64
    and any head dim ``0 < d <= 128``."""
    if len(q_shape) != 4:
        return False
    b, sq, n, d = q_shape
    if sq < MIN_SEQ or not 0 < d <= _build.MAX_HEAD_DIM:
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


def _scores(q, k, causal, scale, offset):
    """f32 ``scale * q k^T`` as ``[B, N, Sq, Sk]`` with the kernels' -1e30
    causal mask; k is ``[B, Sk, N, D]`` (KV heads already repeated)."""
    sq, sk = q.shape[1], k.shape[1]
    s = torch.einsum("bsnd,btnd->bnst", q.float(), k.float()) * scale
    if causal:
        row = offset + torch.arange(sq, device=q.device)[:, None]
        col = torch.arange(sk, device=q.device)[None, :]
        s = s.masked_fill(col > row, _NEG_INF)
    return s


def _repeat_kv(t, g):
    return t.repeat_interleave(g, dim=2) if g > 1 else t


def flash_attention_reference(q, k, v, causal=False, scale=None,
                              q_offset=None):
    """Plain PyTorch version of the kernel on ``[B, S, N, D]``: dense
    attention with the kernel's mask rules (-1e30, causal with
    ``q_offset``), f32 scores and softmax, P rounded to V's dtype before
    P.V. Returns ``(o [B, Sq, N, D] in q's dtype, lse [B, N, Sq] f32)``."""
    offset = _check_shapes(q, k, v, causal, q_offset)
    g = q.shape[2] // k.shape[2]
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    k, v = _repeat_kv(k, g), _repeat_kv(v, g)
    s = _scores(q, k, causal, scale, offset)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    o = torch.einsum("bnst,btnd->bnsd", p.to(v.dtype).float(), v.float()) / l
    lse = (m + torch.log(l))[..., 0]
    return o.transpose(1, 2).to(q.dtype), lse


def flash_attention_bwd_reference(q, k, v, o, lse, do, causal=False,
                                  scale=None, q_offset=None):
    """Plain PyTorch version of the two backward kernels, the math of the
    JAX ``_bwd`` written densely: Delta = rowsum(dO * O) in f32; P =
    exp(S - LSE) from the f32 scores; dV = P^T dO with P rounded to dO's
    dtype; dS = P * (dP - Delta) * scale rounded to the input dtype; dQ =
    dS K and dK = dS^T Q accumulated in f32; under GQA dK/dV summed over
    the g query heads of each KV head. ``lse`` is ``[B, N, Sq]`` f32, as
    the forward returns it. Returns ``(dq, dk, dv)`` in the input dtype."""
    offset = _check_shapes(q, k, v, causal, q_offset)
    b, sq, n, d = q.shape
    sk, nkv = k.shape[1], k.shape[2]
    g = n // nkv
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2)   # [B, N, Sq]
    kr, vr = _repeat_kv(k, g), _repeat_kv(v, g)
    p = torch.exp(_scores(q, kr, causal, scale, offset) - lse[..., None])
    dv = torch.einsum("bnst,bsnd->btnd", p.to(do.dtype).float(), do.float())
    dp = torch.einsum("bsnd,btnd->bnst", do.float(), vr.float())
    ds = (p * (dp - delta[..., None]) * scale).to(q.dtype).float()
    dq = torch.einsum("bnst,btnd->bsnd", ds, kr.float())
    dk = torch.einsum("bnst,bsnd->btnd", ds, q.float())
    if g > 1:
        dk = dk.reshape(b, sk, nkv, g, d).sum(3)
        dv = dv.reshape(b, sk, nkv, g, d).sum(3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check_cuda(ts):
    dev = ts[0].device
    for t in ts:
        if t.device != dev:
            raise ValueError(f"operands on {t.device} and {dev}")
        if t.dtype not in _DTYPE_CODES or t.dtype != ts[0].dtype:
            raise TypeError(f"flash attention kernel takes float32 or "
                            f"bfloat16 operands of one dtype, got {t.dtype}")
        d = t.shape[-1]
        if t.stride(-1) != 1:
            raise ValueError("flash attention kernel needs unit stride "
                             "along the head dim")
        # at an instance's own width the rows are read with 16-byte loads
        vec = 16 // t.element_size()
        if d == _build.instance_head_dim(d) and (
                t.data_ptr() % 16 or any(st % vec for st in t.stride()[:3])):
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
    CUDA tensors, the plain version for CPU tensors. Not differentiable:
    :func:`flash_attention_bshd` is."""
    if all(t.device.type == "cpu" for t in (q, k, v)):
        return flash_attention_reference(q, k, v, causal, scale, q_offset)
    if not all(t.is_cuda for t in (q, k, v)):
        raise ValueError(f"flash attention runs on CUDA or CPU tensors, got "
                         f"{q.device}, {k.device}, {v.device}")
    offset = _check_shapes(q, k, v, causal, q_offset)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    return _launch(q, k, v, causal, scale, offset)


def _check_bwd(q, k, v, o, lse, do):
    _check_cuda((q, k, v, o, do))
    b, sq, n, _ = q.shape
    if o.shape != q.shape or do.shape != q.shape:
        raise ValueError(f"o {tuple(o.shape)} and do {tuple(do.shape)} must "
                         f"have q's shape {tuple(q.shape)}")
    if lse.shape != (b, n, sq) or lse.dtype != torch.float32 \
            or lse.device != q.device or not lse.is_contiguous():
        raise ValueError(f"lse must be a contiguous float32 [B, N, Sq] = "
                         f"{(b, n, sq)} tensor on {q.device}")
    if b * n >= 65536:
        raise ValueError(f"batch*heads {b * n} exceeds the grid limit")


def _launch_dq(q, k, v, o, lse, do, causal, scale, offset):
    """The dQ kernel on checked operands; returns ``(dq, delta)`` with
    ``delta = rowsum(do * o)`` ``[B, N, Sq]`` f32, which the dK/dV kernel
    reads."""
    global dq_launches
    b, sq, n, d = q.shape
    dq = torch.empty((b, sq, n, d), dtype=q.dtype, device=q.device)
    delta = torch.empty((b, n, sq), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        err = _build.load_library().ptt_flash_attention_bwd_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            _DTYPE_CODES[q.dtype], b, n, k.shape[2], sq, k.shape[1], d,
            *[s for t in (q, k, v, o, do, dq) for s in t.stride()[:3]],
            int(bool(causal)), offset, float(scale),
            torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_attention_bwd_dq")
    dq_launches += 1
    return dq, delta


def _launch_dkv(q, k, v, do, lse, delta, causal, scale, offset):
    """The dK/dV kernel on checked operands (``delta`` from
    :func:`_launch_dq`); returns ``(dk, dv)``."""
    global dkv_launches
    b, sq, n, d = q.shape
    dk = torch.empty(k.shape, dtype=q.dtype, device=q.device)
    dv = torch.empty_like(dk)
    with torch.cuda.device(q.device):
        err = _build.load_library().ptt_flash_attention_bwd_dkv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            _DTYPE_CODES[q.dtype], b, n, k.shape[2], sq, k.shape[1], d,
            *[s for t in (q, k, v, do, dk, dv) for s in t.stride()[:3]],
            int(bool(causal)), offset, float(scale),
            torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_attention_bwd_dkv")
    dkv_launches += 1
    return dk, dv


def flash_attention_bwd(q, k, v, o, lse, do, causal=False, scale=None,
                        q_offset=None):
    """Gradients ``(dq, dk, dv)`` of the ``[B, S, N, D]`` forward from its
    residuals ``o`` and ``lse`` and the output gradient ``do``: the dQ
    kernel, then the dK/dV kernel, for CUDA tensors; the plain version for
    CPU tensors."""
    ts = (q, k, v, o, lse, do)
    if all(t.device.type == "cpu" for t in ts):
        return flash_attention_bwd_reference(q, k, v, o, lse, do, causal,
                                             scale, q_offset)
    if not all(t.is_cuda for t in ts):
        raise ValueError("flash attention backward runs on CUDA or CPU "
                         "tensors, got " + ", ".join(str(t.device)
                                                     for t in ts))
    offset = _check_shapes(q, k, v, causal, q_offset)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if do.stride(-1) != 1:
        do = do.contiguous()
    _check_bwd(q, k, v, o, lse, do)
    dq, delta = _launch_dq(q, k, v, o, lse, do, causal, scale, offset)
    return (dq,) + _launch_dkv(q, k, v, do, lse, delta, causal, scale, offset)


class _FlashAttention(torch.autograd.Function):
    """The counterpart of the JAX ``_flash`` ``custom_vjp``: the forward
    saves ``(q, k, v, o, lse)``, the backward runs both backward passes."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, q_offset):
        o, lse = flash_attention_fwd(q, k, v, causal, scale, q_offset)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = (causal, scale, q_offset)
        return o

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do, *ctx.args)
        return dq, dk, dv, None, None, None


def flash_attention_bshd(q, k, v, causal=False, scale=None, q_offset=None):
    """``[B, Sq, N, D]`` (k/v ``[B, Sk, Nkv, D]``) → ``[B, Sq, N, D]``,
    differentiable in q, k and v."""
    return _FlashAttention.apply(q, k, v, causal, scale, q_offset)


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
