"""Weight-only int8 dequant-matmul: a hand-written CUDA kernel and its plain
version.

Counterpart of ``paddle_tpu/kernels/int8_matmul.py``. The kernel is
``csrc/int8_matmul.cu``; it replaces the Pallas ``_mm_kernel``.

``int8_matmul(x, w, scale)`` computes ``[M, K] float x int8 -> [M, N]``:
the products accumulate in f32, the f32 per-column scale multiplies the
f32 sum, and the result is rounded once to ``x``'s dtype (the Pallas
kernel's rounding points). The weight is taken in the layout the serving
engine stores it, with no transposed copy:

- ``layout="kn"``: ``w [K, N]`` (``wqkv`` as ``[H, 3 * nh * d]``, ``wo`` as
  ``[nh * d, H]``, ``w1``, ``w2``);
- ``layout="nk"``: ``w [N, K]`` (the logits against ``wte [V, H]``, where
  the JAX auto-fusion rule transposes the weight instead).

Dispatch: CPU tensors take :func:`int8_matmul_reference`; CUDA tensors
launch the kernel or raise. ``launches`` counts kernel launches.
"""
from __future__ import annotations

import math

import torch

from . import _build

__all__ = ["int8_matmul", "int8_matmul_reference"]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_LAYOUTS = {"kn": 0, "nk": 1}

# kernel launches since the counter was last set to 0
launches = 0


def int8_matmul_reference(x, w, scale, layout="kn"):
    """Plain PyTorch version: ``((x.float() @ w.float()) * scale).to(
    x.dtype)``, with ``w`` read as ``[K, N]`` (``"kn"``) or ``[N, K]``
    (``"nk"``)."""
    wf = w.float() if layout == "kn" else w.float().t()
    return ((x.float() @ wf) * scale.float()).to(x.dtype)


def _shapes(x, w, scale, layout):
    if layout not in _LAYOUTS:
        raise ValueError(f"layout {layout!r} is not 'kn' or 'nk'")
    if x.dim() != 2 or w.dim() != 2:
        raise ValueError(f"int8_matmul takes a 2-D x and w, got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    M, K = x.shape
    K2, N = w.shape if layout == "kn" else w.shape[::-1]
    if K != K2 or tuple(scale.shape) != (N,):
        raise ValueError(f"int8_matmul shape mismatch: x {tuple(x.shape)}, "
                         f"w {tuple(w.shape)} ({layout}), scale "
                         f"{tuple(scale.shape)}")
    return M, N, K


def _launch(x, w, scale, layout, M, N, K):
    """Launch the kernel: one pass, K split across a thread-block cluster
    where the tiles alone do not fill the card (the kernel picks the
    cluster); nothing is allocated but the output."""
    global launches
    dev = x.device
    for name, t in (("w", w), ("scale", scale)):
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, x on {dev}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"int8 matmul kernel takes float32 or bfloat16 x, "
                        f"got {x.dtype}")
    if w.dtype != torch.int8 or scale.dtype != torch.float32:
        raise TypeError(f"int8 matmul kernel takes an int8 weight and f32 "
                        f"scales, got {w.dtype} and {scale.dtype}")
    if not (w.is_contiguous() and scale.is_contiguous()) or x.stride(1) != 1:
        raise ValueError("int8 matmul kernel needs a contiguous weight and "
                         "scale, and x with unit stride along K")
    if max(M * max(K, x.stride(0)), K * N) >= 2 ** 31:
        raise ValueError("int8 matmul operands too large for 32-bit strides")
    if math.ceil(M / 8) > 65535 or math.ceil(N / 64) > 65535:
        raise ValueError(f"M {M} or N {N} exceeds the grid limit")
    out = torch.empty((M, N), dtype=x.dtype, device=dev)
    row = N if layout == "kn" else K
    vec = int(w.data_ptr() % 16 == 0 and row % 16 == 0)
    xvec = int(x.data_ptr() % 16 == 0
               and x.stride(0) * x.element_size() % 16 == 0)
    lib = _build.load_library()
    with torch.cuda.device(dev):
        err = lib.ptt_int8_matmul(
            x.data_ptr(), w.data_ptr(), scale.data_ptr(), out.data_ptr(),
            _DTYPE_CODES[x.dtype], _LAYOUTS[layout], M, N, K, x.stride(0),
            vec, xvec, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "int8_matmul")
    launches += 1
    return out


def int8_matmul(x, w, scale, layout="kn"):
    """``x [M, K]`` (f32 or bf16) times the int8 weight ``w`` (``[K, N]``
    for ``layout="kn"``, ``[N, K]`` for ``"nk"``) with the f32
    per-column ``scale [N]`` applied to the f32 sum; returns ``[M, N]``
    in ``x``'s dtype."""
    M, N, K = _shapes(x, w, scale, layout)
    if all(t.device.type == "cpu" for t in (x, w, scale)):
        return int8_matmul_reference(x, w, scale, layout)
    if not x.is_cuda:
        raise ValueError(f"int8_matmul runs on CUDA or CPU tensors, got "
                         f"{x.device}")
    return _launch(x, w, scale, layout, M, N, K)
