"""Common functionals: linear, dropout, embedding, interpolate, ...
(counterpart of ``paddle_tpu/nn/functional/common.py``).

Dropout masks are drawn from the facade's generator of the input's device
(:func:`paddle_tpu_torch.framework.random.generator`), a kept element where
a uniform draw is below ``1 - p``, as ``jax.random.bernoulli`` keeps it;
the two frameworks draw other masks from one seed. ``interpolate`` computes
``jax.image.resize``'s function (half-pixel centres, antialiased linear and
Keys-cubic weights when downsampling), which torch's ``F.interpolate`` does
not.
"""
from __future__ import annotations

import numpy as np
import torch

from ...framework import random as random_mod
from ...ops._dispatch import apply, unwrap, wrap
from ...ops.creation import one_hot as _one_hot
from ...ops.manipulation import pad  # paddle.nn.functional.pad
from ...framework.tensor import Tensor

__all__ = ["linear", "dropout", "dropout2d", "dropout3d", "alpha_dropout",
           "embedding", "one_hot", "label_smooth", "interpolate", "upsample",
           "pixel_shuffle", "pixel_unshuffle", "channel_shuffle", "unfold",
           "fold", "cosine_similarity", "pad", "bilinear",
           "class_center_sample"]


def _keep_mask(shape, p, device):
    """True where an element is kept (probability ``1 - p``)."""
    u = torch.rand(tuple(shape), device=device,
                   generator=random_mod.generator(device))
    return u < (1.0 - p)


def _pair(v, n):
    return tuple(v) if isinstance(v, (list, tuple)) else (v,) * n


def linear(x, weight, bias=None, name=None):
    """``x @ W (+ b)`` with paddle's ``[in, out]`` weight."""
    if bias is not None:
        return apply(lambda v, w, b: torch.matmul(v, w) + b, x, weight, bias,
                     op_name="linear")
    return apply(torch.matmul, x, weight, op_name="linear")


def dropout(x, p=0.5, axis=None, training=True, mode="upscale_in_train",
            name=None):
    """Zero each element with probability ``p`` (one draw shared along the
    dims not in ``axis``); ``upscale_in_train`` divides the kept ones by
    ``1 - p``. Outside training, or at ``p = 0``, ``x`` itself, as in the
    JAX package."""
    if not training or p == 0.0:
        return x if isinstance(x, Tensor) else apply(lambda v: v, x)

    def f(v):
        shape = list(v.shape)
        if axis is not None:
            axes = axis if isinstance(axis, (list, tuple)) else [axis]
            shape = [s if i in axes else 1 for i, s in enumerate(shape)]
        keep = _keep_mask(shape, p, v.device)
        zero = torch.zeros((), dtype=v.dtype, device=v.device)
        if mode == "upscale_in_train":
            return torch.where(keep, v / (1.0 - p), zero)
        return torch.where(keep, v, zero)

    return apply(f, x, op_name="dropout")


def dropout2d(x, p=0.5, training=True, data_format="NCHW", name=None):
    axes = [0, 1] if data_format == "NCHW" else [0, 3]
    return dropout(x, p, axis=axes, training=training)


def dropout3d(x, p=0.5, training=True, data_format="NCDHW", name=None):
    axes = [0, 1] if data_format == "NCDHW" else [0, 4]
    return dropout(x, p, axis=axes, training=training)


def alpha_dropout(x, p=0.5, training=True, name=None):
    """SELU-preserving dropout: dropped elements take SELU's negative
    saturation, then an affine map keeps mean and variance."""
    if not training or p == 0.0:
        return x
    alpha_p = -1.6732632423543772 * 1.0507009873554805
    a = float(np.float32(1.0 / np.sqrt((1.0 - p) * (1.0 + p * alpha_p ** 2))))
    b = -a * alpha_p * p

    def f(v):
        keep = _keep_mask(v.shape, p, v.device)
        fill = torch.full((), alpha_p, dtype=v.dtype, device=v.device)
        return a * torch.where(keep, v, fill) + b

    return apply(f, x, op_name="alpha_dropout")


def embedding(x, weight, padding_idx=None, sparse=False, name=None):
    """Rows of ``weight`` at the ids ``x``; rows at ``padding_idx`` are
    zero (and get no gradient)."""
    def f(idx, w):
        out = torch.nn.functional.embedding(idx.long(), w)
        if padding_idx is not None:
            out = out.masked_fill((idx == padding_idx)[..., None], 0.0)
        return out

    return apply(f, x, weight, op_name="embedding")


def one_hot(x, num_classes, name=None):
    return _one_hot(x, num_classes)


def label_smooth(label, prior_dist=None, epsilon=0.1, name=None):
    def f(v, *pd):
        if pd:
            return (1.0 - epsilon) * v + epsilon * pd[0]
        return (1.0 - epsilon) * v + epsilon / v.shape[-1]
    if prior_dist is not None:
        return apply(f, label, prior_dist, op_name="label_smooth")
    return apply(f, label, op_name="label_smooth")


# ---- interpolate: jax.image.resize's function ------------------------------

def _linear_kernel(x):
    return (1.0 - x.abs()).clamp_min(0.0)


def _cubic_kernel(x):           # Keys, a = -0.5
    x = x.abs()
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


def _weight_mat(n_in, n_out, kernel, device):
    """``[n_in, n_out]`` weights of ``jax.image.scale_and_translate`` at
    scale ``n_out / n_in`` (antialiased: the kernel widened when
    downsampling), in f32."""
    inv_scale = n_in / n_out
    kernel_scale = max(inv_scale, 1.0)
    sample = (torch.arange(n_out, dtype=torch.float32, device=device)
              + 0.5) * inv_scale - 0.5
    src = torch.arange(n_in, dtype=torch.float32, device=device)
    w = kernel((sample[None, :] - src[:, None]).abs() / kernel_scale)
    total = w.sum(0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                    w / torch.where(total != 0, total, 1.0),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def _resize(v, out_shape, method):
    for ax, (n_in, n_out) in enumerate(zip(v.shape, out_shape)):
        if n_in == n_out:
            continue
        if method == "nearest":
            idx = ((torch.arange(n_out, dtype=torch.float32, device=v.device)
                    + 0.5) * n_in / n_out).floor().long()
            v = v.index_select(ax, idx)
            continue
        kernel = _linear_kernel if method == "linear" else _cubic_kernel
        w = _weight_mat(n_in, n_out, kernel, v.device).to(v.dtype)
        v = torch.tensordot(v, w, dims=([ax], [0])).movedim(-1, ax)
    return v


def _resize_align_corners(v, out_shape, channel_last):
    nd = v.ndim
    out = v
    for ax in (range(1, nd - 1) if channel_last else range(2, nd)):
        n_in, n_out = v.shape[ax], out_shape[ax]
        if n_in == n_out:
            continue
        pos = torch.linspace(0.0, n_in - 1.0, n_out, device=v.device)
        lo = pos.floor().long()
        hi = (lo + 1).clamp_max(n_in - 1)
        w = (pos - lo).to(v.dtype)
        a, b = out.index_select(ax, lo), out.index_select(ax, hi)
        shape = [1] * out.ndim
        shape[ax] = n_out
        out = a + (b - a) * w.reshape(shape)
    return out


def interpolate(x, size=None, scale_factor=None, mode="nearest",
                align_corners=False, align_mode=0, data_format="NCHW",
                name=None):
    channel_last = not data_format.startswith("NC")

    def f(v):
        nd = v.ndim - 2
        spatial = v.shape[1:-1] if channel_last else v.shape[2:]
        if size is not None:
            out_spatial = [int(s) for s in (
                size if isinstance(size, (list, tuple)) else [size])]
        else:
            sf = scale_factor if isinstance(scale_factor, (list, tuple)) \
                else [scale_factor] * nd
            out_spatial = [int(s * f_) for s, f_ in zip(spatial, sf)]
        if channel_last:
            out_shape = (v.shape[0],) + tuple(out_spatial) + (v.shape[-1],)
        else:
            out_shape = tuple(v.shape[:2]) + tuple(out_spatial)
        method = {"nearest": "nearest", "bilinear": "linear",
                  "linear": "linear", "trilinear": "linear",
                  "bicubic": "cubic", "area": "linear"}[mode]
        if mode == "nearest":
            return _resize(v, out_shape, "nearest")
        if align_corners:
            return _resize_align_corners(v, out_shape, channel_last)
        return _resize(v, out_shape, method)

    return apply(f, x, op_name="interpolate")


def upsample(x, size=None, scale_factor=None, mode="nearest",
             align_corners=False, align_mode=0, data_format="NCHW",
             name=None):
    return interpolate(x, size, scale_factor, mode, align_corners,
                       align_mode, data_format)


def pixel_shuffle(x, upscale_factor, data_format="NCHW", name=None):
    r = upscale_factor

    def f(v):
        if data_format == "NCHW":
            n, c, h, w = v.shape
            out = v.reshape(n, c // (r * r), r, r, h, w)
            out = out.permute(0, 1, 4, 2, 5, 3)
            return out.reshape(n, c // (r * r), h * r, w * r)
        n, h, w, c = v.shape
        out = v.reshape(n, h, w, r, r, c // (r * r))
        out = out.permute(0, 1, 3, 2, 4, 5)
        return out.reshape(n, h * r, w * r, c // (r * r))

    return apply(f, x, op_name="pixel_shuffle")


def pixel_unshuffle(x, downscale_factor, data_format="NCHW", name=None):
    r = downscale_factor

    def f(v):
        if data_format == "NCHW":
            n, c, h, w = v.shape
            out = v.reshape(n, c, h // r, r, w // r, r)
            out = out.permute(0, 1, 3, 5, 2, 4)
            return out.reshape(n, c * r * r, h // r, w // r)
        n, h, w, c = v.shape
        out = v.reshape(n, h // r, r, w // r, r, c)
        out = out.permute(0, 1, 3, 2, 4, 5)
        return out.reshape(n, h // r, w // r, c * r * r)

    return apply(f, x, op_name="pixel_unshuffle")


def channel_shuffle(x, groups, data_format="NCHW", name=None):
    def f(v):
        if data_format == "NCHW":
            n, c, h, w = v.shape
            out = v.reshape(n, groups, c // groups, h, w).transpose(1, 2)
            return out.reshape(n, c, h, w)
        n, h, w, c = v.shape
        out = v.reshape(n, h, w, groups, c // groups).transpose(3, 4)
        return out.reshape(n, h, w, c)
    return apply(f, x, op_name="channel_shuffle")


def _paddings4(paddings):
    """(top, left, bottom, right) from an int, [h, w] or 4 values."""
    if isinstance(paddings, int):
        return (paddings,) * 4
    if len(paddings) == 2:
        return (paddings[0], paddings[1], paddings[0], paddings[1])
    return tuple(paddings)


def unfold(x, kernel_sizes, strides=1, paddings=0, dilations=1, name=None):
    """Sliding ``[c * kh * kw]`` patches as ``[n, c * kh * kw, L]``
    (paddings ``[top, left, bottom, right]`` may differ)."""
    k, s, d = (_pair(a, 2) for a in (kernel_sizes, strides, dilations))
    t, left, b, r = _paddings4(paddings)

    def f(v):
        v = torch.nn.functional.pad(v, (left, r, t, b))
        return torch.nn.functional.unfold(v, k, dilation=d, stride=s)

    return apply(f, x, op_name="unfold")


def fold(x, output_sizes, kernel_sizes, strides=1, paddings=0, dilations=1,
         name=None):
    """The sum of ``unfold``'s patches back into ``[n, c, H, W]``."""
    out_hw = _pair(output_sizes, 2)
    k, s, d = (_pair(a, 2) for a in (kernel_sizes, strides, dilations))
    p = _paddings4(paddings)

    def f(v):
        n, ckk, _ = v.shape
        c = ckk // (k[0] * k[1])
        oh = (out_hw[0] + p[0] + p[2] - d[0] * (k[0] - 1) - 1) // s[0] + 1
        ow = (out_hw[1] + p[1] + p[3] - d[1] * (k[1] - 1) - 1) // s[1] + 1
        v6 = v.reshape(n, c, k[0], k[1], oh, ow)
        out = v.new_zeros(n, c, out_hw[0] + p[0] + p[2],
                          out_hw[1] + p[1] + p[3])
        for i in range(k[0]):
            for j in range(k[1]):
                hi, wj = i * d[0], j * d[1]
                out[:, :, hi:hi + oh * s[0]:s[0],
                    wj:wj + ow * s[1]:s[1]] += v6[:, :, i, j]
        return out[:, :, p[0]:out.shape[2] - p[2], p[1]:out.shape[3] - p[3]]

    return apply(f, x, op_name="fold")


def cosine_similarity(x1, x2, axis=1, eps=1e-8, name=None):
    def f(a, b):
        num = (a * b).sum(axis)
        na = a.square().sum(axis).sqrt()
        nb = b.square().sum(axis).sqrt()
        return num / (na * nb).clamp_min(eps)
    return apply(f, x1, x2, op_name="cosine_similarity")


def bilinear(x1, x2, weight, bias=None, name=None):
    """``out[b, o] = x1[b] W[o] x2[b] (+ bias[o])``."""
    def f(a, b, w, *bi):
        out = torch.einsum("bi,oij,bj->bo", a, w, b)
        if bi:
            out = out + bi[0]
        return out
    if bias is not None:
        return apply(f, x1, x2, weight, bias, op_name="bilinear")
    return apply(f, x1, x2, weight, op_name="bilinear")


def class_center_sample(label, num_classes, num_samples, group=None):
    """Host-side sampling (PLSC-style training): every positive class, then
    negatives drawn from the facade's CPU generator up to ``num_samples``;
    returns the labels remapped into the sample and the sampled classes."""
    lab = np.asarray(unwrap(label).cpu())
    pos = np.unique(lab)
    if len(pos) >= num_samples:
        sampled = pos[:num_samples]
    else:
        neg = np.setdiff1d(np.arange(num_classes), pos)
        cpu = torch.device("cpu")
        pick = torch.randperm(len(neg), generator=random_mod.generator(cpu))
        extra = neg[pick[:num_samples - len(pos)].numpy()]
        sampled = np.concatenate([pos, extra])
    sampled.sort()
    remap = -np.ones(num_classes, np.int64)
    remap[sampled] = np.arange(len(sampled))
    dev = unwrap(label).device
    return (wrap(torch.from_numpy(remap[lab]).to(dev)),
            wrap(torch.from_numpy(sampled).to(dev)))

