"""Gradient clipping (counterpart of ``paddle_tpu/nn/clip.py``).

The clip classes take and return a list of ``(param, grad)`` pairs, as the
optimizers hand them over; a pair whose grad is None, or whose parameter
has ``need_clip = False``, passes unchanged (the parameters may be torch
tensors or the facade's, the gradients are torch tensors).
:func:`clip_grad_norm_` scales the ``.grad`` of the given parameters in
place; :func:`clip_by_norm` is the facade op.
"""
from __future__ import annotations

import torch

from ..framework.tensor import Tensor

__all__ = ["ClipGradBase", "ClipGradByValue", "ClipGradByNorm",
           "ClipGradByGlobalNorm", "clip_grad_norm_", "clip_by_norm"]


def _skip(p, g):
    return g is None or not getattr(p, "need_clip", True)


class ClipGradBase:
    def __call__(self, params_grads):
        raise NotImplementedError


class ClipGradByValue(ClipGradBase):
    """Each gradient clipped elementwise to ``[min, max]`` (``min`` is
    ``-max`` when None)."""

    def __init__(self, max, min=None):
        self.max = max
        self.min = -max if min is None else min

    def __call__(self, params_grads):
        return [(p, g) if _skip(p, g) else (p, g.clamp(self.min, self.max))
                for p, g in params_grads]


class ClipGradByNorm(ClipGradBase):
    """Each gradient scaled by ``min(clip_norm / max(|g|_2, 1e-12), 1)``."""

    def __init__(self, clip_norm):
        self.clip_norm = clip_norm

    def __call__(self, params_grads):
        out = []
        for p, g in params_grads:
            if _skip(p, g):
                out.append((p, g))
                continue
            norm = g.square().sum().sqrt()
            scale = (self.clip_norm / norm.clamp_min(1e-12)).clamp_max(1.0)
            out.append((p, g * scale))
        return out


class ClipGradByGlobalNorm(ClipGradBase):
    """Every gradient scaled by ``clip_norm / max(global_norm, clip_norm)``,
    the global norm over all clipped gradients summed in f32."""

    def __init__(self, clip_norm, group_name="default_group",
                 auto_skip_clip=False):
        self.clip_norm = clip_norm
        self.group_name = group_name

    def _global_norm_sq(self, params_grads):
        sq = [g.float().square().sum() for p, g in params_grads
              if not _skip(p, g)]
        return torch.stack(sq).sum() if sq else None

    def __call__(self, params_grads):
        sq = self._global_norm_sq(params_grads)
        if sq is None:
            return params_grads
        scale = self.clip_norm / sq.sqrt().clamp_min(self.clip_norm)
        return [(p, g) if _skip(p, g) else (p, g * scale.to(g.dtype))
                for p, g in params_grads]


def clip_grad_norm_(parameters, max_norm, norm_type=2.0,
                    error_if_nonfinite=False):
    """Scale the ``.grad`` of ``parameters`` in place by ``min(max_norm /
    max(total, 1e-6), 1)``, ``total`` the ``norm_type`` norm over all of
    them (``inf``: the largest |g|); returns ``total``.
    ``error_if_nonfinite`` raises where ``total`` is not finite (a host
    sync)."""
    if isinstance(parameters, (torch.Tensor, Tensor)):
        parameters = [parameters]
    parameters = [p._value if isinstance(p, Tensor) else p
                  for p in parameters]
    grads = [p.grad for p in parameters if p.grad is not None]
    if not grads:
        return torch.zeros([])
    if norm_type == float("inf"):
        total = torch.stack([g.abs().max() for g in grads]).max()
    else:
        total = sum(g.abs().pow(norm_type).sum()
                    for g in grads).pow(1.0 / norm_type)
    if error_if_nonfinite and not torch.isfinite(total):
        raise RuntimeError(f"the total norm of order {norm_type} of the "
                           f"gradients is not finite")
    scale = (max_norm / total.clamp_min(1e-6)).clamp_max(1.0)
    with torch.no_grad():
        for g in grads:
            g.mul_(scale)
    return total


def clip_by_norm(x, max_norm, name=None):
    """``x`` scaled so that its L2 norm (in f32) is at most ``max_norm``."""
    from ..framework.tape import apply

    def f(v):
        n = v.float().square().sum().sqrt()
        scale = torch.where(n > max_norm, max_norm / n.clamp_min(1e-12), 1.0)
        return (v.float() * scale).to(v.dtype)

    return apply(f, x, op_name="clip_by_norm")
