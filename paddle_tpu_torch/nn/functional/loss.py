"""Loss functionals (counterpart of ``paddle_tpu/nn/functional/loss.py``).

Each is the JAX function's expression in torch ops. Nothing reads a value
back to the host: ``ignore_index`` and class weights enter as masks and
sums on the device, and a mean over no valid element divides by 1e-12
rather than branching, so the losses run inside a captured CUDA graph.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ...ops._dispatch import apply, unwrap

__all__ = [
    "cross_entropy", "softmax_with_cross_entropy", "binary_cross_entropy",
    "binary_cross_entropy_with_logits", "nll_loss", "mse_loss", "l1_loss",
    "smooth_l1_loss", "kl_div", "margin_ranking_loss",
    "hinge_embedding_loss", "cosine_embedding_loss", "triplet_margin_loss",
    "ctc_loss", "square_error_cost", "log_loss", "sigmoid_focal_loss",
    "dice_loss", "npair_loss", "huber_loss",
]


def _reduce(out, reduction):
    if reduction == "mean":
        return out.mean()
    if reduction == "sum":
        return out.sum()
    return out


def _zero(v):
    return torch.zeros((), dtype=v.dtype, device=v.device)


def cross_entropy(input, label, weight=None, ignore_index=-100,
                  reduction="mean", soft_label=False, axis=-1,
                  use_softmax=True, label_smoothing=0.0, name=None):
    """Softmax cross entropy over ``axis``: hard labels (ids, with
    ``ignore_index`` and the class ``weight``; a weighted mean divides by
    the valid labels' weights) or ``soft_label`` distributions;
    ``label_smoothing`` mixes in the uniform distribution."""
    w = unwrap(weight) if weight is not None else None

    def f(logits, lab):
        ax = axis % logits.ndim
        if use_softmax:
            logp = torch.log_softmax(logits, ax)
        else:
            logp = torch.log(logits.clamp_min(1e-30))
        if soft_label:
            tgt = lab
            if label_smoothing > 0.0:
                tgt = (1.0 - label_smoothing) * tgt \
                    + label_smoothing / logits.shape[ax]
            loss = -(tgt * logp).sum(ax)
            if w is not None:
                wshape = [1] * logits.ndim
                wshape[ax] = -1
                sw = (w.reshape(wshape) * tgt).sum(ax)
                loss = loss * sw
                if reduction == "mean":
                    return loss.sum() / sw.sum().clamp_min(1e-12)
            return _reduce(loss, reduction)
        li = lab
        if li.ndim == logp.ndim:
            li = li.squeeze(ax)
        li = li.long()
        valid = li != ignore_index
        safe = torch.where(valid, li, 0)
        loss = -logp.gather(ax, safe.unsqueeze(ax)).squeeze(ax)
        if label_smoothing > 0.0:
            smooth = -logp.mean(ax)
            loss = (1.0 - label_smoothing) * loss + label_smoothing * smooth
        loss = torch.where(valid, loss, _zero(loss))
        wt = torch.where(valid, w[safe], 0.0) if w is not None else None
        if wt is not None:
            loss = loss * wt
        if reduction == "mean":
            denom = wt.sum() if wt is not None else valid.to(
                loss.dtype).sum()
            return loss.sum() / denom.clamp_min(1e-12)
        return _reduce(loss, reduction)

    return apply(f, input, label, op_name="cross_entropy")


def softmax_with_cross_entropy(logits, label, soft_label=False,
                               ignore_index=-100, numeric_stable_mode=True,
                               return_softmax=False, axis=-1):
    """The per-example loss with the class axis kept as size 1 (and the
    softmax with ``return_softmax``)."""
    from ...ops.manipulation import unsqueeze
    from .activation import softmax
    loss = unsqueeze(cross_entropy(logits, label, soft_label=soft_label,
                                   ignore_index=ignore_index,
                                   reduction="none", axis=axis), axis)
    if return_softmax:
        return loss, softmax(logits, axis=axis)
    return loss


def binary_cross_entropy(input, label, weight=None, reduction="mean",
                         name=None):
    def f(p, t, *w):
        loss = -(t * torch.log(p.clamp_min(1e-12))
                 + (1 - t) * torch.log((1 - p).clamp_min(1e-12)))
        if w:
            loss = loss * w[0]
        return _reduce(loss, reduction)
    args = [input, label] + ([weight] if weight is not None else [])
    return apply(f, *args, op_name="binary_cross_entropy")


def binary_cross_entropy_with_logits(logit, label, weight=None,
                                     reduction="mean", pos_weight=None,
                                     name=None):
    pw = unwrap(pos_weight) if pos_weight is not None else None

    def f(z, t, *w):
        # max(z, 0) - z t + log(1 + exp(-|z|))
        loss = z.clamp_min(0) - z * t + torch.log1p(torch.exp(-z.abs()))
        if pw is not None:
            loss = loss * (t * (pw - 1) + 1)
        if w:
            loss = loss * w[0]
        return _reduce(loss, reduction)
    args = [logit, label] + ([weight] if weight is not None else [])
    return apply(f, *args, op_name="bce_with_logits")


def nll_loss(input, label, weight=None, ignore_index=-100, reduction="mean",
             name=None):
    w = unwrap(weight) if weight is not None else None

    def f(logp, lab):
        lab = lab.long()
        valid = lab != ignore_index
        safe = torch.where(valid, lab, 0)
        loss = -logp.gather(1, safe.unsqueeze(1)).squeeze(1)
        wt = w[safe] if w is not None else torch.ones(
            (), dtype=loss.dtype, device=loss.device)
        loss = torch.where(valid, loss * wt, 0.0)
        if reduction == "mean":
            return loss.sum() / torch.where(valid, wt, 0.0).sum().clamp_min(
                1e-12)
        return _reduce(loss, reduction)

    return apply(f, input, label, op_name="nll_loss")


def mse_loss(input, label, reduction="mean", name=None):
    return apply(lambda p, t: _reduce((p - t).square(), reduction), input,
                 label, op_name="mse_loss")


def l1_loss(input, label, reduction="mean", name=None):
    return apply(lambda p, t: _reduce((p - t).abs(), reduction), input,
                 label, op_name="l1_loss")


def smooth_l1_loss(input, label, reduction="mean", delta=1.0, name=None):
    def f(p, t):
        d = (p - t).abs()
        loss = torch.where(d < delta, 0.5 * d * d, delta * (d - 0.5 * delta))
        return _reduce(loss, reduction)
    return apply(f, input, label, op_name="smooth_l1_loss")


def kl_div(input, label, reduction="mean", name=None):
    def f(logp, t):
        loss = t * (torch.log(t.clamp_min(1e-12)) - logp)
        if reduction == "batchmean":
            return loss.sum() / logp.shape[0]
        return _reduce(loss, reduction)
    return apply(f, input, label, op_name="kl_div")


def margin_ranking_loss(input, other, label, margin=0.0, reduction="mean",
                        name=None):
    def f(a, b, t):
        return _reduce((-t * (a - b) + margin).clamp_min(0.0), reduction)
    return apply(f, input, other, label, op_name="margin_ranking_loss")


def hinge_embedding_loss(input, label, margin=1.0, reduction="mean",
                         name=None):
    def f(x, t):
        loss = torch.where(t == 1, x, (margin - x).clamp_min(0.0))
        return _reduce(loss, reduction)
    return apply(f, input, label, op_name="hinge_embedding_loss")


def cosine_embedding_loss(input1, input2, label, margin=0.0,
                          reduction="mean", name=None):
    def f(a, b, t):
        sim = (a * b).sum(-1) / (a.norm(dim=-1) * b.norm(dim=-1)).clamp_min(
            1e-12)
        loss = torch.where(t == 1, 1 - sim, (sim - margin).clamp_min(0.0))
        return _reduce(loss, reduction)
    return apply(f, input1, input2, label, op_name="cosine_embedding_loss")


def triplet_margin_loss(input, positive, negative, margin=1.0, p=2.0,
                        epsilon=1e-6, swap=False, reduction="mean",
                        name=None):
    def dist(a, b):
        return ((a - b).abs() + epsilon).pow(p).sum(-1).pow(1 / p)

    def f(a, pos, neg):
        dp, dn = dist(a, pos), dist(a, neg)
        if swap:
            dn = torch.minimum(dn, dist(pos, neg))
        return _reduce((dp - dn + margin).clamp_min(0.0), reduction)
    return apply(f, input, positive, negative, op_name="triplet_margin_loss")


def ctc_loss(log_probs, labels, input_lengths, label_lengths, blank=0,
             reduction="mean", norm_by_times=False):
    """CTC over ``log_probs [T, B, C]``, normalized over C first as the JAX
    function's ``optax.ctc_loss`` does; ``mean`` averages the per-sequence
    losses (not divided by the label lengths)."""
    lab = unwrap(labels).long()
    il = unwrap(input_lengths).long()
    ll = unwrap(label_lengths).long()

    def f(lp):
        per_seq = F.ctc_loss(torch.log_softmax(lp, -1), lab, il, ll,
                             blank=blank, reduction="none",
                             zero_infinity=False)
        if norm_by_times:
            per_seq = per_seq / il.to(per_seq.dtype)
        return _reduce(per_seq, reduction)

    return apply(f, log_probs, op_name="ctc_loss")


def square_error_cost(input, label):
    return apply(lambda p, t: (p - t).square(), input, label,
                 op_name="square_error_cost")


def log_loss(input, label, epsilon=1e-4, name=None):
    def f(p, t):
        return -t * torch.log(p + epsilon) \
            - (1 - t) * torch.log(1 - p + epsilon)
    return apply(f, input, label, op_name="log_loss")


def sigmoid_focal_loss(logit, label, normalizer=None, alpha=0.25, gamma=2.0,
                       reduction="sum", name=None):
    norm = unwrap(normalizer) if normalizer is not None else None

    def f(z, t):
        p = torch.sigmoid(z)
        ce = z.clamp_min(0) - z * t + torch.log1p(torch.exp(-z.abs()))
        p_t = p * t + (1 - p) * (1 - t)
        a_t = alpha * t + (1 - alpha) * (1 - t)
        loss = a_t * (1 - p_t).pow(gamma) * ce
        if norm is not None:
            loss = loss / norm
        return _reduce(loss, reduction)

    return apply(f, logit, label, op_name="sigmoid_focal_loss")


def dice_loss(input, label, epsilon=1e-5, name=None):
    def f(p, t):
        t_oh = F.one_hot(t.squeeze(-1).long(), p.shape[-1]).to(p.dtype)
        dims = tuple(range(1, p.ndim))
        inter = (p * t_oh).sum(dims)
        union = p.sum(dims) + t_oh.sum(dims)
        return (1 - (2 * inter + epsilon) / (union + epsilon)).mean()
    return apply(f, input, label, op_name="dice_loss")


def npair_loss(anchor, positive, labels, l2_reg=0.002):
    lab = unwrap(labels).reshape(-1)

    def f(a, p):
        sim = a @ p.T
        tgt = (lab[:, None] == lab[None, :]).to(a.dtype)
        tgt = tgt / tgt.sum(1, keepdim=True)
        ce = -(tgt * torch.log_softmax(sim, 1)).sum(1).mean()
        reg = l2_reg * (a.square().sum(1).mean()
                        + p.square().sum(1).mean()) * 0.25
        return ce + reg

    return apply(f, anchor, positive, op_name="npair_loss")


def huber_loss(input, label, delta=1.0, reduction="mean", name=None):
    """Quadratic within ``delta``, linear beyond (smooth_l1_loss without
    its scaling)."""
    def f(x, y):
        d = x - y
        a = d.abs()
        out = torch.where(a <= delta, 0.5 * d * d, delta * (a - 0.5 * delta))
        return _reduce(out, reduction)

    return apply(f, input, label, op_name="huber_loss")
