"""Search and sort ops (counterpart of ``paddle_tpu/ops/search.py``).

Sorts are stable, so ties keep their order as in the JAX package;
``kthvalue`` and ``mode`` follow its tie rules (the stable sort's k-th;
the smallest most frequent value at its first position).
"""
from __future__ import annotations

import numpy as np
import torch

from ._dispatch import apply, apply_nondiff, unwrap, wrap
from ..framework.dtype import to_torch_dtype

__all__ = [
    "argmax", "argmin", "argsort", "sort", "topk", "top_k", "nonzero",
    "index_sample", "searchsorted", "kthvalue", "mode", "masked_select_idx",
    "bucketize",
]


def _arg(tfn, x, axis, keepdim, dtype):
    td = to_torch_dtype(dtype)

    def f(v):
        if axis is None:
            out = tfn(v.reshape(-1))
            return (out.reshape([1] * v.ndim) if keepdim else out).to(td)
        return tfn(v, dim=int(axis), keepdim=keepdim).to(td)
    return apply_nondiff(f, x)


def argmax(x, axis=None, keepdim=False, dtype="int64", name=None):
    return _arg(torch.argmax, x, axis, keepdim, dtype)


def argmin(x, axis=None, keepdim=False, dtype="int64", name=None):
    return _arg(torch.argmin, x, axis, keepdim, dtype)


def argsort(x, axis=-1, descending=False, name=None):
    return apply_nondiff(lambda v: torch.argsort(
        v, dim=axis, descending=descending, stable=True).to(torch.int64), x)


def sort(x, axis=-1, descending=False, name=None):
    return apply(lambda v: torch.sort(v, dim=axis, descending=descending,
                                      stable=True).values, x, op_name="sort")


def topk(x, k, axis=None, largest=True, sorted=True, name=None):
    k = int(unwrap(k))

    def f(v):
        ax = v.ndim - 1 if axis is None else axis % v.ndim
        vals, idx = torch.topk(v, k, dim=ax, largest=largest, sorted=True)
        return vals, idx.to(torch.int64)
    # values differentiated, indices through the aux channel
    return apply(f, x, op_name="topk", has_aux=True)


top_k = topk


def nonzero(x, as_tuple=False, name=None):
    v = unwrap(x).detach()
    if as_tuple:
        return tuple(wrap(i.to(torch.int64))
                     for i in torch.nonzero(v, as_tuple=True))
    return wrap(torch.nonzero(v).to(torch.int64))


def index_sample(x, index, name=None):
    return apply(lambda v, idx: torch.take_along_dim(v, idx, dim=1), x,
                 index, op_name="index_sample")


def searchsorted(sorted_sequence, values, out_int32=False, right=False,
                 name=None):
    def f(s, u):
        if s.ndim > 1:
            s = s.reshape(-1, s.shape[-1])
            out = torch.searchsorted(s, u.reshape(-1, u.shape[-1]),
                                     right=right).reshape(u.shape)
        else:
            out = torch.searchsorted(s, u, right=right)
        return out.to(torch.int32 if out_int32 else torch.int64)
    return apply_nondiff(f, sorted_sequence, values)


def bucketize(x, sorted_sequence, out_int32=False, right=False, name=None):
    return searchsorted(sorted_sequence, x, out_int32=out_int32, right=right)


def kthvalue(x, k, axis=-1, keepdim=False, name=None):
    def fv(v):
        s = torch.sort(v, dim=axis, stable=True).values
        out = s.select(axis, k - 1)
        return out.unsqueeze(axis) if keepdim else out

    def fi(v):
        si = torch.argsort(v, dim=axis, stable=True)
        out = si.select(axis, k - 1)
        return (out.unsqueeze(axis) if keepdim else out).to(torch.int64)
    return apply(fv, x, op_name="kthvalue"), apply_nondiff(fi, x)


def mode(x, axis=-1, keepdim=False, name=None):
    """On the host: the smallest most frequent value along ``axis`` and the
    first position where it occurs."""
    t = unwrap(x).detach()
    v = t.cpu().numpy()
    moved = np.moveaxis(v, axis, -1)
    rows = moved.reshape(-1, moved.shape[-1])
    vals = np.empty(rows.shape[0], v.dtype)
    idx = np.empty(rows.shape[0], np.int64)
    for i, r in enumerate(rows):
        uniq, counts = np.unique(r, return_counts=True)
        vals[i] = uniq[np.argmax(counts)]
        idx[i] = np.argmax(r == vals[i])
    vals = vals.reshape(moved.shape[:-1])
    idx = idx.reshape(moved.shape[:-1])
    if keepdim:
        vals, idx = np.expand_dims(vals, axis), np.expand_dims(idx, axis)
    return (wrap(torch.as_tensor(vals, device=t.device)),
            wrap(torch.as_tensor(idx, device=t.device)))


def masked_select_idx(x, mask):
    return apply_nondiff(lambda v, m: v[m.bool()], x, mask)
