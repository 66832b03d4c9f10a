"""Shape, layout and gather/scatter ops (counterpart of
``paddle_tpu/ops/manipulation.py``).

Functional throughout: a scatter or an ``index_put`` writes into a copy
(``torch`` records the write in the graph), and the ``*_`` variants rebind
the tensor they are called on. The ops whose output size depends on the
data (``unique``, ``masked_select``) read it on the host, as the JAX
package's do.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ._dispatch import apply, apply_nondiff, unwrap, wrap
from ..framework.dtype import to_torch_dtype
from ..framework.place import to_torch_device
from ..framework.tensor import Tensor

_py_slice = slice  # the builtin; shadowed below by the paddle `slice` op

__all__ = [
    "cast", "reshape", "reshape_", "transpose", "flatten", "squeeze",
    "unsqueeze", "concat", "stack", "split", "chunk", "tile", "expand",
    "expand_as", "broadcast_to", "broadcast_tensors", "gather", "gather_nd",
    "scatter", "scatter_", "scatter_nd", "scatter_nd_add", "index_select",
    "index_add", "index_put", "masked_select", "masked_fill", "where",
    "roll", "flip", "rot90", "unique", "unique_consecutive", "unbind",
    "unstack", "repeat_interleave", "take_along_axis", "put_along_axis",
    "tril", "triu", "diag", "diagflat", "meshgrid", "tensordot", "moveaxis",
    "as_complex", "as_real", "view", "view_as", "slice", "strided_slice",
    "crop", "pad", "shard_index", "numel", "rank", "assign", "fill_",
    "zero_", "fill_diagonal_", "fill_diagonal_tensor",
    "fill_diagonal_tensor_", "exponential_", "uniform_",
    "diag_embed", "flatten_", "squeeze_", "unsqueeze_", "tolist",
    "atleast_1d", "atleast_2d", "atleast_3d",
]


def _is_float(td: torch.dtype) -> bool:
    return td.is_floating_point or td.is_complex


def cast(x, dtype):
    td = to_torch_dtype(dtype)
    v = unwrap(x)
    if v.dtype == td:
        return x if isinstance(x, Tensor) else wrap(v)
    if _is_float(td):
        return apply(lambda u: u.to(td), x, op_name="cast")
    return apply_nondiff(lambda u: u.to(td), x)


def assign(x, output=None):
    if isinstance(x, Tensor):
        out = apply(torch.clone, x, op_name="assign")
    else:
        out = wrap(torch.as_tensor(np.asarray(x), device=to_torch_device()))
    if output is not None:
        output._inplace_assign(out)
        return output
    return out


def numel(x, name=None):
    v = unwrap(x)
    return wrap(torch.tensor(v.numel(), dtype=torch.int64, device=v.device))


def rank(x):
    v = unwrap(x)
    return wrap(torch.tensor(v.ndim, dtype=torch.int32, device=v.device))


def _resolve_shape(shape):
    if isinstance(shape, Tensor):
        return [int(s) for s in shape.tolist()]
    return [int(s.item()) if isinstance(s, Tensor) else int(s)
            for s in shape]


def _int(a):
    return int(a.item()) if isinstance(a, Tensor) else int(a)


def reshape(x, shape, name=None):
    shape = _resolve_shape(shape)
    return apply(lambda v: torch.reshape(v, shape), x, op_name="reshape")


def reshape_(x, shape, name=None):
    return x._inplace_assign(reshape(x, shape))


def transpose(x, perm, name=None):
    perm = [int(p) for p in perm]
    return apply(lambda v: v.permute(perm), x, op_name="transpose")


def moveaxis(x, source, destination, name=None):
    return apply(lambda v: torch.movedim(v, source, destination), x,
                 op_name="moveaxis")


def flatten(x, start_axis=0, stop_axis=-1, name=None):
    def f(v):
        nd = v.ndim
        a = start_axis % nd if nd else 0
        b = stop_axis % nd if nd else 0
        return v.reshape(list(v.shape[:a]) + [-1] + list(v.shape[b + 1:]))
    return apply(f, x, op_name="flatten")


def flatten_(x, start_axis=0, stop_axis=-1, name=None):
    return x._inplace_assign(flatten(x, start_axis, stop_axis))


def squeeze(x, axis=None, name=None):
    def f(v):
        if axis is None:
            return torch.squeeze(v)
        axes = axis if isinstance(axis, (list, tuple)) else [axis]
        axes = tuple(a % v.ndim for a in axes if v.shape[a % v.ndim] == 1)
        return torch.squeeze(v, axes) if axes else v
    return apply(f, x, op_name="squeeze")


def squeeze_(x, axis=None, name=None):
    return x._inplace_assign(squeeze(x, axis))


def unsqueeze(x, axis, name=None):
    axes = axis if isinstance(axis, (list, tuple)) else [axis]
    axes = sorted(_int(a) for a in axes)

    def f(v):
        out = v
        for a in axes:
            out = torch.unsqueeze(out, a)
        return out
    return apply(f, x, op_name="unsqueeze")


def unsqueeze_(x, axis, name=None):
    return x._inplace_assign(unsqueeze(x, axis))


def concat(x, axis=0, name=None):
    axis = _int(axis)
    return apply(lambda *vs: torch.cat(vs, dim=axis), *list(x),
                 op_name="concat")


def stack(x, axis=0, name=None):
    return apply(lambda *vs: torch.stack(vs, dim=axis), *list(x),
                 op_name="stack")


def split(x, num_or_sections, axis=0, name=None):
    axis = _int(axis)
    dim = unwrap(x).shape[axis]
    if isinstance(num_or_sections, int):
        if dim % num_or_sections != 0:
            raise ValueError(
                f"split expects dim {dim} divisible by {num_or_sections}; "
                "use chunk() for uneven splits")
        sizes = [dim // num_or_sections] * num_or_sections
    else:
        sizes = [int(s) for s in num_or_sections]
        if any(s < 0 for s in sizes):
            known = np.sum([s for s in sizes if s >= 0])
            sizes = [s if s >= 0 else int(dim - known) for s in sizes]
    return list(apply(lambda v: tuple(torch.split(v, sizes, dim=axis)), x,
                      op_name="split"))


def chunk(x, chunks, axis=0, name=None):
    dim = unwrap(x).shape[axis]
    per = (dim + chunks - 1) // chunks
    sizes = []
    left = dim
    while left > 0:
        sizes.append(per if per < left else left)
        left -= per
    return split(x, sizes, axis)


def unbind(x, axis=0, name=None):
    return list(apply(lambda v: tuple(torch.unbind(v, dim=axis)), x,
                      op_name="unbind"))


unstack = unbind


def tile(x, repeat_times, name=None):
    reps = _resolve_shape(repeat_times)
    return apply(lambda v: torch.tile(v, reps), x, op_name="tile")


def expand(x, shape, name=None):
    shape = _resolve_shape(shape)

    def f(v):
        tgt = list(shape)
        # paddle: -1 keeps the original dim
        offset = len(tgt) - v.ndim
        for i in range(len(tgt)):
            if tgt[i] == -1:
                tgt[i] = v.shape[i - offset]
        return torch.broadcast_to(v, tgt)
    return apply(f, x, op_name="expand")


def expand_as(x, y, name=None):
    return expand(x, list(unwrap(y).shape))


def broadcast_to(x, shape, name=None):
    return expand(x, shape)


def broadcast_tensors(inputs, name=None):
    shape = torch.broadcast_shapes(*[unwrap(t).shape for t in inputs])
    return [apply(lambda v: torch.broadcast_to(v, shape), t,
                  op_name="broadcast_tensors") for t in inputs]


def gather(x, index, axis=0, name=None):
    axis = _int(axis)
    return apply(lambda v, idx: torch.index_select(v, axis, idx.reshape(-1)),
                 x, index, op_name="gather")


def gather_nd(x, index, name=None):
    def f(v, idx):
        k = idx.shape[-1]
        return v[tuple(idx[..., i] for i in range(k))]
    return apply(f, x, index, op_name="gather_nd")


def scatter(x, index, updates, overwrite=True, name=None):
    def f(v, idx, u):
        idx = idx.reshape(-1)
        out = v.clone()
        if overwrite:
            out[idx] = u.to(v.dtype)
            return out
        # paddle overwrite=False: zero the target rows, then add
        out[idx] = 0
        return out.index_put((idx,), u.to(v.dtype), accumulate=True)
    return apply(f, x, index, updates, op_name="scatter")


def scatter_(x, index, updates, overwrite=True, name=None):
    return x._inplace_assign(scatter(x, index, updates, overwrite))


def scatter_nd(index, updates, shape, name=None):
    idx = unwrap(index)
    shape = _resolve_shape(shape)

    def f(u):
        z = torch.zeros(shape, dtype=u.dtype, device=u.device)
        k = idx.shape[-1]
        return z.index_put(tuple(idx[..., i] for i in range(k)), u,
                           accumulate=True)
    return apply(f, updates, op_name="scatter_nd")


def scatter_nd_add(x, index, updates, name=None):
    idx = unwrap(index)

    def f(v, u):
        k = idx.shape[-1]
        return v.index_put(tuple(idx[..., i] for i in range(k)),
                           u.to(v.dtype), accumulate=True)
    return apply(f, x, updates, op_name="scatter_nd_add")


def index_select(x, index, axis=0, name=None):
    return apply(lambda v, idx: torch.index_select(v, axis, idx.reshape(-1)),
                 x, index, op_name="index_select")


def index_add(x, index, axis, value, name=None):
    idx = unwrap(index).reshape(-1)
    return apply(lambda v, u: torch.index_add(v, axis, idx, u.to(v.dtype)),
                 x, value, op_name="index_add")


def index_put(x, indices, value, accumulate=False, name=None):
    idx = tuple(unwrap(i) for i in indices)
    return apply(lambda v, u: v.index_put(idx, u.to(v.dtype),
                                          accumulate=accumulate),
                 x, value, op_name="index_put")


def masked_select(x, mask, name=None):
    """Output size depends on the mask: not differentiated, as in the JAX
    package."""
    return apply_nondiff(lambda v, m: v[m.bool()], x, mask)


def masked_fill(x, mask, value, name=None):
    val = unwrap(value)
    return apply(lambda v, m: torch.where(
        m, torch.as_tensor(val, device=v.device).to(v.dtype), v), x, mask,
        op_name="masked_fill")


def where(condition, x=None, y=None, name=None):
    if x is None and y is None:
        return tuple(wrap(i) for i in torch.nonzero(unwrap(condition),
                                                    as_tuple=True))
    return apply(lambda c, a, b: torch.where(c, a, b), condition, x, y,
                 op_name="where")


def roll(x, shifts, axis=None, name=None):
    return apply(lambda v: torch.roll(v, shifts, dims=axis), x,
                 op_name="roll")


def flip(x, axis, name=None):
    axes = axis if isinstance(axis, (list, tuple)) else [axis]
    return apply(lambda v: torch.flip(v, dims=tuple(axes)), x, op_name="flip")


def rot90(x, k=1, axes=(0, 1), name=None):
    return apply(lambda v: torch.rot90(v, k, dims=tuple(axes)), x,
                 op_name="rot90")


def unique(x, return_index=False, return_inverse=False, return_counts=False,
           axis=None, dtype="int64", name=None):
    """On the host (the output size depends on the data)."""
    v = unwrap(x)
    res = np.unique(v.detach().cpu().numpy(), return_index=return_index,
                    return_inverse=return_inverse,
                    return_counts=return_counts, axis=axis)
    if not isinstance(res, tuple):
        res = (res,)
    td = to_torch_dtype(dtype)
    outs = [wrap(torch.as_tensor(res[0], device=v.device))]
    for r in res[1:]:
        outs.append(wrap(torch.as_tensor(r, device=v.device).to(td)))
    return outs[0] if len(outs) == 1 else tuple(outs)


def unique_consecutive(x, return_inverse=False, return_counts=False,
                       axis=None, dtype="int64", name=None):
    dev = unwrap(x).device
    v = unwrap(x).detach().cpu().numpy()
    if axis is None:
        v = v.reshape(-1)
        axis = 0
    keep = np.ones(v.shape[axis], bool)

    def sl(i):
        return tuple(_py_slice(None) if d != axis else i
                     for d in range(v.ndim))
    for i in range(1, v.shape[axis]):
        keep[i] = not np.array_equal(v[sl(i)], v[sl(i - 1)])
    idx = np.nonzero(keep)[0]
    out = [wrap(torch.as_tensor(np.take(v, idx, axis=axis), device=dev))]
    if return_inverse:
        inv = np.cumsum(keep) - 1
        out.append(wrap(torch.as_tensor(inv.astype(np.int64), device=dev)))
    if return_counts:
        counts = np.diff(np.append(idx, v.shape[axis]))
        out.append(wrap(torch.as_tensor(counts.astype(np.int64),
                                        device=dev)))
    return out[0] if len(out) == 1 else tuple(out)


def repeat_interleave(x, repeats, axis=None, name=None):
    r = unwrap(repeats)
    return apply(lambda v: torch.repeat_interleave(v, r, dim=axis), x,
                 op_name="repeat_interleave")


def take_along_axis(arr, indices, axis, name=None):
    return apply(lambda v, idx: torch.take_along_dim(v, idx, dim=axis), arr,
                 indices, op_name="take_along_axis")


def put_along_axis(arr, indices, values, axis, reduce="assign", name=None):
    idx = unwrap(indices)

    def f(v, u):
        u = torch.broadcast_to(torch.as_tensor(u, device=v.device)
                               .to(v.dtype), idx.shape)
        if reduce == "assign":
            return v.scatter(axis, idx, u)
        if reduce == "add":
            return v.scatter_add(axis, idx, u)
        if reduce in ("multiply", "mul"):
            return v.scatter_reduce(axis, idx, u, "prod", include_self=True)
        raise ValueError(f"unsupported reduce {reduce!r}")
    if isinstance(values, Tensor):
        return apply(f, arr, values, op_name="put_along_axis")
    return apply(lambda v: f(v, values), arr, op_name="put_along_axis")


def tril(x, diagonal=0, name=None):
    return apply(lambda v: torch.tril(v, diagonal), x, op_name="tril")


def triu(x, diagonal=0, name=None):
    return apply(lambda v: torch.triu(v, diagonal), x, op_name="triu")


def diag(x, offset=0, padding_value=0, name=None):
    def f(v):
        out = torch.diag(v, offset)
        if v.ndim == 1 and padding_value != 0:
            mask = torch.ones(out.shape, dtype=torch.bool, device=v.device)
            mask = torch.diag(torch.diagonal(mask, offset), offset)
            out = torch.where(mask, out, torch.as_tensor(
                padding_value, device=v.device).to(out.dtype))
        return out
    return apply(f, x, op_name="diag")


def diagflat(x, offset=0, name=None):
    return apply(lambda v: torch.diagflat(v, offset), x, op_name="diagflat")


def diag_embed(x, offset=0, dim1=-2, dim2=-1, name=None):
    return apply(lambda v: torch.diag_embed(v, offset, dim1, dim2), x,
                 op_name="diag_embed")


def meshgrid(*args, name=None):
    if len(args) == 1 and isinstance(args[0], (list, tuple)):
        args = tuple(args[0])
    return list(apply(lambda *vs: tuple(torch.meshgrid(*vs, indexing="ij")),
                      *args, op_name="meshgrid"))


def tensordot(x, y, axes=2, name=None):
    ax = axes.tolist() if isinstance(axes, Tensor) else axes
    return apply(lambda a, b: torch.tensordot(a, b, dims=ax), x, y,
                 op_name="tensordot")


def as_complex(x, name=None):
    return apply(lambda v: torch.complex(v[..., 0], v[..., 1]), x,
                 op_name="as_complex")


def as_real(x, name=None):
    return apply(lambda v: torch.stack([torch.real(v), torch.imag(v)], -1),
                 x, op_name="as_real")


def view(x, shape_or_dtype, name=None):
    if isinstance(shape_or_dtype, (list, tuple)):
        return reshape(x, shape_or_dtype)
    return cast(x, shape_or_dtype)


def view_as(x, other, name=None):
    return reshape(x, list(unwrap(other).shape))


def slice(input, axes, starts, ends):
    starts, ends = _resolve_shape(starts), _resolve_shape(ends)

    def f(v):
        out = v
        for ax, s, e in zip(axes, starts, ends):
            dim = v.shape[ax]
            s2 = (s + dim if s + dim > 0 else 0) if s < 0 else (
                s if s < dim else dim)
            e2 = (e + dim if e + dim > 0 else 0) if e < 0 else (
                e if e < dim else dim)
            out = out.narrow(ax, s2, e2 - s2 if e2 > s2 else 0)
        return out
    return apply(f, input, op_name="slice")


def strided_slice(x, axes, starts, ends, strides, name=None):
    def f(v):
        out = v
        for ax, s, e, st in zip(axes, _resolve_shape(starts),
                                _resolve_shape(ends),
                                _resolve_shape(strides)):
            rng = range(*_py_slice(s, e, st).indices(v.shape[ax]))
            out = torch.index_select(out, ax, torch.tensor(
                list(rng), dtype=torch.int64, device=v.device))
        return out
    return apply(f, x, op_name="strided_slice")


def crop(x, shape=None, offsets=None, name=None):
    shape = _resolve_shape(shape)
    offsets = _resolve_shape(offsets) if offsets is not None \
        else [0] * len(shape)

    def f(v):
        out = v
        for i, sh in enumerate(shape):
            size = sh if sh != -1 else v.shape[i] - offsets[i]
            # the start is clamped so the window fits, as XLA's
            # dynamic_slice clamps it
            start = offsets[i]
            start = start if start < v.shape[i] - size else v.shape[i] - size
            start = start if start > 0 else 0
            out = out.narrow(i, start, size)
        return out
    return apply(f, x, op_name="crop")


def _pad_index(n, lo, hi, mode, device):
    """Source positions of a dim of size ``n`` padded by ``(lo, hi)``."""
    pos = torch.arange(-lo, n + hi, device=device)
    if mode == "replicate":
        return pos.clamp(0, n - 1)
    if mode == "circular":
        return torch.remainder(pos, n)
    # reflect (no edge repeat), numpy's "reflect"
    period = 2 * (n - 1) if n > 1 else 1
    p = torch.remainder(pos, period)
    return torch.where(p >= n, period - p, p)


def pad(x, pad, mode="constant", value=0.0, data_format="NCHW", name=None):
    """``paddle.nn.functional.pad``'s pairs: all dims' pairs in order when
    ``len(pad) == 2 * ndim``, else the FIRST pair pads the LAST dim, the
    next the dim before it, and so on."""
    p = _resolve_shape(pad) if not isinstance(pad, int) else [pad]
    if mode not in ("constant", "reflect", "replicate", "circular"):
        raise ValueError(f"unsupported pad mode {mode!r}")

    def f(v):
        nd = v.ndim
        if len(p) == 2 * nd:
            width = [(p[2 * i], p[2 * i + 1]) for i in range(nd)]
        else:
            k = len(p) // 2
            pairs = [(p[2 * i], p[2 * i + 1]) for i in range(k)]
            width = [(0, 0)] * (nd - k) + pairs[::-1]
        if mode == "constant":
            flat = [w for lo_hi in width[::-1] for w in lo_hi]
            return F.pad(v, flat, mode="constant", value=value)
        out = v
        for d, (lo, hi) in enumerate(width):
            if lo or hi:
                out = torch.index_select(out, d, _pad_index(
                    v.shape[d], lo, hi, mode, v.device))
        return out
    return apply(f, x, op_name="pad")


def shard_index(input, index_num, nshards, shard_id, ignore_value=-1):
    def f(v):
        shard_size = (index_num + nshards - 1) // nshards
        in_shard = torch.div(v, shard_size, rounding_mode="floor") == shard_id
        return torch.where(in_shard, torch.remainder(v, shard_size),
                           torch.full_like(v, ignore_value))
    return apply_nondiff(f, input)


def fill_diagonal_(x, value, offset=0, wrap=False, name=None):
    """In-place diagonal fill; ``wrap`` repeats the diagonal every N+1
    rows of a tall matrix (numpy's ``fill_diagonal``)."""
    def f(v):
        out = v.clone()
        if v.ndim == 2:
            m, n = v.shape
            if wrap and m > n:
                flat = out.reshape(-1)
                flat[torch.arange(0, m * n, n + 1, device=v.device)] = value
                return flat.reshape(m, n)
            rows = torch.arange(m, device=v.device)
            cols = rows + offset
            ok = (cols >= 0) & (cols < n)
            out[rows[ok], cols[ok]] = value
            return out
        k = torch.arange(min(v.shape), device=v.device)
        out[tuple(k for _ in range(v.ndim))] = value
        return out
    return x._inplace_assign(apply(f, x, op_name="fill_diagonal_"))


def fill_diagonal_tensor(x, y, offset=0, dim1=0, dim2=1, name=None):
    """Write ``y`` onto the (dim1, dim2) diagonal of ``x``."""
    def f(v, w):
        v2 = torch.movedim(v, (dim1, dim2), (-2, -1)).clone()
        m, n = v2.shape[-2], v2.shape[-1]
        k = min(m, n - offset) if offset >= 0 else min(m + offset, n)
        rows = torch.arange(k, device=v.device) + (
            0 if offset >= 0 else -offset)
        cols = torch.arange(k, device=v.device) + (
            offset if offset >= 0 else 0)
        v2[..., rows, cols] = w.to(v.dtype)
        return torch.movedim(v2, (-2, -1), (dim1, dim2))
    return apply(f, x, y, op_name="fill_diagonal_tensor")


def fill_diagonal_tensor_(x, y, offset=0, dim1=0, dim2=1, name=None):
    return x._inplace_assign(fill_diagonal_tensor(x, y, offset, dim1, dim2))


def exponential_(x, lam=1.0, name=None):
    """In-place exponential-distribution fill."""
    from ..framework import random as random_mod

    def f(v):
        e = torch.empty(v.shape, dtype=torch.float32, device=v.device)
        e.exponential_(1.0, generator=random_mod.generator(v.device))
        return (e / lam).to(v.dtype)
    return x._inplace_assign(apply(f, x, op_name="exponential_"))


def uniform_(x, min=-1.0, max=1.0, seed=0, name=None):
    """In-place U(min, max) fill."""
    from ..framework import random as random_mod

    def f(v):
        gen = random_mod.generator(v.device)
        if seed:
            gen = torch.Generator(device=v.device)
            gen.manual_seed(int(seed))
        u = torch.rand(v.shape, dtype=torch.float32, device=v.device,
                       generator=gen)
        return (u * (max - min) + min).to(v.dtype)
    return x._inplace_assign(apply(f, x, op_name="uniform_"))


def fill_(x, value):
    return x._inplace_assign(apply(lambda v: torch.full_like(v, value), x,
                                   op_name="fill_"))


def zero_(x):
    return fill_(x, 0.0)


def tolist(x):
    return unwrap(x).detach().cpu().tolist()


def atleast_1d(*inputs, name=None):
    outs = [apply(torch.atleast_1d, t, op_name="atleast_1d") for t in inputs]
    return outs[0] if len(outs) == 1 else outs


def atleast_2d(*inputs, name=None):
    outs = [apply(torch.atleast_2d, t, op_name="atleast_2d") for t in inputs]
    return outs[0] if len(outs) == 1 else outs


def atleast_3d(*inputs, name=None):
    outs = [apply(torch.atleast_3d, t, op_name="atleast_3d") for t in inputs]
    return outs[0] if len(outs) == 1 else outs
