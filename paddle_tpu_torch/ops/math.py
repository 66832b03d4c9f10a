"""Elementwise, reduction and scan ops (counterpart of
``paddle_tpu/ops/math.py``).

Each op is a torch function through the dispatch. Where JAX and torch
give different dtypes, the op follows the JAX package: a float-valued op
on an integer tensor computes in float64 (JAX's default float with 64-bit
types on), an integer scan keeps its input's dtype, and ``divide`` of two
integer tensors gives float32.
"""
from __future__ import annotations

import torch

from ._dispatch import apply, apply_nondiff, binop, unwrap
from ..framework.dtype import to_torch_dtype
from ..framework.tensor import Tensor

__all__ = [
    "add", "subtract", "multiply", "divide", "floor_divide", "remainder",
    "mod", "pow", "float_power", "maximum", "minimum", "fmax", "fmin",
    "exp", "expm1", "log", "log2", "log10", "log1p", "sqrt", "rsqrt",
    "abs", "sign", "sin", "cos", "tan", "asin", "acos", "atan", "atan2",
    "sinh", "cosh", "tanh", "asinh", "acosh", "atanh",
    "floor", "ceil", "round", "trunc", "frac",
    "reciprocal", "square", "erf", "erfinv", "lgamma", "digamma",
    "clip", "scale", "stanh", "multiplex",
    "sum", "mean", "max", "min", "prod", "std", "var", "median", "nanmedian",
    "nansum", "nanmean", "logsumexp", "amax", "amin",
    "cumsum", "cumprod", "cummax", "cummin", "logcumsumexp",
    "isnan", "isinf", "isfinite", "nan_to_num",
    "add_n", "addmm", "inner", "outer", "kron", "lerp", "diff", "rad2deg",
    "deg2rad", "angle", "conj", "real", "imag", "trace", "diagonal",
    "heaviside", "logaddexp", "logit", "gcd", "lcm", "count_nonzero",
    "increment", "any", "all",
]


def _flt(v):
    """An integer or bool tensor as float64 (the JAX package's default
    float), a float one unchanged."""
    return v if (v.is_floating_point() or v.is_complex()) \
        else v.to(torch.float64)


# ---- elementwise binary ------------------------------------------------------

def add(x, y, name=None):
    return binop(torch.add, x, y, op_name="add")


def subtract(x, y, name=None):
    return binop(torch.subtract, x, y, op_name="subtract")


def multiply(x, y, name=None):
    return binop(torch.multiply, x, y, op_name="multiply")


def divide(x, y, name=None):
    def f(a, b):
        # int/int -> float32 (paddle)
        if not (a.is_floating_point() or a.is_complex()) and not (
                b.is_floating_point() or b.is_complex()):
            a, b = a.to(torch.float32), b.to(torch.float32)
        return torch.true_divide(a, b)
    return binop(f, x, y, op_name="divide")


def floor_divide(x, y, name=None):
    return binop(lambda a, b: torch.div(a, b, rounding_mode="floor"), x, y,
                 op_name="floor_divide")


def remainder(x, y, name=None):
    return binop(torch.remainder, x, y, op_name="remainder")


mod = remainder


def pow(x, y, name=None):
    # a python-scalar exponent stays a scalar: integer powers stay exact
    def p(v, e):
        if isinstance(e, float) and not v.is_floating_point() \
                and not v.is_complex():
            v = v.to(torch.float64)
        return torch.pow(v, e)
    if not isinstance(y, Tensor) and not isinstance(x, Tensor):
        from .creation import to_tensor
        return pow(to_tensor(x), y)
    if not isinstance(y, Tensor):
        return apply(lambda v: p(v, y), x, op_name="pow")
    if not isinstance(x, Tensor):
        return apply(lambda v: torch.pow(x, v), y, op_name="pow")
    return binop(torch.pow, x, y, op_name="pow")


def float_power(x, y, name=None):
    # the power in the operands' float dtype, then widened (JAX's order)
    return binop(lambda a, b: torch.pow(_flt(a), _flt(b)).to(torch.float64),
                 x, y, op_name="float_power")


def maximum(x, y, name=None):
    return binop(torch.maximum, x, y, op_name="maximum")


def minimum(x, y, name=None):
    return binop(torch.minimum, x, y, op_name="minimum")


def fmax(x, y, name=None):
    return binop(torch.fmax, x, y, op_name="fmax")


def fmin(x, y, name=None):
    return binop(torch.fmin, x, y, op_name="fmin")


def logaddexp(x, y, name=None):
    return binop(lambda a, b: torch.logaddexp(_flt(a), _flt(b)), x, y,
                 op_name="logaddexp")


def atan2(x, y, name=None):
    return binop(lambda a, b: torch.atan2(_flt(a), _flt(b)), x, y,
                 op_name="atan2")


def gcd(x, y, name=None):
    return apply_nondiff(torch.gcd, x, y)


def lcm(x, y, name=None):
    return apply_nondiff(torch.lcm, x, y)


def heaviside(x, y, name=None):
    # written out: torch's heaviside has no derivative; this one passes
    # the gradient to ``y`` where ``x`` is 0, as the JAX package's does
    def f(a, b):
        # 0 and 1 that stay in the graph of ``a`` (a zero gradient)
        zero = torch.where(torch.zeros_like(a, dtype=torch.bool), a, 0.0)
        one = zero + 1
        return torch.where(a < 0, zero, torch.where(a > 0, one, b))
    return binop(f, x, y, op_name="heaviside")


# ---- elementwise unary -------------------------------------------------------

def _unary(tfn, name, to_float=True):
    def op(x, name_=None, name=None):
        return apply((lambda v: tfn(_flt(v))) if to_float else tfn, x,
                     op_name=op.__name__)
    op.__name__ = name
    return op


def _int_identity(tfn):
    """``tfn`` on floats; an integer tensor is returned as it is (JAX's
    floor/ceil/round/trunc of an integer)."""
    def f(v):
        return tfn(v) if (v.is_floating_point() or v.is_complex()) \
            else v.clone()
    return f


def _imag(v):
    if v.is_complex():
        return torch.imag(v)
    # zeros that stay in the graph (a zero gradient), as JAX's imag
    return torch.where(torch.zeros_like(v, dtype=torch.bool), v, 0.0)


def _real(v):
    return torch.real(v) if v.is_complex() else v.clone()


exp = _unary(torch.exp, "exp")
expm1 = _unary(torch.expm1, "expm1")
log = _unary(torch.log, "log")
log2 = _unary(torch.log2, "log2")
log10 = _unary(torch.log10, "log10")
log1p = _unary(torch.log1p, "log1p")
sqrt = _unary(torch.sqrt, "sqrt")
rsqrt = _unary(torch.rsqrt, "rsqrt")
abs = _unary(torch.abs, "abs", to_float=False)
sign = _unary(torch.sign, "sign", to_float=False)
sin = _unary(torch.sin, "sin")
cos = _unary(torch.cos, "cos")
tan = _unary(torch.tan, "tan")
asin = _unary(torch.asin, "asin")
acos = _unary(torch.acos, "acos")
atan = _unary(torch.atan, "atan")
sinh = _unary(torch.sinh, "sinh")
cosh = _unary(torch.cosh, "cosh")
tanh = _unary(torch.tanh, "tanh")
asinh = _unary(torch.asinh, "asinh")
acosh = _unary(torch.acosh, "acosh")
atanh = _unary(torch.atanh, "atanh")
floor = _unary(_int_identity(torch.floor), "floor", to_float=False)
ceil = _unary(_int_identity(torch.ceil), "ceil", to_float=False)
round = _unary(_int_identity(torch.round), "round", to_float=False)
trunc = _unary(_int_identity(torch.trunc), "trunc", to_float=False)
reciprocal = _unary(torch.reciprocal, "reciprocal")
square = _unary(torch.square, "square", to_float=False)
erf = _unary(torch.erf, "erf")
erfinv = _unary(torch.erfinv, "erfinv")
lgamma = _unary(torch.lgamma, "lgamma")
digamma = _unary(torch.digamma, "digamma")
conj = _unary(torch.conj_physical, "conj", to_float=False)
real = _unary(_real, "real", to_float=False)
imag = _unary(_imag, "imag", to_float=False)
angle = _unary(torch.angle, "angle")
rad2deg = _unary(torch.rad2deg, "rad2deg")
deg2rad = _unary(torch.deg2rad, "deg2rad")


def frac(x, name=None):
    return apply(lambda v: v - torch.trunc(v), x, op_name="frac")


def logit(x, eps=None, name=None):
    def f(v):
        u = _flt(v)
        if eps is not None:
            u = torch.clamp(u, eps, 1.0 - eps)
        return torch.log(u / (1.0 - u))
    return apply(f, x, op_name="logit")


def stanh(x, scale_a=0.67, scale_b=1.7159, name=None):
    return apply(lambda v: scale_b * torch.tanh(scale_a * v), x,
                 op_name="stanh")


def clip(x, min=None, max=None, name=None):
    lo, hi = unwrap(min), unwrap(max)

    def f(v):
        out = v
        if lo is not None:
            out = torch.maximum(out, torch.as_tensor(lo, dtype=v.dtype,
                                                     device=v.device))
        if hi is not None:
            out = torch.minimum(out, torch.as_tensor(hi, dtype=v.dtype,
                                                     device=v.device))
        return out
    return apply(f, x, op_name="clip")


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None,
          name=None):
    s, b = unwrap(scale), unwrap(bias)

    def f(v):
        st = torch.as_tensor(s, device=v.device).to(v.dtype)
        bt = torch.as_tensor(b, device=v.device).to(v.dtype)
        return v * st + bt if bias_after_scale else (v + bt) * st
    return apply(f, x, op_name="scale")


def nan_to_num(x, nan=0.0, posinf=None, neginf=None, name=None):
    return apply(lambda v: torch.nan_to_num(v, nan=nan, posinf=posinf,
                                            neginf=neginf), x,
                 op_name="nan_to_num")


def increment(x, value=1.0, name=None):
    out = apply(lambda v: v + torch.as_tensor(value, device=v.device)
                .to(v.dtype), x, op_name="increment")
    if isinstance(x, Tensor):
        x._inplace_assign(out)
    return x


# ---- reductions --------------------------------------------------------------

def _norm_axis(axis):
    if axis is None:
        return None
    if isinstance(axis, Tensor):
        axis = axis.tolist()
    if isinstance(axis, (list, tuple)):
        return tuple(int(a) for a in axis)
    return int(axis)


def _dims(v, axis):
    """``axis`` as a tuple of dims (every dim for None)."""
    if axis is None:
        return tuple(range(v.ndim))
    return axis if isinstance(axis, tuple) else (axis,)


def _reduce_each(tfn, v, axis, keepdim):
    """Reduce with ``tfn(v, dim, keepdim)``, which takes one dim, over
    every dim of ``axis``."""
    if v.ndim == 0:
        return tfn(v.reshape(1), 0, keepdim=False)
    dims = sorted((d % v.ndim for d in _dims(v, axis)), reverse=True)
    out = v
    for d in dims:
        out = tfn(out, d, keepdim=keepdim)
    return out


def _td(dtype):
    return to_torch_dtype(dtype) if dtype is not None else None


def sum(x, axis=None, dtype=None, keepdim=False, name=None):
    axis, td = _norm_axis(axis), _td(dtype)

    def f(v):
        if v.ndim == 0:
            return torch.sum(v, dtype=td)
        return torch.sum(v, dim=_dims(v, axis), keepdim=keepdim, dtype=td)
    return apply(f, x, op_name="sum")


def nansum(x, axis=None, dtype=None, keepdim=False, name=None):
    axis, td = _norm_axis(axis), _td(dtype)
    return apply(lambda v: torch.nansum(v, dim=_dims(v, axis),
                                        keepdim=keepdim, dtype=td)
                 if v.is_floating_point() else
                 torch.sum(v, dim=_dims(v, axis), keepdim=keepdim, dtype=td),
                 x, op_name="nansum")


def mean(x, axis=None, keepdim=False, name=None):
    axis = _norm_axis(axis)
    return apply(lambda v: torch.mean(_flt(v), dim=_dims(v, axis),
                                      keepdim=keepdim), x, op_name="mean")


def nanmean(x, axis=None, keepdim=False, name=None):
    axis = _norm_axis(axis)
    return apply(lambda v: torch.nanmean(_flt(v), dim=_dims(v, axis),
                                         keepdim=keepdim), x,
                 op_name="nanmean")


def max(x, axis=None, keepdim=False, name=None):
    axis = _norm_axis(axis)
    return apply(lambda v: torch.amax(v, dim=_dims(v, axis),
                                      keepdim=keepdim), x, op_name="max")


def min(x, axis=None, keepdim=False, name=None):
    axis = _norm_axis(axis)
    return apply(lambda v: torch.amin(v, dim=_dims(v, axis),
                                      keepdim=keepdim), x, op_name="min")


amax, amin = max, min


def prod(x, axis=None, keepdim=False, dtype=None, name=None):
    axis, td = _norm_axis(axis), _td(dtype)

    def f(v):
        if td is not None:
            v = v.to(td)
        elif not (v.is_floating_point() or v.is_complex()):
            v = v.to(torch.int64)
        return _reduce_each(lambda u, d, keepdim: torch.prod(
            u, d, keepdim=keepdim), v, axis, keepdim)
    return apply(f, x, op_name="prod")


def std(x, axis=None, unbiased=True, keepdim=False, name=None):
    axis = _norm_axis(axis)
    return apply(lambda v: torch.std(_flt(v), dim=_dims(v, axis),
                                     correction=1 if unbiased else 0,
                                     keepdim=keepdim), x, op_name="std")


def var(x, axis=None, unbiased=True, keepdim=False, name=None):
    axis = _norm_axis(axis)
    return apply(lambda v: torch.var(_flt(v), dim=_dims(v, axis),
                                     correction=1 if unbiased else 0,
                                     keepdim=keepdim), x, op_name="var")


def _quantile_half(qfn, v, axis, keepdim):
    """numpy's median (the mean of the two middle values) over ``axis``
    (an int or None) through ``torch.quantile``."""
    u = _flt(v)
    if axis is None:
        out = qfn(u.reshape(-1), 0.5)
        return out.reshape([1] * v.ndim) if keepdim else out
    return qfn(u, 0.5, dim=axis, keepdim=keepdim)


def median(x, axis=None, keepdim=False, name=None):
    axis = _norm_axis(axis)
    return apply(lambda v: _quantile_half(torch.quantile, v, axis, keepdim),
                 x, op_name="median")


def nanmedian(x, axis=None, keepdim=False, name=None):
    axis = _norm_axis(axis)
    return apply(lambda v: _quantile_half(torch.nanquantile, v, axis,
                                          keepdim), x, op_name="nanmedian")


def logsumexp(x, axis=None, keepdim=False, name=None):
    axis = _norm_axis(axis)
    return apply(lambda v: torch.logsumexp(_flt(v), dim=_dims(v, axis),
                                           keepdim=keepdim), x,
                 op_name="logsumexp")


def count_nonzero(x, axis=None, keepdim=False, name=None):
    axis = _norm_axis(axis)
    return apply_nondiff(lambda v: torch.sum(v != 0, dim=_dims(v, axis),
                                             keepdim=keepdim), x)


def all(x, axis=None, keepdim=False, name=None):
    axis = _norm_axis(axis)
    return apply_nondiff(lambda v: _reduce_each(
        lambda u, d, keepdim: torch.all(u, d, keepdim=keepdim),
        v.bool(), axis, keepdim), x)


def any(x, axis=None, keepdim=False, name=None):
    axis = _norm_axis(axis)
    return apply_nondiff(lambda v: _reduce_each(
        lambda u, d, keepdim: torch.any(u, d, keepdim=keepdim),
        v.bool(), axis, keepdim), x)


# ---- scans -------------------------------------------------------------------

def _scan_dtype(v, td):
    # an integer scan keeps its dtype unless one is asked for (JAX)
    if td is not None:
        return td
    return None if (v.is_floating_point() or v.is_complex()) else v.dtype


def cumsum(x, axis=None, dtype=None, name=None):
    td = _td(dtype)

    def f(v):
        if axis is None:
            v = v.reshape(-1)
        return torch.cumsum(v, dim=0 if axis is None else int(axis),
                            dtype=_scan_dtype(v, td))
    return apply(f, x, op_name="cumsum")


def cumprod(x, dim=None, dtype=None, name=None):
    td = _td(dtype)

    def f(v):
        if dim is None:
            v = v.reshape(-1)
        return torch.cumprod(v, dim=0 if dim is None else int(dim),
                             dtype=_scan_dtype(v, td))
    return apply(f, x, op_name="cumprod")


def logcumsumexp(x, axis=None, name=None):
    def f(v):
        if axis is None:
            v = v.reshape(-1)
        return torch.logcumsumexp(_flt(v), dim=0 if axis is None
                                  else int(axis))
    return apply(f, x, op_name="logcumsumexp")


def _cum_arg(tfn, x, axis, dtype):
    """Running max/min and the index of its latest occurrence (ties take
    the later index, as the JAX package's scan does)."""
    ax = 0 if axis is None else int(axis)

    def values(v):
        return tfn(v.reshape(-1) if axis is None else v, ax).values
    out = apply(values, x, op_name=tfn.__name__)
    v = unwrap(x).detach()
    v = v.reshape(-1) if axis is None else v
    n = v.shape[ax]
    shape = [1] * v.ndim
    shape[ax] = n
    pos = torch.arange(n, device=v.device).reshape(shape).expand(v.shape)
    # the latest position where the running value equals the element
    hit = torch.where(v == out._value.detach(), pos, torch.zeros_like(pos))
    idx = torch.cummax(hit, ax).values
    return out, Tensor._wrap(idx.to(to_torch_dtype(dtype)), True)


def cummax(x, axis=None, dtype="int64", name=None):
    return _cum_arg(torch.cummax, x, axis, dtype)


def cummin(x, axis=None, dtype="int64", name=None):
    return _cum_arg(torch.cummin, x, axis, dtype)


# ---- predicates --------------------------------------------------------------

def isnan(x, name=None):
    return apply_nondiff(torch.isnan, x)


def isinf(x, name=None):
    return apply_nondiff(torch.isinf, x)


def isfinite(x, name=None):
    return apply_nondiff(torch.isfinite, x)


# ---- composite ---------------------------------------------------------------

def add_n(inputs, name=None):
    if isinstance(inputs, Tensor):
        return inputs
    return apply(lambda *vs: torch.stack(vs).sum(0) if len(vs) > 1
                 else vs[0].clone(), *inputs, op_name="add_n")


def addmm(input, x, y, beta=1.0, alpha=1.0, name=None):
    return apply(lambda i, a, b: beta * i + alpha * (a @ b), input, x, y,
                 op_name="addmm")


def inner(x, y, name=None):
    return apply(torch.inner, x, y, op_name="inner")


def outer(x, y, name=None):
    return apply(lambda a, b: torch.outer(a.reshape(-1), b.reshape(-1)),
                 x, y, op_name="outer")


def kron(x, y, name=None):
    return apply(torch.kron, x, y, op_name="kron")


def lerp(x, y, weight, name=None):
    if isinstance(weight, Tensor):
        return apply(lambda a, b, w: a + w * (b - a), x, y, weight,
                     op_name="lerp")
    return apply(lambda a, b: a + weight * (b - a), x, y, op_name="lerp")


def diff(x, n=1, axis=-1, prepend=None, append=None, name=None):
    pre, app = unwrap(prepend), unwrap(append)
    return apply(lambda v: torch.diff(v, n=n, dim=axis, prepend=pre,
                                      append=app), x, op_name="diff")


def trace(x, offset=0, axis1=0, axis2=1, name=None):
    def f(v):
        d = torch.diagonal(v, offset=offset, dim1=axis1, dim2=axis2)
        if not (v.is_floating_point() or v.is_complex()):
            d = d.to(torch.int64)
        return d.sum(-1)
    return apply(f, x, op_name="trace")


def diagonal(x, offset=0, axis1=0, axis2=1, name=None):
    return apply(lambda v: torch.diagonal(v, offset=offset, dim1=axis1,
                                          dim2=axis2).clone(), x,
                 op_name="diagonal")


def multiplex(inputs, index, name=None):
    idx = unwrap(index).reshape(-1)
    return apply(lambda *vs: torch.stack(vs, 0)[
        idx, torch.arange(vs[0].shape[0], device=vs[0].device)],
        *inputs, op_name="multiplex")

