"""Every ported name of the six op modules (creation, math,
manipulation, linalg, logic, search) against the JAX package's, case by
case on the same numpy inputs (this file holds the table and runs the
creation and math cases; ``test_torch_ops_manip.py`` and
``test_torch_ops_linalg.py`` run the others): the value, and for float differentiable
ops the gradient of ``sum(out * w)`` (``w`` fixed random) against the JAX
tape's. The two packages must also agree on which outputs carry a
gradient. Random ops are held to shape and dtype (the frameworks draw
different numbers). Factorizations whose outputs are unique only up to
signs are held by reconstruction.

Two kinds of case cannot be held to the JAX package as it is, and are
held as stated instead:

- the in-place ops on a result (``reshape_(a * 1)``, ``increment`` ...):
  the JAX tape's rebind makes the op's node an input of itself and drops
  the gradient to the producer; the port's gradient is held to JAX's of
  the same function written out of place (``JAX_GRAD_REF``);
- ``index_add``: the JAX op raises (its ``slice(None)`` meets the paddle
  ``slice`` op of its module); the port is held to numpy
  (``JAX_BROKEN``).

Tolerances: f32 elementwise and transcendental ops rtol 1e-5, atol 1e-6;
matmul, reductions and gradients rtol 1e-5, atol 1e-5; f64 1e-12;
integer, bool and index results exactly equal.
"""
import numpy as np
import pytest

import paddle_tpu as jp
import paddle_tpu_torch as tp
from paddle_tpu_torch.framework import place as tplace

ELEM = dict(rtol=1e-5, atol=1e-6)
RED = dict(rtol=1e-5, atol=1e-5)
F64 = dict(rtol=1e-12, atol=1e-12)
E, R = "elementwise", "reduction"


@pytest.fixture(autouse=True)
def _cpu_place():
    prev = tplace._current_place
    tp.set_device("cpu")
    yield
    tplace._current_place = prev


_rng = np.random.default_rng(1)
A = _rng.standard_normal((4, 5)).astype(np.float32)
B = _rng.standard_normal((4, 5)).astype(np.float32)
_m = _rng.standard_normal((4, 4))
IN = {
    "A": A, "B": B,
    "POS": np.abs(A) + 0.5,
    "POS1": np.abs(A) + 1.5,
    "SMALL": np.clip(A * 0.3, -0.9, 0.9),
    "U01": _rng.uniform(0.1, 0.9, (4, 5)).astype(np.float32),
    "A3": (A * 3).astype(np.float32),
    "A345": _rng.standard_normal((3, 4, 5)).astype(np.float32),
    "A45T": _rng.standard_normal((3, 5, 4)).astype(np.float32),
    "V5": _rng.standard_normal(5).astype(np.float32),
    "V4": _rng.standard_normal(4).astype(np.float32),
    "R15": _rng.standard_normal((1, 5)).astype(np.float32),
    "W53": _rng.standard_normal((5, 3)).astype(np.float32),
    "W43": _rng.standard_normal((4, 3)).astype(np.float32),
    "W35": _rng.standard_normal((3, 5)).astype(np.float32),
    "K22": _rng.standard_normal((2, 2)).astype(np.float32),
    "K23": _rng.standard_normal((2, 3)).astype(np.float32),
    "C3": _rng.standard_normal((4, 3)).astype(np.float32),
    "D3": _rng.standard_normal((4, 3)).astype(np.float32),
    "P2": _rng.standard_normal((3, 2)).astype(np.float32),
    "SPD": _m @ _m.T + 4 * np.eye(4),
    "SPDL": np.linalg.cholesky(_m @ _m.T + 4 * np.eye(4)),
    "M": _rng.standard_normal((4, 4)) + 3 * np.eye(4),
    "MB": _rng.standard_normal((4, 2)),
    "TALL": _rng.standard_normal((6, 3)),
    "TB": _rng.standard_normal((6, 2)),
    "I": _rng.integers(0, 9, (4, 5)).astype(np.int64),
    "I2": _rng.integers(1, 6, (4, 5)).astype(np.int64),
    "I32": _rng.integers(0, 9, (4, 5)).astype(np.int32),
    "ISORT": np.sort(_rng.integers(0, 4, 12)).astype(np.int64),
    "BOOL": A > 0,
    "BOOL2": B > 0.3,
    "IDX2": np.array([3, 1], np.int64),
    "IDX4x1": np.array([[1], [0], [4], [2]], np.int64),
    "IDX4x2": np.array([[1, 3], [0, 0], [4, 2], [2, 1]], np.int64),
    "ND3x2": np.array([[0, 1], [3, 4], [2, 0]], np.int64),
    "ND3x1": np.array([[2], [0], [3]], np.int64),
    "UPD2x5": _rng.standard_normal((2, 5)).astype(np.float32),
    "UPD3x5": _rng.standard_normal((3, 5)).astype(np.float32),
    "UPD3": _rng.standard_normal(3).astype(np.float32),
    "UPD4x1": _rng.standard_normal((4, 1)).astype(np.float32),
    "UPD2": _rng.standard_normal(2).astype(np.float32),
    "MUXI": np.array([[1], [0], [1], [0]], np.int32),
    "SEQ": np.array([-1.0, 0.0, 0.5, 2.0, 3.5], np.float32),
    "VALS": np.array([-2.0, 0.25, 0.5, 3.0, 9.0], np.float32),
    "SPECIAL": np.array([1.0, np.nan, np.inf, -np.inf, -0.5], np.float32),
    "PROB": np.array([0.1, 0.2, 0.3, 0.4], np.float32),
    "HALF": np.full((4, 5), 0.5, np.float32),
    "SCALAR": np.float32(2.5),
}


def _lu_unpack(P):
    def f(m):
        lu_, piv = P.lu(m)
        return P.lu_unpack(lu_, piv)
    return f


def _svd_parts(P, a):
    u, s, vh = P.svd(a)
    return P.matmul(u * s.unsqueeze(0), vh), s


def _qr_parts(P, a):
    q, r = P.qr(a)
    return P.matmul(q, r), P.abs(r)


def _eigh_parts(P, m):
    w, v = P.eigh(m)
    return w, P.matmul(v * w.unsqueeze(0), v.T)


# name -> (fn(P, *tensors), input keys, kind, flags); a name may have
# several cases ("name#2")
CASES = {
    # ---- creation --------------------------------------------------------
    "to_tensor": (lambda P, a: P.to_tensor(a), ["A"], E, ""),
    "zeros": (lambda P: P.zeros([2, 3], dtype="int32"), [], E, ""),
    "ones": (lambda P: P.ones([2, 3]), [], E, ""),
    "full": (lambda P: P.full([2, 3], 7), [], E, ""),
    "full#bool": (lambda P: P.full([2], True), [], E, ""),
    "empty": (lambda P: P.empty([2, 3]), [], E, ""),
    "zeros_like": (lambda P, a: P.zeros_like(a), ["I"], E, ""),
    "ones_like": (lambda P, a: P.ones_like(a, dtype="float64"), ["A"], E,
                  ""),
    "full_like": (lambda P, a: P.full_like(a, 3.5), ["A"], E, ""),
    "empty_like": (lambda P, a: P.empty_like(a), ["A"], E, ""),
    "arange": (lambda P: P.arange(2, 11, 3), [], E, ""),
    "arange#float": (lambda P: P.arange(0.5, 3.0, 0.5), [], E, ""),
    "linspace": (lambda P: P.linspace(-1.0, 2.0, 7), [], E, ""),
    "logspace": (lambda P: P.logspace(0.0, 2.0, 5), [], E, ""),
    "eye": (lambda P: P.eye(3, 4), [], E, ""),
    "rand": (lambda P: P.rand([3, 4]), [], E, "random"),
    "randn": (lambda P: P.randn([3, 4]), [], E, "random"),
    "randint": (lambda P: P.randint(0, 5, [3, 4]), [], E, "random"),
    "randint_like": (lambda P, a: P.randint_like(a, 0, 5), ["I"], E,
                     "random"),
    "randperm": (lambda P: P.randperm(6), [], E, "random"),
    "uniform": (lambda P: P.uniform([3, 4], min=1.0, max=2.0), [], E,
                "random"),
    "normal": (lambda P: P.normal(0.0, 2.0, [3, 4]), [], E, "random"),
    "standard_normal": (lambda P: P.standard_normal([3, 4]), [], E,
                        "random"),
    "multinomial": (lambda P, p: P.multinomial(p, 3), ["PROB"], E, "random"),
    "bernoulli": (lambda P, p: P.bernoulli(p), ["HALF"], E, "random"),
    "poisson": (lambda P, p: P.poisson(p), ["POS"], E, "random"),
    "tril_indices": (lambda P: P.tril_indices(4, 3, -1), [], E, ""),
    "triu_indices": (lambda P: P.triu_indices(3, 4, 1), [], E, ""),
    "one_hot": (lambda P, i: P.one_hot(i, 9), ["I"], E, ""),
    "clone": (lambda P, a: P.clone(a), ["A"], E, ""),
    "complex": (lambda P, a, b: P.complex(a, b), ["A", "B"], E, ""),
    # ---- math: binary ----------------------------------------------------
    "add": (lambda P, a, b: P.add(a, b), ["A", "B"], E, ""),
    "add#scalar": (lambda P, a: P.add(a, 2), ["I"], E, ""),
    "subtract": (lambda P, a, b: P.subtract(a, b), ["A", "B"], E, ""),
    "multiply": (lambda P, a, b: P.multiply(a, b), ["A", "B"], E, ""),
    "multiply#promote": (lambda P, a, b: P.multiply(a, b), ["I32", "I"], E,
                         ""),
    "divide": (lambda P, a, b: P.divide(a, b), ["A", "POS"], E, ""),
    "divide#int": (lambda P, a, b: P.divide(a, b), ["I", "I2"], E, ""),
    "floor_divide": (lambda P, a, b: P.floor_divide(a, b), ["I", "I2"], E,
                     ""),
    "remainder": (lambda P, a, b: P.remainder(a, b), ["A3", "POS"], E, ""),
    "mod": (lambda P, a, b: P.mod(a, b), ["I", "I2"], E, ""),
    "pow": (lambda P, a: P.pow(a, 3), ["A"], E, ""),
    "pow#tensor": (lambda P, a, b: P.pow(a, b), ["POS", "SMALL"], E, ""),
    "float_power": (lambda P, a, b: P.float_power(a, b), ["POS", "SMALL"],
                    E, ""),
    "maximum": (lambda P, a, b: P.maximum(a, b), ["A", "B"], E, ""),
    "minimum": (lambda P, a, b: P.minimum(a, b), ["A", "B"], E, ""),
    "fmax": (lambda P, a, b: P.fmax(a, b), ["A", "B"], E, ""),
    "fmin": (lambda P, a, b: P.fmin(a, b), ["A", "B"], E, ""),
    "atan2": (lambda P, a, b: P.atan2(a, b), ["A", "B"], E, ""),
    "heaviside": (lambda P, a, b: P.heaviside(a, b), ["A", "B"], E, ""),
    "logaddexp": (lambda P, a, b: P.logaddexp(a, b), ["A", "B"], E, ""),
    "gcd": (lambda P, a, b: P.gcd(a, b), ["I", "I2"], E, ""),
    "lcm": (lambda P, a, b: P.lcm(a, b), ["I", "I2"], E, ""),
    # ---- math: unary -----------------------------------------------------
    **{n: ((lambda n: lambda P, a: getattr(P, n)(a))(n), [k], E, "")
       for n, k in [
           ("exp", "A"), ("expm1", "A"), ("log", "POS"), ("log2", "POS"),
           ("log10", "POS"), ("log1p", "POS"), ("sqrt", "POS"),
           ("rsqrt", "POS"), ("abs", "A"), ("sign", "A"), ("sin", "A"),
           ("cos", "A"), ("tan", "SMALL"), ("asin", "SMALL"),
           ("acos", "SMALL"), ("atan", "A"), ("sinh", "A"), ("cosh", "A"),
           ("tanh", "A"), ("asinh", "A"), ("acosh", "POS1"),
           ("atanh", "SMALL"), ("floor", "A3"), ("ceil", "A3"),
           ("round", "A3"), ("trunc", "A3"), ("frac", "A3"),
           ("reciprocal", "POS"), ("square", "A"), ("erf", "A"),
           ("erfinv", "SMALL"), ("lgamma", "POS"), ("digamma", "POS"),
           ("conj", "A"), ("real", "A"), ("imag", "A"), ("angle", "A"),
           ("rad2deg", "A"), ("deg2rad", "A"), ("logit", "U01"),
           ("stanh", "A"), ("isnan", "SPECIAL"), ("isinf", "SPECIAL"),
           ("isfinite", "SPECIAL"), ("nan_to_num", "SPECIAL")]},
    "exp#int": (lambda P, a: P.exp(a), ["I"], E, ""),
    "abs#int": (lambda P, a: P.abs(a), ["I32"], E, ""),
    "logit#eps": (lambda P, a: P.logit(a, eps=0.2), ["U01"], E, ""),
    "clip": (lambda P, a: P.clip(a, -0.5, 0.5), ["A"], E, ""),
    "clip#int": (lambda P, a: P.clip(a, 1, 3), ["I"], E, ""),
    "scale": (lambda P, a: P.scale(a, 2.0, 0.5), ["A"], E, ""),
    "scale#before": (lambda P, a: P.scale(a, 2.0, 0.5,
                                          bias_after_scale=False), ["A"], E,
                     ""),
    "multiplex": (lambda P, a, b, i: P.multiplex([a, b], i),
                  ["A", "B", "MUXI"], E, ""),
    "increment": (lambda P, a: P.increment(a * 1, 2.0), ["A"], E, ""),
    # ---- math: reductions and scans --------------------------------------
    "sum": (lambda P, a: P.sum(a, axis=1), ["A"], R, ""),
    "sum#int": (lambda P, a: P.sum(a), ["I32"], R, ""),
    "mean": (lambda P, a: P.mean(a, axis=[0, 1], keepdim=True), ["A"], R,
             ""),
    "max": (lambda P, a: P.max(a, axis=0), ["A"], R, ""),
    "min": (lambda P, a: P.min(a), ["A"], R, ""),
    "amax": (lambda P, a: P.amax(a, axis=1, keepdim=True), ["A"], R, ""),
    "amin": (lambda P, a: P.amin(a, axis=-1), ["A"], R, ""),
    "prod": (lambda P, a: P.prod(a, axis=1), ["A"], R, ""),
    "prod#all": (lambda P, a: P.prod(a), ["SMALL"], R, ""),
    "std": (lambda P, a: P.std(a, axis=1, unbiased=False), ["A"], R, ""),
    "var": (lambda P, a: P.var(a, axis=0, keepdim=True), ["A"], R, ""),
    "median": (lambda P, a: P.median(a, axis=1), ["A"], R, ""),
    "median#all": (lambda P, a: P.median(a), ["A"], R, ""),
    "nanmedian": (lambda P, a: P.nanmedian(a, axis=0), ["A"], R, ""),
    "nansum": (lambda P, a: P.nansum(a, axis=1), ["A"], R, ""),
    "nanmean": (lambda P, a: P.nanmean(a), ["A"], R, ""),
    "logsumexp": (lambda P, a: P.logsumexp(a, axis=1), ["A"], R, ""),
    "count_nonzero": (lambda P, a: P.count_nonzero(a, axis=1), ["I"], R,
                      ""),
    "any": (lambda P, a: P.any(a, axis=1), ["BOOL"], R, ""),
    "all": (lambda P, a: P.all(a, axis=[0, 1]), ["BOOL"], R, ""),
    "cumsum": (lambda P, a: P.cumsum(a, axis=1), ["A"], R, ""),
    "cumsum#int": (lambda P, a: P.cumsum(a, axis=0), ["I32"], R, ""),
    "cumsum#flat": (lambda P, a: P.cumsum(a), ["A"], R, ""),
    "cumprod": (lambda P, a: P.cumprod(a, dim=1), ["A"], R, ""),
    "logcumsumexp": (lambda P, a: P.logcumsumexp(a, axis=1), ["A"], R, ""),
    "cummax": (lambda P, a: P.cummax(a, axis=1), ["A"], R, ""),
    "cummax#ties": (lambda P, a: P.cummax(a, axis=1), ["I"], R, ""),
    "cummin": (lambda P, a: P.cummin(a, axis=0), ["A"], R, ""),
    "cummin#ties": (lambda P, a: P.cummin(a), ["I"], R, ""),
    # ---- math: composite -------------------------------------------------
    "add_n": (lambda P, a, b: P.add_n([a, b, a]), ["A", "B"], E, ""),
    "addmm": (lambda P, i, x, y: P.addmm(i, x, y, beta=0.5, alpha=2.0),
              ["A", "W43", "W35"], R, ""),
    "inner": (lambda P, a, b: P.inner(a, b), ["A", "B"], R, ""),
    "outer": (lambda P, a, b: P.outer(a, b), ["V5", "V4"], E, ""),
    "kron": (lambda P, a, b: P.kron(a, b), ["K22", "K23"], E, ""),
    "lerp": (lambda P, a, b: P.lerp(a, b, 0.3), ["A", "B"], E, ""),
    "lerp#tensor": (lambda P, a, b, w: P.lerp(a, b, w), ["A", "B", "U01"],
                    E, ""),
    "diff": (lambda P, a: P.diff(a, axis=1), ["A"], E, ""),
    "diff#n2": (lambda P, a, b: P.diff(a, n=2, axis=0, prepend=b), ["A",
                                                                     "B"],
                E, ""),
    "trace": (lambda P, a: P.trace(a, offset=1), ["A"], R, ""),
    "diagonal": (lambda P, a: P.diagonal(a, offset=-1), ["A"], E, ""),
    # ---- manipulation ----------------------------------------------------
    "cast": (lambda P, a: P.cast(a, "float64"), ["A"], E, ""),
    "cast#int": (lambda P, a: P.cast(a, "int32"), ["A3"], E, ""),
    "reshape": (lambda P, a: P.reshape(a, [5, -1]), ["A"], E, ""),
    "reshape_": (lambda P, a: P.reshape_(a * 1, [2, 10]), ["A"], E, ""),
    "transpose": (lambda P, a: P.transpose(a, [2, 0, 1]), ["A345"], E, ""),
    "flatten": (lambda P, a: P.flatten(a, 1, 2), ["A345"], E, ""),
    "flatten_": (lambda P, a: P.flatten_(a * 1), ["A345"], E, ""),
    "squeeze": (lambda P, a: P.squeeze(P.unsqueeze(a, 2), [0, 2]),
                ["R15"], E, ""),
    "squeeze_": (lambda P, a: P.squeeze_(a * 1), ["R15"], E, ""),
    "unsqueeze": (lambda P, a: P.unsqueeze(a, [0, 2]), ["A"], E, ""),
    "unsqueeze_": (lambda P, a: P.unsqueeze_(a * 1, -1), ["A"], E, ""),
    "concat": (lambda P, a, b: P.concat([a, b], axis=1), ["A", "B"], E, ""),
    "stack": (lambda P, a, b: P.stack([a, b], axis=1), ["A", "B"], E, ""),
    "split": (lambda P, a: P.split(a, [2, -1], axis=1), ["A"], E, ""),
    "chunk": (lambda P, a: P.chunk(a, 2, axis=1), ["A"], E, ""),
    "unbind": (lambda P, a: P.unbind(a, axis=1), ["A"], E, ""),
    "unstack": (lambda P, a: P.unstack(a), ["A"], E, ""),
    "tile": (lambda P, a: P.tile(a, [2, 1, 2]), ["A"], E, ""),
    "expand": (lambda P, a: P.expand(a, [3, 4, -1]), ["R15"], E, ""),
    "expand_as": (lambda P, a, b: P.expand_as(a, b), ["R15", "A"], E, ""),
    "broadcast_to": (lambda P, a: P.broadcast_to(a, [4, 5]), ["V5"], E, ""),
    "broadcast_tensors": (lambda P, a, b: P.broadcast_tensors([a, b]),
                          ["A", "V5"], E, ""),
    "gather": (lambda P, a, i: P.gather(a, i, axis=1), ["A", "IDX2"], E, ""),
    "gather_nd": (lambda P, a, i: P.gather_nd(a, i), ["A", "ND3x2"], E, ""),
    "scatter": (lambda P, a, i, u: P.scatter(a, i, u),
                ["A", "IDX2", "UPD2x5"], E, ""),
    "scatter#add": (lambda P, a, i, u: P.scatter(a, i, u, overwrite=False),
                    ["A", "IDX2", "UPD2x5"], E, ""),
    "scatter_": (lambda P, a, i, u: P.scatter_(a * 1, i, u),
                 ["A", "IDX2", "UPD2x5"], E, ""),
    "scatter_nd": (lambda P, i, u: P.scatter_nd(i, u, [4, 5]),
                   ["ND3x1", "UPD3x5"], E, ""),
    "scatter_nd_add": (lambda P, a, i, u: P.scatter_nd_add(a, i, u),
                       ["A", "ND3x2", "UPD3"], E, ""),
    "index_select": (lambda P, a, i: P.index_select(a, i, axis=0),
                     ["A", "IDX2"], E, ""),
    "index_add": (lambda P, a, i, u: P.index_add(a, i, 0, u),
                  ["A", "IDX2", "UPD2x5"], E, ""),
    "index_put": (lambda P, a, i, j, u: P.index_put(a, (i, j), u),
                  ["A", "IDX2", "IDX2", "UPD2"], E, ""),
    "index_put#acc": (lambda P, a, i, j, u: P.index_put(a, (i, j), u,
                                                         accumulate=True),
                      ["A", "IDX2", "IDX2", "UPD2"], E, ""),
    "masked_select": (lambda P, a, m: P.masked_select(a, m), ["A", "BOOL"],
                      E, ""),
    "masked_fill": (lambda P, a, m: P.masked_fill(a, m, 0.5),
                    ["A", "BOOL"], E, ""),
    "where": (lambda P, c, a, b: P.where(c, a, b), ["BOOL", "A", "B"], E,
              ""),
    "where#nonzero": (lambda P, c: P.where(c), ["BOOL"], E, ""),
    "roll": (lambda P, a: P.roll(a, 2, axis=1), ["A"], E, ""),
    "roll#flat": (lambda P, a: P.roll(a, -3), ["A"], E, ""),
    "flip": (lambda P, a: P.flip(a, [0, 1]), ["A"], E, ""),
    "rot90": (lambda P, a: P.rot90(a, k=3), ["A"], E, ""),
    "unique": (lambda P, a: P.unique(a, return_index=True,
                                     return_inverse=True,
                                     return_counts=True), ["I"], E, ""),
    "unique_consecutive": (lambda P, a: P.unique_consecutive(
        a, return_inverse=True, return_counts=True), ["ISORT"], E, ""),
    "repeat_interleave": (lambda P, a: P.repeat_interleave(a, 2, axis=0),
                          ["A"], E, ""),
    "take_along_axis": (lambda P, a, i: P.take_along_axis(a, i, 1),
                        ["A", "IDX4x2"], E, ""),
    "put_along_axis": (lambda P, a, i, u: P.put_along_axis(a, i, u, 1),
                       ["A", "IDX4x1", "UPD4x1"], E, ""),
    "put_along_axis#add": (lambda P, a, i, u: P.put_along_axis(
        a, i, u, 1, reduce="add"), ["A", "IDX4x1", "UPD4x1"], E, ""),
    "put_along_axis#mul": (lambda P, a, i: P.put_along_axis(
        a, i, 3.0, 1, reduce="multiply"), ["A", "IDX4x1"], E, ""),
    "tril": (lambda P, a: P.tril(a, -1), ["A"], E, ""),
    "triu": (lambda P, a: P.triu(a, 1), ["A"], E, ""),
    "diag": (lambda P, v: P.diag(v, 1), ["V4"], E, ""),
    "diag#pad": (lambda P, v: P.diag(v, -1, padding_value=2.0), ["V4"], E,
                 ""),
    "diag#2d": (lambda P, a: P.diag(a, 1), ["A"], E, ""),
    "diagflat": (lambda P, a: P.diagflat(a, -1), ["K23"], E, ""),
    "diag_embed": (lambda P, a: P.diag_embed(a, 1), ["K23"], E, ""),
    "meshgrid": (lambda P, a, b: P.meshgrid(a, b), ["V5", "V4"], E, ""),
    "tensordot": (lambda P, a, b: P.tensordot(a, b, axes=1), ["A", "W53"],
                  R, ""),
    "moveaxis": (lambda P, a: P.moveaxis(a, 0, 2), ["A345"], E, ""),
    "as_complex": (lambda P, a: P.as_complex(a), ["P2"], E, ""),
    "as_real": (lambda P, a, b: P.as_real(P.complex(a, b)), ["A", "B"], E,
                ""),
    "view": (lambda P, a: P.view(a, [10, 2]), ["A"], E, ""),
    "view_as": (lambda P, a, b: P.view_as(a, b), ["A", "A"], E, ""),
    "slice": (lambda P, a: P.slice(a, [0, 1], [1, -3], [3, 10]), ["A"], E,
              ""),
    "strided_slice": (lambda P, a: P.strided_slice(a, [0, 1], [0, 4],
                                                   [4, 0], [2, -2]),
                      ["A"], E, ""),
    "crop": (lambda P, a: P.crop(a, [2, 3], [1, 1]), ["A"], E, ""),
    "pad": (lambda P, a: P.pad(a, [1, 2]), ["A"], E, ""),
    "pad#reflect": (lambda P, a: P.pad(a, [2, 1, 1, 2], mode="reflect"),
                    ["A"], E, ""),
    "shard_index": (lambda P, i: P.shard_index(i, 9, 2, 1), ["I"], E, ""),
    "numel": (lambda P, a: P.numel(a), ["A"], E, ""),
    "rank": (lambda P, a: P.rank(a), ["A345"], E, ""),
    "assign": (lambda P, a: P.assign(a), ["A"], E, ""),
    "fill_": (lambda P, a: P.fill_(a * 1, 2.0), ["A"], E, ""),
    "zero_": (lambda P, a: P.zero_(a * 1), ["A"], E, ""),
    "fill_diagonal_": (lambda P, a: P.fill_diagonal_(a * 1, 5.0, offset=1),
                       ["A"], E, ""),
    "fill_diagonal_#wrap": (lambda P, a: P.fill_diagonal_(
        P.concat([a, a], 0) * 1, 5.0, wrap=True), ["A"], E, ""),
    "fill_diagonal_tensor": (lambda P, a, v: P.fill_diagonal_tensor(a, v),
                             ["A", "V4"], E, ""),
    "fill_diagonal_tensor_": (lambda P, a, v: P.fill_diagonal_tensor_(
        a * 1, v), ["A", "V4"], E, ""),
    "exponential_": (lambda P, a: P.exponential_(a * 1), ["A"], E,
                     "random"),
    "uniform_": (lambda P, a: P.uniform_(a * 1), ["A"], E, "random"),
    "tolist": (lambda P, a: P.tolist(a), ["I"], E, ""),
    "atleast_1d": (lambda P, a: P.atleast_1d(a), ["SCALAR"], E, ""),
    "atleast_2d": (lambda P, a: P.atleast_2d(a), ["V5"], E, ""),
    "atleast_3d": (lambda P, a: P.atleast_3d(a), ["A"], E, ""),
    # ---- linalg ----------------------------------------------------------
    "matmul": (lambda P, a, b: P.matmul(a, b, transpose_y=True),
               ["A", "B"], R, ""),
    "matmul#promote": (lambda P, a, b: P.matmul(a, b), ["SPD", "W43"], R,
                       ""),
    "dot": (lambda P, a, b: P.dot(a, b), ["A", "B"], R, ""),
    "mm": (lambda P, a, b: P.mm(a, b), ["A", "W53"], R, ""),
    "bmm": (lambda P, a, b: P.bmm(a, b), ["A345", "A45T"], R, ""),
    "mv": (lambda P, a, v: P.mv(a, v), ["A", "V5"], R, ""),
    "t": (lambda P, a: P.t(a), ["A"], E, ""),
    "norm": (lambda P, a: P.norm(a), ["A"], R, ""),
    "norm#axis": (lambda P, a: P.norm(a, p=3, axis=1), ["A"], R, ""),
    "norm#inf": (lambda P, a: P.norm(a, p="inf", axis=[0, 1]), ["A"], R,
                 ""),
    "dist": (lambda P, a, b: P.dist(a, b, 3), ["A", "B"], R, ""),
    "cross": (lambda P, a, b: P.cross(a, b), ["C3", "D3"], E, ""),
    "einsum": (lambda P, a, b: P.einsum("ij,kj->ik", a, b), ["A", "B"], R,
               ""),
    "cholesky": (lambda P, m: P.cholesky(m), ["SPD"], R, ""),
    "cholesky#upper": (lambda P, m: P.cholesky(m, upper=True), ["SPD"], R,
                       ""),
    "inv": (lambda P, m: P.inv(m), ["M"], R, ""),
    "inverse": (lambda P, m: P.inverse(m), ["M"], R, ""),
    "pinv": (lambda P, m: P.pinv(m), ["TALL"], R, ""),
    "svd": (_svd_parts, ["TALL"], R, ""),
    "qr": (_qr_parts, ["TALL"], R, ""),
    "lu": (lambda P, m: P.lu(m), ["M"], R, ""),
    "lu_unpack": (lambda P, m: _lu_unpack(P)(m), ["M"], R, ""),
    "eig": (lambda P, m: P.sort(P.real(P.eig(m)[0])), ["SPD"], R, ""),
    "eigvals": (lambda P, m: P.sort(P.real(P.eigvals(m))), ["SPD"], R, ""),
    "eigh": (_eigh_parts, ["SPD"], R, ""),
    "eigvalsh": (lambda P, m: P.eigvalsh(m), ["SPD"], R, ""),
    "det": (lambda P, m: P.det(m), ["M"], R, ""),
    "slogdet": (lambda P, m: P.slogdet(m), ["M"], R, ""),
    "solve": (lambda P, m, b: P.solve(m, b), ["M", "MB"], R, ""),
    "triangular_solve": (lambda P, m, b: P.triangular_solve(
        m, b, upper=False), ["SPDL", "MB"], R, ""),
    "triangular_solve#t": (lambda P, m, b: P.triangular_solve(
        m, b, upper=False, transpose=True), ["SPDL", "MB"], R, ""),
    "cholesky_solve": (lambda P, b, l: P.cholesky_solve(b, l),
                       ["MB", "SPDL"], R, ""),
    "lstsq": (lambda P, a, b: P.lstsq(a, b), ["TALL", "TB"], R, ""),
    "matrix_power": (lambda P, m: P.matrix_power(m, 3), ["M"], R, ""),
    "matrix_rank": (lambda P, a: P.matrix_rank(a), ["A"], R, ""),
    "multi_dot": (lambda P, a, b, c: P.multi_dot([a, b, c]),
                  ["A", "W53", "W35"], R, ""),
    "cov": (lambda P, a: P.cov(a), ["A"], R, ""),
    "cov#cols": (lambda P, a: P.cov(a, rowvar=False, ddof=False), ["A"], R,
                 ""),
    "corrcoef": (lambda P, a: P.corrcoef(a), ["A"], R, ""),
    "histogram": (lambda P, a: P.histogram(a, bins=5), ["A"], R, ""),
    "histogram#range": (lambda P, a: P.histogram(a, bins=4, min=-1, max=1),
                        ["A"], R, ""),
    "bincount": (lambda P, i: P.bincount(P.reshape(i, [-1])), ["I"], R, ""),
    "bincount#w": (lambda P, i, w: P.bincount(P.reshape(i, [-1]),
                                              weights=P.reshape(w, [-1])),
                   ["I", "A"], R, ""),
    # ---- logic -----------------------------------------------------------
    **{n: ((lambda n: lambda P, a, b: getattr(P, n)(a, b))(n), ["A", "B"],
           E, "")
       for n in ("equal", "not_equal", "greater_than", "greater_equal",
                 "less_than", "less_equal", "allclose", "isclose")},
    "equal_all": (lambda P, a, b: P.equal_all(a, b), ["A", "A"], E, ""),
    **{n: ((lambda n: lambda P, a, b: getattr(P, n)(a, b))(n),
           ["BOOL", "BOOL2"], E, "")
       for n in ("logical_and", "logical_or", "logical_xor")},
    "logical_not": (lambda P, a: P.logical_not(a), ["BOOL"], E, ""),
    **{n: ((lambda n: lambda P, a, b: getattr(P, n)(a, b))(n), ["I", "I2"],
           E, "")
       for n in ("bitwise_and", "bitwise_or", "bitwise_xor")},
    "bitwise_not": (lambda P, a: P.bitwise_not(a), ["I"], E, ""),
    "is_empty": (lambda P, a: P.is_empty(a), ["A"], E, ""),
    "is_tensor": (lambda P, a: P.is_tensor(a), ["A"], E, ""),
    # ---- search ----------------------------------------------------------
    "argmax": (lambda P, a: P.argmax(a, axis=1, keepdim=True), ["A"], E, ""),
    "argmin": (lambda P, a: P.argmin(a), ["A"], E, ""),
    "argsort": (lambda P, a: P.argsort(a, axis=0, descending=True), ["I"],
                E, ""),
    "sort": (lambda P, a: P.sort(a, axis=1, descending=True), ["A"], E, ""),
    "topk": (lambda P, a: P.topk(a, 3, axis=0, largest=False), ["A"], E,
             ""),
    "top_k": (lambda P, a: P.top_k(a, 2), ["A"], E, ""),
    "nonzero": (lambda P, a: P.nonzero(a), ["BOOL"], E, ""),
    "nonzero#tuple": (lambda P, a: P.nonzero(a, as_tuple=True), ["BOOL"], E,
                      ""),
    "index_sample": (lambda P, a, i: P.index_sample(a, i), ["A", "IDX4x2"],
                     E, ""),
    "searchsorted": (lambda P, s, v: P.searchsorted(s, v, right=True),
                     ["SEQ", "VALS"], E, ""),
    "bucketize": (lambda P, v, s: P.bucketize(v, s, out_int32=True),
                  ["VALS", "SEQ"], E, ""),
    "kthvalue": (lambda P, a: P.kthvalue(a, 2, axis=1), ["A"], E, ""),
    "mode": (lambda P, a: P.mode(a, axis=1), ["I"], E, ""),
    "masked_select_idx": (lambda P, a, m: P.masked_select_idx(a, m),
                          ["A", "BOOL"], E, ""),
}


def _diag_mask(m, n, offset=0, wrap_rows=None):
    mask = np.zeros((m, n), bool)
    if wrap_rows:
        mask.reshape(-1)[np.arange(0, m * n, n + 1)] = True
        return mask
    for i in range(m):
        if 0 <= i + offset < n:
            mask[i, i + offset] = True
    return mask


# the out-of-place JAX functions the in-place cases' gradients are held to
JAX_GRAD_REF = {
    "reshape_": lambda P, a: P.reshape(a, [2, 10]),
    "flatten_": lambda P, a: P.flatten(a),
    "squeeze_": lambda P, a: P.squeeze(a),
    "unsqueeze_": lambda P, a: P.unsqueeze(a, -1),
    "scatter_": lambda P, a, i, u: P.scatter(a, i, u),
    "increment": lambda P, a: a + 2.0,
    "fill_diagonal_": lambda P, a: P.where(
        P.to_tensor(_diag_mask(4, 5, 1)), P.full_like(a, 5.0), a),
    "fill_diagonal_#wrap": lambda P, a: P.where(
        P.to_tensor(_diag_mask(8, 5, wrap_rows=True)),
        P.full([8, 5], 5.0), P.concat([a, a], 0)),
    "fill_diagonal_tensor_": lambda P, a, v: P.fill_diagonal_tensor(a, v),
}


def _index_add_np(a, i, u):
    out = a.copy()
    np.add.at(out, i, u)
    return [out]


# cases the JAX op cannot run: a numpy oracle of the outputs, and of the
# gradient of sum(out * w) per input
JAX_BROKEN = {
    "index_add": (_index_add_np,
                  lambda w, a, i, u: [w, None, w[i]]),
}


def _flat(out):
    if isinstance(out, (tuple, list)) and out and not isinstance(
            out[0], (int, float)):
        res = []
        for o in out:
            res.extend(_flat(o))
        return res
    return [out]


def _run(P, name, fn=None):
    fn = fn or CASES[name][0]
    keys = CASES[name][1]
    ins = []
    for k in keys:
        arr = IN[k]
        diff = np.asarray(arr).dtype.kind == "f"
        ins.append(P.to_tensor(arr, stop_gradient=not diff))
    return ins, _flat(fn(P, *ins))


def _as_np(o):
    if isinstance(o, (bool, list, int, float)):
        return np.asarray(o)
    return np.asarray(o.numpy())


def _float_out(o):
    return not isinstance(o, (bool, list, int, float)) and \
        o.dtype.name in ("float16", "bfloat16", "float32", "float64")


def _module_of(name):
    import importlib
    base = name.split("#")[0]
    for mod in ("creation", "math", "manipulation", "linalg", "logic",
                "search"):
        if base in importlib.import_module(
                f"paddle_tpu_torch.ops.{mod}").__all__:
            return mod
    raise KeyError(name)


def names_of(*modules):
    return sorted(n for n in CASES if _module_of(n) in modules)


def _grads(P, ins, outs, ws):
    loss = None
    for o, w in zip(outs, ws):
        if w is not None:
            term = P.sum(o * P.to_tensor(w))
            loss = term if loss is None else loss + term
    loss.backward()
    return [None if t.grad is None else _as_np(t.grad) for t in ins]


def _check_broken(name):
    oracle, grad_oracle = JAX_BROKEN[name]
    t_in, t_out = _run(tp, name)
    arrays = [IN[k] for k in CASES[name][1]]
    want = oracle(*arrays)
    for o, w in zip(t_out, want):
        np.testing.assert_allclose(_as_np(o), w, **ELEM)
    w = np.random.default_rng(7).standard_normal(
        want[0].shape).astype(want[0].dtype)
    got = _grads(tp, t_in, t_out, [w])
    for g, gw in zip(got, grad_oracle(w, *arrays)):
        assert (g is None) == (gw is None)
        if g is not None:
            np.testing.assert_allclose(g, gw, **RED)


def check_case(name):
    """The port against the JAX package on case ``name``: outputs, which
    outputs carry a gradient, and the gradient of sum(out * w)."""
    if name in JAX_BROKEN:
        return _check_broken(name)
    _, _, kind, flags = CASES[name]
    j_in, j_out = _run(jp, name)
    t_in, t_out = _run(tp, name)
    assert len(j_out) == len(t_out), name
    tol = ELEM if kind == E else RED
    for i, (jo, to) in enumerate(zip(j_out, t_out)):
        ja, ta = _as_np(jo), _as_np(to)
        what = f"{name} output {i}"
        assert ja.shape == ta.shape, (what, ja.shape, ta.shape)
        assert ja.dtype == ta.dtype, (what, ja.dtype, ta.dtype)
        if "random" in flags:
            continue
        if ja.dtype.kind in "biu":
            np.testing.assert_array_equal(ta, ja, err_msg=what)
        else:
            np.testing.assert_allclose(
                ta, ja, err_msg=what,
                **(F64 if ja.dtype == np.float64 else tol))
        if _float_out(jo) and name not in JAX_GRAD_REF:
            assert jo.stop_gradient == to.stop_gradient, (what, "grad")
    if name in JAX_GRAD_REF:
        j_in, j_out = _run(jp, name, JAX_GRAD_REF[name])
    wrng = np.random.default_rng(7)
    ws = [wrng.standard_normal(_as_np(o).shape).astype(_as_np(o).dtype)
          if _float_out(o) and not o.stop_gradient else None for o in j_out]
    if "random" in flags or not any(w is not None for w in ws):
        return
    jg = _grads(jp, j_in, j_out, ws)
    tg = _grads(tp, t_in, t_out, ws)
    for i, (a, b) in enumerate(zip(jg, tg)):
        what = f"{name} grad of input {i}"
        assert (a is None) == (b is None), what
        if a is not None:
            assert a.dtype == b.dtype, (what, a.dtype, b.dtype)
            np.testing.assert_allclose(
                b, a, err_msg=what, **(F64 if a.dtype == np.float64
                                       else RED))


@pytest.mark.parametrize("name", names_of("creation", "math"))
def test_op_against_jax(name):
    check_case(name)


def test_every_ported_name_has_a_case():
    import importlib
    covered = {n.split("#")[0] for n in CASES}
    for mod in ("creation", "math", "manipulation", "linalg", "logic",
                "search"):
        tmod = importlib.import_module(f"paddle_tpu_torch.ops.{mod}")
        missing = set(tmod.__all__) - covered
        assert not missing, (mod, sorted(missing))
