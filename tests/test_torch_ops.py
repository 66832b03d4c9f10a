"""The port's op surface against the JAX package's: every case of
``tests/test_op_numeric.py`` (the numpy oracle sweep and its finite
differences) run through both packages, and the closure of the six op
modules' ``__all__``.

Tolerances: f32 elementwise and transcendental ops rtol 1e-5, atol 1e-6;
matmul, reductions and gradients rtol 1e-5, atol 1e-5; f64 1e-12; integer,
bool and index results exactly equal. The numpy oracle keeps the JAX
test's own tolerances.
"""
import numpy as np
import pytest

import paddle_tpu as jp
import paddle_tpu_torch as tp
from paddle_tpu import ops as jops
from paddle_tpu_torch import ops as tops
from paddle_tpu_torch.framework import place as tplace

ELEM = dict(rtol=1e-5, atol=1e-6)
RED = dict(rtol=1e-5, atol=1e-5)
F64 = dict(rtol=1e-12, atol=1e-12)

# the names of the six op modules not ported yet, by module (ROADMAP.md,
# Queue 1 item 5 lists the same names)
NOT_PORTED = {"creation": set(), "math": set(), "manipulation": set(),
              "linalg": set(), "logic": set(), "search": set()}


@pytest.fixture(autouse=True)
def _cpu_place():
    prev = tplace._current_place
    tp.set_device("cpu")
    yield
    tplace._current_place = prev


def _np(t):
    return np.asarray(t.numpy())


def _pair(pfn_name, x, tol, *rest, **kw):
    """Run op ``pfn_name`` of both packages on ``x`` (and ``rest``); hold
    the port to JAX at ``tol`` (exactly for integer and bool results)."""
    got = []
    for P, ops in ((jp, jops), (tp, tops)):
        args = [P.to_tensor(a) for a in (x, *rest)]
        got.append(_np(getattr(ops, pfn_name)(*args, **kw)))
    j, t = got
    assert j.dtype == t.dtype and j.shape == t.shape, (pfn_name, j.dtype,
                                                       t.dtype)
    if j.dtype.kind in "biu":
        np.testing.assert_array_equal(t, j, err_msg=pfn_name)
    else:
        np.testing.assert_allclose(t, j, err_msg=pfn_name,
                                   **(F64 if j.dtype == np.float64 else tol))
    return t


RNG = np.random.default_rng(0)
A = RNG.standard_normal((4, 5)).astype(np.float32)
B_ = RNG.standard_normal((4, 5)).astype(np.float32)
POS = np.abs(A) + 0.5
INTS = RNG.integers(0, 9, (4, 5)).astype(np.int64)

# (name, numpy_fn, inputs): the JAX test's tables
UNARY = [
    ("exp", np.exp, A), ("log", np.log, POS), ("log2", np.log2, POS),
    ("log10", np.log10, POS), ("log1p", np.log1p, POS),
    ("sqrt", np.sqrt, POS), ("rsqrt", lambda x: 1 / np.sqrt(x), POS),
    ("abs", np.abs, A), ("sin", np.sin, A), ("cos", np.cos, A),
    ("tan", np.tan, A * 0.3), ("asin", np.arcsin, A * 0.3),
    ("acos", np.arccos, A * 0.3), ("atan", np.arctan, A),
    ("sinh", np.sinh, A), ("cosh", np.cosh, A), ("tanh", np.tanh, A),
    ("floor", np.floor, A * 3), ("ceil", np.ceil, A * 3),
    ("round", np.round, A * 3), ("sign", np.sign, A),
    ("reciprocal", lambda x: 1 / x, POS), ("square", np.square, A),
    ("erf", None, A), ("expm1", np.expm1, A),
]

BINARY = [
    ("add", np.add), ("subtract", np.subtract), ("multiply", np.multiply),
    ("divide", np.divide), ("maximum", np.maximum), ("minimum", np.minimum),
    ("atan2", np.arctan2), ("fmax", np.fmax), ("fmin", np.fmin),
]

REDUCTIONS = [
    ("sum", np.sum), ("mean", np.mean), ("max", np.max), ("min", np.min),
    ("prod", np.prod),
]


@pytest.mark.parametrize("name,nfn,x", UNARY, ids=[u[0] for u in UNARY])
def test_unary_matches_numpy(name, nfn, x):
    got = _pair(name, x, ELEM)
    if nfn is None:
        assert np.isfinite(got).all()
        return
    np.testing.assert_allclose(got, nfn(x), rtol=2e-5, atol=1e-6)


def test_erf_known_values():
    x = np.array([0.0, 1.0, -1.0, 2.0], np.float32)
    got = _pair("erf", x, ELEM)
    want = np.array([0.0, 0.8427008, -0.8427008, 0.9953223], np.float32)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name,nfn", BINARY + [("pow", None)],
                         ids=[b[0] for b in BINARY] + ["pow"])
def test_binary_matches_numpy(name, nfn):
    if name == "pow":
        got = []
        for P, ops in ((jp, jops), (tp, tops)):
            got.append(_np(ops.pow(P.to_tensor(A), 2.0)))
        np.testing.assert_allclose(got[1], got[0], **ELEM)
        np.testing.assert_allclose(got[1], A ** 2.0, rtol=2e-5, atol=1e-6)
        return
    got = _pair(name, A, ELEM, POS)
    np.testing.assert_allclose(got, nfn(A, POS), rtol=2e-5, atol=1e-6)


@pytest.mark.parametrize("name,nfn", REDUCTIONS,
                         ids=[r[0] for r in REDUCTIONS])
@pytest.mark.parametrize("axis", [None, 0, 1])
def test_reduction_matches_numpy(name, nfn, axis):
    got = _pair(name, A, RED, axis=axis)
    np.testing.assert_allclose(got, nfn(A, axis=axis), rtol=2e-5, atol=2e-6)


_GRAD_CASES = [u for u in UNARY if u[0] in
               ("exp", "log", "sqrt", "tanh", "sin", "square", "abs")]


@pytest.mark.parametrize("name,nfn,x", _GRAD_CASES,
                         ids=[u[0] for u in _GRAD_CASES])
def test_unary_grad_matches_finite_difference(name, nfn, x):
    """check_grad (op_test.py): analytic against a central difference, and
    the port's gradient against the JAX tape's."""
    grads = []
    for P, ops in ((jp, jops), (tp, tops)):
        t = P.to_tensor(x.astype(np.float64))
        t.stop_gradient = False
        ops.sum(getattr(ops, name)(t)).backward()
        grads.append(_np(t.grad))
    eps = 1e-6
    num = (nfn(x.astype(np.float64) + eps)
           - nfn(x.astype(np.float64) - eps)) / (2 * eps)
    np.testing.assert_allclose(grads[1], num, rtol=1e-4, atol=1e-6,
                               err_msg=name)
    np.testing.assert_allclose(grads[1], grads[0], **F64)


def _both(fn):
    """``fn(P, ops)`` for both packages → (jax result, port result) as
    numpy."""
    out = []
    for P, ops in ((jp, jops), (tp, tops)):
        r = fn(P, ops)
        out.append([_np(v) for v in r] if isinstance(r, (tuple, list))
                   else _np(r))
    return out


def _agree(j, t, tol=ELEM):
    for a, b in zip(j if isinstance(j, list) else [j],
                    t if isinstance(t, list) else [t]):
        assert a.dtype == b.dtype and a.shape == b.shape
        if a.dtype.kind in "biu":
            np.testing.assert_array_equal(b, a)
        else:
            np.testing.assert_allclose(b, a, **(F64 if a.dtype == np.float64
                                                else tol))


def test_manipulation_ops():
    for P, ops in ((jp, jops), (tp, tops)):
        x = P.to_tensor(A)
        np.testing.assert_allclose(_np(ops.transpose(x, [1, 0])), A.T)
        np.testing.assert_allclose(_np(ops.reshape(x, [5, 4])),
                                   A.reshape(5, 4))
        np.testing.assert_allclose(_np(ops.flip(x, axis=0)), A[::-1])
        np.testing.assert_allclose(_np(ops.roll(x, 2, axis=1)),
                                   np.roll(A, 2, 1))
        np.testing.assert_allclose(_np(ops.concat([x, x], axis=0)),
                                   np.concatenate([A, A], 0))
        np.testing.assert_allclose(_np(ops.stack([x, x], axis=0)),
                                   np.stack([A, A]))
        parts = ops.split(x, 5, axis=1)
        assert len(parts) == 5
        np.testing.assert_allclose(_np(parts[2]), A[:, 2:3])
        np.testing.assert_allclose(_np(ops.tile(x, [2, 1])),
                                   np.tile(A, (2, 1)))
        np.testing.assert_allclose(
            _np(ops.squeeze(ops.unsqueeze(x, 0), 0)), A)
    _agree(*_both(lambda P, ops: ops.split(P.to_tensor(A), 5, axis=1)))


def test_search_sort_ops():
    for P, ops in ((jp, jops), (tp, tops)):
        x = P.to_tensor(A)
        np.testing.assert_allclose(_np(ops.argmax(x, axis=1)), A.argmax(1))
        np.testing.assert_allclose(_np(ops.argmin(x, axis=0)), A.argmin(0))
        np.testing.assert_allclose(_np(ops.sort(x, axis=1)), np.sort(A, 1))
        np.testing.assert_allclose(_np(ops.argsort(x, axis=1)),
                                   np.argsort(A, 1))
        vals, idx = ops.topk(x, k=2, axis=1)
        np.testing.assert_allclose(_np(vals), -np.sort(-A, 1)[:, :2])
        w = ops.where(P.to_tensor(A > 0), P.to_tensor(A), P.to_tensor(B_))
        np.testing.assert_allclose(_np(w), np.where(A > 0, A, B_))
    _agree(*_both(lambda P, ops: ops.topk(P.to_tensor(A), k=2, axis=1)))
    _agree(*_both(lambda P, ops: ops.argsort(P.to_tensor(A), axis=1)))


def test_cumulative_and_logic():
    for P, ops in ((jp, jops), (tp, tops)):
        x = P.to_tensor(A)
        np.testing.assert_allclose(_np(ops.cumsum(x, axis=1)),
                                   np.cumsum(A, 1), rtol=1e-6)
        np.testing.assert_allclose(_np(ops.cumprod(x, dim=1)),
                                   np.cumprod(A, 1), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(
            _np(ops.logical_and(P.to_tensor(A > 0), P.to_tensor(B_ > 0))),
            (A > 0) & (B_ > 0))
        np.testing.assert_allclose(_np(ops.isnan(P.to_tensor(A / POS))),
                                   np.isnan(A / POS))
        np.testing.assert_allclose(_np(ops.clip(x, -0.5, 0.5)),
                                   np.clip(A, -0.5, 0.5))
    _agree(*_both(lambda P, ops: ops.cumsum(P.to_tensor(A), axis=1)), RED)
    _agree(*_both(lambda P, ops: ops.cumprod(P.to_tensor(A), dim=1)), RED)


def test_int_ops():
    for P, ops in ((jp, jops), (tp, tops)):
        x = P.to_tensor(INTS)
        np.testing.assert_allclose(_np(ops.mod(x, 4)), INTS % 4)
        np.testing.assert_allclose(
            _np(ops.floor_divide(x, P.to_tensor(np.int64(3)))), INTS // 3)
        np.testing.assert_allclose(_np(ops.bitwise_and(x, x)), INTS)
    _agree(*_both(lambda P, ops: (
        ops.mod(P.to_tensor(INTS), 4),
        ops.floor_divide(P.to_tensor(INTS), P.to_tensor(np.int64(3))),
        ops.floor_divide(P.to_tensor(-INTS), 4),
        ops.remainder(P.to_tensor(-INTS), 4),
        ops.remainder(P.to_tensor(A * 3), P.to_tensor(-POS)),
        ops.floor_divide(P.to_tensor(A * 3), P.to_tensor(-POS)),
        ops.divide(P.to_tensor(INTS), P.to_tensor(INTS + 1)),
        ops.bitwise_and(P.to_tensor(INTS), P.to_tensor(INTS)))))


def test_linalg_against_numpy():
    m = RNG.standard_normal((4, 4)).astype(np.float64)
    m = m @ m.T + 4 * np.eye(4)  # SPD
    b = RNG.standard_normal((4, 2))
    for P, ops in ((jp, jops), (tp, tops)):
        t = P.to_tensor(m)
        np.testing.assert_allclose(_np(ops.det(t)), np.linalg.det(m),
                                   rtol=1e-8)
        np.testing.assert_allclose(_np(ops.inv(t)), np.linalg.inv(m),
                                   rtol=1e-8)
        np.testing.assert_allclose(_np(ops.cholesky(t)),
                                   np.linalg.cholesky(m), rtol=1e-8)
        evals = np.sort(_np(ops.eigvalsh(t)))
        np.testing.assert_allclose(evals, np.sort(np.linalg.eigvalsh(m)),
                                   rtol=1e-8)
        np.testing.assert_allclose(_np(ops.solve(t, P.to_tensor(b))),
                                   np.linalg.solve(m, b), rtol=1e-8)
    _agree(*_both(lambda P, ops: (
        ops.det(P.to_tensor(m)), ops.inv(P.to_tensor(m)),
        ops.cholesky(P.to_tensor(m)),
        ops.solve(P.to_tensor(m), P.to_tensor(b)))))


# -- the semantics where paddle and torch part ways ----------------------------

def test_paddle_semantics_cases():
    """max gives values only; topk values and int64 indices; axis=None
    reductions with and without keepdim; integer divide gives float32;
    floor and remainder take the divisor's sign."""
    x = np.array([[3.0, -1.5, 2.0], [0.5, 4.0, -2.5]], np.float32)
    _agree(*_both(lambda P, ops: (
        ops.max(P.to_tensor(x)), ops.max(P.to_tensor(x), axis=1),
        ops.sum(P.to_tensor(x), keepdim=True),
        ops.mean(P.to_tensor(x), axis=None, keepdim=True),
        ops.max(P.to_tensor(x), axis=[0, 1], keepdim=True),
        ops.divide(P.to_tensor(np.array([7, -7])), P.to_tensor(
            np.array([2, 2]))),
        ops.floor_divide(P.to_tensor(np.array([7, -7])), 2),
        ops.remainder(P.to_tensor(np.array([7, -7])), -3),
        *ops.topk(P.to_tensor(x), 2, axis=0, largest=False))), RED)
    for P, ops in ((jp, jops), (tp, tops)):
        assert ops.max(P.to_tensor(x)).shape == []
        assert ops.sum(P.to_tensor(x), keepdim=True).shape == [1, 1]


def test_closure_of_the_op_modules():
    """Each ported op module exports what the JAX module does, less the
    names in ``NOT_PORTED``."""
    import importlib
    for mod, missing in NOT_PORTED.items():
        jmod = importlib.import_module(f"paddle_tpu.ops.{mod}")
        tmod = importlib.import_module(f"paddle_tpu_torch.ops.{mod}")
        assert set(tmod.__all__) == set(jmod.__all__) - missing, mod
        assert not (missing & set(tmod.__all__)), mod
        for name in tmod.__all__:
            assert callable(getattr(tmod, name)), (mod, name)
            assert hasattr(tp, name), name
