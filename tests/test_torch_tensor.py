"""The port's Tensor, autograd and PyLayer against the JAX package's.

Every case of ``tests/test_tensor_autograd.py`` (but the jit one, whose
counterpart waits for ``jit``) and the PyLayer cases of
``tests/test_runtime_plumbing.py`` run through both packages on the same
numpy inputs, each package checked by the case's own asserts, and the two
held to each other: values and gradients. Tolerances: f32 elementwise
rtol 1e-5, atol 1e-6; matmul, reductions and gradients rtol 1e-5, atol
1e-5; f64 1e-12; integer, bool and index results exactly equal. Random
draws differ between the frameworks and are held to repeatability.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu_torch as tp
from paddle_tpu.autograd import PyLayer as JPyLayer
from paddle_tpu_torch.autograd import PyLayer as TPyLayer
from paddle_tpu_torch.framework import place as tplace

ELEM = dict(rtol=1e-5, atol=1e-6)
RED = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _cpu_place():
    """The port's facade on the CPU for the test; the place before is put
    back after."""
    prev = tplace._current_place
    tp.set_device("cpu")
    yield
    tplace._current_place = prev


def _np(t):
    return None if t is None else np.asarray(t.numpy())


def _same(a, b, tol=ELEM, what=""):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    if a.dtype.kind in "biuU" or b.dtype.kind in "biuU":
        assert a.dtype == b.dtype, (what, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=what)
    elif a.dtype == np.float64 and b.dtype == np.float64:
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-12,
                                   err_msg=what)
    else:
        assert a.dtype == b.dtype, (what, a.dtype, b.dtype)
        np.testing.assert_allclose(a, b, err_msg=what, **tol)


RNG = np.random.default_rng(0)
X34 = RNG.random((3, 4)).astype("float32")
W45 = RNG.random((4, 5)).astype("float32")
A345 = RNG.random((3, 4, 5)).astype("float32")


# -- the cases of tests/test_tensor_autograd.py, one function per case;
# each takes the package and returns what the two must agree on ------------

def case_to_tensor_basic(P):
    t = P.to_tensor([[1.0, 2.0], [3.0, 4.0]])
    assert t.shape == [2, 2]
    assert t.dtype == P.float32
    np.testing.assert_allclose(t.numpy(), [[1, 2], [3, 4]])
    return {"t": _np(t)}


def case_dtypes(P):
    assert P.to_tensor([1, 2]).dtype == P.int64
    assert P.to_tensor(np.zeros((2,), np.float64)).dtype == P.float64
    assert P.to_tensor([1.0]).dtype == P.float32
    t = P.to_tensor([1.0], dtype="bfloat16")
    assert t.dtype == P.bfloat16
    return {"names": np.array([P.to_tensor([1, 2]).dtype.name,
                               P.to_tensor(np.float64(1.0)).dtype.name,
                               P.to_tensor(True).dtype.name,
                               t.dtype.name])}


def case_arithmetic(P):
    x = P.to_tensor([1.0, 2.0, 3.0])
    y = P.to_tensor([4.0, 5.0, 6.0])
    out = {"add": x + y, "mul": x * y, "sub": y - x, "div": y / x,
           "affine": 2 * x + 1, "pow": x ** 2, "rsub": 1 - x}
    np.testing.assert_allclose(out["add"].numpy(), [5, 7, 9])
    np.testing.assert_allclose(out["mul"].numpy(), [4, 10, 18])
    np.testing.assert_allclose(out["sub"].numpy(), [3, 3, 3])
    np.testing.assert_allclose(out["div"].numpy(), [4, 2.5, 2])
    np.testing.assert_allclose(out["affine"].numpy(), [3, 5, 7])
    np.testing.assert_allclose(out["pow"].numpy(), [1, 4, 9])
    np.testing.assert_allclose(out["rsub"].numpy(), [0, -1, -2])
    return {k: _np(v) for k, v in out.items()}


def case_matmul_grad(P):
    x = P.to_tensor(X34, stop_gradient=False)
    w = P.to_tensor(W45, stop_gradient=False)
    out = P.matmul(x, w)
    out.sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), np.ones((3, 5)) @ W45.T,
                               rtol=1e-5)
    np.testing.assert_allclose(w.grad.numpy(), X34.T @ np.ones((3, 5)),
                               rtol=1e-5)
    return {"out": _np(out), "gx": _np(x.grad), "gw": _np(w.grad)}


def case_chain_grad(P):
    x = P.to_tensor([2.0], stop_gradient=False)
    y = x * x * x
    y.backward()
    np.testing.assert_allclose(x.grad.numpy(), [12.0], rtol=1e-6)
    return {"g": _np(x.grad)}


def case_grad_accumulation(P):
    x = P.to_tensor([3.0], stop_gradient=False)
    (x * 2).backward()
    (x * 3).backward()
    np.testing.assert_allclose(x.grad.numpy(), [5.0])
    g = _np(x.grad)
    x.clear_grad()
    assert x.grad is None
    return {"g": g}


def case_branching_graph(P):
    x = P.to_tensor([1.0, 2.0], stop_gradient=False)
    a = x * 2
    b = x * 3
    (a + b).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), [5.0, 5.0])
    return {"g": _np(x.grad)}


def case_no_grad(P):
    x = P.to_tensor([1.0], stop_gradient=False)
    with P.no_grad():
        y = x * 2
    assert y.stop_gradient
    assert y.is_leaf
    return {"y": _np(y)}


def case_stop_gradient_blocks(P):
    x = P.to_tensor([1.0], stop_gradient=False)
    y = (x * 2).detach()
    z = y * 3
    assert z.stop_gradient
    return {"z": _np(z)}


def case_double_backward_error_without_retain(P):
    x = P.to_tensor([1.0], stop_gradient=False)
    y = (x * x).sum()
    y.backward()
    with pytest.raises(RuntimeError):
        y.backward()
    # also where the graph saved nothing a second pass would miss
    z = (x + 1).sum()
    z.backward()
    with pytest.raises(RuntimeError):
        z.backward()
    return {"g": _np(x.grad)}


def case_retain_graph(P):
    x = P.to_tensor([3.0], stop_gradient=False)
    y = (x * x).sum()
    y.backward(retain_graph=True)
    y.backward()
    np.testing.assert_allclose(x.grad.numpy(), [12.0])
    return {"g": _np(x.grad)}


def case_paddle_grad_api(P):
    x = P.to_tensor([2.0], stop_gradient=False)
    y = x * x
    (gx,) = P.framework.grad(y, [x])
    np.testing.assert_allclose(gx.numpy(), [4.0])
    assert x.grad is None
    return {"gx": _np(gx)}


def case_multi_output_op_grad(P):
    x = P.to_tensor(np.arange(6, dtype="float32").reshape(2, 3),
                    stop_gradient=False)
    a, b, c = P.split(x, 3, axis=1)
    (a.sum() * 2 + b.sum()).backward()
    np.testing.assert_allclose(x.grad.numpy(), [[2, 1, 0], [2, 1, 0]])
    return {"g": _np(x.grad)}


def case_indexing_grad(P):
    x = P.to_tensor([1.0, 2.0, 3.0], stop_gradient=False)
    y = x[1:]
    y.sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), [0, 1, 1])
    return {"g": _np(x.grad), "neg": _np(x[::-1]), "pick": _np(x[P.to_tensor([0, 2])])}


def case_setitem(P):
    x = P.to_tensor([1.0, 2.0, 3.0])
    x[0] = 9.0
    np.testing.assert_allclose(x.numpy(), [9, 2, 3])
    # a functional update: the gradient flows to the value written and,
    # in the port, to what was not overwritten (the JAX tape loses the
    # latter: its rebind makes the setitem node an input of itself)
    w = P.to_tensor([1.0, 2.0, 3.0], stop_gradient=False)
    v = P.to_tensor([5.0], stop_gradient=False)
    u = w * 2
    u[1:2] = v * 3
    (u * P.to_tensor([1.0, 10.0, 100.0])).sum().backward()
    if P is tp:
        np.testing.assert_allclose(w.grad.numpy(), [2.0, 0.0, 200.0])
    return {"x": _np(x), "u": _np(u), "gv": _np(v.grad)}


def case_inplace_ops(P):
    x = P.to_tensor([1.0, 2.0])
    x.add_(P.to_tensor([1.0, 1.0]))
    np.testing.assert_allclose(x.numpy(), [2, 3])
    x.scale_(2.0)
    np.testing.assert_allclose(x.numpy(), [4, 6])
    prior = x * 1
    x.exp_()
    return {"x": _np(x), "prior": _np(prior)}


def case_comparison_and_logic(P):
    x = P.to_tensor([1.0, 2.0, 3.0])
    y = P.to_tensor([3.0, 2.0, 1.0])
    np.testing.assert_array_equal((x < y).numpy(), [True, False, False])
    np.testing.assert_array_equal((x == y).numpy(), [False, True, False])
    assert bool(P.allclose(x, x))
    return {"lt": _np(x < y), "eq": _np(x == y), "ge": _np(x >= 2.0),
            "rgt": _np(2.0 < x)}


def case_cast(P):
    x = P.to_tensor([1.5, 2.5])
    assert x.astype("int32").dtype == P.int32
    assert x.astype(P.float16).dtype == P.float16
    return {"i32": _np(x.astype("int32")), "f16": _np(x.astype(P.float16))}


def case_reductions_match_numpy(P):
    x = P.to_tensor(A345)
    np.testing.assert_allclose(x.sum(axis=1).numpy(), A345.sum(1), rtol=1e-5)
    np.testing.assert_allclose(x.mean().numpy(), A345.mean(), rtol=1e-5)
    np.testing.assert_allclose(x.max(axis=[0, 2]).numpy(), A345.max((0, 2)),
                               rtol=1e-6)
    np.testing.assert_allclose(P.std(x, axis=0).numpy(), A345.std(0, ddof=1),
                               rtol=1e-4)
    return {"sum": _np(x.sum(axis=1)), "mean": _np(x.mean()),
            "max": _np(x.max(axis=[0, 2])), "std": _np(P.std(x, axis=0)),
            "keep": _np(x.sum(keepdim=True))}


def case_manipulation_roundtrip(P):
    a = np.arange(24, dtype="float32").reshape(2, 3, 4)
    x = P.to_tensor(a)
    y = P.transpose(x, [2, 0, 1])
    assert y.shape == [4, 2, 3]
    z = P.reshape(y, [4, -1])
    assert z.shape == [4, 6]
    np.testing.assert_allclose(P.concat([x, x], axis=0).numpy(),
                               np.concatenate([a, a], 0))
    np.testing.assert_allclose(P.stack([x, x]).numpy(), np.stack([a, a]))
    return {"y": _np(y), "z": _np(z), "T": _np(x.T)}


def case_creation_ops(P):
    assert P.zeros([2, 3]).shape == [2, 3]
    assert P.ones([2], dtype="int64").dtype == P.int64
    np.testing.assert_allclose(P.arange(5).numpy(), np.arange(5))
    np.testing.assert_allclose(P.full([2], 7.0).numpy(), [7, 7])
    assert P.eye(3).shape == [3, 3]
    P.seed(42)
    r1 = P.rand([4]).numpy()
    P.seed(42)
    r2 = P.rand([4]).numpy()
    np.testing.assert_allclose(r1, r2)
    return {"arange": _np(P.arange(5)), "full": _np(P.full([2], 7.0)),
            "eye": _np(P.eye(3)), "r_shape": np.array(r1.shape)}


def case_topk(P):
    x = P.to_tensor([[1.0, 5.0, 3.0], [9.0, 2.0, 4.0]])
    vals, idx = P.topk(x, 2)
    np.testing.assert_allclose(vals.numpy(), [[5, 3], [9, 4]])
    np.testing.assert_array_equal(idx.numpy(), [[1, 2], [0, 2]])
    return {"vals": _np(vals), "idx": _np(idx)}


def case_where_gather_scatter(P):
    x = P.to_tensor([1.0, 2.0, 3.0, 4.0])
    idx = P.to_tensor([0, 2])
    np.testing.assert_allclose(P.gather(x, idx).numpy(), [1, 3])
    cond = P.to_tensor([True, False, True, False])
    np.testing.assert_allclose(P.where(cond, x, -x).numpy(), [1, -2, 3, -4])
    return {"gather": _np(P.gather(x, idx)), "where": _np(P.where(cond, x, -x))}


def case_pad_paddle_convention(P):
    # the first pair pads the LAST dim (paddle's convention)
    x = P.to_tensor(np.zeros((1, 1, 2, 3), "float32"))
    if P is jp:
        import paddle_tpu.nn.functional as F
        pad = F.pad
    else:
        pad = P.pad
    assert pad(x, [1, 0, 0, 0]).shape == [1, 1, 2, 4]
    assert pad(x, [0, 0, 1, 1]).shape == [1, 1, 4, 3]
    y = P.to_tensor(np.arange(6, dtype="float32").reshape(1, 2, 3))
    return {"last": _np(pad(x, [1, 0, 0, 0])),
            "prev": _np(pad(x, [0, 0, 1, 1])),
            "value": _np(P.pad(y, [2, 1], value=-1.0)),
            "reflect": _np(P.pad(y, [2, 1], mode="reflect")),
            "replicate": _np(P.pad(y, [1, 2], mode="replicate")),
            "circular": _np(P.pad(y, [1, 1], mode="circular")),
            "full": _np(P.pad(y, [0, 0, 1, 0, 0, 1]))}


def case_chunk_uneven_and_split_errors(P):
    c = P.chunk(P.to_tensor(np.arange(5.0)), 2)
    assert [t.shape[0] for t in c] == [3, 2]
    with pytest.raises(ValueError):
        P.split(P.to_tensor(np.arange(5.0)), 2)
    s = P.split(P.to_tensor(np.arange(6.0)), [1, -1, 2])
    return {"c0": _np(c[0]), "c1": _np(c[1]), "s1": _np(s[1])}


def case_grad_does_not_touch_other_leaves(P):
    w = P.to_tensor([1.0], stop_gradient=False)
    x = P.to_tensor([2.0], stop_gradient=False)
    (gx,) = P.framework.grad((w * x).sum(), [x])
    assert w.grad is None
    np.testing.assert_allclose(gx.numpy(), [1.0])
    return {"gx": _np(gx)}


def case_topk_grad_single_pass(P):
    t = P.to_tensor(np.array([3.0, 1.0, 2.0]), stop_gradient=False)
    vals, idx = P.topk(t, 2)
    vals.sum().backward()
    np.testing.assert_allclose(t.grad.numpy(), [1, 0, 1])
    np.testing.assert_array_equal(idx.numpy(), [0, 2])
    return {"g": _np(t.grad), "idx": _np(idx)}


# -- what the facade adds around those cases --------------------------------

def case_grad_nonleaf_create_graph_allow_unused(P):
    x = P.to_tensor(np.array([0.5, -1.5, 2.0], np.float32),
                    stop_gradient=False)
    u = P.to_tensor(np.array([1.0], np.float32), stop_gradient=False)
    h = P.tanh(x) * x
    y = (h * h).sum()
    gh, gx = P.grad(y, [h, x], retain_graph=True)
    assert x.grad is None
    (g1,) = P.grad((x * x * x).sum(), [x], create_graph=True)
    assert not g1.stop_gradient
    (g2,) = P.grad(g1.sum(), [x])
    with pytest.raises(RuntimeError):
        P.grad((x * 2).sum(), [x, u])
    none_u = P.grad((x * 2).sum(), [x, u], allow_unused=True)[1]
    assert none_u is None
    return {"gh": _np(gh), "gx": _np(gx), "g1": _np(g1), "g2": _np(g2)}


def case_backward_seeds_ones_and_grad_tensor(P):
    x = P.to_tensor(X34, stop_gradient=False)
    y = x * x
    y.backward()                      # a non-scalar root: ones
    g_ones = _np(x.grad)
    x.clear_gradient()
    z = P.exp(x)
    z.backward(P.to_tensor(W45[:3, :4].copy()))
    return {"ones": g_ones, "seeded": _np(x.grad)}


def case_grad_mode(P):
    x = P.to_tensor([1.0, 2.0], stop_gradient=False)

    @P.no_grad()
    def doubled(t):
        return t * 2
    assert doubled(x).stop_gradient
    P.set_grad_enabled(False)
    try:
        assert not P.is_grad_enabled()
        assert (x * 3).stop_gradient
    finally:
        P.set_grad_enabled(True)
    assert P.is_grad_enabled() and not (x * 3).stop_gradient
    return {"d": _np(doubled(x))}


def case_stop_gradient_cuts_result(P):
    x = P.to_tensor([1.0, 2.0], stop_gradient=False)
    a = x * 3
    b = x * 5
    b.stop_gradient = True
    (a * b).sum().backward()
    leaf = P.to_tensor([4.0])
    leaf.stop_gradient = False
    (leaf * leaf).sum().backward()
    return {"g": _np(x.grad), "leaf": _np(leaf.grad)}


def case_tensor_structure(P):
    x = P.to_tensor(A345)
    assert x.ndim == 3 and x.size == 60 and len(x) == 3
    assert x.place == P.CPUPlace()
    assert hash(x) == id(x)
    assert x.is_leaf and x.stop_gradient
    rows = [r for r in x]
    assert len(rows) == 3
    d = x.detach()
    c = x.clone()
    y = P.to_tensor([1.0, 2.0])
    y.set_value(np.array([3.0, 4.0]))
    y.copy_(P.to_tensor([5.0, 6.0]))
    with pytest.raises(ValueError):
        y.set_value(np.zeros(3))
    with pytest.raises(ValueError):
        bool(x)
    assert float(P.to_tensor(2.5)) == 2.5 and int(P.to_tensor(3)) == 3
    assert x.tolist()[0][0][0] == float(A345[0, 0, 0])
    return {"row": _np(rows[1]), "d": _np(d), "c": _np(c), "y": _np(y),
            "item": np.array(x.item(1, 2, 3)), "cpu": _np(x.cpu()),
            "to": _np(x.to("float64")), "astype": _np(x.astype("float64"))}


def case_clear_gradient_set_to_zero(P):
    x = P.to_tensor([1.0, 2.0], stop_gradient=False)
    (x * x).sum().backward()
    x.clear_gradient(set_to_zero=True)
    z = _np(x.grad)
    x.clear_gradient()
    assert x.grad is None
    return {"z": z}


def case_check_nan_inf_flag(P):
    x = P.to_tensor(np.array([1.0, 0.0], np.float32))
    P.set_flags({"FLAGS_check_nan_inf": True})
    try:
        with pytest.raises(FloatingPointError):
            _ = x / P.to_tensor(np.array([1.0, 0.0], np.float32))
        P.set_flags({"FLAGS_check_nan_inf_level": 1})
        with pytest.warns(UserWarning):
            _ = x / P.to_tensor(np.array([1.0, 0.0], np.float32))
    finally:
        P.set_flags({"FLAGS_check_nan_inf": False,
                     "FLAGS_check_nan_inf_level": 0})
    return {"flag": np.array(P.get_flags("FLAGS_check_nan_inf")[
        "FLAGS_check_nan_inf"])}


CASES = {name[5:]: fn for name, fn in sorted(globals().items())
         if name.startswith("case_")}


@pytest.mark.parametrize("name", sorted(CASES))
def test_case_against_jax(name):
    got_j = CASES[name](jp)
    got_t = CASES[name](tp)
    assert sorted(got_j) == sorted(got_t)
    for k in got_j:
        _same(got_t[k], got_j[k], what=f"{name}.{k}")


# -- PyLayer (tests/test_runtime_plumbing.py) --------------------------------

def _cube(PyLayer):
    class Cube(PyLayer):
        @staticmethod
        def forward(ctx, x):
            ctx.save_for_backward(x)
            return x * x * x

        @staticmethod
        def backward(ctx, grad):
            (x,) = ctx.saved_tensor()
            return grad * 3.0 * x * x
    return Cube


def _muladd(PyLayer):
    class MulAdd(PyLayer):
        @staticmethod
        def forward(ctx, a, b):
            ctx.save_for_backward(a, b)
            return a * b, a + b

        @staticmethod
        def backward(ctx, g_mul, g_add):
            a, b = ctx.saved_tensor()
            return g_mul * b + g_add, g_mul * a + g_add
    return MulAdd


def _twoout(PyLayer):
    class TwoOut(PyLayer):
        @staticmethod
        def forward(ctx, x):
            ctx.save_for_backward(x)
            return x * 2.0, x * x

        @staticmethod
        def backward(ctx, ga, gb):
            (x,) = ctx.saved_tensor()
            return ga * 2.0 + gb * 2.0 * x
    return TwoOut


def _double(PyLayer):
    class Double(PyLayer):
        @staticmethod
        def forward(ctx, x):
            return x * 2.0

        @staticmethod
        def backward(ctx, g):
            return g * 2.0
    return Double


def _pylayer_matches_autograd(P, PyLayer):
    x = P.to_tensor(np.array([1.0, -2.0, 3.0], np.float32))
    x.stop_gradient = False
    y = _cube(PyLayer).apply(x)
    P.sum(y).backward()
    np.testing.assert_allclose(x.grad.numpy(), 3.0 * np.array([1.0, 4.0, 9.0]),
                               rtol=1e-6)
    return {"y": _np(y), "g": _np(x.grad)}


def _pylayer_multi_io_and_chaining(P, PyLayer):
    a = P.to_tensor(np.array([2.0], np.float32))
    b = P.to_tensor(np.array([5.0], np.float32))
    a.stop_gradient = b.stop_gradient = False
    m, s = _muladd(PyLayer).apply(a, b)
    loss = P.sum(m * s)
    loss.backward()
    np.testing.assert_allclose(float(a.grad.numpy()[0]), 45.0, rtol=1e-6)
    np.testing.assert_allclose(float(b.grad.numpy()[0]), 24.0, rtol=1e-6)
    return {"ga": _np(a.grad), "gb": _np(b.grad), "loss": _np(loss)}


def _pylayer_multi_output_backward(P, PyLayer):
    x = P.to_tensor(np.array([1.0, -2.0], np.float32))
    x.stop_gradient = False
    a, b = _twoout(PyLayer).apply(x)
    (P.sum(a) + P.sum(b)).backward()
    np.testing.assert_allclose(x.grad.numpy(),
                               2.0 + 2.0 * np.array([1.0, -2.0]), rtol=1e-6)
    return {"g": _np(x.grad)}


def _pylayer_create_graph_clear_error(P, PyLayer):
    x = P.to_tensor(np.array([1.0], np.float32))
    x.stop_gradient = False
    y = P.sum(_double(PyLayer).apply(x))
    with pytest.raises(RuntimeError, match="not supported through op"):
        P.grad(y, [x], create_graph=True)
    (g,) = P.grad(y, [x])
    return {"g": _np(g)}


def _pylayer_nondiff_input_and_no_grad(P, PyLayer):
    x = P.to_tensor(np.array([1.0, 2.0], np.float32))
    x.stop_gradient = False
    k = P.to_tensor(np.array([3.0, 4.0], np.float32))   # stop_gradient

    class Scale(PyLayer):
        @staticmethod
        def forward(ctx, a, b, factor=1.0):
            ctx.save_for_backward(b)
            return a * b * factor

        @staticmethod
        def backward(ctx, g):
            (b,) = ctx.saved_tensor()
            return g * b * 2.0           # one per differentiable input
    y = Scale.apply(x, k, factor=2.0)
    y.sum().backward()
    with P.no_grad():
        z = Scale.apply(x, k)
    assert z.stop_gradient
    return {"y": _np(y), "g": _np(x.grad), "z": _np(z)}


PYLAYER_CASES = {
    "matches_autograd": _pylayer_matches_autograd,
    "multi_io_and_chaining": _pylayer_multi_io_and_chaining,
    "multi_output_backward": _pylayer_multi_output_backward,
    "create_graph_clear_error": _pylayer_create_graph_clear_error,
    "nondiff_input_and_no_grad": _pylayer_nondiff_input_and_no_grad,
}


@pytest.mark.parametrize("name", sorted(PYLAYER_CASES))
def test_pylayer_against_jax(name):
    got_j = PYLAYER_CASES[name](jp, JPyLayer)
    got_t = PYLAYER_CASES[name](tp, TPyLayer)
    for k in got_j:
        _same(got_t[k], got_j[k], what=f"{name}.{k}")


def test_pylayer_apply_not_overridable():
    for PyLayer in (JPyLayer, TPyLayer):
        with pytest.raises(TypeError):
            class Bad(PyLayer):
                @staticmethod
                def apply(*a):
                    pass


def test_saved_tensors_hooks_pack_unpack():
    from paddle_tpu.autograd import saved_tensors_hooks as jhooks
    from paddle_tpu_torch.autograd import saved_tensors_hooks as thooks
    got = {}
    for P, PyLayer, hooks in ((jp, JPyLayer, jhooks), (tp, TPyLayer, thooks)):
        packed = []

        def pack(t):
            packed.append(1)
            return t.numpy()

        def unpack(a):
            return P.to_tensor(a)
        x = P.to_tensor(np.array([1.0, -2.0, 3.0], np.float32),
                        stop_gradient=False)
        with hooks(pack, unpack):
            y = _cube(PyLayer).apply(x)
        y.sum().backward()
        assert packed == [1]
        got[P] = _np(x.grad)
    _same(got[tp], got[jp])


def test_pylayer_saving_an_output_leaves_no_cycle():
    import gc
    import weakref

    class Exp(TPyLayer):
        @staticmethod
        def forward(ctx, x):
            y = tp.exp(x)
            ctx.save_for_backward(y)
            return y

        @staticmethod
        def backward(ctx, g):
            (y,) = ctx.saved_tensor()
            return g * y
    x = tp.to_tensor(np.ones(3, np.float32), stop_gradient=False)
    y = Exp.apply(x)
    y.sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), np.exp(np.ones(3)), rtol=1e-6)
    ref = weakref.ref(y._value)
    gc.disable()
    try:
        del y
        assert ref() is None
    finally:
        gc.enable()


# -- AMP boundary and promotion ------------------------------------------------

def test_amp_boundary_cotangent_comes_back_in_producer_dtype():
    """Under auto_cast(bf16), a white-listed matmul produces bf16; the
    black-listed exp consumes an f32 copy; the gradient flowing back into
    the matmul is bf16 again, and the leaf gradients match the JAX tape's
    (tape.py: the AMP boundary cast)."""
    from paddle_tpu import amp as jamp
    from paddle_tpu_torch import amp as tamp
    x_np = (RNG.standard_normal((4, 8)) * 0.3).astype(np.float32)
    w_np = (RNG.standard_normal((8, 3)) * 0.3).astype(np.float32)
    got = {}
    for P, amp in ((jp, jamp), (tp, tamp)):
        x = P.to_tensor(x_np, stop_gradient=False)
        w = P.to_tensor(w_np, stop_gradient=False)
        with amp.auto_cast(dtype="bfloat16"):
            h = P.matmul(x, w)
            e = P.exp(h)
            loss = P.sum(e)
        assert h.dtype == P.bfloat16 and e.dtype == P.float32
        loss.backward()
        got[P] = {"loss": _np(loss), "gx": _np(x.grad).astype(np.float32),
                  "gw": _np(w.grad).astype(np.float32)}
    seen = []
    x = tp.to_tensor(x_np, stop_gradient=False)
    w = tp.to_tensor(w_np, stop_gradient=False)
    with tamp.auto_cast(dtype="bfloat16"):
        h = tp.matmul(x, w)
        h._value.register_hook(lambda g: seen.append(g.dtype))
        tp.sum(tp.exp(h)).backward()
    assert seen == [torch.bfloat16]
    for k in ("loss", "gx", "gw"):
        np.testing.assert_allclose(got[tp][k], got[jp][k], rtol=1e-2,
                                   atol=1e-2, err_msg=k)


def test_promote_types_is_jax_rule_pair_by_pair():
    """The port's promotion rule equals JAX's (64-bit types on) on every
    pair of the facade's dtypes, and is compared with torch's pair by pair:
    on these twelve dtypes the two agree everywhere (the port still
    promotes by its own copy, so a torch change cannot move it)."""
    import jax.numpy as jnp
    from paddle_tpu_torch.framework.dtype import DType, promote_types
    names = sorted(DType._registry)
    differs = []
    for a in names:
        for b in names:
            want = jnp.promote_types(jp.framework.dtype.to_jax_dtype(a),
                                     jp.framework.dtype.to_jax_dtype(b))
            got = promote_types(a, b)
            assert tp.framework.dtype.convert_dtype(got).name == \
                jp.framework.dtype.convert_dtype(want).name, (a, b, got, want)
            ta, tb = DType._registry[a].torch_dtype, \
                DType._registry[b].torch_dtype
            if torch.promote_types(ta, tb) != got:
                differs.append((a, b))
    assert differs == []
    binop = (tp.to_tensor(np.array([1], np.uint8))
             + tp.to_tensor(np.array([1], np.int8)))
    assert binop.dtype == tp.int16


def test_dtype_and_place_api():
    from paddle_tpu_torch.framework import dtype as tdtype
    assert tp.float32 == "float32" and tp.float32 == torch.float32
    assert tp.float32 == np.float32 and tdtype.convert_dtype("float") is \
        tp.float32
    assert tdtype.convert_dtype(torch.int64) is tp.int64
    assert tdtype.to_torch_dtype("bfloat16") is torch.bfloat16
    with pytest.raises(ValueError):
        tdtype.convert_dtype("float128")
    tp.set_default_dtype("float64")
    try:
        assert tp.get_default_dtype() == "float64"
        assert tp.to_tensor([1.5]).dtype == tp.float64
    finally:
        tp.set_default_dtype("float32")
    with pytest.raises(TypeError):
        tp.set_default_dtype("int32")
    assert tp.get_device() == "cpu"
    assert tp.is_compiled_with_cuda() and not \
        tp.framework.is_compiled_with_tpu()
    assert tp.TPUPlace is tp.CUDAPlace
    with pytest.raises(ValueError):
        tp.set_device("xpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tp.set_device("gpu")
        assert tp.get_device() == "cpu"     # unchanged by the failed set


def test_random_ops_repeatable_and_moments():
    """The frameworks draw different numbers: each random op is held to
    its shape, dtype, range or moments, and to repeatability under one
    seed; ``rng_guard`` neither reads nor advances the ambient stream."""
    from paddle_tpu_torch.framework.random import rng_guard
    draws = {
        "rand": lambda: tp.rand([4000]),
        "randn": lambda: tp.randn([4000]),
        "uniform": lambda: tp.uniform([4000], min=2.0, max=4.0),
        "normal": lambda: tp.normal(1.0, 2.0, [4000]),
        "randint": lambda: tp.randint(0, 7, [4000]),
        "randperm": lambda: tp.randperm(50),
        "bernoulli": lambda: tp.bernoulli(tp.full([4000], 0.25)),
        "poisson": lambda: tp.poisson(tp.full([4000], 3.0)),
        "multinomial": lambda: tp.multinomial(
            tp.to_tensor([0.1, 0.2, 0.7]), 4000, replacement=True),
    }
    for name, draw in draws.items():
        tp.seed(7)
        a = draw().numpy()
        tp.seed(7)
        b = draw().numpy()
        np.testing.assert_array_equal(a, b, err_msg=name)
    tp.seed(3)
    r = tp.rand([4000]).numpy()
    assert r.dtype == np.float32 and 0 <= r.min() and r.max() < 1
    assert abs(r.mean() - 0.5) < 0.03
    n = tp.randn([4000]).numpy()
    assert abs(n.mean()) < 0.08 and abs(n.std() - 1) < 0.05
    u = tp.uniform([4000], min=2.0, max=4.0).numpy()
    assert 2 <= u.min() and u.max() < 4
    i = tp.randint(0, 7, [4000]).numpy()
    assert i.dtype == np.int64 and set(np.unique(i)) == set(range(7))
    assert sorted(tp.randperm(50).numpy()) == list(range(50))
    p = tp.poisson(tp.full([4000], 3.0)).numpy()
    assert abs(p.mean() - 3) < 0.15
    m = tp.multinomial(tp.to_tensor([0.1, 0.2, 0.7]), 4000,
                       replacement=True).numpy()
    assert abs((m == 2).mean() - 0.7) < 0.03
    tp.seed(11)
    first = tp.rand([3]).numpy()
    tp.seed(11)
    with rng_guard(5):
        g1 = tp.rand([3]).numpy()
    assert np.array_equal(tp.rand([3]).numpy(), first)
    with rng_guard(5):
        assert np.array_equal(tp.rand([3]).numpy(), g1)
    state = tp.get_rng_state()
    s1 = tp.rand([3]).numpy()
    tp.set_rng_state(state)
    assert np.array_equal(tp.rand([3]).numpy(), s1)
