"""``paddle_tpu_torch.nn`` convolutions and poolings against
``paddle_tpu.nn``'s, on the CPU.

Every function case by case (strides, dilations, groups, every padding
form with ``"SAME"`` at stride 2, channel-last, the transposes'
``output_padding`` and ``output_size``): the output and the gradient of
``sum(out * w)`` over every float input (the input, the weight, the bias)
against JAX's. Every layer with the JAX layer's ``state_dict`` carried
across: output and every gradient. The JAX functions and layers run
under ``paddle_tpu.jit.to_static`` (one XLA program and its VJP, where
the eager tape compiles every op). The initializers by their
bounds; the ``auto_cast`` dtypes; what raises where the JAX functions
ignore an argument; channel-last adaptive pooling against the NC* result
transposed (the JAX function reduces the wrong axes there).

Tolerances (f32): outputs and gradients rtol 1e-5, atol 1e-5; integer
results exactly.
"""
import numpy as np
import pytest

import paddle_tpu as jp
import paddle_tpu_torch as tp
from paddle_tpu_torch.framework import place as tplace
from test_torch_vision import one_torch_thread  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _cpu_place():
    prev = tplace._current_place
    tp.set_device("cpu")
    yield
    tplace._current_place = prev


_rng = np.random.default_rng(11)


def _n(*shape):
    return _rng.standard_normal(shape).astype(np.float32)


IN = {
    # inputs: N, C, spatial
    "X1": _n(2, 4, 9), "X1L": _n(2, 9, 4),
    "X2": _n(2, 4, 9, 8), "X2L": _n(2, 9, 8, 4), "X2D": _n(2, 4, 8, 8),
    "X3": _n(1, 4, 5, 6, 5), "X3L": _n(1, 5, 6, 5, 4),
    "XT1": _n(2, 4, 5), "XT2": _n(2, 4, 5, 4), "XT2L": _n(2, 5, 4, 4),
    "XT3": _n(1, 4, 3, 4, 3),
    "XI2": _rng.integers(-50, 50, (2, 3, 7, 6)).astype(np.int64),
    # conv weights [out, in/g, *k]; transposes [in, out/g, *k]
    "W1": _n(6, 4, 3), "W1G": _n(6, 2, 3),
    "W2": _n(6, 4, 3, 3), "W2G": _n(6, 2, 3, 3), "W2DW": _n(4, 1, 3, 3),
    "W24": _n(6, 4, 4, 4), "W21": _n(6, 4, 1, 1), "W2R": _n(6, 4, 2, 3),
    "W3": _n(6, 4, 3, 3, 3), "W3G": _n(6, 2, 2, 3, 2),
    "WT1": _n(4, 3, 3), "WT2": _n(4, 3, 3, 3), "WT2G": _n(4, 3, 3, 3),
    "WT24": _n(4, 3, 4, 4), "WT3": _n(4, 3, 3, 3, 3),
    "B6": _n(6), "B3": _n(3), "B6T": _n(6),
}


def _F(P):
    return P.nn.functional


def _c(fn, ins, port_kw=None, **kw):
    """A case: ``fn`` of the inputs named ``ins``; ``port_kw`` the port's
    own spelling of an argument the JAX function cannot read."""
    def call(P, *a):
        return getattr(_F(P), fn)(*a, **dict(kw, **(
            port_kw if port_kw and P is tp else {})))
    return call, ins


CASES = {
    # ---- conv1d ----------------------------------------------------------
    "conv1d": _c("conv1d", ["X1", "W1", "B6"], padding=1),
    "conv1d#stride2_same": _c("conv1d", ["X1", "W1"], stride=2,
                              padding="SAME"),
    "conv1d#nlc": _c("conv1d", ["X1L", "W1", "B6"], padding=1,
                     data_format="NLC"),
    "conv1d#dilation_groups": _c("conv1d", ["X1", "W1G"], padding=2,
                                 dilation=2, groups=2),
    "conv1d#pairs": _c("conv1d", ["X1", "W1"], padding=[1, 2]),
    # ---- conv2d ----------------------------------------------------------
    "conv2d": _c("conv2d", ["X2", "W2", "B6"], padding=1),
    "conv2d#stride2": _c("conv2d", ["X2", "W2"], stride=2, padding=1),
    "conv2d#same_stride2": _c("conv2d", ["X2", "W2", "B6"], stride=2,
                              padding="SAME"),
    "conv2d#same_even_kernel": _c("conv2d", ["X2", "W24"], padding="same"),
    "conv2d#same_stride2_even": _c("conv2d", ["X2D", "W24"], stride=2,
                                   padding="SAME"),
    "conv2d#valid": _c("conv2d", ["X2", "W2R", "B6"], padding="VALID"),
    "conv2d#1x1_stride2": _c("conv2d", ["X2", "W21"], stride=2),
    "conv2d#dilation": _c("conv2d", ["X2", "W2"], padding=2, dilation=2),
    "conv2d#dilation_hw": _c("conv2d", ["X2", "W2"], padding=[2, 1],
                             dilation=[2, 1], stride=[1, 2]),
    "conv2d#groups": _c("conv2d", ["X2", "W2G", "B6"], padding=1, groups=2),
    "conv2d#depthwise": _c("conv2d", ["X2", "W2DW"], padding=1, groups=4),
    "conv2d#per_axis": _c("conv2d", ["X2", "W2"], padding=[1, 2]),
    "conv2d#four": _c("conv2d", ["X2", "W2"], padding=[0, 1, 2, 1]),
    # paddle's per-dimension form, against the JAX function's four ints
    # (its own reading of the form fails at 2-D)
    "conv2d#paddle_form": _c("conv2d", ["X2", "W2", "B6"],
                             padding=[1, 0, 2, 1], port_kw=dict(
                                 padding=[[0, 0], [0, 0], [1, 0], [2, 1]])),
    "conv2d#paddle_form_nhwc": _c(
        "conv2d", ["X2L", "W2"], data_format="NHWC", padding=[1, 0, 2, 1],
        port_kw=dict(padding=[[0, 0], [1, 0], [2, 1], [0, 0]])),
    "conv2d#nhwc": _c("conv2d", ["X2L", "W2", "B6"], padding=1,
                      data_format="NHWC"),
    "conv2d#nhwc_same_stride2": _c("conv2d", ["X2L", "W2"], stride=2,
                                   padding="SAME", data_format="NHWC"),
    # ---- conv3d ----------------------------------------------------------
    "conv3d": _c("conv3d", ["X3", "W3", "B6"], padding=1),
    "conv3d#same_stride2": _c("conv3d", ["X3", "W3"], stride=2,
                              padding="SAME"),
    "conv3d#ndhwc_groups": _c("conv3d", ["X3L", "W3G"], padding=[1, 0, 1],
                              groups=2, data_format="NDHWC"),
    # ---- transposes ------------------------------------------------------
    "conv1d_transpose": _c("conv1d_transpose", ["XT1", "WT1", "B3"]),
    "conv1d_transpose#stride2": _c("conv1d_transpose", ["XT1", "WT1"],
                                   stride=2, padding=1, output_padding=1),
    "conv1d_transpose#output_size": _c("conv1d_transpose", ["XT1", "WT1"],
                                       stride=3, padding=1, output_size=[14]),
    "conv1d_transpose#nlc": _c("conv1d_transpose", ["X1L", "WT1", "B3"],
                               stride=2, data_format="NLC"),
    "conv2d_transpose": _c("conv2d_transpose", ["XT2", "WT2", "B3"],
                           padding=1),
    "conv2d_transpose#stride2": _c("conv2d_transpose", ["XT2", "WT2", "B3"],
                                   stride=2, padding=1, output_padding=1),
    "conv2d_transpose#same_stride2": _c("conv2d_transpose", ["XT2", "WT24"],
                                        stride=2, padding="SAME"),
    "conv2d_transpose#valid": _c("conv2d_transpose", ["XT2", "WT2"],
                                 stride=2, padding="VALID"),
    "conv2d_transpose#groups": _c("conv2d_transpose", ["XT2", "WT2G", "B6T"],
                                  groups=2, padding=1),
    "conv2d_transpose#dilation": _c("conv2d_transpose", ["XT2", "WT2"],
                                    dilation=2, padding=1, stride=2),
    "conv2d_transpose#output_size": _c("conv2d_transpose", ["XT2", "WT2"],
                                       stride=2, padding=1,
                                       output_size=[10, 8]),
    "conv2d_transpose#four": _c("conv2d_transpose", ["XT2", "WT2", "B3"],
                                padding=[1, 0, 0, 2], stride=2),
    "conv2d_transpose#crop": _c("conv2d_transpose", ["XT2", "WT2"],
                                padding=3),
    "conv2d_transpose#extend": _c("conv2d_transpose", ["XT2", "WT2", "B3"],
                                  stride=3, output_padding=2),
    "conv2d_transpose#nhwc": _c("conv2d_transpose", ["XT2L", "WT2", "B3"],
                                stride=2, padding=1, data_format="NHWC"),
    "conv3d_transpose": _c("conv3d_transpose", ["XT3", "WT3", "B3"],
                           stride=2, padding=1),
    "conv3d_transpose#output_size": _c("conv3d_transpose", ["XT3", "WT3"],
                                       stride=2, output_size=[8, 10, 7]),
    # ---- avg pools -------------------------------------------------------
    "avg_pool1d": _c("avg_pool1d", ["X1"], kernel_size=3, stride=2,
                     padding=1),
    "avg_pool1d#inclusive_nlc": _c("avg_pool1d", ["X1L"], kernel_size=3,
                                   padding=1, exclusive=False,
                                   data_format="NLC"),
    "avg_pool2d": _c("avg_pool2d", ["X2"], kernel_size=2),
    "avg_pool2d#pad": _c("avg_pool2d", ["X2"], kernel_size=3, stride=2,
                         padding=1),
    "avg_pool2d#inclusive": _c("avg_pool2d", ["X2"], kernel_size=3,
                               stride=2, padding=1, exclusive=False),
    "avg_pool2d#same_stride2": _c("avg_pool2d", ["X2"], kernel_size=2,
                                  stride=2, padding="SAME"),
    "avg_pool2d#same_k3": _c("avg_pool2d", ["X2"], kernel_size=3, stride=2,
                             padding="SAME"),
    "avg_pool2d#four": _c("avg_pool2d", ["X2"], kernel_size=3,
                          padding=[0, 1, 1, 0]),
    "avg_pool2d#wide_pad": _c("avg_pool2d", ["X2"], kernel_size=[3, 2],
                              padding=[2, 1]),
    "avg_pool2d#wide_pad_inclusive": _c("avg_pool2d", ["X2"],
                                        kernel_size=[3, 2], padding=[2, 1],
                                        exclusive=False),
    "avg_pool2d#nhwc": _c("avg_pool2d", ["X2L"], kernel_size=3, stride=2,
                          padding=1, data_format="NHWC"),
    "avg_pool3d": _c("avg_pool3d", ["X3"], kernel_size=2),
    "avg_pool3d#pad": _c("avg_pool3d", ["X3"], kernel_size=3, stride=2,
                         padding=1),
    # ---- max pools -------------------------------------------------------
    "max_pool1d": _c("max_pool1d", ["X1"], kernel_size=3, stride=2,
                     padding=1),
    "max_pool1d#nlc": _c("max_pool1d", ["X1L"], kernel_size=2,
                         data_format="NLC"),
    "max_pool2d": _c("max_pool2d", ["X2"], kernel_size=3, stride=2,
                     padding=1),
    "max_pool2d#k2": _c("max_pool2d", ["X2"], kernel_size=2, stride=2),
    "max_pool2d#same_stride2": _c("max_pool2d", ["X2"], kernel_size=3,
                                  stride=2, padding="SAME"),
    "max_pool2d#four": _c("max_pool2d", ["X2"], kernel_size=2,
                          padding=[1, 0, 0, 1]),
    "max_pool2d#wide_pad": _c("max_pool2d", ["X2"], kernel_size=2,
                              padding=2),
    "max_pool2d#nhwc": _c("max_pool2d", ["X2L"], kernel_size=3, stride=2,
                          padding=1, data_format="NHWC"),
    "max_pool2d#int": _c("max_pool2d", ["XI2"], kernel_size=3, stride=2,
                         padding=1),
    "max_pool3d": _c("max_pool3d", ["X3"], kernel_size=2),
    "max_pool3d#pad": _c("max_pool3d", ["X3"], kernel_size=3, stride=2,
                         padding=1),
    # ---- adaptive pools --------------------------------------------------
    "adaptive_avg_pool1d": _c("adaptive_avg_pool1d", ["X1"], output_size=4),
    "adaptive_avg_pool1d#divisible": _c("adaptive_avg_pool1d", ["X1"],
                                        output_size=3),
    "adaptive_avg_pool2d": _c("adaptive_avg_pool2d", ["X2"],
                              output_size=(1, 1)),
    "adaptive_avg_pool2d#bins": _c("adaptive_avg_pool2d", ["X2"],
                                   output_size=(4, 3)),
    "adaptive_avg_pool3d": _c("adaptive_avg_pool3d", ["X3"],
                              output_size=(2, 4, 3)),
    "adaptive_max_pool1d": _c("adaptive_max_pool1d", ["X1"], output_size=4),
    "adaptive_max_pool2d": _c("adaptive_max_pool2d", ["X2"],
                              output_size=(4, 3)),
    "adaptive_max_pool2d#int": _c("adaptive_max_pool2d", ["XI2"],
                                  output_size=(3, 4)),
    "adaptive_max_pool3d": _c("adaptive_max_pool3d", ["X3"],
                              output_size=(2, 3, 2)),
}


def _inputs(P, keys):
    return [P.to_tensor(IN[k], stop_gradient=IN[k].dtype.kind != "f")
            for k in keys]


def _np(t):
    return np.asarray(t.numpy())


def _grads(P, ins, out, w):
    P.sum(out * P.to_tensor(w)).backward()
    return [None if t.stop_gradient else _np(t.grad) for t in ins]


def _against_jax(jfn, tfn, j_in, t_in, what):
    """Output and the gradients of sum(out * w) of the port's ``tfn``
    against the JAX ``jfn`` on the same inputs."""
    jo, to = jfn(*j_in), tfn(*t_in)
    ja, ta = _np(jo), _np(to)
    assert ja.shape == ta.shape and ja.dtype == ta.dtype, (
        what, ja.shape, ta.shape, ja.dtype, ta.dtype)
    if ja.dtype.kind in "biu":
        np.testing.assert_array_equal(ta, ja, err_msg=what)
        return
    np.testing.assert_allclose(ta, ja, err_msg=what, **TOL)
    w = np.random.default_rng(7).standard_normal(ja.shape).astype(
        np.float32)
    for i, (a, b) in enumerate(zip(_grads(jp, j_in, jo, w),
                                   _grads(tp, t_in, to, w))):
        np.testing.assert_allclose(b, a, err_msg=f"{what} grad {i}", **TOL)


@pytest.mark.parametrize("name", sorted(CASES))
def test_functional_against_jax(name):
    fn, keys = CASES[name]
    _against_jax(jp.jit.to_static(lambda *a: fn(jp, *a)),
                 lambda *a: fn(tp, *a),
                 _inputs(jp, keys), _inputs(tp, keys), name)


def test_every_function_has_a_case():
    from paddle_tpu_torch.nn.functional import conv, pooling
    covered = {n.split("#")[0] for n in CASES}
    assert set(conv.__all__ + pooling.__all__) == covered


# ---- the layers ------------------------------------------------------------

LAYERS = {
    "Conv1D": (lambda nn: nn.Conv1D(4, 6, 3, stride=2, padding=1), "X1"),
    "Conv2D": (lambda nn: nn.Conv2D(4, 6, 3, padding=1, groups=2), "X2"),
    "Conv2D#nhwc_nobias": (lambda nn: nn.Conv2D(
        4, 6, (3, 2), stride=2, padding="SAME", bias_attr=False,
        data_format="NHWC"), "X2L"),
    "Conv3D": (lambda nn: nn.Conv3D(4, 6, 2, dilation=2), "X3"),
    "Conv1DTranspose": (lambda nn: nn.Conv1DTranspose(
        4, 3, 3, stride=2, padding=1, output_padding=1), "XT1"),
    "Conv2DTranspose": (lambda nn: nn.Conv2DTranspose(
        4, 6, 3, stride=2, padding=1, groups=2), "XT2"),
    "Conv3DTranspose": (lambda nn: nn.Conv3DTranspose(4, 3, 2, stride=2),
                        "XT3"),
    "AvgPool1D": (lambda nn: nn.AvgPool1D(3, 2, 1), "X1"),
    "AvgPool2D": (lambda nn: nn.AvgPool2D(3, stride=2, padding=1,
                                          exclusive=False), "X2"),
    "AvgPool3D": (lambda nn: nn.AvgPool3D(2), "X3"),
    "MaxPool1D": (lambda nn: nn.MaxPool1D(2), "X1"),
    "MaxPool2D": (lambda nn: nn.MaxPool2D(3, stride=2, padding=1), "X2"),
    "MaxPool3D": (lambda nn: nn.MaxPool3D(3, 2, 1), "X3"),
    "AdaptiveAvgPool1D": (lambda nn: nn.AdaptiveAvgPool1D(4), "X1"),
    "AdaptiveAvgPool2D": (lambda nn: nn.AdaptiveAvgPool2D((1, 1)), "X2"),
    "AdaptiveAvgPool3D": (lambda nn: nn.AdaptiveAvgPool3D(2), "X3"),
    "AdaptiveMaxPool1D": (lambda nn: nn.AdaptiveMaxPool1D(3), "X1"),
    "AdaptiveMaxPool2D": (lambda nn: nn.AdaptiveMaxPool2D((4, 3)), "X2"),
    "AdaptiveMaxPool3D": (lambda nn: nn.AdaptiveMaxPool3D((2, 3, 2)), "X3"),
}


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_layer_against_jax(name):
    """The JAX layer's state_dict carried into the port's (same keys and
    shapes); output, the input's and every parameter's gradient."""
    build, key = LAYERS[name]
    jl, tl = build(jp.nn), build(tp.nn)
    jsd = jl.state_dict()
    assert list(jsd) == list(tl.state_dict()), name
    tl.set_state_dict({k: np.asarray(v._value) for k, v in jsd.items()})
    jx, tx = _inputs(jp, [key])[0], _inputs(tp, [key])[0]
    jo, to = jp.jit.to_static(jl)(jx), tl(tx)
    np.testing.assert_allclose(_np(to), _np(jo), err_msg=name, **TOL)
    w = np.random.default_rng(8).standard_normal(_np(jo).shape).astype(
        np.float32)
    jp.sum(jo * jp.to_tensor(w)).backward()
    tp.sum(to * tp.to_tensor(w)).backward()
    np.testing.assert_allclose(_np(tx.grad), _np(jx.grad), err_msg=name,
                               **TOL)
    for (n, jpar), (_, tpar) in zip(jl.named_parameters(),
                                    tl.named_parameters()):
        np.testing.assert_allclose(_np(tpar.grad), _np(jpar.grad),
                                   err_msg=f"{name} {n}", **TOL)


def test_every_layer_has_a_case():
    from paddle_tpu_torch.nn.layer import conv, pooling
    covered = {n.split("#")[0] for n in LAYERS}
    assert set(conv.__all__ + pooling.__all__) == covered


def test_conv_init_is_paddles_uniform():
    """weight and bias from Uniform(+-1/sqrt(fan_in)), fan_in = in/groups
    * prod(k), as the JAX layers draw them; the shapes paddle's."""
    tp.seed(3)
    for layer, fan_in, wshape, out in (
            (tp.nn.Conv2D(16, 32, 3, groups=2), 8 * 9, [32, 8, 3, 3], 32),
            (tp.nn.Conv2DTranspose(16, 32, 3, groups=4), 4 * 9,
             [16, 8, 3, 3], 32),
            (tp.nn.Conv1D(64, 64, 5), 64 * 5, [64, 64, 5], 64)):
        k = 1 / np.sqrt(fan_in)
        w, b = _np(layer.weight), _np(layer.bias)
        assert list(w.shape) == wshape and b.shape == (out,)
        assert np.abs(w).max() <= k and np.abs(b).max() <= k
        # a uniform's std is k / sqrt(3): within 10% over >= 4k draws
        assert abs(w.std() - k / np.sqrt(3)) < 0.1 * k / np.sqrt(3)
    assert tp.nn.Conv2D(3, 4, 3, bias_attr=False).bias is None


def test_what_the_reference_ignores_raises():
    """ceil_mode, return_mask, divisor_override and a padding_mode other
    than zeros raise: the JAX functions ignore them (max_pool2d with
    ceil_mode gives 7x7 where paddle gives 8x8)."""
    x = tp.to_tensor(_n(2, 16, 14, 14))
    F = tp.nn.functional
    for call in (lambda: F.max_pool2d(x, 3, 2, 1, ceil_mode=True),
                 lambda: F.max_pool2d(x, 3, return_mask=True),
                 lambda: F.avg_pool2d(x, 3, ceil_mode=True),
                 lambda: F.avg_pool2d(x, 3, divisor_override=4),
                 lambda: F.adaptive_max_pool2d(x, 2, return_mask=True),
                 lambda: tp.nn.MaxPool2D(3, ceil_mode=True)(x),
                 lambda: tp.nn.Conv2D(16, 4, 3, padding_mode="reflect")):
        with pytest.raises(NotImplementedError, match="JAX reference"):
            call()
    # the JAX function's wrong shape, which the port refuses to copy
    jy = jp.nn.functional.max_pool2d(jp.to_tensor(_n(2, 16, 14, 14)), 3, 2,
                                     1, ceil_mode=True)
    assert jy.shape == [2, 16, 7, 7]


@pytest.mark.parametrize("fn,out", [("adaptive_avg_pool2d", (1, 1)),
                                    ("adaptive_avg_pool2d", (4, 3)),
                                    ("adaptive_avg_pool3d", (2, 4, 3)),
                                    ("max_pool2d", None), ("avg_pool2d", None),
                                    ("conv2d", None)])
def test_channel_last_equals_nchw_transposed(fn, out):
    """Channel-last against the NC* result transposed (for the adaptive
    pools the JAX function reduces the last axes whatever the layout:
    ``adaptive_avg_pool2d(x_nhwc, (1, 1))`` gives ``[2, 14, 1, 1]``)."""
    F = tp.nn.functional
    x = _n(2, 4, 9, 8) if fn != "adaptive_avg_pool3d" else _n(1, 4, 5, 6, 5)
    nd = x.ndim
    to_last = (0,) + tuple(range(2, nd)) + (1,)
    to_first = (0, nd - 1) + tuple(range(1, nd - 1))
    fmt = "NHWC" if nd == 4 else "NDHWC"
    if fn.startswith("adaptive"):
        kw = dict(output_size=out)
    elif fn == "conv2d":
        kw = dict(weight=tp.to_tensor(IN["W2"]), padding="SAME", stride=2)
    else:
        kw = dict(kernel_size=3, stride=2, padding=1)
    want = getattr(F, fn)(tp.to_tensor(x), **kw).numpy()
    got = getattr(F, fn)(tp.to_tensor(np.ascontiguousarray(
        x.transpose(to_last))), data_format=fmt, **kw).numpy()
    np.testing.assert_allclose(got.transpose(to_first), want, **TOL)
    if fn == "adaptive_avg_pool2d" and out == (1, 1):
        jy = jp.nn.functional.adaptive_avg_pool2d(
            jp.to_tensor(x.transpose(to_last)), out, data_format="NHWC")
        assert jy.shape == [2, 9, 1, 1]     # the reference's fault


def test_auto_cast_dtypes_match_jax():
    """Under auto_cast(bf16) the convolutions (O1 white list) compute in
    bf16, the pools keep their input's dtype, as in the JAX package."""
    x, w = IN["X2"], IN["W2"]
    for P in (jp, tp):
        F = P.nn.functional
        with P.amp.auto_cast(dtype="bfloat16"):
            y = F.conv2d(P.to_tensor(x), P.to_tensor(w), padding=1)
            yt = F.conv2d_transpose(P.to_tensor(x), P.to_tensor(IN["WT2"]))
            p = F.max_pool2d(P.to_tensor(x), 2)
            a = F.adaptive_avg_pool2d(y, 1)
        assert (y.dtype, yt.dtype, p.dtype, a.dtype) == (
            P.bfloat16, P.bfloat16, P.float32, P.bfloat16), P.__name__
