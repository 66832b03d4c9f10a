"""``bench_resnet50``'s static program, the four ``static.nn``
convolutions and the Executor's fetch of an updated value, in
``paddle_tpu_torch.static`` against ``paddle_tpu.static``, on the CPU.

``bench.py``'s ``bench_resnet50`` builds ``static.data`` img and label,
``resnet50``, ``cross_entropy`` and ``Momentum(0.1, 0.9).minimize``; here
at B = 2 with 10 classes, on 3 x 64 x 64 images in f64, for 3 runs:
every loss, parameter and BN buffer against the JAX Executor's, from the
port's initial weights. At 3 x 32 x 32 layer4's maps are 1 x 1, so its
BNs normalize over the 2 values of a channel in the batch: that is so
ill-conditioned that the rounding of the two packages' convolutions
(XLA's and oneDNN's sums) moves the f32 programs' first loss, and the
f64 programs' later runs, beyond any tolerance. At 64 x 64 (8 values a
channel) the f64 programs agree within it; the f32 ones agree on the
first loss, and their later runs, after updates at learning rate 0.1 on
two images, differ beyond it.

Tolerances: losses, parameters and BN buffers rtol 1e-4, atol 1e-4; the
convolutions' fetches rtol 1e-5, atol 1e-5; a fetched parameter or
buffer against JAX's rtol 1e-6, atol 1e-7, and the port's first fetch
exactly the value before the run.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu.static.nn as jsnn
import paddle_tpu_torch as tp
import paddle_tpu_torch.static.nn as tsnn
from test_torch_static import (PKGS, _cpu_place, _pair, _params,  # noqa: F401
                               _program, _rng, _run)
from test_torch_vision import one_torch_thread, zero_jax_init  # noqa: F401

TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture
def float64():
    prev = jp.get_default_dtype(), tp.get_default_dtype()
    jp.set_default_dtype("float64")
    tp.set_default_dtype("float64")
    yield
    jp.set_default_dtype(prev[0])
    tp.set_default_dtype(prev[1])


def _bench_resnet50_build(B, hw, classes, dtype):
    """bench_resnet50's build (bench.py:495-504) at B, hw and classes."""
    def build(paddle, static):
        img = static.data("img", [B, 3, hw, hw], dtype)
        label = static.data("label", [B], "int64")
        net = paddle.vision.models.resnet50(num_classes=classes)
        loss = paddle.nn.functional.cross_entropy(net(img), label)
        opt = paddle.optimizer.Momentum(learning_rate=0.1, momentum=0.9,
                                        parameters=net.parameters())
        opt.minimize(loss)
        return loss, net
    return build


def test_bench_resnet50_static_three_momentum_runs_match_jax(float64,
                                                            zero_jax_init):
    """The port's parameters (``paddle.seed``) are set into the JAX
    program, whose initializers ``zero_jax_init`` skips; each package runs
    its program 3 times on one Executor."""
    B, hw, classes = 2, 64, 10
    rng = np.random.default_rng(0)
    feed = {"img": rng.standard_normal((B, 3, hw, hw)),
            "label": rng.integers(0, classes, B).astype(np.int64)}
    build = _bench_resnet50_build(B, hw, classes, "float64")
    tp.seed(0)
    (jm, (jloss, jnet)), (tm, (tloss, tnet)) = (_program("jax", build),
                                                _program("torch", build))
    jps, tps = _params("jax", jm), _params("torch", tm)
    assert [list(p.shape) for p in jps] == [p.shape for p in tps]
    for jpar, tpar in zip(jps, tps):
        jpar.set_value(np.array(tpar.numpy()))
    # the port's BN buffers start as the JAX ones (zeros and ones)
    jbuf = {k: np.asarray(v._value) for k, v in jnet.state_dict().items()
            if k.endswith(("_mean", "_variance"))}
    losses = {}
    for which, main, loss in (("torch", tm, tloss), ("jax", jm, jloss)):
        static = PKGS[which][1]
        static.enable_static()
        try:
            exe = static.Executor()
            losses[which] = [float(np.asarray(exe.run(
                main, feed=feed, fetch_list=[loss])[0])) for _ in range(3)]
        finally:
            static.disable_static()
    np.testing.assert_allclose(losses["torch"], losses["jax"], **TOL)
    assert all(np.isfinite(losses["torch"]))
    jsd, tsd = jnet.state_dict(), tnet.state_dict()
    assert list(jsd) == list(tsd)
    for k, v in jsd.items():
        np.testing.assert_allclose(tsd[k].numpy(), np.asarray(v._value),
                                   err_msg=k, **TOL)
    # every BN buffer moved, and each program trained all 161 parameters
    assert all(not np.array_equal(np.asarray(jsd[k]._value), v)
               for k, v in jbuf.items())
    assert len(jbuf) == 2 * 53
    assert len(_params("jax", jm)) == len(_params("torch", tm)) == 161


# ---- the static.nn convolutions ------------------------------------------

CONV_CASES = {
    "conv2d_relu": ((2, 3, 9, 8), lambda s, x: s.conv2d(
        x, num_filters=4, filter_size=3, stride=2, padding=1, act="relu")),
    "conv2d_groups_nobias": ((2, 4, 6, 6), lambda s, x: s.conv2d(
        x, num_filters=6, filter_size=[3, 1], groups=2, bias_attr=False)),
    "conv2d_transpose_output_size": ((2, 3, 5, 4), lambda s, x:
                                     s.conv2d_transpose(
                                         x, num_filters=4, output_size=[11, 9],
                                         stride=2, padding=1)),
    "conv2d_transpose_filter": ((2, 3, 5, 4), lambda s, x: s.conv2d_transpose(
        x, num_filters=4, filter_size=3, stride=2, act="tanh")),
    "conv3d": ((1, 2, 5, 4, 5), lambda s, x: s.conv3d(
        x, num_filters=3, filter_size=3, padding=1, act="sigmoid")),
    "conv3d_transpose": ((1, 2, 3, 4, 3), lambda s, x: s.conv3d_transpose(
        x, num_filters=3, output_size=[6, 8, 6], stride=2)),
}


@pytest.mark.parametrize("case", sorted(CONV_CASES))
def test_static_nn_convs_match_jax(case):
    shape, fn = CONV_CASES[case]
    x_np = _rng(9).standard_normal(shape).astype(np.float32)

    def build(paddle, static):
        snn = jsnn if paddle is jp else tsnn
        return fn(snn, static.data("x", list(shape), "float32"))

    (jm, jy), (tm, ty) = _pair(build)
    want = _run("jax", jm, {"x": x_np}, [jy])[0]
    got = _run("torch", tm, {"x": x_np}, [ty])[0]
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_static_nn_transpose_needs_a_size():
    with pytest.raises(ValueError, match="filter_size or output_size"):
        _program("torch", lambda paddle, static: tsnn.conv2d_transpose(
            static.data("x", [1, 2, 4, 4], "float32"), num_filters=2))
    with pytest.raises(ValueError, match="numeric padding"):
        _program("torch", lambda paddle, static: tsnn.conv2d_transpose(
            static.data("x", [1, 2, 4, 4], "float32"), num_filters=2,
            output_size=[8, 8], padding="SAME"))


# ---- the Executor's fetch of a value the run updates ---------------------

def _fetch_runs(which, build, feed, fetch_of, return_numpy):
    """Two runs fetching ``fetch_of(out)``: the two runs' fetches, read as
    numpy after both runs, and what the build returned."""
    main, out = _program(which, build)
    static = PKGS[which][1]
    fetch = fetch_of(out)
    static.enable_static()
    try:
        exe = static.Executor()
        r1 = exe.run(main, feed=feed, fetch_list=fetch,
                     return_numpy=return_numpy)
        r2 = exe.run(main, feed=feed, fetch_list=fetch,
                     return_numpy=return_numpy)
    finally:
        static.disable_static()

    def read(rs):
        return [np.array(r if return_numpy else r.numpy()) for r in rs]
    return read(r1), read(r2), out


@pytest.mark.parametrize("return_numpy", [True, False])
def test_fetched_parameter_is_the_value_the_run_read(return_numpy):
    """Linear(3, 2) under SGD(0.5), fetching [loss, weight] over two runs:
    run 1 returns w0 and run 2 w1, and run 1's fetch still reads w0 after
    run 2 (it was w1, then w2: the update's storage), as the JAX
    Executor's."""
    x = _rng(4).standard_normal((4, 3)).astype(np.float32)

    def build(paddle, static):
        lin = paddle.nn.Linear(3, 2)
        loss = paddle.mean(lin(static.data("x", [4, 3], "float32")))
        paddle.optimizer.SGD(0.5, parameters=lin.parameters()).minimize(loss)
        return loss, lin

    (jm, (jl, jlin)), (tm, (tl, tlin)) = _pair(build)
    w0 = np.array(tlin.weight.numpy())
    got, want = {}, {}
    for which, main, loss, lin, into in (("jax", jm, jl, jlin, want),
                                         ("torch", tm, tl, tlin, got)):
        static = PKGS[which][1]
        static.enable_static()
        try:
            exe = static.Executor()
            rs = [exe.run(main, feed={"x": x}, fetch_list=[loss, lin.weight],
                          return_numpy=return_numpy) for _ in range(2)]
        finally:
            static.disable_static()
        into.update(w=[np.array(r[1] if return_numpy else r[1].numpy())
                       for r in rs], end=np.array(lin.weight.numpy()))
    np.testing.assert_array_equal(got["w"][0], w0)
    for a, b in zip(got["w"], want["w"]):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)
    assert not np.array_equal(got["w"][1], w0)
    assert not np.array_equal(got["end"], got["w"][1])


@pytest.mark.parametrize("return_numpy", [True, False])
def test_fetched_bn_buffer_is_the_value_the_run_read(return_numpy):
    """A training BN's running mean fetched with a minimize: each run
    returns the statistics it read (zeros, then run 1's update), a copy
    that run 2's update leaves alone, as the JAX Executor's."""
    x = _rng(5).standard_normal((4, 3, 2, 2)).astype(np.float32)

    def build(paddle, static):
        bn = paddle.nn.BatchNorm2D(3)
        loss = paddle.mean(bn(static.data("x", [4, 3, 2, 2], "float32")))
        paddle.optimizer.SGD(0.1, parameters=bn.parameters()).minimize(loss)
        return loss, bn

    runs = {which: _fetch_runs(which, build, {"x": x},
                               lambda out: [out[0], out[1]._mean],
                               return_numpy)
            for which in ("jax", "torch")}
    (j1, j2, (_, jbn)), (t1, t2, (_, tbn)) = runs["jax"], runs["torch"]
    np.testing.assert_array_equal(t1[1], np.zeros(3, np.float32))
    np.testing.assert_allclose(t2[1], j2[1], rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(j1[1], np.zeros(3, np.float32))
    assert np.abs(t2[1]).max() > 0
    np.testing.assert_allclose(tbn._mean.numpy(), np.asarray(
        jbn._mean._value), rtol=1e-6, atol=1e-7)
    assert not np.array_equal(tbn._mean.numpy(), t2[1])
