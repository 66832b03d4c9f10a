"""``paddle_tpu_torch.vision`` against ``paddle_tpu.vision``, on the CPU.

ResNet-18 and ResNet-50 (``num_classes=10``) on ``[2, 3, 32, 32]`` (the
JAX test ``test_io_vision.py``'s input), weights and BN buffers carried
across by ``set_state_dict`` from numpy: the logits, every parameter's
gradient and the BN running statistics, in eval and in training mode, in
f64 (``RESNET_CASES`` says why; in training mode ResNet-50 takes
``[2, 3, 64, 64]``). LeNet trained by Adam as ``test_io_vision.py``
trains it, against the JAX loop. The state_dict keys of every ResNet
model function, and the closures of ``vision`` and ``vision.models``.
The JAX models run under ``paddle_tpu.jit.to_static`` (one XLA program
and its VJP, where the eager tape compiles every op on the CPU).

Eval-mode models are compared after ``calibrate`` (He-uniform weights,
BN statistics from a calibration batch), so that their logits are of
order 1; each comparison also asserts that size.

Tolerances: whole models rtol 1e-4, atol 1e-4.
"""
import math

import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu.vision as jvision
import paddle_tpu_torch as tp
import paddle_tpu_torch.vision as tvision
from paddle_tpu_torch.framework import place as tplace
from paddle_tpu_torch.nn.layer.norm import _BatchNormBase

TOL = dict(rtol=1e-4, atol=1e-4)
# the least max |logit| a comparison at TOL is held to: below it the
# absolute tolerance would pass any model
MIN_LOGIT = 0.5


@pytest.fixture(autouse=True)
def _cpu_place():
    prev = tplace._current_place
    tp.set_device("cpu")
    yield
    tplace._current_place = prev


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread for torch: the suite runs in several worker
    processes, and torch's CPU convolutions (f64 above all) run many times
    slower when the workers' threads outnumber the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(t):
    return np.asarray(t.numpy())


@pytest.fixture
def zero_jax_init(monkeypatch):
    """The JAX layers' parameters made as numpy zeros, without their
    initializers (``jax.random`` compiles once per shape on the CPU, over
    ten seconds for a model): for tests that carry the port's weights into
    the JAX model, or read shapes alone."""
    import jax.numpy as jnp
    from paddle_tpu.nn.layer import layers as jlayers
    create = jlayers.Layer.create_parameter

    def zeros(shape, dtype):
        return jnp.asarray(np.zeros(shape, dtype.np_dtype))

    def create_parameter(self, shape, attr=None, dtype=None, is_bias=False,
                         default_initializer=None):
        return create(self, shape, attr, dtype, is_bias, zeros)
    monkeypatch.setattr(jlayers.Layer, "create_parameter", create_parameter)


def _carry(src, dst):
    """``src``'s state_dict (parameters and buffers) into ``dst`` by
    ``set_state_dict`` from numpy (either package into the other); the key
    sets must be equal."""
    sd = src.state_dict()
    assert list(sd) == list(dst.state_dict())
    dst.set_state_dict({k: np.array(v.numpy()) for k, v in sd.items()})


def calibrate(m, shape, seed=99):
    """Make ``m``'s eval-mode outputs of order 1. paddle's
    Uniform(±1/sqrt(fan_in)) weights shrink a ReLU layer's second moment
    about sixfold, and fresh BN statistics make every BN the identity, so
    a deep model's logits fall to 1e-6 or below, where the absolute
    tolerance passes anything. Every conv and fc weight is scaled by
    sqrt(6) (He's uniform bound), and every BN's running statistics are
    set to those of a calibration batch of 8 of ``shape[1:]`` (a pass with
    the BNs alone in training mode, momentum 0). Leaves ``m`` in eval
    mode."""
    bns = [l for l in m.sublayers() if isinstance(l, _BatchNormBase)]
    x = np.random.default_rng(seed).random((8,) + tuple(shape[1:]))
    m.eval()
    with tp.no_grad():
        with torch.no_grad():
            for p in m.parameters():
                if len(p.shape) >= 2:
                    p._value.mul_(math.sqrt(6))
        moms = [bn._momentum for bn in bns]
        for bn in bns:
            bn._momentum, bn.training = 0.0, True
        m(tp.to_tensor(x.astype(tp.get_default_dtype())))
        for bn, mom in zip(bns, moms):
            bn._momentum, bn.training = mom, False
    return m


def assert_logits_close(t, j, msg=""):
    """``t`` against ``j`` at TOL, after asserting that ``j`` is large
    enough for TOL to tell models apart (its max |logit| is in the
    message)."""
    size = float(np.abs(j).max())
    msg = f"{msg} (max |logit| {size:.4g})"
    assert t.shape == j.shape and np.isfinite(t).all(), msg
    assert size > MIN_LOGIT, msg
    np.testing.assert_allclose(t, j, err_msg=msg, **TOL)


@pytest.fixture
def default_dtype(request):
    """Both packages' default float dtype set to ``request.param`` for the
    test (parameters are made in it), then put back."""
    prev = jp.get_default_dtype(), tp.get_default_dtype()
    jp.set_default_dtype(request.param)
    tp.set_default_dtype(request.param)
    yield request.param
    jp.set_default_dtype(prev[0])
    tp.set_default_dtype(prev[1])


# (model function, mode, dtype, input). In training mode the BNs of
# layer4 see B x H x W values a channel (H x W = 1 x 1 at a 32 x 32
# input): with so few, the normalization is so ill-conditioned that f32
# rounding (the convolutions' sums in XLA's and oneDNN's orders) moves
# ResNet-50's logits and gradients beyond any tolerance, in either
# package. More values do not cure it: at [4, 3, 64, 64] (16 a channel)
# each package's f32 gradients differ from its own f64 ones by percents.
# In eval mode, with logits of order 1, f32 rounding alone puts either
# package's ResNet-18 gradients 1.4 tolerances from its own f64 ones
# (tools/torch_vision_f32_rounding.py gives both readings). Every case is
# therefore held in f64 (ResNet-50's at 64 x 64), where the port agrees
# with JAX well within the tolerance; no test holds a whole ResNet in
# f32 against JAX.
RESNET_CASES = [("resnet18", "eval", "float64", (2, 3, 32, 32)),
                ("resnet18", "train", "float64", (2, 3, 32, 32)),
                ("resnet50", "train", "float64", (2, 3, 64, 64))]


@pytest.mark.parametrize("build,mode,default_dtype,shape", RESNET_CASES,
                         indirect=["default_dtype"])
def test_resnet_logits_and_gradients_match_jax(build, mode, default_dtype,
                                               shape, zero_jax_init):
    """Logits, the gradient of sum(logits * w) over every parameter, and
    the BN buffers after the forward (updated in training mode). The
    port's weights (``paddle.seed``, calibrated in eval mode) are carried
    into the JAX model, which runs under ``jit.to_static``."""
    tp.seed(len(build))
    jm = getattr(jvision.models, build)(num_classes=10)
    tm = getattr(tvision.models, build)(num_classes=10)
    if mode == "eval":
        calibrate(tm, shape)
    _carry(tm, jm)
    getattr(jm, mode)()
    getattr(tm, mode)()
    rng = np.random.default_rng(len(shape))
    x = rng.random(shape).astype(default_dtype)
    w = rng.standard_normal((shape[0], 10)).astype(default_dtype)
    jy, ty = jp.jit.to_static(jm)(jp.to_tensor(x)), tm(tp.to_tensor(x))
    assert ty.shape == [shape[0], 10]
    assert ty.dtype == getattr(tp, default_dtype)
    assert_logits_close(_np(ty), _np(jy), f"{build} {mode}")
    jp.sum(jy * jp.to_tensor(w)).backward()
    tp.sum(ty * tp.to_tensor(w)).backward()
    jparams, tparams = dict(jm.named_parameters()), \
        dict(tm.named_parameters())
    assert list(jparams) == list(tparams)
    for name, jpar in jparams.items():
        np.testing.assert_allclose(_np(tparams[name].grad), _np(jpar.grad),
                                   err_msg=name, **TOL)
    tsd = tm.state_dict()
    for name, v in jm.state_dict().items():
        if name.endswith(("_mean", "_variance")):
            np.testing.assert_allclose(_np(tsd[name]), np.asarray(v._value),
                                       err_msg=name, **TOL)


def test_resnet_state_dict_keys_equal_jax(zero_jax_init):
    """Every ResNet model function's state_dict keys (parameters and BN
    buffers, e.g. ``layer1.0.conv1.weight``, ``bn1._mean``) and shapes
    equal the JAX model's; ``pretrained=True`` raises as the JAX function
    does."""
    for build in ("resnet18", "resnet34", "resnet50", "resnet101",
                  "resnet152", "wide_resnet50_2", "wide_resnet101_2",
                  "resnext50_32x4d"):
        jsd = getattr(jvision.models, build)(num_classes=7).state_dict()
        tsd = getattr(tvision.models, build)(num_classes=7).state_dict()
        assert list(jsd) == list(tsd), build
        for k, v in tsd.items():
            assert list(jsd[k].shape) == list(v.shape), (build, k)
    assert "layer1.0.conv1.weight" in tsd and "bn1._mean" in tsd
    with pytest.raises(NotImplementedError, match="pretrained"):
        tvision.models.resnet50(pretrained=True)
    m = tvision.models.resnet18(num_classes=0, with_pool=False)
    y = m(tp.to_tensor(np.zeros((1, 3, 64, 64), np.float32)))
    assert y.shape == [1, 512, 2, 2]


def test_lenet_adam_training_matches_jax():
    """LeNet on 8 fixed samples through Adam(1e-3), the loop of
    ``test_io_vision.py`` (the JAX forward under ``jit.to_static``): every
    loss and the parameters after 5 steps."""
    x = np.random.default_rng(7).random((8, 1, 28, 28)).astype(np.float32)
    y = np.arange(8) % 10
    jp.seed(7)
    jm = jvision.models.LeNet()
    tm = tvision.models.LeNet()
    _carry(jm, tm)
    losses = {}
    for P, m in (("jax", jm), ("torch", tm)):
        pkg = jp if P == "jax" else tp
        opt = pkg.optimizer.Adam(1e-3, parameters=m.parameters())
        ce = pkg.nn.CrossEntropyLoss()
        xs, ys = pkg.to_tensor(x), pkg.to_tensor(y)
        fwd = jp.jit.to_static(m) if P == "jax" else m
        losses[P] = []
        for _ in range(5):
            loss = ce(fwd(xs), ys)
            loss.backward()
            opt.step()
            opt.clear_grad()
            losses[P].append(float(loss))
    np.testing.assert_allclose(losses["torch"], losses["jax"], **TOL)
    assert losses["torch"][-1] < losses["torch"][0]
    tparams = dict(tm.named_parameters())
    for name, jpar in jm.named_parameters():
        np.testing.assert_allclose(_np(tparams[name]), _np(jpar),
                                   err_msg=name, **TOL)


# ---- closures -------------------------------------------------------------

# what ROADMAP Queue 1 item 13 defers in ``vision``
VISION_NOT_PORTED = {"transforms", "datasets", "ops", "image",
                     "set_image_backend", "get_image_backend", "image_load"}


def test_vision_closure():
    """``vision.models`` is whole: every public name of the JAX zoo is in
    the port's; ``vision`` has ``models`` and defers the rest."""
    jnames = {n for n in dir(jvision.models) if not n.startswith("_")}
    tnames = {n for n in dir(tvision.models) if not n.startswith("_")}
    modules = {n for n in jnames if n in {
        "alexnet", "densenet", "googlenet", "inceptionv3", "lenet",
        "mobilenet", "mobilenetv1", "mobilenetv3", "resnet", "shufflenetv2",
        "squeezenet", "vgg"}}
    assert not (jnames - tnames), sorted(jnames - tnames)
    assert modules <= tnames
    jv = {n for n in dir(jvision) if not n.startswith("_")}
    assert VISION_NOT_PORTED <= jv
    assert jv - VISION_NOT_PORTED == {"models"}
    assert set(tvision.__all__) == {"models"}
    assert not (VISION_NOT_PORTED & set(dir(tvision)))
    assert tp.vision is tvision
