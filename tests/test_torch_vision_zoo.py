"""The rest of ``paddle_tpu_torch.vision.models`` against
``paddle_tpu.vision.models``, on the CPU: each family at its smallest
variant on a small input, in eval mode, in f64. The port's weights (drawn from
``paddle.seed``, then ``calibrate``d: He-uniform weights and BN
statistics from a calibration batch, so that the logits are of order 1)
are carried into the JAX model, whose own initializers are skipped
(``zero_jax_init``); the state_dict keys and shapes must be equal. The
JAX forward runs under ``paddle_tpu.jit.to_static`` (one XLA program,
where the eager tape compiles every op on the CPU).

Tolerance: logits rtol 1e-4, atol 1e-4, each output's max |logit| above
``MIN_LOGIT`` (0.5). In f32 the tolerance fails on rounding alone: with
logits of order 1, JAX's own f32 inception_v3 is 5.7 tolerances from its
f64 (``tools/torch_vision_f32_rounding.py``); the f64 programs agree
within it.
"""
import numpy as np
import pytest

import paddle_tpu as jp
import paddle_tpu.vision as jvision
import paddle_tpu_torch as tp
import paddle_tpu_torch.vision as tvision
from paddle_tpu_torch.framework import place as tplace
from test_torch_vision import (_carry, assert_logits_close,  # noqa: F401
                               calibrate, one_torch_thread, zero_jax_init)


@pytest.fixture(autouse=True)
def _cpu_place():
    prev = tplace._current_place
    tp.set_device("cpu")
    yield
    tplace._current_place = prev


@pytest.fixture(autouse=True)
def _float64():
    prev = jp.get_default_dtype(), tp.get_default_dtype()
    jp.set_default_dtype("float64")
    tp.set_default_dtype("float64")
    yield
    jp.set_default_dtype(prev[0])
    tp.set_default_dtype(prev[1])


# (model function, its arguments, input shape)
ZOO = {
    "LeNet": ("LeNet", {}, (2, 1, 28, 28)),
    "alexnet": ("alexnet", dict(num_classes=10), (1, 3, 64, 64)),
    "vgg11": ("vgg11", dict(num_classes=10), (1, 3, 32, 32)),
    "vgg11_bn": ("vgg11", dict(num_classes=10, batch_norm=True),
                 (1, 3, 32, 32)),
    "mobilenet_v1": ("mobilenet_v1", dict(scale=0.25, num_classes=10),
                     (1, 3, 32, 32)),
    "mobilenet_v2": ("mobilenet_v2", dict(scale=0.25, num_classes=10),
                     (1, 3, 32, 32)),
    "mobilenet_v3_small": ("mobilenet_v3_small",
                           dict(scale=0.5, num_classes=10), (1, 3, 32, 32)),
    "mobilenet_v3_large": ("mobilenet_v3_large",
                           dict(scale=0.5, num_classes=10), (1, 3, 32, 32)),
    "squeezenet1_1": ("squeezenet1_1", dict(num_classes=10), (1, 3, 64, 64)),
    "shufflenet_v2_x0_25": ("shufflenet_v2_x0_25", dict(num_classes=10),
                            (1, 3, 32, 32)),
    "densenet121": ("densenet121", dict(num_classes=10), (1, 3, 32, 32)),
    "googlenet": ("googlenet", dict(num_classes=10), (1, 3, 64, 64)),
    "inception_v3": ("inception_v3", dict(num_classes=10), (1, 3, 96, 96)),
}


@pytest.mark.parametrize("name", sorted(ZOO))
def test_zoo_forward_matches_jax(name, zero_jax_init):
    build, kw, shape = ZOO[name]
    tp.seed(len(name))
    tm = calibrate(getattr(tvision.models, build)(**kw), shape)
    jm = getattr(jvision.models, build)(**kw).eval()
    jsd, tsd = jm.state_dict(), tm.state_dict()
    assert [(k, list(v.shape)) for k, v in jsd.items()] == \
        [(k, list(v.shape)) for k, v in tsd.items()], name
    _carry(tm, jm)
    x = np.random.default_rng(len(name)).random(shape)
    tys, jys = tm(tp.to_tensor(x)), jp.jit.to_static(jm)(jp.to_tensor(x))
    tys = tys if isinstance(tys, tuple) else (tys,)
    jys = tuple(jys) if isinstance(jys, (tuple, list)) else (jys,)
    assert len(tys) == len(jys)
    for ty, jy in zip(tys, jys):
        assert_logits_close(ty.numpy(), np.asarray(jy.numpy()), name)


def test_every_family_has_a_case():
    """Each model class of the zoo is built by a case here or in
    test_torch_vision.py (the ResNets)."""
    classes = {n for n in dir(tvision.models) if n[0].isupper()}
    built = {type(getattr(tvision.models, b)(**kw)).__name__
             for b, kw, _ in ZOO.values()}
    assert classes - built == {"ResNet", "BasicBlock", "BottleneckBlock"}
