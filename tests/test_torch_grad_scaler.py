"""The port's ``GradScaler`` against the JAX package's, on the CPU.

The small least-squares model of ``tests/test_torch_optimizer.py`` (a
``Linear`` of 6 to 4 and a loose vector) with the same numpy weights and
data on both sides, trained by SGD through each framework's scaler. The
scale, the counters and ``state_dict`` are host numbers and must be equal;
gradients and parameters are f32 sums in other orders (rtol 1e-5, atol
1e-6, the optimizer tests' tolerance).
"""
import numpy as np
import pytest
import torch

from paddle_tpu import amp as jamp
from paddle_tpu import optimizer as joptim
from paddle_tpu_torch import amp as tamp
from paddle_tpu_torch import optimizer as toptim

from test_torch_optimizer import F32, _data, _jax_model, _TorchModel


def _pair(**kw):
    """(JAX params, JAX loss, JAX optimizer, JAX scaler) and the port's
    (model, optimizer, scaler), from the same numpy weights."""
    d = _data()
    jparams, jloss = _jax_model(d)
    tm = _TorchModel(d)
    jopt = joptim.SGD(0.05, parameters=jparams)
    topt = toptim.SGD(0.05, parameters=tm.parameters())
    return (jparams, jloss, jopt, jamp.GradScaler(**kw)), \
        (tm, d, topt, tamp.GradScaler(**kw))


def _tparams(tm):
    return [tm.lin.weight, tm.lin.bias, tm.u]


def _assert_params(jparams, tm):
    for i, (j, t) in enumerate(zip(jparams, _tparams(tm))):
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(j._value),
                                   **F32, err_msg=f"param {i}")


def _poison(grads_of, where):
    """Put an inf into the first gradient (the backward ran already)."""
    if where == "jax":
        g = grads_of[0].grad
        g._value = g._value.at[0, 0].set(np.inf)
    else:
        grads_of[0].grad[0, 0] = float("inf")


def _steps(j, t, bad_steps):
    """One scaled step a flag of ``bad_steps`` on both sides (an inf put
    into a gradient where the flag is set): the scaler's ``scale``,
    ``step`` and ``update``. Returns the scales seen after each step."""
    (jparams, jloss, jopt, js), (tm, d, topt, ts) = j, t
    scales = []
    for bad in bad_steps:
        js.scale(jloss()).backward()
        ts.scale(tm.loss(d)).backward()
        if bad:
            _poison(jparams, "jax")
            _poison(_tparams(tm), "torch")
        js.step(jopt)
        ts.step(topt)
        js.update()
        ts.update()
        jopt.clear_grad()
        topt.clear_grad()
        scales.append((js._scale, ts._scale))
    return scales


def test_scale_unscale_and_step_match_jax():
    """The scaled loss, the unscaled gradients, one step and the scale."""
    j, t = _pair(init_loss_scaling=2.0 ** 10)
    (jparams, jloss, jopt, js), (tm, d, topt, ts) = j, t
    jl, tl = js.scale(jloss()), ts.scale(tm.loss(d))
    np.testing.assert_allclose(tl.item(), float(np.asarray(jl._value)),
                               rtol=1e-6)
    jl.backward()
    tl.backward()
    js.unscale_(jopt)
    ts.unscale_(topt)
    for i, (jp, tp) in enumerate(zip(jparams, _tparams(tm))):
        np.testing.assert_allclose(tp.grad.numpy(),
                                   np.asarray(jp.grad._value), **F32,
                                   err_msg=f"grad {i}")
    js.step(jopt)
    ts.step(topt)
    js.update()
    ts.update()
    _assert_params(jparams, tm)
    assert ts.get_loss_scaling().item() == \
        float(np.asarray(js.get_loss_scaling()._value)) == 2.0 ** 10
    assert ts.get_loss_scaling().dtype == torch.float32
    assert ts.state_dict() == js.state_dict()


@pytest.mark.parametrize("misuse", ["unscale_twice", "unscale_after_step",
                                    "step_twice"])
def test_unscale_guard_matches_jax(misuse):
    """Each optimizer moves INIT -> UNSCALED -> STEPPED between updates:
    the same misuse raises the same error on both sides, and ``update``
    resets the guard."""
    j, t = _pair()
    (_, jloss, jopt, js), (tm, d, topt, ts) = j, t
    errors = []
    for scaler, opt, loss in ((js, jopt, jloss), (ts, topt,
                                                  lambda: tm.loss(d))):
        scaler.scale(loss()).backward()
        first, second = {"unscale_twice": ("unscale_", "unscale_"),
                         "unscale_after_step": ("step", "unscale_"),
                         "step_twice": ("step", "step")}[misuse]
        getattr(scaler, first)(opt)
        with pytest.raises(RuntimeError) as e:
            getattr(scaler, second)(opt)
        errors.append(str(e.value))
        scaler.update()
        scaler.unscale_(opt)       # after update() the guard is reset
    assert errors[0] == errors[1]


def test_skipped_steps_and_counters_match_jax():
    """A step with an inf in a gradient is skipped (the parameters stay),
    two bad steps in a row halve the scale, two good ones double it; the
    counters and ``state_dict`` follow the JAX scaler's after each step."""
    kw = dict(init_loss_scaling=2.0 ** 8, incr_every_n_steps=2,
              decr_every_n_nan_or_inf=2)
    j, t = _pair(**kw)
    (tm, _, _, ts) = t
    before = [p.detach().clone() for p in _tparams(tm)]
    scales = _steps(j, t, [True])
    assert all(torch.equal(a, b) for a, b in zip(before, _tparams(tm)))
    scales += _steps(j, t, [True, False, False, False, True, True])
    for js_scale, ts_scale in scales:
        assert js_scale == ts_scale
    assert [s for _, s in scales] == [2.0 ** 8, 2.0 ** 7, 2.0 ** 7, 2.0 ** 8,
                                      2.0 ** 8, 2.0 ** 8, 2.0 ** 7]
    assert ts.state_dict() == j[3].state_dict()
    _assert_params(j[0], tm)


def test_state_dict_round_trip_and_switches():
    """``load_state_dict`` restores the scale and counters; a disabled
    scaler passes the loss through and steps plainly; the static scale
    never moves; ``AmpScaler`` is the same class, on both sides."""
    ts = tamp.GradScaler(init_loss_scaling=64.0)
    ts._good_steps, ts._bad_steps = 3, 1
    other = tamp.GradScaler()
    other.load_state_dict(ts.state_dict())
    assert other.state_dict() == ts.state_dict()
    other.set_init_loss_scaling(2.0)
    assert other.get_loss_scaling().item() == 2.0
    assert tamp.AmpScaler is tamp.GradScaler
    assert jamp.AmpScaler is jamp.GradScaler
    off = tamp.GradScaler(enable=False)
    loss = torch.tensor(3.0)
    assert off.scale(loss) is loss and not off.is_enable()
    static = tamp.GradScaler(init_loss_scaling=4.0,
                             use_dynamic_loss_scaling=False)
    assert not static.is_use_dynamic_loss_scaling()
    static._found_inf = True
    static.update()
    assert static._scale == 4.0 and not static._found_inf


def test_minimize_matches_jax():
    """``minimize(optimizer, scaled_loss)``: backward, step and update."""
    j, t = _pair(init_loss_scaling=2.0 ** 4)
    (jparams, jloss, jopt, js), (tm, d, topt, ts) = j, t
    for _ in range(2):
        js.minimize(jopt, js.scale(jloss()))
        ts.minimize(topt, ts.scale(tm.loss(d)))
        jopt.clear_grad()
        topt.clear_grad()
    _assert_params(jparams, tm)
    assert ts.state_dict() == js.state_dict()
