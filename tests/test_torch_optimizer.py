"""The port's optimizers and gradient clips against the JAX package's, on
the CPU.

A small least-squares model (a ``Linear`` of 6 to 4 and a loose vector) with
the same numpy weights and data on both sides; each framework takes its
own gradients, and after 3 steps every parameter is held to the JAX one's
(f32, sums in other orders: rtol 1e-5, atol 1e-6).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import optimizer as joptim
from paddle_tpu.incubate.distributed.models.moe import (
    ClipGradForMOEByGlobalNorm as JClipMoE)
from paddle_tpu.nn import clip as jclip
from paddle_tpu_torch import optimizer as toptim
from paddle_tpu_torch.incubate.distributed.models.moe import (
    ClipGradForMOEByGlobalNorm)
from paddle_tpu_torch.nn import clip as tclip
from paddle_tpu_torch.nn._torch_layers import Linear
from paddle_tpu_torch.optimizer import lr as tlr

F32 = dict(rtol=1e-5, atol=1e-6)
STEPS = 3


def _data():
    rng = np.random.default_rng(0)
    return dict(w=rng.standard_normal((6, 4)).astype(np.float32) * 0.5,
                b=rng.standard_normal((4,)).astype(np.float32) * 0.1,
                u=rng.standard_normal((4,)).astype(np.float32),
                x=rng.standard_normal((16, 6)).astype(np.float32),
                y=rng.standard_normal((16, 4)).astype(np.float32))


class _TorchModel(torch.nn.Module):
    def __init__(self, d):
        super().__init__()
        self.lin = Linear(6, 4, generator=torch.Generator().manual_seed(0))
        with torch.no_grad():
            self.lin.weight.copy_(torch.from_numpy(d["w"]))
            self.lin.bias.copy_(torch.from_numpy(d["b"]))
        self.u = torch.nn.Parameter(torch.tensor(d["u"]))

    def loss(self, d):
        out = self.lin(torch.from_numpy(d["x"])) * self.u
        return ((out - torch.from_numpy(d["y"])) ** 2).mean()


def _jax_model(d):
    lin = paddle.nn.Linear(6, 4)
    lin.weight.set_value(d["w"])
    lin.bias.set_value(d["b"])
    u = paddle.create_parameter([4], "float32")
    u.set_value(d["u"])

    def loss():
        out = lin(paddle.to_tensor(d["x"])) * u
        return ((out - paddle.to_tensor(d["y"])) ** 2).mean()
    return [lin.weight, lin.bias, u], loss


def _run(make_j, make_t, steps=STEPS, sched=None, attrs=None):
    """``steps`` steps of the JAX optimizer ``make_j(params, lr)`` and the
    port's ``make_t(module, lr)``; ``sched`` makes a learning-rate scheduler
    from either package's ``lr`` module (stepped after each step);
    ``attrs`` sets attributes on the JAX and the port parameters, by
    index. Returns both parameter lists as numpy."""
    d = _data()
    jparams, jloss = _jax_model(d)
    tm = _TorchModel(d)
    tparams = [tm.lin.weight, tm.lin.bias, tm.u]
    for i, kv in (attrs or {}).items():
        for p, v in ((jparams[i], kv["jax"]), (tparams[i], kv["torch"])):
            for k, val in v.items():
                setattr(p, k, val)
    jlr = sched(joptim.lr) if sched else 0.05
    tlr_ = sched(tlr) if sched else 0.05
    jopt, topt = make_j(jparams, jlr), make_t(tm, tlr_)
    for _ in range(steps):
        jloss().backward()
        jopt.step()
        jopt.clear_grad()
        tm.loss(d).backward()
        topt.step()
        topt.clear_grad()
        if sched:
            jlr.step()
            tlr_.step()
    return ([np.asarray(p._value) for p in jparams],
            [p.detach().numpy() for p in tparams])


def _assert_params(j, t):
    for i, (a, b) in enumerate(zip(t, j)):
        np.testing.assert_allclose(a, b, **F32, err_msg=f"param {i}")


CASES = {
    "sgd": (lambda p, lr: joptim.SGD(lr, parameters=p),
            lambda m, lr: toptim.SGD(lr, parameters=m.parameters())),
    "sgd_l2": (lambda p, lr: joptim.SGD(lr, parameters=p, weight_decay=0.1),
               lambda m, lr: toptim.SGD(lr, parameters=m.parameters(),
                                        weight_decay=0.1)),
    "sgd_l1": (lambda p, lr: joptim.SGD(lr, parameters=p,
                                        weight_decay=joptim.L1Decay(0.1)),
               lambda m, lr: toptim.SGD(lr, parameters=m.parameters(),
                                        weight_decay=toptim.L1Decay(0.1))),
    "momentum": (lambda p, lr: joptim.Momentum(lr, 0.9, parameters=p),
                 lambda m, lr: toptim.Momentum(lr, 0.9,
                                               parameters=m.parameters())),
    "nesterov": (lambda p, lr: joptim.Momentum(lr, 0.8, parameters=p,
                                               use_nesterov=True),
                 lambda m, lr: toptim.Momentum(lr, 0.8,
                                               parameters=m.parameters(),
                                               use_nesterov=True)),
    "adam": (lambda p, lr: joptim.Adam(lr, parameters=p),
             lambda m, lr: toptim.Adam(lr, parameters=m.parameters())),
    "adam_l2": (lambda p, lr: joptim.Adam(lr, parameters=p,
                                          weight_decay=0.01),
                lambda m, lr: toptim.Adam(lr, parameters=m.parameters(),
                                          weight_decay=0.01)),
    "adamw": (lambda p, lr: joptim.AdamW(lr, parameters=p, weight_decay=0.1),
              lambda m, lr: toptim.AdamW(lr, parameters=m.parameters(),
                                         weight_decay=0.1)),
    "adamw_lr_ratio": (
        lambda p, lr: joptim.AdamW(lr, parameters=p, weight_decay=0.1,
                                   lr_ratio=lambda q: 0.5),
        lambda m, lr: toptim.AdamW(lr, parameters=m.parameters(),
                                   weight_decay=0.1, lr_ratio=lambda q: 0.5)),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_optimizer_matches_jax(name):
    _assert_params(*_run(*CASES[name]))


def test_adamw_apply_decay_param_fun_by_name():
    """The port calls ``apply_decay_param_fun`` with the qualified name of
    ``named_parameters()`` (the JAX one with paddle's unique name): decay
    the Linear's weight only, on both sides."""
    def make_j(p, lr):
        wname = p[0].name
        return joptim.AdamW(lr, parameters=p, weight_decay=0.2,
                            apply_decay_param_fun=lambda n: n == wname)
    seen = []

    def make_t(m, lr):
        def decay(n):
            seen.append(n)
            return n == "lin.weight"
        return toptim.AdamW(lr, parameters=m.named_parameters(),
                            weight_decay=0.2, apply_decay_param_fun=decay)
    _assert_params(*_run(make_j, make_t))
    assert set(seen) == {"lin.weight", "lin.bias", "u"}
    with pytest.raises(ValueError, match="named_parameters"):
        toptim.AdamW(parameters=_TorchModel(_data()).parameters(),
                     apply_decay_param_fun=lambda n: True)


@pytest.mark.parametrize("sched", ["step_decay", "warmup_cosine"])
def test_optimizer_with_lr_scheduler_matches_jax(sched):
    make = {"step_decay": lambda m: m.StepDecay(0.05, step_size=1, gamma=0.5),
            "warmup_cosine": lambda m: m.LinearWarmup(
                m.CosineAnnealingDecay(0.05, T_max=4), warmup_steps=2,
                start_lr=0.0, end_lr=0.05)}[sched]
    _assert_params(*_run(
        lambda p, lr: joptim.AdamW(lr, parameters=p, weight_decay=0.1),
        lambda m, lr: toptim.AdamW(lr, parameters=m.parameters(),
                                   weight_decay=0.1), sched=make))


def test_per_parameter_regularizer_and_lr_match_jax():
    """A parameter's own ``regularizer`` wins over the optimizer's, and its
    ``optimize_attr["learning_rate"]`` scales the step."""
    attrs = {0: dict(jax=dict(regularizer=joptim.L2Decay(0.5)),
                     torch=dict(regularizer=toptim.L2Decay(0.5))),
             2: dict(jax=dict(optimize_attr={"learning_rate": 0.25}),
                     torch=dict(optimize_attr={"learning_rate": 0.25}))}
    _assert_params(*_run(
        lambda p, lr: joptim.Momentum(lr, 0.9, parameters=p,
                                      weight_decay=0.01),
        lambda m, lr: toptim.Momentum(lr, 0.9, parameters=m.parameters(),
                                      weight_decay=0.01), attrs=attrs))


CLIPS = {
    "value": (lambda: jclip.ClipGradByValue(0.05),
              lambda: tclip.ClipGradByValue(0.05)),
    "value_min": (lambda: jclip.ClipGradByValue(0.1, min=-0.02),
                  lambda: tclip.ClipGradByValue(0.1, min=-0.02)),
    "norm": (lambda: jclip.ClipGradByNorm(0.1),
             lambda: tclip.ClipGradByNorm(0.1)),
    "global_norm": (lambda: jclip.ClipGradByGlobalNorm(0.1),
                    lambda: tclip.ClipGradByGlobalNorm(0.1)),
    "moe_global_norm": (lambda: JClipMoE(0.1),
                        lambda: ClipGradForMOEByGlobalNorm(0.1)),
}


@pytest.mark.parametrize("opt", ["sgd", "adam"])
@pytest.mark.parametrize("clip", sorted(CLIPS))
def test_grad_clip_matches_jax(clip, opt):
    jc, tc = CLIPS[clip]
    jcls, tcls = (joptim.SGD, toptim.SGD) if opt == "sgd" else \
        (joptim.Adam, toptim.Adam)
    _assert_params(*_run(
        lambda p, lr: jcls(lr, parameters=p, grad_clip=jc()),
        lambda m, lr: tcls(lr, parameters=m.parameters(), grad_clip=tc())))


def test_need_clip_false_passes_unclipped():
    p, q = torch.nn.Parameter(torch.ones(3)), torch.nn.Parameter(torch.ones(3))
    p.need_clip = False
    g = torch.full((3,), 10.0)
    for c in (tclip.ClipGradByValue(1.0), tclip.ClipGradByNorm(1.0),
              tclip.ClipGradByGlobalNorm(1.0)):
        (_, gp), (_, gq) = c([(p, g), (q, g)])
        assert gp is g and gq.abs().max() <= 1.0 + 1e-6


@pytest.mark.parametrize("norm_type", [2.0, 1.0, float("inf")])
def test_clip_grad_norm_matches_jax(norm_type):
    rng = np.random.default_rng(3)
    grads = [rng.standard_normal(s).astype(np.float32) for s in ((5, 3), (7,))]
    jps, tps = [], []
    for g in grads:
        jp = paddle.create_parameter(list(g.shape), "float32")
        jp.grad = paddle.to_tensor(g)
        jps.append(jp)
        tp = torch.nn.Parameter(torch.zeros(g.shape))
        tp.grad = torch.from_numpy(g.copy())
        tps.append(tp)
    jt = jclip.clip_grad_norm_(jps, 0.5, norm_type)
    tt = tclip.clip_grad_norm_(tps, 0.5, norm_type)
    np.testing.assert_allclose(tt.item(), float(np.asarray(jt._value)),
                               rtol=1e-6)
    for jp, tp in zip(jps, tps):
        np.testing.assert_allclose(tp.grad.numpy(), np.asarray(jp.grad._value),
                                   rtol=1e-6, atol=1e-7)
    tps[0].grad[0, 0] = float("nan")
    with pytest.raises(RuntimeError, match="not finite"):
        tclip.clip_grad_norm_(tps, 0.5, norm_type, error_if_nonfinite=True)


def test_state_dict_round_trip_continues_the_run():
    """``state_dict`` after 2 steps, loaded into a new optimizer (before its
    accumulators exist), continues as the first one does; ``minimize`` is
    backward then step; ``clear_grad(set_to_zero=True)`` zeroes."""
    d = _data()
    a, b = _TorchModel(d), _TorchModel(d)
    sched = tlr.StepDecay(0.05, step_size=1, gamma=0.5)
    oa = toptim.AdamW(sched, parameters=a.named_parameters(),
                      weight_decay=0.1)
    for _ in range(2):
        oa.minimize(a.loss(d))
        oa.clear_grad()
        sched.step()
    state = {k: (v.clone() if torch.is_tensor(v) else v)
             for k, v in oa.state_dict().items()}
    assert {"lin.weight_moment1", "u_beta2_pow", "global_step",
            "LR_Scheduler"} <= set(state)
    b.load_state_dict(a.state_dict())
    sched_b = tlr.StepDecay(0.05, step_size=1, gamma=0.5)
    ob = toptim.AdamW(sched_b, parameters=b.named_parameters(),
                      weight_decay=0.1)
    ob.set_state_dict(state)
    assert ob._global_step == 2 and ob.get_lr() == oa.get_lr()
    for m, o in ((a, oa), (b, ob)):
        o.minimize(m.loss(d))
        o.clear_grad(set_to_zero=True)
        assert all(p.grad is not None and not p.grad.any()
                   for p in m.parameters())
    for pa, pb in zip(a.parameters(), b.parameters()):
        torch.testing.assert_close(pa, pb, rtol=0, atol=0)


def test_adam_keeps_f32_state_for_bf16_parameters():
    p = torch.nn.Parameter(torch.ones(4, dtype=torch.bfloat16))
    p.grad = torch.full((4,), 0.5, dtype=torch.bfloat16)
    opt = toptim.AdamW(1e-2, parameters=[p])
    opt.step()
    state = opt.state_dict()
    assert state["0_moment1"].dtype == torch.float32
    assert p.dtype == torch.bfloat16 and (p < 1).all()
