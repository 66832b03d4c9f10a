"""The port's ``ParallelTrainStep`` (one device) against the JAX package's,
on the CPU, where the port's step runs eagerly.

The JAX oracle is ``ParallelTrainStep`` over a ``HybridCommunicateGroup``
of degree 1 on every axis. ERNIE-MoE: the 2-layer tiny model of
``tests/test_torch_ernie_train.py`` with its weights carried across and
random routing off, 3 AdamW steps through each step object (gather and
fused MoE paths), losses to that file's ``LOSS_RTOL`` and parameters to
its ``PARAM_ATOL``. The schedule, the clips, the state round trip and the
loss scaling use a small MLP (6 -> 8 -> 4, tanh, mean squared error) with
the same numpy weights on both sides, at the optimizer tests' f32
tolerance. Against its own dygraph loop (``loss.backward()``,
``opt.step()``) the port's step runs the same update code, so the two
agree bit for bit.
"""
import types

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import amp as jamp
from paddle_tpu import optimizer as joptim
from paddle_tpu.distributed.fleet.train_step import \
    ParallelTrainStep as JStep
from paddle_tpu.distributed.mesh import HybridCommunicateGroup
from paddle_tpu.incubate.distributed.models.moe import (
    ClipGradForMOEByGlobalNorm as JClipMoE)
from paddle_tpu.nn import clip as jclip
from paddle_tpu_torch import amp as tamp
from paddle_tpu_torch import optimizer as toptim
from paddle_tpu_torch.distributed import ParallelTrainStep, fleet
from paddle_tpu_torch.incubate.distributed.models.moe import (
    ClipGradForMOEByGlobalNorm, GShardGate)
from paddle_tpu_torch.models import ernie as ternie
from paddle_tpu_torch.nn import clip as tclip
from paddle_tpu_torch.nn._torch_layers import Linear
from paddle_tpu_torch.optimizer import lr as tlr

from test_torch_ernie_train import (LOSS_RTOL, PARAM_ATOL, _batch, _models,
                                    _np)
from test_torch_optimizer import F32

STEPS = 3


def _hcg():
    return HybridCommunicateGroup(dp_degree=1, mp_degree=1, pp_degree=1,
                                  sharding_degree=1)


def _mlm(m, ids, labels, *rest):
    return m.forward_with_mlm_loss(ids, labels, *rest)


# ------------------------------------------------------------- ERNIE-MoE

@pytest.mark.parametrize("fused", [False, True])
def test_ernie_moe_steps_match_jax(fused):
    """3 AdamW steps of the tiny ERNIE-MoE through each framework's
    ParallelTrainStep: every loss and every parameter, including the token
    type table, which the loss does not reach: both steps give it a zero
    gradient, so AdamW's decay moves it."""
    jm, tm = _models(fused)
    js = JStep(jm, joptim.AdamW(learning_rate=1e-3,
                                parameters=jm.parameters()), _mlm, hcg=_hcg())
    ts = ParallelTrainStep(tm, toptim.AdamW(1e-3,
                                            parameters=tm.named_parameters()),
                           _mlm, hcg=_hcg())
    ids, labels = _batch()
    table = "ernie.embeddings.token_type_embeddings.weight"
    start = dict(tm.named_parameters())[table].detach().clone()
    jl = [float(_np(js(ids, labels))) for _ in range(STEPS)]
    tl = [ts(ids, labels).item() for _ in range(STEPS)]
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
    assert tl[-1] < tl[0]
    tparams = dict(tm.named_parameters())
    for name, p in jm.named_parameters():
        np.testing.assert_allclose(_np(tparams[name]), _np(p), rtol=0,
                                   atol=PARAM_ATOL, err_msg=name)
    assert not torch.equal(tparams[table], start)
    assert ts.step_count == js._step_count == STEPS


def _ernie(seed=0, fused=False):
    cfg = ternie.ernie_moe_tiny_config(num_hidden_layers=2,
                                       fused_dispatch=fused)
    model = ternie.ErnieMoeForPretraining(
        ternie.ErnieMoeModel(cfg, seed=seed, device="cpu")).train()
    for g in model.modules():
        if isinstance(g, GShardGate):
            g.random_routing = False
    return model


def _ernie_inputs():
    ids, labels = _batch()
    return ids, labels, np.zeros_like(ids)


@pytest.mark.parametrize("fused", [False, True])
def test_steps_equal_the_dygraph_loop(fused):
    """The step against ``loss.backward(); opt.step(); opt.clear_grad()``
    from the same weights, 3 steps: every loss, parameter and accumulator
    and the global step bit for bit (token types given, so every
    parameter has a gradient in the dygraph loop too)."""
    a, b = _ernie(fused=fused), _ernie(fused=fused)
    oa = toptim.AdamW(1e-3, parameters=a.named_parameters())
    ob = toptim.AdamW(1e-3, parameters=b.named_parameters())
    step = ParallelTrainStep(b, ob, _mlm)
    batch = _ernie_inputs()
    for _ in range(STEPS):
        la = _mlm(a, *(torch.from_numpy(x) for x in batch))
        la.backward()
        oa.step()
        oa.clear_grad()
        assert step(*batch).item() == la.item()
    for (n, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(p, q), n
    sa, sb = oa.state_dict(), ob.state_dict()
    assert sa.keys() == sb.keys()
    for k in sa:
        assert (torch.equal(sa[k], sb[k]) if isinstance(sa[k], torch.Tensor)
                else sa[k] == sb[k]), k
    assert sb["global_step"] == STEPS
    assert all(p.grad is None for p in b.parameters())


def test_power_of_two_scale_equals_the_unscaled_run():
    """With a GradScaler at 2^10 (no overflow) the scaled loss's gradients
    times 2^-10 are the unscaled gradients exactly: every loss and
    parameter bit for bit over 3 steps."""
    a, b = _ernie(), _ernie()
    sa = ParallelTrainStep(a, toptim.AdamW(1e-3, parameters=a.parameters()),
                           _mlm)
    sb = ParallelTrainStep(b, toptim.AdamW(1e-3, parameters=b.parameters()),
                           _mlm,
                           scaler=tamp.GradScaler(init_loss_scaling=2.0 ** 10))
    batch = _ernie_inputs()
    for _ in range(STEPS):
        assert sa(*batch).item() == sb(*batch).item()
        assert not sb.last_found_inf
    assert all(torch.equal(p, q) for p, q in zip(a.parameters(),
                                                 b.parameters()))
    assert sb.scaler._scale == 2.0 ** 10 and sb.scaler._good_steps == STEPS


# ------------------------------------------------------------- small MLP

def _mlp_data():
    rng = np.random.default_rng(1)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return dict(w1=f(6, 8) * 0.5, b1=f(8) * 0.1, w2=f(8, 4) * 0.5,
                b2=f(4) * 0.1, x=f(16, 6), y=f(16, 4))


class _TNet(torch.nn.Module):
    def __init__(self, d):
        super().__init__()
        gen = torch.Generator().manual_seed(0)
        self.lin1 = Linear(6, 8, generator=gen)
        self.lin2 = Linear(8, 4, generator=gen)
        with torch.no_grad():
            for lin, w, b in ((self.lin1, "w1", "b1"),
                              (self.lin2, "w2", "b2")):
                lin.weight.copy_(torch.from_numpy(d[w]))
                lin.bias.copy_(torch.from_numpy(d[b]))

    def forward(self, x):
        return self.lin2(torch.tanh(self.lin1(x)))


def _jnet(d):
    class Net(paddle.nn.Layer):
        def __init__(self):
            super().__init__()
            self.lin1 = paddle.nn.Linear(6, 8)
            self.lin2 = paddle.nn.Linear(8, 4)

        def forward(self, x):
            return self.lin2(paddle.tanh(self.lin1(x)))
    net = Net()
    for lin, w, b in ((net.lin1, "w1", "b1"), (net.lin2, "w2", "b2")):
        lin.weight.set_value(d[w])
        lin.bias.set_value(d[b])
    return net


def _mse(m, x, y):
    return ((m(x) - y) ** 2).mean()


def _mlp_pair(make_j, make_t, **kw):
    """A JAX and a port ParallelTrainStep over the MLP from the same
    weights; ``make_j(params, lr)`` and ``make_t(named_params, lr)`` build
    the optimizers, ``lr`` from ``kw["sched"]`` (either package's ``lr``
    module) or 0.05."""
    d = _mlp_data()
    jnet, tnet = _jnet(d), _TNet(d)
    sched = kw.pop("sched", None)
    jlr = sched(joptim.lr) if sched else 0.05
    tlr_ = sched(tlr) if sched else 0.05
    js = JStep(jnet, make_j(jnet.parameters(), jlr), _mse, hcg=_hcg(),
               **kw.get("jax", {}))
    ts = ParallelTrainStep(tnet, make_t(tnet.named_parameters(), tlr_),
                           _mse, **kw.get("torch", {}))
    return d, (jnet, js, jlr), (tnet, ts, tlr_)


def _mlp_run(pair, steps=STEPS, sched=False):
    d, (jnet, js, jlr), (tnet, ts, tlr_) = pair
    jl, tl = [], []
    for _ in range(steps):
        jl.append(float(_np(js(d["x"], d["y"]))))
        tl.append(ts(d["x"], d["y"]).item())
        if sched:
            jlr.step()
            tlr_.step()
    np.testing.assert_allclose(tl, jl, **F32)
    tparams = dict(tnet.named_parameters())
    for name, p in jnet.named_parameters():
        np.testing.assert_allclose(tparams[name].detach().numpy(), _np(p),
                                   **F32, err_msg=name)
    return tl


def test_schedule_is_read_once_a_call_like_jax():
    """Under StepDecay (x0.5 a step, stepped by the caller after each
    call) the port's step reads the schedule once a call, as the JAX step
    does: 4 steps equal the JAX step's, and differ from a constant-lr
    run after the first."""
    sched = lambda m: m.StepDecay(0.05, step_size=1, gamma=0.5)  # noqa: E731
    adam_j = lambda p, lr: joptim.Adam(lr, parameters=p)      # noqa: E731
    adam_t = lambda p, lr: toptim.Adam(lr, parameters=p)      # noqa: E731
    scheduled = _mlp_run(_mlp_pair(adam_j, adam_t, sched=sched), steps=4,
                         sched=True)
    constant = _mlp_run(_mlp_pair(adam_j, adam_t), steps=4)
    assert scheduled[:2] == constant[:2] and scheduled[2] != constant[2]


@pytest.mark.parametrize("clip", ["global_norm", "moe_global_norm"])
def test_clips_match_jax(clip):
    """``ClipGradByGlobalNorm`` and ``ClipGradForMOEByGlobalNorm`` (one
    expert-parallel rank) as the optimizer's ``grad_clip``, at a norm that
    binds on every step."""
    jc = {"global_norm": lambda: jclip.ClipGradByGlobalNorm(0.05),
          "moe_global_norm": lambda: JClipMoE(0.05)}[clip]
    tc = {"global_norm": lambda: tclip.ClipGradByGlobalNorm(0.05),
          "moe_global_norm": lambda: ClipGradForMOEByGlobalNorm(0.05)}[clip]
    _mlp_run(_mlp_pair(
        lambda p, lr: joptim.AdamW(lr, parameters=p, grad_clip=jc()),
        lambda p, lr: toptim.AdamW(lr, parameters=p, grad_clip=tc())))


def test_train_state_round_trip():
    """``train_state_dict`` after 2 steps (Adam under StepDecay, with a
    GradScaler), then 2 more: a fresh step on other weights restored from
    the snapshot (its values as numpy arrays) takes the same 2 steps bit
    for bit. The snapshot's keys are the JAX step's."""
    def make(seed):
        d = _mlp_data()
        net = _TNet(d)
        if seed:
            with torch.no_grad():
                for p in net.parameters():
                    p.mul_(-0.5)
        opt = toptim.Adam(tlr.StepDecay(0.05, step_size=1, gamma=0.5),
                          parameters=net.named_parameters())
        return d, net, ParallelTrainStep(
            net, opt, _mse, scaler=tamp.GradScaler(init_loss_scaling=2.0 ** 4,
                                                   incr_every_n_steps=1))

    def run(d, step, n):
        out = []
        for _ in range(n):
            out.append(step(d["x"], d["y"]).item())
            step.optimizer._learning_rate.step()
        return out
    d, net, step = make(0)
    run(d, step, 2)
    snap = step.train_state_dict()
    as_numpy = {k: (v.numpy() if isinstance(v, torch.Tensor) else v)
                for k, v in snap.items()}
    want = run(d, step, 2)
    d2, net2, step2 = make(1)
    step2.set_train_state(as_numpy)
    assert run(d2, step2, 2) == want
    assert all(torch.equal(p, q) for p, q in zip(net.parameters(),
                                                 net2.parameters()))
    assert step2.step_count == step.step_count == 4
    assert step2.scaler._scale == step.scaler._scale == 2.0 ** 8
    # the JAX step's snapshot of the same model and optimizer
    dj = _mlp_data()
    jnet = _jnet(dj)
    js = JStep(jnet, joptim.Adam(joptim.lr.StepDecay(0.05, step_size=1),
                                 parameters=jnet.parameters()), _mse,
               hcg=_hcg(), scaler=jamp.GradScaler(init_loss_scaling=2.0 ** 4))
    js(dj["x"], dj["y"])
    assert set(js.train_state_dict()) == set(snap)


def test_scaler_overflow_skips_like_jax():
    """A forced overflow: the loss is ``lin(x).sum()`` with x all ones, so
    every gradient is 3 and, at a scale of 2^127, every scaled gradient
    is inf. Both steps skip the update (parameters and accumulators bit
    for bit as before), set ``last_found_inf`` and halve the scale; the
    next step, at 2^126, updates, as the JAX step does."""
    rng = np.random.default_rng(2)
    w = rng.standard_normal((6, 4)).astype(np.float32)
    b = rng.standard_normal(4).astype(np.float32)
    x = np.ones((3, 6), np.float32)
    jlin = paddle.nn.Linear(6, 4)
    jlin.weight.set_value(w)
    jlin.bias.set_value(b)
    tlin = Linear(6, 4, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        tlin.weight.copy_(torch.from_numpy(w))
        tlin.bias.copy_(torch.from_numpy(b))
    kw = dict(init_loss_scaling=2.0 ** 127, decr_every_n_nan_or_inf=1)
    loss = lambda m, x: m(x).sum()                            # noqa: E731
    js = JStep(jlin, joptim.AdamW(1e-3, parameters=jlin.parameters()), loss,
               hcg=_hcg(), scaler=jamp.GradScaler(**kw))
    topt = toptim.AdamW(1e-3, parameters=tlin.named_parameters())
    ts = ParallelTrainStep(tlin, topt, loss, scaler=tamp.GradScaler(**kw))
    before = [t.clone() for t in list(tlin.parameters())
              + topt._state_tensors(list(tlin.parameters()))]
    js(x)
    ts(x)
    after = list(tlin.parameters()) + topt._state_tensors(
        list(tlin.parameters()))
    assert all(torch.equal(p, q) for p, q in zip(before, after))
    assert ts.last_found_inf and js.last_found_inf
    assert ts.scaler._scale == js.scaler._scale == 2.0 ** 126
    js(x)
    ts(x)
    assert not ts.last_found_inf and not js.last_found_inf
    assert not torch.equal(tlin.weight, before[0])
    np.testing.assert_allclose(tlin.weight.detach().numpy(),
                               _np(jlin.weight), **F32)


# ------------------------------------------------------------- surface

def test_what_is_not_ported_raises():
    """Degrees above 1 (an hcg's or a mesh's), ``validate=True`` and the
    checkpoint manager raise ``NotImplementedError`` naming their ROADMAP
    item; an hcg of degree 1 (the JAX one) is accepted, and the arguments
    with nothing to do on one device are kept."""
    d = _mlp_data()
    net = _TNet(d)

    def make(**kw):
        return ParallelTrainStep(net, toptim.SGD(
            0.1, parameters=net.named_parameters()), _mse, **kw)
    two = types.SimpleNamespace(get_data_parallel_world_size=lambda: 2)
    for kw, item in ((dict(hcg=two), "Hybrid parallel"),
                     (dict(mesh=types.SimpleNamespace(
                         shape={"dp": 1, "mp": 2})), "Hybrid parallel"),
                     (dict(validate=True), "Analysis, planner")):
        with pytest.raises(NotImplementedError, match=item):
            make(**kw)
    step = make(hcg=_hcg(), zero_stage=2, accumulate_steps=4,
                donate=False, mesh=types.SimpleNamespace(shape=(1,)))
    assert (step.zero_stage, step.accumulate_steps, step.donate) == \
        (2, 4, False)
    for call in (lambda: step.attach_checkpoint_manager(object()),
                 lambda: step.resume_from_checkpoint()):
        with pytest.raises(NotImplementedError, match="Host-side systems"):
            call()
    step.sync_optimizer_state()
    assert fleet.ParallelTrainStep is ParallelTrainStep
    other = _TNet(d)
    with pytest.raises(ValueError, match="does not hold"):
        ParallelTrainStep(net, toptim.SGD(
            0.1, parameters=[other.lin2.weight]), _mse)
