"""The port's MoE gates and ``MoELayer`` in training against the JAX
package's, on the CPU.

Same numpy inputs and weights on both sides (the JAX layer's state dict
carried across by name); the JAX fused kernels run in interpret mode, the
port's wrappers their plain versions. Gates that draw random numbers draw
different ones in the two frameworks, so those are held to statistics.
"""
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.incubate.distributed.models.moe import (
    ExpertLayer as JExpertLayer, GShardGate as JGShardGate,
    MoELayer as JMoELayer, NaiveGate as JNaiveGate,
    SwitchGate as JSwitchGate)
from paddle_tpu.incubate.distributed.models.moe import gate as jgate
from paddle_tpu_torch import amp
from paddle_tpu_torch.incubate.distributed.models.moe import (
    ClipGradForMOEByGlobalNorm, ExpertLayer, GShardGate, MoELayer,
    NaiveGate, SwitchGate)
from paddle_tpu_torch.incubate.distributed.models.moe import gate as tgate

D, H, E = 16, 32, 4
# f32 on both sides, sums in other orders: outputs, aux losses and every
# gradient to rtol 1e-4 / atol 1e-5 (exact math, f32 rounding)
F32 = dict(rtol=1e-4, atol=1e-5)


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(jnp.asarray(t._value if hasattr(t, "_value") else t)
                      .astype(jnp.float32))


def _gates(kind):
    """A JAX gate and a port gate of ``kind`` that draw no random numbers."""
    gen = torch.Generator().manual_seed(0)
    if kind == "naive":
        return JNaiveGate(D, E, 1), NaiveGate(D, E, 1, generator=gen)
    if kind == "switch":
        return (JSwitchGate(D, E, 1, switch_eps=0.0),
                SwitchGate(D, E, 1, switch_eps=0.0, generator=gen))
    return (JGShardGate(D, E, 1, random_routing=False),
            GShardGate(D, E, 1, random_routing=False, generator=gen))


def _carry(jl, tl):
    tl.load_state_dict({k: torch.tensor(np.asarray(v._value))
                        for k, v in jl.state_dict().items()}, strict=True)
    return tl


def _layers(kind, cf, fused, hidden=(H,) * E, recompute=0):
    paddle.seed(7)
    jg, tg = _gates(kind)
    gen = torch.Generator().manual_seed(1)
    jl = JMoELayer(D, [JExpertLayer(D, h) for h in hidden], gate=jg,
                   capacity_factor=cf, fused_dispatch=fused,
                   recompute_interval=recompute)
    tl = MoELayer(D, [ExpertLayer(D, h, generator=gen) for h in hidden],
                  gate=tg, capacity_factor=cf, fused_dispatch=fused,
                  recompute_interval=recompute, generator=gen)
    _carry(jl, tl)
    jl.train()
    return jl, tl.train()


def _inputs(seed=4, shape=(2, 9, D)):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


def _jax_run(jl, x, ct):
    jx = paddle.to_tensor(x, stop_gradient=False)
    y = jl(jx)
    aux = jl.gate.get_loss()
    loss = (y * paddle.to_tensor(ct)).sum()
    if aux is not None:
        loss = loss + aux
    loss.backward()
    grads = {n: _np(p.grad) for n, p in jl.named_parameters()
             if p.grad is not None}
    return _np(y), None if aux is None else float(_np(aux)), _np(jx.grad), \
        grads


def _torch_run(tl, x, ct):
    tx = torch.from_numpy(x).requires_grad_()
    y = tl(tx)
    aux = tl.gate.get_loss()
    loss = (y * torch.from_numpy(ct)).sum()
    if aux is not None:
        loss = loss + aux
    loss.backward()
    grads = {n: _np(p.grad) for n, p in tl.named_parameters()
             if p.grad is not None}
    return _np(y), None if aux is None else aux.item(), _np(tx.grad), grads


def _assert_runs(got, want):
    (y, aux, dx, grads), (jy, jaux, jdx, jgrads) = got, want
    np.testing.assert_allclose(y, jy, **F32, err_msg="output")
    assert (aux is None) == (jaux is None)
    if aux is not None:
        np.testing.assert_allclose(aux, jaux, **F32, err_msg="aux loss")
    np.testing.assert_allclose(dx, jdx, **F32, err_msg="d input")
    assert set(grads) == set(jgrads)
    for name, g in grads.items():
        np.testing.assert_allclose(g, jgrads[name], **F32, err_msg=name)


def test_load_balance_loss_matches_jax():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((64, E)).astype(np.float32)
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    idx = rng.integers(0, E, (64,))
    want = jgate._load_balance_loss(paddle.to_tensor(probs),
                                    paddle.to_tensor(idx), E)
    got = tgate._load_balance_loss(torch.from_numpy(probs),
                                   torch.from_numpy(idx), E)
    np.testing.assert_allclose(got.item(), _np(want), rtol=1e-6)


@pytest.mark.parametrize("kind", ["naive", "switch", "gshard"])
def test_gates_train_match_jax(kind):
    """Each gate in training: its values, its choices and its aux loss
    (none for the naive gate), and in eval the aux loss cleared."""
    jg, tg = _gates(kind)
    tg.load_state_dict({k: torch.tensor(np.asarray(v._value))
                        for k, v in jg.state_dict().items()})
    x = np.random.default_rng(1).standard_normal((40, D)).astype(np.float32)
    for train in (True, False):
        jg.train() if train else jg.eval()
        tg.train(train)
        jv, ji = jg(paddle.to_tensor(x))
        with torch.no_grad():
            tv, ti = tg(torch.from_numpy(x))
        np.testing.assert_allclose(_np(tv), _np(jv), rtol=1e-6, atol=1e-7)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji._value))
        jl, tl = jg.get_loss(), tg.get_loss()
        assert (tl is None) == (jl is None)
        assert (tl is not None) == (train and kind != "naive")
        if tl is not None:
            np.testing.assert_allclose(tl.item(), _np(jl), rtol=1e-6)
        assert not tg.has_loss


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("cf", [None, 0.5])
@pytest.mark.parametrize("kind", ["naive", "switch", "gshard"])
def test_moe_layer_train_matches_jax(kind, cf, fused):
    """``MoELayer`` in training, gather path and fused path, against the
    JAX layer: the output, the aux loss and every gradient (input, gate,
    experts), with the gate's train capacity factor (1.2) and a dropping
    one (0.5)."""
    jl, tl = _layers(kind, cf, fused)
    assert tl._fused_gate_kind() == jl._fused_gate_kind()
    assert tl._capacity(18) == jl._capacity(18)
    x, ct = _inputs()
    _assert_runs(_torch_run(tl, x, ct), _jax_run(jl, x, ct))


def test_moe_layer_capacity_drops():
    """At capacity factor 0.5 some choices are dropped, so the dropping
    cases above drop."""
    from paddle_tpu_torch.kernels.moe_dispatch import dispatch_indices
    _, tl = _layers("gshard", 0.5, False)
    x, _ = _inputs()
    with torch.no_grad():
        _, idx = tl.gate(torch.from_numpy(x).reshape(-1, D))
    C = tl._capacity(18)
    _, comb = dispatch_indices(idx, num_expert=E, capacity=C)
    assert (comb == E * C).any()


def test_moe_layer_heterogeneous_experts_match_jax():
    """Experts of different widths run one by one (the per-expert loop)."""
    jl, tl = _layers("gshard", None, False, hidden=(16, 24, 16, 40))
    assert not tl._homogeneous_ffn()
    x, ct = _inputs(5)
    _assert_runs(_torch_run(tl, x, ct), _jax_run(jl, x, ct))


def test_moe_layer_heterogeneous_experts_recompute():
    """The per-expert loop under the recompute: the output and the input's
    gradient equal the JAX layer's, and every gradient equals the port's
    without the recompute bit for bit. (The JAX layer's recompute of a
    whole expert module leaves the experts' weights without a gradient,
    ROADMAP Queue 3, so those are not held to it.)"""
    hidden = (16, 24, 16, 40)
    jl, tl = _layers("gshard", None, False, hidden=hidden, recompute=1)
    x, ct = _inputs(5)
    got, want = _torch_run(tl, x, ct), _jax_run(jl, x, ct)
    for a, b, what in zip(got[:3], want[:3], ("output", "aux", "d input")):
        np.testing.assert_allclose(a, b, **F32, err_msg=what)
    _, plain = _layers("gshard", None, False, hidden=hidden)
    ref = _torch_run(plain, x, ct)
    assert set(got[3]) == set(ref[3])
    for name, g in got[3].items():
        np.testing.assert_array_equal(g, ref[3][name], err_msg=name)


@pytest.mark.parametrize("fused", [False, True])
def test_moe_layer_recompute_matches_jax_and_plain(fused):
    """``recompute_interval > 0``: the experts under
    ``torch.utils.checkpoint`` give the JAX layer's numbers and, under
    ``auto_cast``, the same bits as without the recompute (the recompute
    casts as the forward did)."""
    jl, tl = _layers("gshard", None, fused, recompute=1)
    x, ct = _inputs(6)
    _assert_runs(_torch_run(tl, x, ct), _jax_run(jl, x, ct))
    _, plain = _layers("gshard", None, fused)
    for layer in (tl, plain):
        layer.zero_grad()
    outs = []
    for layer in (tl, plain):
        with amp.auto_cast(dtype="bfloat16"):
            outs.append(_torch_run(layer, x, ct))
    np.testing.assert_array_equal(outs[0][0], outs[1][0])
    for name, g in outs[0][3].items():
        np.testing.assert_array_equal(g, outs[1][3][name], err_msg=name)


def _kept_share_bound(p2, n):
    """The expected share of second choices random routing keeps,
    ``mean(min(1, 2 p2))``, and five binomial standard deviations."""
    p = np.minimum(1.0, 2.0 * p2)
    return p.mean(), 5.0 * np.sqrt((p * (1 - p)).sum()) / n


def test_gshard_random_routing_statistics():
    """Random routing keeps the second choice with probability
    ``min(1, 2 p2)``: over 4096 tokens the kept share of the port's gate,
    and of the JAX gate on the same weights, lies within five binomial
    standard deviations of ``mean(min(1, 2 p2))``. The first choice and
    the kept weights are the eval gate's; the draws come from the gate's
    own generator (the same seed draws the same, another seed not)."""
    n = 4096
    paddle.seed(11)
    jg = JGShardGate(D, E, 1)
    gen = torch.Generator().manual_seed(0)
    tgs = [GShardGate(D, E, 1, generator=gen, seed=s) for s in (5, 5, 6)]
    state = {k: torch.tensor(np.asarray(v._value))
             for k, v in jg.state_dict().items()}
    for g in tgs:
        g.load_state_dict(state)
    # weights scaled so that p2 spreads over (0, 0.5]
    x = (np.random.default_rng(2).standard_normal((n, D)) * 4).astype(
        np.float32)
    tx = torch.from_numpy(x)
    with torch.no_grad():
        tgs[0].eval()
        ev, ei = tgs[0](tx)
        draws = []
        for g in tgs:
            g.train()
            draws.append(g(tx))
    tv, ti = draws[0]
    torch.testing.assert_close(ti, ei, rtol=0, atol=0)
    torch.testing.assert_close(tv[:, 0], ev[:, 0], rtol=0, atol=0)
    kept = tv[:, 1] > 0
    torch.testing.assert_close(tv[kept, 1], ev[kept, 1], rtol=0, atol=0)
    mean, tol = _kept_share_bound(ev[:, 1].numpy(), n)
    assert 0.05 < mean < 0.95
    share = kept.float().mean().item()
    assert abs(share - mean) <= tol, (share, mean, tol)
    jg.train()
    jv, _ = jg(paddle.to_tensor(x))
    jshare = float((_np(jv)[:, 1] > 0).mean())
    assert abs(jshare - mean) <= tol, (jshare, mean, tol)
    torch.testing.assert_close(draws[1][0], tv, rtol=0, atol=0)
    assert not torch.equal(draws[2][0], tv)


def test_switch_jitter_statistics():
    """Switch's jitter multiplies the logits by ``1 + (u - 0.5) * 2 eps``:
    the port's choices equal those of the formula replayed with the gate's
    seed, and the share of tokens whose choice the jitter moves (against
    eval) is the JAX gate's within five binomial standard deviations."""
    n, eps = 4096, 0.3
    paddle.seed(12)
    jg = JSwitchGate(D, E, 1, switch_eps=eps)
    tg = SwitchGate(D, E, 1, switch_eps=eps,
                    generator=torch.Generator().manual_seed(0), seed=9)
    tg.load_state_dict({k: torch.tensor(np.asarray(v._value))
                        for k, v in jg.state_dict().items()})
    x = np.random.default_rng(3).standard_normal((n, D)).astype(np.float32)
    tx = torch.from_numpy(x)
    with torch.no_grad():
        logits = tg.gate(tx)
        u = torch.rand(logits.shape,
                       generator=torch.Generator().manual_seed(9))
        jit = torch.softmax(logits * (1.0 + (u - 0.5) * 2.0 * eps), -1)
        tv, ti = tg.train()(tx)
        _, ei = tg.eval()(tx)
    torch.testing.assert_close(ti[:, 0], jit.argmax(-1), rtol=0, atol=0)
    torch.testing.assert_close(tv[:, 0], jit.amax(-1), rtol=0, atol=0)
    moved = (ti != ei).float().mean().item()
    jg.train()
    _, ji = jg(paddle.to_tensor(x))
    jmoved = float((np.asarray(ji._value) != ei.numpy()).mean())
    p = (moved + jmoved) / 2
    assert 0.01 < p < 0.5
    assert abs(moved - jmoved) <= 5 * np.sqrt(2 * p * (1 - p) / n), (
        moved, jmoved)


def test_fused_gate_kind_follows_the_configuration():
    """The JAX rule: a gate that draws random numbers in training takes the
    gather path; in eval, or without the draws, the fused kernel."""
    gen = torch.Generator().manual_seed(0)
    experts = lambda: [ExpertLayer(D, H, generator=gen) for _ in range(E)]  # noqa: E731
    layer = MoELayer(D, experts(), fused_dispatch=True, generator=gen)
    assert layer.train()._fused_gate_kind() is None
    assert layer.eval()._fused_gate_kind() == "gshard"
    layer.gate.random_routing = False
    assert layer.train()._fused_gate_kind() == "gshard"
    switch = MoELayer(D, experts(), gate={"type": "switch"},
                      fused_dispatch=True, generator=gen)
    assert switch.train()._fused_gate_kind() is None
    switch.gate.switch_eps = 0.0
    assert switch._fused_gate_kind() == "switch"
    naive = MoELayer(D, experts(), gate={"type": "naive"}, generator=gen)
    assert naive.train()._fused_gate_kind() == "naive"
    assert isinstance(naive.gate, NaiveGate)


def test_ep_axis_raises():
    gen = torch.Generator().manual_seed(0)
    two = types.SimpleNamespace(nranks=2)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        MoELayer(D, [ExpertLayer(D, H, generator=gen)], moe_group=two)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ClipGradForMOEByGlobalNorm(1.0, moe_group=two)
    MoELayer(D, [ExpertLayer(D, H, generator=gen)], generator=gen,
             moe_group=types.SimpleNamespace(nranks=1))
