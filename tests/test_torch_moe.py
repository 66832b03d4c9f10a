"""The port's MoE dispatch and combine, and its MoE layer, against the JAX
package's.

Same numpy inputs on both sides, on the CPU: the JAX fused kernels run in
interpret mode, the port's wrappers through their plain versions (the CUDA
kernels are held to those on the card, ``tests/test_torch_gpu.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.incubate.distributed.models.moe import (
    ExpertLayer as JExpertLayer, MoELayer as JMoELayer)
from paddle_tpu.kernels import moe_dispatch as jmd
from paddle_tpu_torch.incubate.distributed.models.moe import (ExpertLayer,
                                                              GShardGate,
                                                              MoELayer)
from paddle_tpu_torch.kernels import moe_dispatch as tmd

# the cases of tests/test_moe_fused.py: (S, E, C, k, gate kind)
CASES = [(16, 4, 5, 2, "gshard"),     # plain top-2
         (13, 4, 2, 2, "renorm"),     # ragged token count, tight capacity
         (7, 3, 1, 1, "switch"),      # top-1, capacity-1 overflow drops
         (32, 8, 3, 2, "naive"),      # raw-logit combine weights
         (5, 4, 20, 2, "gshard"),     # capacity >> tokens (no drops)
         (130, 4, 40, 2, "gshard")]   # crosses the 128-token block
M = 8
# val/me/ce: f32 products and softmax in another summation order
F32 = dict(rtol=1e-5, atol=1e-6)


def _inputs(S, E, seed=None):
    rng = np.random.default_rng(S * 31 + E if seed is None else seed)
    x = rng.standard_normal((S, M)).astype(np.float32)
    gw = rng.standard_normal((M, E)).astype(np.float32)
    gb = rng.standard_normal((E,)).astype(np.float32) * 0.1
    return x, gw, gb


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(jnp.asarray(t).astype(jnp.float32))


def _assert_dispatch(got, ref, label):
    names = ("expert_in", "comb_idx", "val", "me", "ce")
    for name, a, b in zip(names, got, ref):
        if name in ("expert_in", "comb_idx"):
            np.testing.assert_array_equal(_np(a), _np(b),
                                          err_msg=f"{label} {name}")
        else:
            np.testing.assert_allclose(_np(a), _np(b), **F32,
                                       err_msg=f"{label} {name}")


@pytest.mark.parametrize("S,E,C,K,kind", CASES)
def test_dispatch_matches_jax(S, E, C, K, kind):
    """The port's dispatch (its plain version on the CPU) against the JAX
    reference and the JAX fused kernel in interpret mode."""
    x, gw, gb = _inputs(S, E)
    kw = dict(num_expert=E, capacity=C, top_k=K, gate_kind=kind)
    got = tmd.fused_moe_dispatch(*map(torch.from_numpy, (x, gw, gb)), **kw)
    assert got[1].dtype == torch.int32 and got[2].dtype == torch.float32
    jx = [jnp.asarray(a) for a in (x, gw, gb)]
    _assert_dispatch(got, jmd.reference_moe_dispatch(*jx, **kw), "reference")
    _assert_dispatch(got, jmd.fused_moe_dispatch(*jx, **kw), "kernel")


def test_dispatch_bf16_matches_jax():
    x, gw, gb = _inputs(40, 4)
    kw = dict(num_expert=4, capacity=12, top_k=2, gate_kind="gshard")
    tx = torch.from_numpy(x).bfloat16()
    got = tmd.fused_moe_dispatch(tx, torch.from_numpy(gw),
                                 torch.from_numpy(gb), **kw)
    assert got[0].dtype == torch.bfloat16
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    for fn in (jmd.reference_moe_dispatch, jmd.fused_moe_dispatch):
        _assert_dispatch(got, fn(jx, jnp.asarray(gw), jnp.asarray(gb), **kw),
                         fn.__name__)


@pytest.mark.parametrize("w_dtype,b_dtype", [("bfloat16", "float32"),
                                             ("float32", "bfloat16")])
def test_dispatch_mixed_gate_dtypes_match_jax(w_dtype, b_dtype):
    """A gate weight and bias of different dtypes are each widened to f32
    on their own, as the JAX wrapper does; neither is rounded to the
    other's dtype."""
    x, gw, gb = _inputs(24, 4)
    kw = dict(num_expert=4, capacity=24, top_k=2, gate_kind="gshard")
    tw = torch.from_numpy(gw).to(getattr(torch, w_dtype))
    tb = torch.from_numpy(gb).to(getattr(torch, b_dtype))
    got = tmd.fused_moe_dispatch(torch.from_numpy(x), tw, tb, **kw)
    jw = jnp.asarray(gw).astype(getattr(jnp, w_dtype))
    jb = jnp.asarray(gb).astype(getattr(jnp, b_dtype))
    for fn in (jmd.reference_moe_dispatch, jmd.fused_moe_dispatch):
        _assert_dispatch(got, fn(jnp.asarray(x), jw, jb, **kw), fn.__name__)


def test_dispatch_indices_and_top_k_ties():
    """The slot rule, and top-k ties to the lowest index (as lax.top_k)."""
    idx = np.array([[0, 1], [0, 2], [1, 0], [0, 1]], np.int32)
    st, comb = tmd.dispatch_indices(torch.from_numpy(idx), num_expert=3,
                                    capacity=2)
    jst, jcomb = jmd.dispatch_indices(jnp.asarray(idx), num_expert=3,
                                      capacity=2)
    np.testing.assert_array_equal(st.numpy(), np.asarray(jst))
    np.testing.assert_array_equal(comb.numpy(), np.asarray(jcomb))
    logits = torch.tensor([[1.0, 3.0, 3.0, 3.0], [2.0, 2.0, 0.0, 2.0]])
    val, ix = tmd._gate_values(logits, torch.softmax(logits, -1), "naive", 2)
    jv, ji = jmd._gate_values(jnp.asarray(logits.numpy()),
                              jax.nn.softmax(jnp.asarray(logits.numpy())),
                              "naive", 2)
    np.testing.assert_array_equal(ix.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(ix.numpy(), [[1, 2], [0, 1]])
    np.testing.assert_allclose(val.numpy(), np.asarray(jv))


def _combine_inputs(S, E, C, K, kind, dtype):
    x, gw, gb = _inputs(S, E)
    _, comb, val, _, _ = jmd.reference_moe_dispatch(
        *map(jnp.asarray, (x, gw, gb)), num_expert=E, capacity=C, top_k=K,
        gate_kind=kind)
    eo = np.random.default_rng(S).standard_normal(
        (E * C, M)).astype(np.float32)
    comb, val = np.array(comb), np.array(val)
    jeo = jnp.asarray(eo).astype(getattr(jnp, dtype))
    teo = torch.from_numpy(eo).to(getattr(torch, dtype))
    return (teo, torch.from_numpy(val), torch.from_numpy(comb)), \
        (jeo, jnp.asarray(val), jnp.asarray(comb))


def _within_one_bf16_spacing(a, b):
    """|a - b| at most one bf16 spacing of b, elementwise."""
    a, b = _np(a), _np(b)
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(b), 1e-30))) - 7)
    assert np.all(np.abs(a - b) <= ulp), np.max(np.abs(a - b) / ulp)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", [CASES[0], CASES[1], CASES[2], CASES[5]])
def test_combine_matches_jax(case, dtype):
    """``combine_kernel_reference`` (what the port's combine runs on the
    CPU) against the JAX fused combine in interpret mode; the port's
    ``reference_moe_combine`` against the JAX reference."""
    t, j = _combine_inputs(*case, dtype)
    got = tmd.fused_moe_combine(*t)
    assert got.dtype == t[0].dtype
    torch.testing.assert_close(got, tmd.combine_kernel_reference(*t),
                               rtol=0, atol=0)
    kern = jmd.fused_moe_combine(*j)
    ref, jref = tmd.reference_moe_combine(*t), jmd.reference_moe_combine(*j)
    if dtype == "float32":
        top = np.abs(_np(kern)).max()
        np.testing.assert_allclose(_np(got), _np(kern), rtol=0,
                                   atol=1e-6 * top)
        np.testing.assert_allclose(_np(ref), _np(jref), rtol=0,
                                   atol=1e-6 * top)
    else:
        _within_one_bf16_spacing(got, kern)
        _within_one_bf16_spacing(ref, jref)


@pytest.mark.parametrize("S,E,C,K,kind", [CASES[0], CASES[1], CASES[3]])
def test_dispatch_grads_match_jax_vjp(S, E, C, K, kind):
    x, gw, gb = _inputs(S, E)
    rng = np.random.default_rng(99)
    ct_in = rng.standard_normal((E, C, M)).astype(np.float32)
    ct_val = rng.standard_normal((S, K)).astype(np.float32)
    ct_me = rng.standard_normal((E,)).astype(np.float32)
    kw = dict(num_expert=E, capacity=C, top_k=K, gate_kind=kind)
    _, vjp = jax.vjp(lambda a, b, c: jmd.fused_moe_dispatch(a, b, c, **kw),
                     *map(jnp.asarray, (x, gw, gb)))
    ref = vjp((jnp.asarray(ct_in), np.zeros((S, K), jax.dtypes.float0),
               jnp.asarray(ct_val), jnp.asarray(ct_me),
               jnp.zeros((E,), jnp.float32)))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (x, gw, gb)]
    ei, _, val, me, _ = tmd.fused_moe_dispatch(*leaves, **kw)
    got = torch.autograd.grad(
        [ei, val, me], leaves,
        [torch.from_numpy(a) for a in (ct_in, ct_val, ct_me)])
    for name, a, b in zip(("x", "gate_w", "gate_b"), got, ref):
        np.testing.assert_allclose(_np(a), _np(b), rtol=1e-5, atol=1e-5,
                                   err_msg=name)


@pytest.mark.parametrize("case", [CASES[1], CASES[3]])
def test_combine_grads_match_jax_vjp(case):
    t, j = _combine_inputs(*case, "float32")
    S, K = t[2].shape
    dy = np.random.default_rng(5).standard_normal((S, M)).astype(np.float32)
    _, vjp = jax.vjp(lambda eo, v: jmd.fused_moe_combine(eo, v, j[2]),
                     j[0], j[1])
    ref = vjp(jnp.asarray(dy))
    eo, val = (a.clone().requires_grad_() for a in t[:2])
    y = tmd.fused_moe_combine(eo, val, t[2])
    got = torch.autograd.grad(y, (eo, val), torch.from_numpy(dy))
    for name, a, b in zip(("expert_out", "val"), got, ref):
        np.testing.assert_allclose(_np(a), _np(b), rtol=1e-5, atol=1e-5,
                                   err_msg=name)


# ------------------------------------------------------------ MoE layer

def _layers(d_model, d_hidden, E, cf, fused):
    paddle.seed(3)
    jl = JMoELayer(d_model, [JExpertLayer(d_model, d_hidden)
                             for _ in range(E)],
                   gate={"type": "gshard", "top_k": 2}, capacity_factor=cf,
                   fused_dispatch=fused)
    jl.eval()
    gen = torch.Generator().manual_seed(0)
    tl = MoELayer(d_model, [ExpertLayer(d_model, d_hidden, generator=gen)
                            for _ in range(E)],
                  gate={"type": "gshard", "top_k": 2}, capacity_factor=cf,
                  fused_dispatch=fused, generator=gen)
    state = {k: torch.tensor(np.asarray(v._value))
             for k, v in jl.state_dict().items()}
    tl.load_state_dict(state, strict=True)
    return jl, tl.eval()


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("cf", [None, 1.0, 100.0])
def test_moe_layer_matches_jax(cf, fused):
    """The port's ``MoELayer`` in eval, gather path and fused path, against
    the JAX layer (capacity from the gate's eval factor, a dropping one,
    and the no-drop one serving uses)."""
    jl, tl = _layers(16, 32, 4, cf, fused)
    x = np.random.default_rng(4).standard_normal((2, 9, 16)).astype(
        np.float32)
    want = np.asarray(jl(paddle.to_tensor(x)).numpy())
    with torch.no_grad():
        got = tl(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert tl._capacity(18) == jl._capacity(18)


def test_moe_layer_training_and_other_gates_raise():
    gen = torch.Generator().manual_seed(0)
    layer = MoELayer(8, [ExpertLayer(8, 16, generator=gen) for _ in range(2)],
                     generator=gen)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        layer(torch.zeros(3, 8))                 # a new module trains
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        GShardGate(8, 2, 1, generator=gen)(torch.zeros(3, 8))
    with pytest.raises(NotImplementedError):
        MoELayer(8, [ExpertLayer(8, 16, generator=gen)], gate={"type":
                                                               "switch"})
    with pytest.raises(ValueError, match="gate_kind"):
        tmd.fused_moe_dispatch(torch.zeros(3, 8), torch.zeros(8, 2),
                               torch.zeros(2), num_expert=2, capacity=2,
                               top_k=1, gate_kind="top1")
    with pytest.raises(ValueError, match="top_k"):
        tmd.fused_moe_dispatch(torch.zeros(3, 8), torch.zeros(8, 2),
                               torch.zeros(2), num_expert=2, capacity=2,
                               top_k=3)
