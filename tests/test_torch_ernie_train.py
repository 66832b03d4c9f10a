"""ERNIE-MoE pretraining in the port against the JAX package, on the CPU.

The JAX ``ErnieMoeForPretraining`` at ``ernie_moe_tiny_config`` cut to 2
layers (a dense one and an MoE one; hidden 64, 2 heads of 32, 4 experts
top-2) is carried across with ``ernie_moe_state_dict_from_numpy``. Every gate's
random routing is off on both sides, so the two compute the same
function: the MLM loss plus 0.01 times the gates' aux loss. At S = 64
the JAX model's attention is its flash kernel (interpret mode) and the
port's the flash kernel's plain version; the fused MoE kernels likewise.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import amp as jamp
from paddle_tpu import optimizer as joptim
from paddle_tpu.incubate.distributed.models.moe import GShardGate as JGate
from paddle_tpu.models import ernie as jernie
from paddle_tpu_torch import amp as tamp
from paddle_tpu_torch import optimizer as toptim
from paddle_tpu_torch.incubate.distributed.models.moe import GShardGate
from paddle_tpu_torch.models import ernie as ternie
from paddle_tpu_torch.models.convert import ernie_moe_state_dict_from_numpy

B, S = 2, 64
# f32, sums in other orders: the loss to 1e-5 relative; each gradient to
# rtol 1e-3 with atol 1e-6 of the largest |gradient| of the model
# (gradients summed over the batch in other orders; the key bias's is 0
# up to rounding, since softmax ignores a constant added to a row)
LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-3, 1e-6
# 3 AdamW steps at lr 1e-3: losses to 1e-5 relative, parameters to 2e-5
# absolute (an element whose gradient is near 0 takes a step of up to lr
# whose sign rounding may set)
PARAM_ATOL = 2e-5
# bf16 under auto_cast: both cast at the same points, but the JAX GELU
# rounds each of its steps on bf16 values where torch's computes in f32 and
# rounds once (2e-3 rms apart on one bf16 tensor), and the flash plain
# version rounds P where the interpret-mode kernel rounds its tiles: the
# loss to 1e-4 relative (seen: 9.6e-6)
BF16_LOSS_RTOL = 1e-4


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(jnp.asarray(t._value).astype(jnp.float32))


def _no_random_routing(model, gate_cls):
    for sub in (model.sublayers() if hasattr(model, "sublayers")
                else model.modules()):
        if isinstance(sub, gate_cls):
            sub.random_routing = False


def _models(fused=False, **kw):
    kw.setdefault("num_hidden_layers", 2)
    paddle.seed(0)
    jcfg = jernie.ernie_moe_tiny_config(fused_dispatch=fused, **kw)
    jmodel = jernie.ErnieMoeForPretraining(jernie.ErnieMoeModel(jcfg))
    tcfg = ternie.ernie_moe_tiny_config(fused_dispatch=fused, **kw)
    tmodel = ternie.ErnieMoeForPretraining(
        ternie.ErnieMoeModel(tcfg, device="cpu"))
    tmodel.load_state_dict(ernie_moe_state_dict_from_numpy(
        {k: np.asarray(v._value) for k, v in jmodel.state_dict().items()}),
        strict=True)
    _no_random_routing(jmodel, JGate)
    _no_random_routing(tmodel, GShardGate)
    jmodel.train()
    return jmodel, tmodel.train()


def _batch(vocab=1024, b=B, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, vocab, (b, S)).astype(np.int64)
    labels = rng.integers(0, vocab, (b, S)).astype(np.int64)
    labels[rng.random((b, S)) < 0.3] = -100
    return ids, labels


def _jax_loss(jmodel, ids, labels):
    return jmodel.forward_with_mlm_loss(paddle.to_tensor(ids),
                                        paddle.to_tensor(labels))


def _torch_loss(tmodel, ids, labels):
    return tmodel.forward_with_mlm_loss(torch.from_numpy(ids),
                                        torch.from_numpy(labels))


def _assert_grads(jmodel, tmodel):
    tgrads = dict(tmodel.named_parameters())
    top = max(np.abs(_np(p.grad)).max() for p in jmodel.parameters()
              if p.grad is not None)
    n = 0
    for name, p in jmodel.named_parameters():
        n += 1
        if p.grad is None:       # the token type table: no ids given
            assert tgrads[name].grad is None, name
            continue
        want = _np(p.grad)
        got = _np(tgrads[name].grad)
        np.testing.assert_allclose(got, want, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL * top, err_msg=name)
    assert n == len(tgrads)


@pytest.mark.parametrize("fused", [False, True])
def test_mlm_loss_and_grads_match_jax(fused):
    """``forward_with_mlm_loss`` in training, f32, with -100 labels: the
    loss (MLM + 0.01 aux) and every gradient, gather and fused MoE paths."""
    jmodel, tmodel = _models(fused)
    ids, labels = _batch()
    jl = _jax_loss(jmodel, ids, labels)
    jl.backward()
    tl = _torch_loss(tmodel, ids, labels)
    tl.backward()
    np.testing.assert_allclose(tl.item(), _np(jl), rtol=LOSS_RTOL)
    _assert_grads(jmodel, tmodel)


def test_adamw_three_steps_match_jax():
    jmodel, tmodel = _models()
    jopt = joptim.AdamW(learning_rate=1e-3, parameters=jmodel.parameters())
    topt = toptim.AdamW(learning_rate=1e-3, parameters=tmodel.parameters())
    ids, labels = _batch()
    jlosses, tlosses = [], []
    for _ in range(3):
        jl = _jax_loss(jmodel, ids, labels)
        jl.backward()
        jopt.step()
        jopt.clear_grad()
        jlosses.append(float(_np(jl)))
        tl = _torch_loss(tmodel, ids, labels)
        tl.backward()
        topt.step()
        topt.clear_grad()
        tlosses.append(tl.item())
    np.testing.assert_allclose(tlosses, jlosses, rtol=LOSS_RTOL)
    assert tlosses[-1] < tlosses[0]
    tparams = dict(tmodel.named_parameters())
    for name, p in jmodel.named_parameters():
        np.testing.assert_allclose(_np(tparams[name]), _np(p),
                                   rtol=0, atol=PARAM_ATOL, err_msg=name)


@pytest.mark.parametrize("fused", [False, True])
def test_auto_cast_bf16_loss_matches_jax(fused):
    """The loss under ``auto_cast(dtype="bfloat16")`` (paddle's O1 lists)
    against the JAX model's under its ``auto_cast``, and away from the f32
    loss by more than the tolerance would allow (the casts happen)."""
    jmodel, tmodel = _models(fused)
    ids, labels = _batch(seed=1)
    with jamp.auto_cast(enable=True, dtype="bfloat16"):
        jl = float(_np(_jax_loss(jmodel, ids, labels)))
    with tamp.auto_cast(enable=True, dtype="bfloat16"):
        tl = _torch_loss(tmodel, ids, labels)
    assert tl.dtype == torch.float32
    np.testing.assert_allclose(tl.item(), jl, rtol=BF16_LOSS_RTOL)
    with torch.no_grad():
        f32 = _torch_loss(tmodel, ids, labels).item()
    assert f32 != tl.item()


def test_auto_cast_dtypes_follow_the_lists():
    """Where the casts fall: attention and the Linears in bf16, the layer
    norms, the gate's softmax and the MoE layer's rows in f32 (the MoE
    input is a layer norm's output), the expert products in bf16 with
    their bias adds promoting to f32."""
    _, tmodel = _models()
    seen = {}

    def hook(name):
        def f(mod, inp, out):
            seen.setdefault(name, (inp[0].dtype, out.dtype))
        return f
    blk = tmodel.ernie.layers[1]
    for name, mod in (("q_proj", blk.attn.q_proj), ("ln1", blk.ln1),
                      ("moe", blk.moe), ("gate", blk.moe.gate.gate),
                      ("head_ln", tmodel.layer_norm)):
        mod.register_forward_hook(hook(name))
    ids, labels = _batch()
    with tamp.auto_cast(dtype="bfloat16"):
        _torch_loss(tmodel, ids, labels)
    bf, f32 = torch.bfloat16, torch.float32
    assert seen == {"q_proj": (f32, bf), "ln1": (f32, f32),
                    "moe": (f32, f32), "gate": (f32, bf),
                    "head_ln": (bf, f32)}


def test_chunked_cross_entropy_matches_jax():
    """V = 16384 and 33 x 64 = 2112 > 2048 tokens: the chunked cross
    entropy branch on both sides; the loss and the gradients of the tied
    embedding and the head."""
    jmodel, tmodel = _models(vocab_size=16384)
    ids, labels = _batch(vocab=16384, b=33, seed=2)
    jl = _jax_loss(jmodel, ids, labels)
    jl.backward()
    tl = _torch_loss(tmodel, ids, labels)
    tl.backward()
    np.testing.assert_allclose(tl.item(), _np(jl), rtol=LOSS_RTOL)
    tparams = dict(tmodel.named_parameters())
    for name, p in jmodel.named_parameters():
        if name in ("decoder_weight", "decoder_bias", "transform.weight"):
            want = _np(p.grad)
            np.testing.assert_allclose(
                _np(tparams[name].grad), want, rtol=GRAD_RTOL,
                atol=GRAD_ATOL * np.abs(want).max(), err_msg=name)


def test_gate_aux_loss_train_and_eval():
    """In training the gates' aux loss is the JAX model's (read and
    cleared); in eval there is none."""
    jmodel, tmodel = _models()
    ids, _ = _batch()
    jmodel.ernie(paddle.to_tensor(ids))
    with torch.no_grad():
        tmodel.ernie(torch.from_numpy(ids))
    np.testing.assert_allclose(tmodel.gate_aux_loss().item(),
                               _np(jmodel.gate_aux_loss()), rtol=1e-5)
    assert tmodel.gate_aux_loss() is None
    jmodel.eval()
    tmodel.eval()
    with torch.no_grad():
        tmodel.ernie(torch.from_numpy(ids))
    jmodel.ernie(paddle.to_tensor(ids))
    assert tmodel.gate_aux_loss() is None
    assert jmodel.gate_aux_loss() is None


def test_random_routing_trains_and_guard():
    """With the default gates (random routing on in training) a step runs
    and its loss is finite; ``nonfinite_guard`` keeps a finite loss and
    makes a non-finite one 0."""
    cfg = ternie.ernie_moe_tiny_config(num_hidden_layers=2)
    model = ternie.ErnieMoeForPretraining(
        ternie.ErnieMoeModel(cfg, seed=3, device="cpu")).train()
    gates = [m for m in model.modules() if isinstance(m, GShardGate)]
    assert gates and all(g.random_routing for g in gates)
    assert len({g.rng.initial_seed() for g in gates}) == len(gates)
    ids, labels = (torch.from_numpy(a) for a in _batch())
    loss = model.forward_with_mlm_loss(ids, labels, nonfinite_guard=True)
    assert torch.isfinite(loss) and loss.item() > 0
    loss.backward()
    with torch.no_grad():
        model.transform.bias.fill_(float("inf"))
        bad = model.forward_with_mlm_loss(ids, labels, nonfinite_guard=True)
    assert bad.item() == 0.0


@pytest.mark.parametrize("op", ["linear", "einsum", "flash_attention",
                                "softmax", "layer_norm", "gelu",
                                "fused_mlm_loss"])
def test_amp_cast_follows_the_jax_tape(op):
    """``amp_cast`` casts an op's inputs as the JAX tape's ``_amp_cast_fn``
    does, with the O1 lists and with a custom white and black list; a
    non-float input and an inactive ``auto_cast`` pass unchanged."""
    from paddle_tpu.framework.tape import _amp_cast_fn
    f32, bf16 = torch.ones(2), torch.ones(2, dtype=torch.bfloat16)
    ints = torch.ones(2, dtype=torch.int64)
    jvals = {torch.float32: jnp.ones(2, jnp.float32),
             torch.bfloat16: jnp.ones(2, jnp.bfloat16)}
    for white, black in ((None, None), (["gelu"], ["linear"])):
        with jamp.auto_cast(enable=True, dtype="bfloat16",
                            custom_white_list=white,
                            custom_black_list=black):
            cast = _amp_cast_fn(op)
        with tamp.auto_cast(dtype="bfloat16", custom_white_list=white,
                            custom_black_list=black):
            got = tamp.amp_cast(op, f32, bf16, ints)
        for t, g in zip((f32, bf16), got):
            want = jvals[t.dtype] if cast is None else cast(jvals[t.dtype])
            assert str(g.dtype).split(".")[-1] == str(want.dtype), (op, t)
        assert got[2] is ints
    assert tamp.amp_cast(op, f32)[0] is f32
