"""The port's GPT pretraining step against the JAX package's, on the CPU.

Both steps start from one JAX ``state_dict`` (carried across as numpy) and
train on the same numpy batch: the JAX ``GPTHybridTrainStep`` at
dp = mp = pp = 1, and the port's. The port runs with the flash path on (its
plain flash forward and backward inside the step) and off, under every
remat mode; the JAX side runs its dense attention, the same math (Pallas
in interpret mode inside ``shard_map`` is slow). The loss and the
criterion are checked on their own as well.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.distributed import mesh as mesh_mod
from paddle_tpu.distributed.mesh import HybridCommunicateGroup
from paddle_tpu.models import gpt as jgpt
from paddle_tpu_torch.kernels import flash_attention as tfa
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.models.convert import gpt_state_dict_from_numpy

# d = 64, a head dim the CUDA kernels take
CFG = dict(hidden_size=128, num_heads=2, num_layers=2, vocab_size=256,
           max_position_embeddings=128)
B, S, STEPS, LR = 2, 128, 5, 1e-3
# f32 losses: the two frameworks sum in other orders; seen <= 1e-6
LOSS_TOL = 1e-5
# f32 masters after 5 steps. AdamW divides each gradient by its own RMS,
# so an element whose gradient is rounding noise takes a step of the
# noise's sign: the key bias (its exact gradient is 0, since a constant
# added to every score of a row leaves the softmax unchanged) and a few
# others. Those elements move apart by up to lr per step; seen <= 4e-5.
# Every other element agrees to 1e-6.
PARAM_TOL, PARAM_TIGHT, PARAM_TIGHT_SHARE = 1e-4, 1e-6, 0.995


@pytest.fixture(autouse=True)
def reset_mesh():
    saved = (mesh_mod._global_mesh, mesh_mod._hcg)
    mesh_mod._global_mesh, mesh_mod._hcg = None, None
    yield
    mesh_mod._global_mesh, mesh_mod._hcg = saved


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, CFG["vocab_size"], (B, S)).astype(np.int32)
    return ids, np.roll(ids, -1, axis=1)


def _jax_model(seed=0):
    paddle.seed(seed)
    model = jgpt.GPTForPretraining(jgpt.GPTModel(jgpt.gpt_tiny_config(
        **CFG)))
    state = {k: np.asarray(v._value) for k, v in model.state_dict().items()}
    return model, state


def _jax_step(model, **kw):
    hcg = HybridCommunicateGroup(dp_degree=1, mp_degree=1, pp_degree=1)
    kw = dict(dict(n_micro=1, lr=LR, remat=False, use_flash=False), **kw)
    return jgpt.GPTHybridTrainStep(model, jgpt.gpt_tiny_config(**CFG), hcg,
                                   **kw)


def _port_step(state, **kw):
    model = tgpt.GPTForPretraining(tgpt.GPTModel(
        tgpt.gpt_tiny_config(**CFG), device="cpu"))
    model.load_state_dict(gpt_state_dict_from_numpy(state), strict=True)
    kw = dict(dict(n_micro=1, lr=LR), **kw)
    return model, tgpt.GPTHybridTrainStep(model, model.config, None, **kw)


@pytest.fixture(scope="module")
def jax_run():
    """The JAX step's 5-step f32 trajectory and its trained weights."""
    saved = (mesh_mod._global_mesh, mesh_mod._hcg)
    mesh_mod._global_mesh, mesh_mod._hcg = None, None
    model, state = _jax_model()
    step = _jax_step(model)
    ids, labels = _batch()
    losses = [float(step(ids, labels).numpy()) for _ in range(STEPS)]
    step.sync_params_to_model()
    trained = {k: np.asarray(v._value)
               for k, v in model.state_dict().items()}
    mesh_mod._global_mesh, mesh_mod._hcg = saved
    return state, losses, trained


def _close_params(got, want):
    for name, ref in want.items():
        out = got[name].detach().float().numpy()
        np.testing.assert_allclose(out, ref, rtol=0, atol=PARAM_TOL,
                                   err_msg=name)
    diffs = np.concatenate([np.abs(got[n].detach().float().numpy()
                                   - want[n]).ravel() for n in want])
    assert (diffs <= PARAM_TIGHT).mean() >= PARAM_TIGHT_SHARE


# ------------------------------------------------------------- the loss

def test_full_logits_cross_entropy_matches_jax():
    rng = np.random.default_rng(1)
    h = rng.standard_normal((2, 24, 16)).astype(np.float32)
    wte = rng.standard_normal((300, 16)).astype(np.float32)
    lab = rng.integers(0, 300, (2, 24)).astype(np.int32)
    mask = (rng.random((2, 24)) > 0.3).astype(np.float32)
    for kw in ({}, {"loss_mask": mask}):
        jf = lambda h_, w_: jgpt.vocab_parallel_cross_entropy(
            h_, w_, jnp.asarray(lab), **{k: jnp.asarray(v)
                                         for k, v in kw.items()})
        ref, (gh, gw) = jax.value_and_grad(jf, (0, 1))(jnp.asarray(h),
                                                       jnp.asarray(wte))
        th, tw = (torch.from_numpy(a).requires_grad_() for a in (h, wte))
        tkw = {k: torch.from_numpy(v) for k, v in kw.items()}
        for mp_axis in (None, "mp"):     # an mp axis of size 1
            out = tgpt.vocab_parallel_cross_entropy(
                th, tw, torch.from_numpy(lab), mp_axis=mp_axis, **tkw)
            dh, dw = torch.autograd.grad(out, (th, tw))
            np.testing.assert_allclose(out.item(), float(ref), rtol=1e-6)
            np.testing.assert_allclose(dh.numpy(), np.asarray(gh), atol=1e-6)
            np.testing.assert_allclose(dw.numpy(), np.asarray(gw), atol=1e-6)


def test_chunked_cross_entropy_matches_jax():
    """N > 2048 tokens and V >= 16384 without an mp axis: chunks of 2048
    under checkpoints, with a loss mask, a bias and out-of-range ids."""
    rng = np.random.default_rng(2)
    n_tok, V, H = 2200, 16384, 8
    h = (rng.standard_normal((2, n_tok // 2, H)) * 0.5).astype(np.float32)
    wte = (rng.standard_normal((V, H)) * 0.5).astype(np.float32)
    bias = rng.standard_normal(V).astype(np.float32)
    lab = rng.integers(0, V, (2, n_tok // 2)).astype(np.int32)
    lab[0, :5] = -1
    mask = (rng.random((2, n_tok // 2)) > 0.2).astype(np.float32)
    jf = lambda h_, w_, b_: jgpt.vocab_parallel_cross_entropy(
        h_, w_, jnp.asarray(lab), loss_mask=jnp.asarray(mask), bias=b_)
    ref, grads = jax.value_and_grad(jf, (0, 1, 2))(
        jnp.asarray(h), jnp.asarray(wte), jnp.asarray(bias))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (h, wte, bias)]
    out = tgpt.vocab_parallel_cross_entropy(
        leaves[0], leaves[1], torch.from_numpy(lab),
        loss_mask=torch.from_numpy(mask), bias=leaves[2])
    got = torch.autograd.grad(out, leaves)
    np.testing.assert_allclose(out.item(), float(ref), rtol=1e-5)
    for g, r in zip(got, grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-6)


@pytest.mark.parametrize("masked", [False, True])
def test_pretraining_criterion_matches_jax(masked):
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((2, 10, 50)).astype(np.float32)
    lab = rng.integers(0, 50, (2, 10)).astype(np.int32)
    mask = (rng.random((2, 10)) > 0.5).astype(np.float32)
    args = (lab, mask) if masked else (lab,)
    ref = jgpt.GPTPretrainingCriterion()(
        *(paddle.to_tensor(a) for a in (logits,) + args))
    out = tgpt.GPTPretrainingCriterion()(
        *(torch.from_numpy(a) for a in (logits,) + args))
    np.testing.assert_allclose(out.item(), float(ref.numpy()), rtol=1e-6)


def test_shapes_and_flops_match_jax():
    for name in ("gpt_tiny_config", "gpt_345m_config"):
        jc, tc = getattr(jgpt, name)(), getattr(tgpt, name)()
        assert tgpt.gpt_stacked_param_shapes(tc) == \
            jgpt.gpt_stacked_param_shapes(jc)
        assert tgpt.model_flops_per_token(tc, 1024) == \
            jgpt.model_flops_per_token(jc, 1024)


# ------------------------------------------------------------- the step

@pytest.mark.parametrize("use_flash", [False, True])
@pytest.mark.parametrize("remat", [False, True, "dots"])
def test_step_trajectory_matches_jax(jax_run, remat, use_flash):
    state, jax_losses, jax_trained = jax_run
    model, step = _port_step(state, remat=remat, use_flash=use_flash)
    ids, labels = _batch()
    losses = []
    for _ in range(STEPS):
        loss = step(ids, labels)
        assert loss.dim() == 0 and loss.dtype == torch.float32
        losses.append(loss.item())
    np.testing.assert_allclose(losses, jax_losses, rtol=0, atol=LOSS_TOL)
    assert step.flops_per_token == jgpt.model_flops_per_token(
        jgpt.gpt_tiny_config(**CFG), S)[0]
    step.sync_params_to_model()
    _close_params(model.state_dict(), jax_trained)


@pytest.mark.parametrize("remat,fwd_per_layer", [(False, 1), (True, 2),
                                                 ("dots", 2)])
def test_flash_calls_per_step_follow_remat(monkeypatch, remat,
                                           fwd_per_layer):
    """The flash forward runs once per layer per step, and once more in
    the backward's recompute under a checkpoint; each backward pass once
    per layer. (The CUDA launch counters follow the same calls.)"""
    calls = {"fwd": 0, "bwd": 0}

    def counted(name, fn):
        def inner(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return inner

    monkeypatch.setattr(tfa, "flash_attention_fwd",
                        counted("fwd", tfa.flash_attention_fwd))
    monkeypatch.setattr(tfa, "flash_attention_bwd",
                        counted("bwd", tfa.flash_attention_bwd))
    _, state = _jax_model()
    _, step = _port_step(state, remat=remat, use_flash=True)
    ids, labels = _batch()
    for n in (1, 2):
        step(ids, labels)
        L = CFG["num_layers"]
        assert calls == {"fwd": n * fwd_per_layer * L, "bwd": n * L}


def test_selective_remat_gives_the_same_gradients():
    _, state = _jax_model()
    ids, labels = _batch()
    ref = _port_step(state, remat=False, use_flash=True)[1].loss_and_grads(
        ids, labels)
    got = _port_step(state, remat="dots", use_flash=True)[1].loss_and_grads(
        ids, labels)
    torch.testing.assert_close(got[0], ref[0], rtol=0, atol=0)
    for k, g in got[1]["blocks"].items():
        torch.testing.assert_close(g, ref[1]["blocks"][k], rtol=0, atol=0)


def test_micro_batches_and_lr_schedule_match_jax():
    class Schedule:            # read, then stepped, once per call
        def __init__(self):
            self.i = 0

        def __call__(self):
            return (1e-3, 5e-4, 2e-3)[self.i]

        def step(self):
            self.i += 1

    jmodel, state = _jax_model(seed=4)
    jstep = _jax_step(jmodel, n_micro=2, lr=Schedule())
    _, step = _port_step(state, n_micro=2, lr=Schedule(), remat="dots")
    ids, labels = _batch(seed=4)
    for _ in range(3):
        ref = float(jstep(ids, labels).numpy())
        np.testing.assert_allclose(step(ids, labels).item(), ref, rtol=0,
                                   atol=LOSS_TOL)
    assert step.hyper[0].i == 3


def test_bf16_compute_and_storage_match_jax():
    """compute_dtype bf16 (f32 masters) and bf16 masters + moments. The
    losses agree within 5e-3: both frameworks round the activations to
    bf16 at the same points but sum in other orders (seen <= 6e-4, against
    a bf16 spacing of 0.03 at these losses)."""
    jmodel, state = _jax_model(seed=5)
    ids, labels = _batch(seed=5)
    for kw in (dict(compute_dtype="bfloat16"),
               dict(param_dtype="bfloat16", moment_dtype="bfloat16")):
        mesh_mod._global_mesh, mesh_mod._hcg = None, None
        jstep = _jax_step(jmodel, **kw)
        _, step = _port_step(state, use_flash=True, **kw)
        want = torch.bfloat16 if "param_dtype" in kw else torch.float32
        assert step.params["blocks"]["wqkv"].dtype == want
        assert step.params["wte"].dtype == want
        assert step.opt_state["m"]["wte"].dtype == want
        assert step.opt_state["v"]["blocks"]["w1"].dtype == want
        losses = [step(ids, labels).item() for _ in range(3)]
        ref = [float(jstep(ids, labels).numpy()) for _ in range(3)]
        np.testing.assert_allclose(losses, ref, rtol=0, atol=5e-3)
        assert losses[-1] < losses[0]


class _Hcg:
    def __init__(self, **degrees):
        self.degrees = degrees

    def __getattr__(self, name):
        axis = name[len("get_"):-len("_parallel_world_size")]
        return lambda: self.degrees.get(axis, 1)


@pytest.mark.parametrize("kw", [
    dict(hcg=_Hcg(data=2)), dict(hcg=_Hcg(model=2)), dict(hcg=_Hcg(pipe=2)),
    dict(hcg=_Hcg(sharding=2)), dict(pipeline_schedule="1f1b"),
    dict(virtual_pp_degree=2), dict(validate=True)])
def test_unported_options_raise(kw):
    _, state = _jax_model()
    model = tgpt.GPTForPretraining(tgpt.GPTModel(
        tgpt.gpt_tiny_config(**CFG), device="cpu"))
    hcg = kw.pop("hcg", _Hcg())
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 1"):
        tgpt.GPTHybridTrainStep(model, model.config, hcg, **kw)


def test_bad_arguments_raise():
    model = tgpt.GPTForPretraining(tgpt.GPTModel(
        tgpt.gpt_tiny_config(**CFG), device="cpu"))
    with pytest.raises(ValueError, match="pipeline_schedule"):
        tgpt.GPTHybridTrainStep(model, model.config,
                                pipeline_schedule="zb")
    with pytest.raises(ValueError, match="remat"):
        tgpt.GPTHybridTrainStep(model, model.config, remat="full")
    step = tgpt.GPTHybridTrainStep(model, model.config, n_micro=3)
    ids, labels = _batch()
    with pytest.raises(ValueError, match="micro-batches"):
        step(ids, labels)
    long_ids = np.zeros((1, 256), np.int32)
    with pytest.raises(ValueError, match="max_position_embeddings"):
        tgpt.GPTHybridTrainStep(model, model.config)(long_ids, long_ids)
