"""The GPT training step with device-tensor ``lr`` and step count, and its
CUDA graph.

On the CPU (where the step runs eagerly, with the device formulas the
graph captures) the port's step under an LR schedule is held against the
JAX step under the JAX package's same schedule; these tests import JAX
inside their bodies, so the file also collects on a machine without it.
On the card (``gpu`` marker) the captured step, the default there, is
held against the eager step (``gpt._eager_step()``): losses and masters
bit-equal over 5 steps, launches counted through replays, one graph per
batch shape, the schedule reaching the replays and a failed capture
raising. The card cases run in a fresh interpreter, as
``tests/test_torch_aot.py``'s sampled cases do.

    python -m pytest tests/test_torch_train_graph.py -m gpu --noconftest -q
"""
import contextlib
import gc
import weakref

import numpy as np
import pytest
import torch

from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.optimizer import lr as tlr

# d = 64, a head dim the CUDA kernels take
CFG = dict(hidden_size=128, num_heads=2, num_layers=2, vocab_size=256,
           max_position_embeddings=128)
B, S, LR = 2, 128, 1e-3
# the tolerances of tests/test_torch_train.py: f32 losses, and the masters,
# where an element whose gradient is rounding noise (the key bias) moves
# by up to lr a step
LOSS_TOL = 1e-5
PARAM_TOL, PARAM_TIGHT, PARAM_TIGHT_SHARE = 1e-4, 1e-6, 0.995

# schedules (built from either package's ``optimizer.lr``) that move lr
# at every one of 3 steps
SCHEDULES = {
    "step_decay": lambda m: m.StepDecay(LR, step_size=1, gamma=0.5),
    "warmup_cosine": lambda m: m.LinearWarmup(
        m.CosineAnnealingDecay(LR, T_max=4), warmup_steps=2,
        start_lr=2e-4, end_lr=LR),
}


def _batch(seed=0, shape=(B, S)):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, CFG["vocab_size"], shape).astype(np.int32)
    return ids, np.roll(ids, -1, axis=1)


def _port_step(state=None, device="cpu", seed=0, **kw):
    model = tgpt.GPTForPretraining(tgpt.GPTModel(
        tgpt.gpt_tiny_config(**CFG), seed=seed, device=device))
    if state is not None:
        from paddle_tpu_torch.models.convert import gpt_state_dict_from_numpy
        model.load_state_dict(gpt_state_dict_from_numpy(state), strict=True)
    kw = dict(dict(n_micro=1, lr=LR, remat="dots", use_flash=True), **kw)
    return model, tgpt.GPTHybridTrainStep(model, model.config, None, **kw)


def _jax_run(schedule, steps):
    """The JAX step (dp = mp = pp = 1, dense attention) under the JAX
    package's ``schedule``: the initial state, the losses and the trained
    state."""
    import paddle_tpu as paddle
    from paddle_tpu.distributed import mesh as mesh_mod
    from paddle_tpu.distributed.mesh import HybridCommunicateGroup
    from paddle_tpu.models import gpt as jgpt
    from paddle_tpu.optimizer import lr as jlr
    saved = (mesh_mod._global_mesh, mesh_mod._hcg)
    mesh_mod._global_mesh, mesh_mod._hcg = None, None
    try:
        paddle.seed(0)
        model = jgpt.GPTForPretraining(jgpt.GPTModel(jgpt.gpt_tiny_config(
            **CFG)))
        state = {k: np.asarray(v._value)
                 for k, v in model.state_dict().items()}
        hcg = HybridCommunicateGroup(dp_degree=1, mp_degree=1, pp_degree=1)
        step = jgpt.GPTHybridTrainStep(
            model, jgpt.gpt_tiny_config(**CFG), hcg, n_micro=1,
            lr=SCHEDULES[schedule](jlr), remat=False, use_flash=False)
        ids, labels = _batch()
        losses = [float(step(ids, labels).numpy()) for _ in range(steps)]
        step.sync_params_to_model()
        trained = {k: np.asarray(v._value)
                   for k, v in model.state_dict().items()}
    finally:
        mesh_mod._global_mesh, mesh_mod._hcg = saved
    return state, losses, trained


def _close_params(got, want):
    for name, ref in want.items():
        np.testing.assert_allclose(got[name].detach().float().numpy(), ref,
                                   rtol=0, atol=PARAM_TOL, err_msg=name)
    diffs = np.concatenate([np.abs(got[n].detach().float().numpy()
                                   - want[n]).ravel() for n in want])
    assert (diffs <= PARAM_TIGHT).mean() >= PARAM_TIGHT_SHARE


# ------------------------------------------------------------------ CPU

@pytest.mark.parametrize("schedule", sorted(SCHEDULES))
def test_scheduled_steps_match_jax(schedule):
    """Three steps under a ported schedule against the JAX step under the
    JAX schedule: losses and trained masters at the tolerances of
    ``tests/test_torch_train.py``; the schedule is the caller's object,
    stepped once a call."""
    state, want_losses, trained = _jax_run(schedule, 3)
    sched = SCHEDULES[schedule](tlr)
    model, step = _port_step(state, lr=sched)
    ids, labels = _batch()
    losses = [step(ids, labels).item() for _ in range(3)]
    np.testing.assert_allclose(losses, want_losses, rtol=0, atol=LOSS_TOL)
    assert step.hyper[0] is sched and sched.last_epoch == 3
    step.sync_params_to_model()
    _close_params(model.state_dict(), trained)


def test_update_takes_device_scalars(monkeypatch):
    """Each call hands the update ``lr`` and the step count as 0-d f32
    tensors on the masters' device: the schedule's value read before it
    steps, and 1, 2, 3."""
    seen = []
    adamw = tgpt.GPTHybridTrainStep._adamw

    def spy(self, grads, lr, t):
        seen.append((lr.dtype, lr.dim(), lr.device.type, lr.item(),
                     t.dtype, t.dim(), t.item()))
        return adamw(self, grads, lr, t)
    monkeypatch.setattr(tgpt.GPTHybridTrainStep, "_adamw", spy)
    sched = tlr.StepDecay(LR, step_size=1, gamma=0.5)
    _, step = _port_step(lr=sched)
    ids, labels = _batch()
    for _ in range(3):
        step(ids, labels)
    f32 = torch.float32
    assert seen == [(f32, 0, "cpu", float(np.float32(LR * 0.5 ** i)), f32,
                     0, float(i + 1)) for i in range(3)]
    assert step.captured_shapes == [] and step.graph_pool_bytes() == 0
    assert step.capture_s == 0.0


def test_returned_loss_outlives_the_next_call():
    _, step = _port_step()
    ids, labels = _batch()
    first = step(ids, labels)
    value = first.item()
    second = step(ids, labels)
    assert first.dim() == 0 and first.dtype == torch.float32
    assert first.item() == value and second.item() != value


def test_step_holds_no_reference_cycle():
    """A step goes with its last reference, never in a later garbage
    collection (on the card that could fall inside another capture, which
    a graph's destruction invalidates)."""
    was = gc.isenabled()
    gc.disable()
    try:
        _, step = _port_step(lr=tlr.StepDecay(LR, step_size=1))
        step(*_batch())
        ref = weakref.ref(step)
        del step
        assert ref() is None
    finally:
        if was:
            gc.enable()


# ------------------------------------------------------------------ card

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _flash_counts():
    from paddle_tpu_torch.kernels import flash_attention as tfa
    return tfa.launches, tfa.dq_launches, tfa.dkv_launches


def _card_run(captured, steps=5, shapes=((B, S),), on_device=False, **kw):
    """``steps`` steps on the card from seed 0, captured or eager, cycling
    through the batch ``shapes`` (numpy arrays, or int32 CUDA tensors):
    losses, the masters after each step (on the host), the launches of
    each call and the step."""
    model, step = _port_step(device="cuda", **kw)
    batches = [_batch(i, shape) for i, shape in enumerate(shapes)]
    if on_device:
        batches = [tuple(torch.from_numpy(a).cuda() for a in batch)
                   for batch in batches]
    losses, masters, counts = [], [], []
    with contextlib.nullcontext() if captured else tgpt._eager_step():
        for i in range(steps):
            c0 = _flash_counts()
            losses.append(step(*batches[i % len(batches)]).item())
            counts.append([b - a for a, b in zip(c0, _flash_counts())])
            masters.append({k: v.detach().cpu() for k, v in
                            tgpt._tree_items(step.params)})
    return losses, masters, counts, step


def _max_diff(a, b):
    return max((x.float() - b[k].float()).abs().max().item()
               for k, x in a.items())


def _card_cases():
    """Every card case's result, as JSON-ready values."""
    out = {}
    L = CFG["num_layers"]
    for dtype in (None, "bfloat16"):
        label = dtype or "float32"
        cap = _card_run(True, compute_dtype=dtype)
        eag = _card_run(False, compute_dtype=dtype)
        out[f"vs_eager_{label}"] = dict(
            losses=cap[0], eager_losses=eag[0],
            param_diff=[_max_diff(a, b) for a, b in zip(cap[1], eag[1])],
            counts=cap[2], eager_counts=eag[2], want=[2 * L, L, L],
            shapes=[list(s) for s in cap[3].captured_shapes],
            pool=cap[3].graph_pool_bytes(), capture_s=cap[3].capture_s)
    shapes = ((B, S), (4, 64))
    cap = _card_run(True, steps=6, shapes=shapes)
    eag = _card_run(False, steps=6, shapes=shapes)
    out["two_shapes"] = dict(
        shapes=[list(s) for s in cap[3].captured_shapes],
        losses=cap[0], eager_losses=eag[0],
        param_diff=_max_diff(cap[1][-1], eag[1][-1]), counts=cap[2])
    cap = _card_run(True, steps=3, on_device=True)
    eag = _card_run(False, steps=3)
    out["device_inputs"] = dict(losses=cap[0], eager_losses=eag[0],
                                param_diff=_max_diff(cap[1][-1], eag[1][-1]))
    sched = lambda: tlr.StepDecay(LR, step_size=1, gamma=0.1)  # noqa: E731
    cap = _card_run(True, steps=3, lr=sched())
    eag = _card_run(False, steps=3, lr=sched())
    const = _card_run(True, steps=3)
    out["schedule"] = dict(
        vs_eager=_max_diff(cap[1][-1], eag[1][-1]),
        vs_constant=[_max_diff(a, b) for a, b in zip(cap[1], const[1])],
        last_epoch=cap[3].hyper[0].last_epoch)
    # a returned loss is a copy: the next replay leaves it as it was
    _, step = _port_step(device="cuda")
    ids, labels = _batch()
    step(ids, labels)
    first = step(ids, labels)
    value = first.item()
    second = step(ids, labels).item()
    out["loss_kept"] = dict(value=value, after=first.item(), next=second)
    # no reference cycle: the step and its graphs go with the last reference
    ref = weakref.ref(step)
    gc.disable()
    del step
    out["freed"] = ref() is None
    gc.enable()
    return out


def _failing_capture():
    """A host sync only inside the capture (a loss read to the host): the
    call raises and no graph is kept."""
    real = tgpt.vocab_parallel_cross_entropy

    def syncing(*a, **kw):
        loss = real(*a, **kw)
        if torch.cuda.is_current_stream_capturing():
            float(loss)
        return loss
    tgpt.vocab_parallel_cross_entropy = syncing
    _, step = _port_step(device="cuda")
    try:
        step(*_batch())
    except RuntimeError as e:
        raised = str(e).splitlines()[0][:200]
    else:
        raised = None
    finally:
        tgpt.vocab_parallel_cross_entropy = real
    return dict(raised=raised, shapes=len(step.captured_shapes))


_CARD_RUNNER = """
import importlib.util, json, sys
spec = importlib.util.spec_from_file_location("train_graph_cases", sys.argv[1])
mod = importlib.util.module_from_spec(spec)
spec.loader.exec_module(mod)
mod._cuda()
print(json.dumps(getattr(mod, sys.argv[2])()))
"""


def _in_subprocess(name):
    import json
    import subprocess
    import sys
    from pathlib import Path
    out = subprocess.run([sys.executable, "-c", _CARD_RUNNER, __file__, name],
                         cwd=Path(__file__).resolve().parents[1],
                         capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.splitlines()[-1])


@pytest.fixture(scope="module")
def card():
    _cuda()
    return _in_subprocess("_card_cases")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_captured_step_equals_eager(card, dtype):
    """Five steps, captured (the first runs eagerly and captures) against
    eager from one seed: every loss and every master bit-equal after every
    step, and the same launches."""
    res = card[f"vs_eager_{dtype}"]
    assert res["losses"] == res["eager_losses"]
    assert res["param_diff"] == [0.0] * 5
    assert all(np.isfinite(res["losses"]))
    assert res["shapes"] == [[B, S]] and res["pool"] != 0
    assert res["capture_s"] > 0


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_replays_count_flash_launches(card, dtype):
    """Each call, the capturing one and every replay, counts the flash
    forward twice a layer (forward and recompute) and each backward kernel
    once a layer, as each eager call does."""
    res = card[f"vs_eager_{dtype}"]
    assert res["counts"] == [res["want"]] * 5 == res["eager_counts"]


@pytest.mark.gpu
def test_second_shape_captures_second_graph(card):
    res = card["two_shapes"]
    assert res["shapes"] == [[B, S], [4, 64]]
    assert res["losses"] == res["eager_losses"]
    assert res["param_diff"] == 0.0
    L = CFG["num_layers"]
    assert res["counts"] == [[2 * L, L, L]] * 6


@pytest.mark.gpu
def test_cuda_tensor_inputs_are_staged(card):
    """ids and labels given as int32 CUDA tensors reach the graph as numpy
    arrays do: the same steps as the eager step on numpy inputs."""
    res = card["device_inputs"]
    assert res["losses"] == res["eager_losses"]
    assert res["param_diff"] == 0.0


@pytest.mark.gpu
def test_schedule_reaches_the_replays(card):
    """Under StepDecay (x0.1 a step) the masters after steps 2 and 3
    differ from a constant-lr run's, and equal the eager step's under the
    same schedule."""
    res = card["schedule"]
    assert res["vs_eager"] == 0.0 and res["last_epoch"] == 3
    assert res["vs_constant"][0] == 0.0
    assert res["vs_constant"][1] > 0 and res["vs_constant"][2] > 0


@pytest.mark.gpu
def test_captured_loss_is_a_copy_and_the_step_is_freed(card):
    res = card["loss_kept"]
    assert res["after"] == res["value"] != res["next"]
    assert card["freed"]


@pytest.mark.gpu
def test_failed_capture_raises():
    _cuda()
    res = _in_subprocess("_failing_capture")
    assert res["raised"] is not None and res["shapes"] == 0
