"""BERT built from ``paddle_tpu_torch.nn`` against the JAX package's, on
the CPU.

The JAX ``BertForPretraining`` at ``bert_tiny_config`` (2 layers, hidden
64, 2 heads of 32, V = 1024; dropout 0) is carried across with
``set_state_dict`` from its ``state_dict()`` as numpy arrays: the two
models have the same structured names. At S = 64 without a mask the JAX
attention is its flash kernel (interpret mode) and the port's the flash
kernel's plain version; with a padding mask both take the dense form.

Tolerances, f32: the logits, the pooled output, ``forward_with_mlm_loss``
and ``BertPretrainingCriterion`` to rtol 1e-5 (atol 1e-6 on the logits);
every gradient (the tied embedding's, the sum over both uses, included)
to max |a - b| <= 1e-5 max |a|, except a key projection's bias, whose
gradient is 0 up to rounding (the softmax ignores a constant added to a
row): it is held to 1e-5 of the model's largest gradient. 3 AdamW steps
(dygraph, and through ``ParallelTrainStep``, which the CPU runs eagerly):
losses rtol 1e-5, parameters atol 2e-5. bf16 under ``auto_cast`` as the
ERNIE-MoE tests hold it: the loss to 1e-4 relative (the JAX GELU rounds
each step in bf16 where torch's rounds once).
"""
import numpy as np
import pytest

import paddle_tpu as jp
import paddle_tpu_torch as tp
from paddle_tpu.models import bert as jbert
from paddle_tpu_torch.framework import place as tplace
from paddle_tpu_torch.models import bert as tbert

B, S = 2, 64
RTOL = 1e-5
GRAD_REL = 1e-5
PARAM_ATOL = 2e-5
BF16_LOSS_RTOL = 1e-4


@pytest.fixture(autouse=True)
def _cpu_place():
    prev = tplace._current_place
    tp.set_device("cpu")
    yield
    tplace._current_place = prev


def _models(**kw):
    jp.seed(0)
    jm = jbert.BertForPretraining(jbert.BertModel(
        jbert.bert_tiny_config(**kw)))
    tm = tbert.BertForPretraining(tbert.BertModel(
        tbert.bert_tiny_config(**kw)))
    state = {k: np.asarray(v._value) for k, v in jm.state_dict().items()}
    assert list(state) == list(tm.state_dict())
    assert tm.set_state_dict(state) == ([], [])
    return jm, tm


def _batch(seed=0, ignore=0.3):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 1024, (B, S)).astype(np.int64)
    labels = rng.integers(0, 1024, (B, S)).astype(np.int64)
    labels[rng.random((B, S)) < ignore] = -100
    types = rng.integers(0, 2, (B, S)).astype(np.int64)
    return ids, labels, types


def _np(t):
    return np.asarray(t.numpy(), np.float32)


def _assert_grads(jm, tm):
    tgrads = {k: p.grad for k, p in tm.named_parameters()}
    jgrads = {k: p.grad for k, p in jm.named_parameters()}
    assert list(tgrads) == list(jgrads)
    top = max(np.abs(_np(g)).max() for g in jgrads.values()
              if g is not None)
    for k, g in jgrads.items():
        if g is None:
            assert tgrads[k] is None, k
            continue
        want, got = _np(g), _np(tgrads[k])
        scale = top if k.endswith("k_proj.bias") else np.abs(want).max()
        assert np.abs(got - want).max() <= GRAD_REL * scale, k


def test_state_dict_names_and_the_tie():
    """The structured names are the JAX model's; the decoder weight is the
    word embedding's Parameter: one entry in ``state_dict``, one in
    ``parameters()``, and ``set_state_dict`` writes both uses."""
    jm, tm = _models()
    assert [k for k, _ in jm.named_parameters()] == \
        [k for k, _ in tm.named_parameters()]
    word = tm.bert.embeddings.word_embeddings.weight
    assert tm.cls.decoder_weight is word
    assert sum(p is word for p in tm.parameters()) == 1
    assert "cls.decoder_weight" not in tm.state_dict()
    leaf = word._value
    tm.set_state_dict({"bert.embeddings.word_embeddings.weight":
                       np.ones(word.shape, np.float32)})
    assert word._value is leaf and (tm.cls.decoder_weight.numpy() == 1).all()


@pytest.mark.parametrize("with_mask", [False, True])
def test_logits_and_pooled_match_jax(with_mask):
    """``forward``: the MLM logits (the tied decoder) and the next-sentence
    scores, with token types; with a padding mask (dense attention)."""
    jm, tm = _models()
    ids, _, types = _batch()
    mask = np.ones((B, S), np.int64)
    mask[1, 40:] = 0
    args = {"token_type_ids": types}
    if with_mask:
        args["attention_mask"] = mask
    jlog, jnsp = jm(jp.to_tensor(ids), **{
        k: jp.to_tensor(v) for k, v in args.items()})
    tlog, tnsp = tm(tp.to_tensor(ids), **{
        k: tp.to_tensor(v) for k, v in args.items()})
    np.testing.assert_allclose(_np(tlog), _np(jlog), rtol=RTOL, atol=1e-6)
    np.testing.assert_allclose(_np(tnsp), _np(jnsp), rtol=RTOL, atol=1e-6)
    jseq, jpool = jm.bert(jp.to_tensor(ids))
    tseq, tpool = tm.bert(tp.to_tensor(ids))
    np.testing.assert_allclose(_np(tpool), _np(jpool), rtol=RTOL, atol=1e-6)


def test_mlm_loss_and_every_gradient_match_jax():
    jm, tm = _models()
    ids, labels, _ = _batch()
    jl = jm.forward_with_mlm_loss(jp.to_tensor(ids), jp.to_tensor(labels))
    jl.backward()
    tl = tm.forward_with_mlm_loss(tp.to_tensor(ids), tp.to_tensor(labels))
    tl.backward()
    np.testing.assert_allclose(float(tl), float(jl), rtol=RTOL)
    assert tl.dtype == tp.float32 and tl.shape == []
    # the tied leaf's gradient (the sum over both uses) among them
    _assert_grads(jm, tm)


def test_criterion_matches_jax_and_the_fused_loss():
    """``BertPretrainingCriterion`` on the full logits (MLM + NSP) against
    JAX's, with every gradient; its MLM part equals
    ``forward_with_mlm_loss``."""
    jm, tm = _models()
    ids, labels, types = _batch(seed=1)
    nsp = np.array([0, 1], np.int64)
    res = {}
    for P, m, crit in ((jp, jm, jbert.BertPretrainingCriterion(1024)),
                       (tp, tm, tbert.BertPretrainingCriterion(1024))):
        logits, rel = m(P.to_tensor(ids), P.to_tensor(types))
        loss = crit(logits, rel, P.to_tensor(labels), P.to_tensor(nsp))
        loss.backward()
        mlm = crit(logits, rel, P.to_tensor(labels))
        res[P] = (float(loss), float(mlm))
    np.testing.assert_allclose(res[tp], res[jp], rtol=RTOL)
    _assert_grads(jm, tm)
    fused = tm.forward_with_mlm_loss(tp.to_tensor(ids), tp.to_tensor(labels),
                                     tp.to_tensor(types))
    np.testing.assert_allclose(float(fused), res[tp][1], rtol=RTOL)


def _train(P, model, ids, labels, steps=3):
    opt = P.optimizer.AdamW(learning_rate=1e-3,
                            parameters=model.parameters())
    losses = []
    for _ in range(steps):
        loss = model.forward_with_mlm_loss(P.to_tensor(ids),
                                           P.to_tensor(labels))
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss))
    return losses, opt


def _assert_params(jm, tm):
    tparams = dict(tm.named_parameters())
    for k, p in jm.named_parameters():
        np.testing.assert_allclose(_np(tparams[k]), _np(p), rtol=0,
                                   atol=PARAM_ATOL, err_msg=k)


def test_adamw_three_steps_match_jax():
    """3 AdamW steps: the tied weight is one leaf with one update (one
    accumulator set, under the JAX parameter name)."""
    jm, tm = _models()
    ids, labels, _ = _batch()
    jl, _ = _train(jp, jm, ids, labels)
    tl, topt = _train(tp, tm, ids, labels)
    np.testing.assert_allclose(tl, jl, rtol=RTOL)
    assert tl[-1] < tl[0]
    _assert_params(jm, tm)
    word = tm.bert.embeddings.word_embeddings.weight
    keys = [k for k in topt.state_dict() if k.startswith(word.name + "_")]
    assert sorted(keys) == sorted(f"{word.name}_{a}" for a in (
        "moment1", "moment2", "beta1_pow", "beta2_pow"))


def test_parallel_train_step_three_steps_match_jax():
    """The same 3 steps through ``ParallelTrainStep`` (a Layer and a
    ``loss_fn`` returning a facade Tensor) against the JAX dygraph loop;
    ``train_state_dict`` carries the model's keys."""
    from paddle_tpu_torch.distributed import ParallelTrainStep
    jm, tm = _models()
    ids, labels, _ = _batch()
    jl, _ = _train(jp, jm, ids, labels)
    opt = tp.optimizer.AdamW(learning_rate=1e-3,
                             parameters=tm.parameters())
    step = ParallelTrainStep(
        tm, opt, lambda m, i, y: m.forward_with_mlm_loss(i, y))
    tl = [float(step(ids, labels)) for _ in range(3)]
    np.testing.assert_allclose(tl, jl, rtol=RTOL)
    _assert_params(jm, tm)
    state = step.train_state_dict()
    assert {f"model/{k}" for k in tm.state_dict()} <= set(state)
    assert state["train/step_count"] == 3


def test_auto_cast_bf16_loss_matches_jax():
    jm, tm = _models()
    ids, labels, _ = _batch(seed=2)
    with jp.amp.auto_cast(enable=True, dtype="bfloat16"):
        jl = float(jm.forward_with_mlm_loss(jp.to_tensor(ids),
                                            jp.to_tensor(labels)))
    with tp.amp.auto_cast(enable=True, dtype="bfloat16"):
        tl = tm.forward_with_mlm_loss(tp.to_tensor(ids),
                                      tp.to_tensor(labels))
    assert tl.dtype == tp.float32
    np.testing.assert_allclose(float(tl), jl, rtol=BF16_LOSS_RTOL)
    f32 = float(tm.forward_with_mlm_loss(tp.to_tensor(ids),
                                         tp.to_tensor(labels)))
    assert f32 != float(tl)


def test_save_load_keeps_the_tie_and_spike_damping(tmp_path):
    """``paddle.save``/``load`` of the state and ``set_state_dict`` into a
    fresh model: the same loss, the tie held; a JAX bf16 state loads;
    ``loss_spike_damping`` compresses a loss above 15 as JAX's does."""
    _, tm = _models()
    ids, labels, _ = _batch()
    path = str(tmp_path / "bert.pdparams")
    tp.save(tm.state_dict(), path)
    fresh = tbert.BertForPretraining(tbert.BertModel(
        tbert.bert_tiny_config()))
    fresh.set_state_dict(tp.load(path))
    assert fresh.cls.decoder_weight is \
        fresh.bert.embeddings.word_embeddings.weight
    a = float(tm.forward_with_mlm_loss(tp.to_tensor(ids),
                                       tp.to_tensor(labels)))
    b = float(fresh.forward_with_mlm_loss(tp.to_tensor(ids),
                                          tp.to_tensor(labels)))
    assert a == b
    jm, _ = _models()
    jm.bfloat16()
    half = tbert.BertForPretraining(tbert.BertModel(
        tbert.bert_tiny_config()))
    half.set_state_dict({k: np.asarray(v._value)
                         for k, v in jm.state_dict().items()})
    np.testing.assert_array_equal(
        half.cls.decoder_weight.numpy(),
        np.asarray(jm.cls.decoder_weight._value, np.float32))
    with tp.no_grad():        # one class's logit far above the rest
        tm.cls.decoder_bias._value[0] = 40.0
    big = tm.forward_with_mlm_loss(tp.to_tensor(ids), tp.to_tensor(labels))
    damped = tm.forward_with_mlm_loss(tp.to_tensor(ids),
                                      tp.to_tensor(labels),
                                      loss_spike_damping=True)
    assert float(big) > 15
    np.testing.assert_allclose(float(damped),
                               15 + np.log1p(float(big) - 15), rtol=1e-6)
