"""BERT on the static path: ``bench_bert``'s build (``bench.py:534-549``) in
both packages, on the CPU.

``BertForPretraining(BertModel(bert_tiny_config()))`` (2 layers, hidden
64, 2 heads of 32, V = 1024, dropout 0), B = 2, S = 64, is built under
``enable_static`` in each package, the JAX model's weights carried into
the port's with ``set_state_dict``; ``forward_with_mlm_loss`` and
``AdamW(1e-4).minimize(loss)`` record the step, the Executors run it on
the same numpy batch.

- The recorded ops, in order, are the JAX program's. One difference,
  under ``auto_cast`` only: where a residual add meets a bf16 and an f32
  operand the port's dispatch records the promotion as a ``cast`` op
  (``ops._dispatch.maybe_cast_pair``) and JAX's ``add`` promotes inside.
- f32, 3 AdamW runs: losses rtol 1e-5, parameters atol 2e-5.
- ``auto_cast(bfloat16)`` at record time, runs outside it: every node's
  output dtype is the JAX node's (bf16 after the white-list ops), and the
  loss to 1e-4 relative (the tolerance ``test_torch_bert.py`` gives bf16).
- The port's static step against the port's ``ParallelTrainStep`` (eager
  on the CPU) from the same weights, batch and dropout draws (hidden
  dropout 0.1): 3 runs, every loss and every parameter the program trains
  bit for bit, in f32 and under ``auto_cast(bfloat16)``. The parameters
  the MLM loss does not read (the pooler, the next-sentence head, the
  token-type embedding) are no parameters of the program, as in the JAX
  Executor; ``ParallelTrainStep``'s AdamW decays them.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu_torch as tp
from paddle_tpu.models import bert as jbert
from paddle_tpu_torch.framework import place as tplace
from paddle_tpu_torch.models import bert as tbert

B, S = 2, 64
RTOL = 1e-5
PARAM_ATOL = 2e-5
BF16_LOSS_RTOL = 1e-4
RUNS = 3


@pytest.fixture(autouse=True)
def _cpu_place():
    prev = tplace._current_place
    tp.set_device("cpu")
    yield
    tplace._current_place = prev
    jp.static.disable_static()
    tp.static.disable_static()


def _batch(seed=0, ignore=0.3):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 1024, (B, S)).astype(np.int64)
    labels = rng.integers(0, 1024, (B, S)).astype(np.int64)
    labels[rng.random((B, S)) < ignore] = -100
    return ids, labels


def _build(paddle, bert, bf16, state=None, seed=0, **kw):
    """bench_bert's build in ``paddle`` (the JAX package or the port);
    ``state`` (numpy) loaded into the model. Returns the program, the
    loss, the model and the first linear's output variable."""
    static = paddle.static
    paddle.seed(seed)
    static.enable_static()
    main = static.Program()
    seen = []
    try:
        with static.program_guard(main):
            with paddle.amp.auto_cast(enable=bf16, dtype="bfloat16"):
                ids = static.data("ids", [B, S], "int64")
                labels = static.data("labels", [B, S], "int64")
                model = bert.BertForPretraining(bert.BertModel(
                    bert.bert_tiny_config(**kw)))
                if state is not None:
                    model.set_state_dict(state)
                lin = model.bert.encoder.layers[0].self_attn.q_proj
                lin.register_forward_post_hook(
                    lambda layer, inputs, out: seen.append(out))
                loss = model.forward_with_mlm_loss(ids, labels)
                paddle.optimizer.AdamW(
                    learning_rate=1e-4,
                    parameters=model.parameters()).minimize(loss)
    finally:
        static.disable_static()
    return main, loss, model, seen[0]


def _pair(bf16):
    jmain, jloss, jm, jq = _build(jp, jbert, bf16)
    state = {k: np.asarray(v._value) for k, v in jm.state_dict().items()}
    tmain, tloss, tm, tq = _build(tp, tbert, bf16, state)
    assert list(state) == list(tm.state_dict())
    return (jmain, jloss, jm, jq), (tmain, tloss, tm, tq)


def _run(paddle, main, fetch, n=RUNS):
    ids, labels = _batch()
    exe = paddle.static.Executor()
    paddle.static.enable_static()
    try:
        return [exe.run(main, feed={"ids": ids, "labels": labels},
                        fetch_list=fetch) for _ in range(n)]
    finally:
        paddle.static.disable_static()


def _names(main):
    return [n.name for n in main._nodes]


def _without_promotions(tmain):
    """The port's node names less the casts of mixed-dtype adds, each of
    which must sit just before its add."""
    names = _names(tmain)
    for i, n in enumerate(names):
        if n == "cast":
            assert names[i + 1] == "add", names[i:i + 2]
            node, add = tmain._nodes[i], tmain._nodes[i + 1]
            assert any(a._lazy[0] is node for a in add.args
                       if isinstance(a, tp.Tensor) and hasattr(a, "_lazy"))
    return [n for n in names if n != "cast"]


def test_recorded_ops_and_three_adamw_runs_match_jax_f32():
    (jmain, jloss, jm, _), (tmain, tloss, tm, _) = _pair(False)
    assert _names(tmain) == _names(jmain)
    assert len(tmain._nodes) == 40
    jl = [float(r[0]) for r in _run(jp, jmain, [jloss])]
    tl = [float(r[0]) for r in _run(tp, tmain, [tloss])]
    np.testing.assert_allclose(tl, jl, rtol=RTOL)
    assert tl[-1] < tl[0]
    jstate, tstate = jm.state_dict(), tm.state_dict()
    for k, v in jstate.items():
        np.testing.assert_allclose(tstate[k].numpy(), np.asarray(v._value),
                                   atol=PARAM_ATOL, err_msg=k)


def test_auto_cast_fixed_at_record_time_bf16():
    """Built under auto_cast(bf16), run outside it: the port's nodes carry
    the JAX nodes' dtypes (the white-list ops bf16), a linear's output is
    fetched in bf16, and the loss matches JAX's to 1e-4."""
    (jmain, jloss, _, jq), (tmain, tloss, _, tq) = _pair(True)
    assert _without_promotions(tmain) == _names(jmain)
    tdts = [str(n.out_avals[0].dtype).replace("torch.", "")
            for n in tmain._nodes if n.name != "cast"]
    jdts = [str(np.dtype(n.out_avals[0].dtype)) for n in jmain._nodes]
    assert tdts == jdts
    assert "bfloat16" in tdts and tq.dtype == tp.bfloat16
    (jl, jqv), = _run(jp, jmain, [jloss, jq], n=1)
    (tl, tqv), = _run(tp, tmain, [tloss, tq], n=1)
    assert str(tqv.dtype) == "bfloat16" and str(np.asarray(jqv).dtype) == \
        "bfloat16"
    np.testing.assert_allclose(float(tl), float(jl), rtol=BF16_LOSS_RTOL)


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_static_step_equals_parallel_train_step(bf16):
    from paddle_tpu_torch.distributed import ParallelTrainStep
    kw = dict(hidden_dropout_prob=0.1)
    ids, labels = _batch()
    # dygraph: ParallelTrainStep (eager on the CPU)
    tp.seed(5)
    model = tbert.BertForPretraining(tbert.BertModel(
        tbert.bert_tiny_config(**kw)))

    def loss_fn(m, i, y):
        with tp.amp.auto_cast(enable=bf16, dtype="bfloat16"):
            return m.forward_with_mlm_loss(i, y)

    step = ParallelTrainStep(model, tp.optimizer.AdamW(
        learning_rate=1e-4, parameters=model.parameters()), loss_fn)
    tp.seed(11)
    step_losses = [float(step(ids, labels)) for _ in range(RUNS)]
    step_params = {k: p.numpy() for k, p in model.named_parameters()}
    # static: the same weights (seed 5) and draws (seed 11)
    main, loss, smodel, _ = _build(tp, tbert, bf16, seed=5, **kw)
    init = {k: p.numpy().copy() for k, p in smodel.named_parameters()}
    tp.seed(11)
    losses = [float(r[0]) for r in _run(tp, main, [loss])]
    assert losses == step_losses
    untouched = []
    for k, p in smodel.named_parameters():
        if np.array_equal(p.numpy(), init[k]):
            untouched.append(k)
        else:
            np.testing.assert_array_equal(p.numpy(), step_params[k],
                                          err_msg=k)
    assert sorted(untouched) == [
        "bert.embeddings.token_type_embeddings.weight",
        "bert.pooler.dense.bias", "bert.pooler.dense.weight",
        "cls.seq_relationship.bias", "cls.seq_relationship.weight"]


def test_damping_stays_eager_only():
    """loss_spike_damping reads the loss on the host: recording it raises
    with the reason, as the model's docstring says."""
    tp.static.enable_static()
    try:
        with tp.static.program_guard(tp.static.Program()):
            ids = tp.static.data("ids", [B, S], "int64")
            labels = tp.static.data("labels", [B, S], "int64")
            model = tbert.BertForPretraining(tbert.BertModel(
                tbert.bert_tiny_config()))
            with pytest.raises(RuntimeError, match="no value until"):
                model.forward_with_mlm_loss(ids, labels,
                                            loss_spike_damping=True)
    finally:
        tp.static.disable_static()
    assert torch.is_grad_enabled()
