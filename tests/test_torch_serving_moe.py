"""The port's ERNIE-MoE model and MoE serving engine against the JAX
package's, on the CPU.

The JAX model's weights (the JAX MoE serving test's tiny config) are
carried across with ``ernie_moe_state_dict_from_numpy``; the JAX engine is
built with ``autofuse=False, aot=False`` (its auto-fusion rewrite fails
closed under the installed jax) and runs its Pallas kernels in interpret
mode, the port's wrappers their plain versions. The JAX eager generator
compiles every op anew for each sequence length, so most of its checks run
teacher-forced: one forward of the JAX model over prompt + generated
tokens under the causal mask, whose argmax at each position is the token
the generator emits there (no token is capacity-dropped at this capacity
factor, so a position sees only its prefix).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import ernie as jernie
from paddle_tpu.serving import ContinuousBatchingScheduler as JScheduler
from paddle_tpu.serving import MoEServingEngine as JEngine
from paddle_tpu.serving import moe_engine as jmoe
from paddle_tpu_torch.kernels import moe_dispatch as tmd
from paddle_tpu_torch.models import ernie as ternie
from paddle_tpu_torch.models.convert import ernie_moe_state_dict_from_numpy
from paddle_tpu_torch.serving import (ContinuousBatchingScheduler,
                                      EngineShapeError, MoEServingEngine,
                                      PagePool, moe_decode_step_fn,
                                      moe_prefill_fn)

MAX_NEW = 5


def _tiny_cfg(mod, **kw):
    """tests/test_serving_moe.py's config, from either package."""
    base = dict(num_hidden_layers=2, hidden_size=32,
                num_attention_heads=2, intermediate_size=64,
                num_experts=4, capacity_factor=100.0,
                max_position_embeddings=64)
    base.update(kw)
    return mod.ernie_moe_tiny_config(**base)


def _jax_state(jmodel):
    return {k: np.asarray(v._value) for k, v in jmodel.state_dict().items()}


@pytest.fixture(scope="module")
def models():
    paddle.seed(0)
    jmodel = jernie.ErnieMoeForPretraining(
        jernie.ErnieMoeModel(_tiny_cfg(jernie)))
    jmodel.eval()
    tmodel = ternie.ErnieMoeForPretraining(
        ternie.ErnieMoeModel(_tiny_cfg(ternie), device="cpu"))
    tmodel.load_state_dict(ernie_moe_state_dict_from_numpy(
        _jax_state(jmodel)), strict=True)
    return jmodel, tmodel.eval()


@pytest.fixture(scope="module")
def engines(models):
    jmodel, tmodel = models
    kw = dict(page_size=8, decode_buckets=(1, 2, 4))
    return (JEngine(jmodel, autofuse=False, aot=False, **kw),
            MoEServingEngine(tmodel, device="cpu", **kw))


def _prompts(lens, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 1024, (n,)).astype(np.int32) for n in lens]


def _greedy(eng, sid, prompt, n=MAX_NEW):
    toks = [eng.prefill(sid, prompt)]
    for _ in range(n - 1):
        eng.pool.extend(sid, 1)
        toks.append(eng.decode([sid])[0])
    eng.release(sid)
    return toks


def _jax_argmax_teacher_forced(jmodel, prompt, tokens):
    """The JAX model's argmax at each generated position, fed prompt +
    tokens under the causal mask (what ErnieMoeGenerator emits)."""
    ids = np.concatenate([prompt, tokens[:-1]]).astype(np.int64)[None]
    S = ids.shape[1]
    causal = np.tril(np.ones((S, S), bool))[None, None]
    logits = np.asarray(jmodel(paddle.to_tensor(ids),
                               attention_mask=paddle.to_tensor(causal))
                        .numpy())[0]
    return list(np.argmax(logits[len(prompt) - 1:], -1))


# --------------------------------------------------------------- model

def test_state_dict_carries_across(models):
    jmodel, tmodel = models
    state = _jax_state(jmodel)
    conv = ernie_moe_state_dict_from_numpy(state)
    assert set(conv) == set(tmodel.state_dict())
    assert tmodel.decoder_weight is \
        tmodel.ernie.embeddings.word_embeddings.weight
    for name, arr in state.items():
        np.testing.assert_array_equal(tmodel.state_dict()[name].numpy(), arr)
    with pytest.raises(ValueError, match="missing"):
        ernie_moe_state_dict_from_numpy(
            {k: v for k, v in state.items() if "ln2" not in k})
    with pytest.raises(ValueError, match="shape"):
        ernie_moe_state_dict_from_numpy(
            {**state, "transform.bias": np.zeros(3, np.float32)})
    with pytest.raises(ValueError, match="not an ErnieMoeForPretraining"):
        ernie_moe_state_dict_from_numpy({"x": np.zeros(1)})


@pytest.mark.parametrize("mask", ["none", "padding", "causal"])
def test_eager_logits_match_jax(models, mask):
    jmodel, tmodel = models
    rng = np.random.default_rng(7)
    ids = rng.integers(0, 1024, (2, 11))
    types = rng.integers(0, 2, (2, 11))
    masks = {"none": None,
             "padding": np.array([[1] * 11, [1] * 7 + [0] * 4], np.int64),
             "causal": np.tril(np.ones((11, 11), bool))[None, None]}
    m = masks[mask]
    want = np.asarray(jmodel(
        paddle.to_tensor(ids), paddle.to_tensor(types),
        None if m is None else paddle.to_tensor(m)).numpy())
    with torch.no_grad():
        got = tmodel(torch.from_numpy(ids), torch.from_numpy(types),
                     None if m is None else torch.from_numpy(m)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_stacked_weights_shapes_and_kinds(models):
    jmodel, tmodel = models
    jp, jk = jernie.stack_ernie_moe_weights(jmodel)
    tp, tk = ternie.stack_ernie_moe_weights(tmodel)
    assert tk == jk == ("dense", "moe")
    jflat = jax.tree_util.tree_leaves_with_path(jp)
    tflat = jax.tree_util.tree_leaves_with_path(
        jax.tree_util.tree_map(lambda t: t.numpy(), tp,
                               is_leaf=lambda t: isinstance(t,
                                                            torch.Tensor)))
    assert [p for p, _ in jflat] == [p for p, _ in tflat]
    for (path, a), (_, b) in zip(jflat, tflat):
        np.testing.assert_array_equal(np.asarray(a), b, err_msg=str(path))
    assert tp["layers"][1]["ew1"].shape == (4, 32, 64)
    assert "gate_w" not in tp["layers"][0]
    with pytest.raises(TypeError):
        ternie.stack_ernie_moe_weights(tmodel.ernie)


# ------------------------------------------------------- step functions

def _pool_arrays(seed, L=2, P=10, ps=8, nh=2, d=16):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((L, P, ps, nh, d)).astype(np.float32),
            rng.standard_normal((L, P, ps, nh, d)).astype(np.float32))


def _step_kw(cfg):
    return dict(kinds=("dense", "moe"), eps=cfg.layer_norm_eps,
                top_k=cfg.top_k, temperature=0.0, topk_sample=0)


@pytest.mark.parametrize("fused", [True, False])
def test_step_functions_match_jax(models, fused):
    """``moe_prefill_fn`` then ``moe_decode_step_fn`` on one pool, the port
    against JAX: the pages written and the tokens."""
    jmodel, tmodel = models
    cfg = tmodel.config
    jparams, _ = jernie.stack_ernie_moe_weights(jmodel)
    tparams, _ = ternie.stack_ernie_moe_weights(tmodel)
    kp, vp = _pool_arrays(3)
    kw = _step_kw(cfg)
    # prefill: 11 tokens padded to 16, rows into pages 1-2, pads to the sink
    ids = np.zeros((1, 16), np.int32)
    ids[0, :11] = _prompts([11], 4)[0]
    rows = np.array(list(range(8, 19)) + [0] * 5, np.int32)
    jk, jv, jt = jmoe.moe_prefill_fn(
        jparams, jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(ids),
        jnp.asarray(np.int32(11)), jnp.asarray(rows), jax.random.key(0),
        use_fused_moe=fused, **kw)
    tk, tv = torch.tensor(kp), torch.tensor(vp)
    tt = moe_prefill_fn(tparams, tk, tv, torch.from_numpy(ids), 11,
                        torch.from_numpy(rows), None, use_fused_moe=fused,
                        **kw)
    live = slice(1, None)           # page 0 (the sink) takes the pads
    np.testing.assert_allclose(tk.numpy()[:, live], np.asarray(jk)[:, live],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tv.numpy()[:, live], np.asarray(jv)[:, live],
                               rtol=1e-5, atol=1e-5)
    assert int(tt[0]) == int(jt[0])
    # decode: three ragged sequences and an idle slot on the same pool
    pt = np.array([[1, 2, 0], [3, 4, 5], [6, 0, 0], [0, 0, 0]], np.int32)
    lens = np.array([12, 17, 3, 0], np.int32)
    pos = np.maximum(lens - 1, 0).astype(np.int32)
    toks = np.array([int(tt[0]), 5, 900, 0], np.int32)
    jk, jv, jt = jmoe.moe_decode_step_fn(
        jparams, jk, jv, jnp.asarray(toks), jnp.asarray(pos),
        jnp.asarray(pt), jnp.asarray(lens), jax.random.key(0),
        use_kernel=True, use_fused_moe=fused, **kw)
    tt = moe_decode_step_fn(tparams, tk, tv, torch.from_numpy(toks),
                            torch.from_numpy(pos), torch.from_numpy(pt),
                            torch.from_numpy(lens), None,
                            use_fused_moe=fused, **kw)
    np.testing.assert_allclose(tk.numpy()[:, live], np.asarray(jk)[:, live],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tv.numpy()[:, live], np.asarray(jv)[:, live],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(tt.numpy()[:3], np.asarray(jt)[:3])


# --------------------------------------------------------------- engine

def test_engine_tokens_match_jax_engine_and_generator(models, engines):
    """Greedy tokens of the port's engine equal the JAX engine's, the
    port's eager generator's and the JAX generator's (teacher-forced for
    every prompt; the JAX generator itself for the first token of the
    first, at a length already compiled)."""
    jmodel, tmodel = models
    jeng, teng = engines
    gen = ternie.ErnieMoeGenerator(tmodel)
    prompts = _prompts((7, 3, 12), 0)
    for i, prompt in enumerate(prompts):
        got = _greedy(teng, 100 + i, prompt)
        assert got == _greedy(jeng, 100 + i, prompt), len(prompt)
        assert got == list(gen(prompt, MAX_NEW)[0]), len(prompt)
        assert got == _jax_argmax_teacher_forced(jmodel, prompt, got)
    assert teng.pool.pages_in_use == 0
    assert list(jernie.ErnieMoeGenerator(jmodel)(prompts[0], 1)[0]) == \
        _greedy(teng, 7, prompts[0], 1)


def test_scheduler_batched_parity(models, engines):
    """Continuous batching over four ragged concurrent requests gives each
    the tokens of sequential greedy generation, and the JAX scheduler's."""
    jmodel, tmodel = models
    jeng, teng = engines
    prompts = _prompts((5, 9, 3, 12), 1)
    outs = []
    for eng, Sched in ((teng, ContinuousBatchingScheduler),
                       (jeng, JScheduler)):
        sched = Sched(eng)
        reqs = [sched.submit(p, max_new_tokens=MAX_NEW) for p in prompts]
        sched.run()
        assert all(r.state == "finished" for r in reqs)
        assert eng.pool.pages_in_use == 0
        outs.append([list(r.tokens) for r in reqs])
    assert outs[0] == outs[1]
    gen = ternie.ErnieMoeGenerator(tmodel)
    for p, toks in zip(prompts, outs[0]):
        assert toks == list(gen(p, MAX_NEW)[0])


def test_unfused_engine_matches_fused(models):
    _, tmodel = models
    prompt = _prompts((6,), 2)[0]

    def run(fused):
        eng = MoEServingEngine(tmodel, page_size=8, decode_buckets=(1, 2),
                               use_fused_moe=fused, device="cpu")
        return _greedy(eng, 0, prompt, 4)

    n0 = tmd.dispatch_launches
    assert run(True) == run(False)
    assert tmd.dispatch_launches == n0      # no kernel runs on the CPU


def test_engine_surface_and_errors(models, engines):
    _, tmodel = models
    _, eng = engines
    st = eng.status()
    assert st["model"] == "ernie_moe" and st["moe_layers"] == 1
    assert st["fused_moe_dispatch"] is True and st["autofuse"] is False
    assert st["pool"]["num_pages"] == eng.pool.num_pages
    assert isinstance(eng.pool, PagePool)
    assert eng.prefill_signatures() == {(1, sb)
                                        for sb in eng.prefill_buckets}
    n_params = sum(p.numel() for p in tmodel.parameters())
    # the tied word embedding is stacked twice (wte and the head's dw)
    assert eng.weight_bytes() == 4 * (n_params + 1024 * 32 - 2 * 32)
    with pytest.raises(EngineShapeError):
        eng.decode_bucket(5)
    with pytest.raises(EngineShapeError):
        eng.prefill_bucket(65)
    with pytest.raises(EngineShapeError):
        eng.prefill(0, np.zeros(64, np.int32))   # no room to decode
    with pytest.raises(EngineShapeError):
        eng.decode([0, 1, 2], bucket=3)          # not a bucket
    with pytest.raises(ValueError):
        eng.prefill(0, np.array([1, 5000], np.int32))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        MoEServingEngine(tmodel, autofuse=True, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        MoEServingEngine.from_checkpoint("x", tmodel.config)
    with pytest.raises(TypeError):
        MoEServingEngine(tmodel.ernie, device="cpu")
    with pytest.raises(ValueError, match="position table"):
        MoEServingEngine(tmodel, max_seq_len=100, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tmodel.train()(torch.zeros(1, 3, dtype=torch.long))
    tmodel.eval()
