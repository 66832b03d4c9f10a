"""The port's serving path against the JAX package's.

Page-pool bookkeeping (ports of the JAX pool tests), the pure step
functions on the same numpy weights and pools, and the whole
engine + scheduler greedy loop token for token, with and without the
flash prefill path. Everything runs on the CPU: the JAX paged and flash
kernels in interpret mode, the port's wrappers through their plain
versions.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import gpt as jgpt
from paddle_tpu.serving import ContinuousBatchingScheduler as JScheduler
from paddle_tpu.serving import ServingEngine as JEngine
from paddle_tpu.serving import engine as jengine
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.models.convert import gpt_state_dict_from_numpy
from paddle_tpu_torch.serving import (ContinuousBatchingScheduler,
                                      EngineShapeError, PagePool,
                                      PagePoolError, PagePoolOOM,
                                      ServingEngine, decode_step_fn,
                                      default_prefill_buckets, prefill_fn)


def _models(seed=0):
    paddle.seed(seed)
    cfg = jgpt.gpt_tiny_config()
    jmodel = jgpt.GPTForPretraining(jgpt.GPTModel(cfg))
    state = {k: np.asarray(v._value) for k, v in jmodel.state_dict().items()}
    tmodel = tgpt.GPTForPretraining(tgpt.GPTModel(tgpt.gpt_tiny_config(),
                                                  device="cpu"))
    tmodel.load_state_dict(gpt_state_dict_from_numpy(state), strict=True)
    return jmodel, tmodel, cfg


def _prompts(vocab, lens, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, (s,)).astype(np.int32) for s in lens]


def _pool(**kw):
    return PagePool(device="cpu", **kw)


# ---------------------------------------------------------------- pool

def test_pool_alloc_extend_free_roundtrip():
    pool = _pool(num_pages=9, page_size=4, num_layers=2, num_kv_heads=2,
                 head_dim=8)
    pages = pool.alloc("a", 5)
    assert len(pages) == 2 and PagePool.SINK not in pages
    assert pool.pages_in_use == 2 and pool.seq_len("a") == 5
    pool.extend("a", 3)
    assert len(pool.table("a")) == 2
    pool.extend("a", 1)
    assert len(pool.table("a")) == 3
    pool.alloc("b", 4)
    assert pool.pages_in_use == 4
    pool.free("a")
    assert pool.pages_in_use == 1 and pool.free_pages == 7
    again = pool.alloc("c", 12)
    assert set(again) & set(pages)
    assert tuple(pool.k_pages.shape) == (2, 9, 4, 2, 8)


def test_pool_oob_and_oom():
    pool = _pool(num_pages=4, page_size=4, num_layers=1, num_kv_heads=1,
                 head_dim=4)
    pool.alloc("a", 4)
    with pytest.raises(PagePoolError):
        pool.alloc("a", 2)
    with pytest.raises(PagePoolError):
        pool.extend("zzz")
    with pytest.raises(PagePoolError):
        pool.free("zzz")
    with pytest.raises(PagePoolError):
        pool.alloc("big", 1000)
    with pytest.raises(PagePoolOOM):
        pool.alloc("b", 12)
    pool.alloc("b", 8)
    with pytest.raises(PagePoolOOM):
        pool.extend("b", 1)
    with pytest.raises(ValueError):
        _pool(num_pages=1, page_size=4, num_layers=1, num_kv_heads=1,
              head_dim=4)


def test_pool_fragmentation_accounting():
    pool = _pool(num_pages=17, page_size=8, num_layers=1, num_kv_heads=1,
                 head_dim=4)
    pool.alloc("a", 9)
    pool.alloc("b", 8)
    st = pool.stats()
    assert st["pages_in_use"] == 3 and st["live_tokens"] == 17
    assert st["utilization"] == round(17 / 24, 4)
    assert st["internal_fragmentation"] == round(1 - 17 / 24, 4)
    assert st["pool_bytes"] == 2 * 17 * 8 * 4 * 4
    pool.free("a")
    pool.free("b")
    assert pool.stats()["internal_fragmentation"] == 0.0


def test_pool_table_and_prefill_rows():
    pool = _pool(num_pages=9, page_size=4, num_layers=1, num_kv_heads=1,
                 head_dim=4, max_seq_len=16)
    pool.alloc("a", 6)
    tbl = pool.table_array(["a", None])
    assert tbl.shape == (2, 4) and tbl.dtype == np.int32
    assert list(tbl[0, :2]) == pool.table("a")
    assert (tbl[0, 2:] == PagePool.SINK).all()
    assert (tbl[1] == PagePool.SINK).all()
    assert list(pool.lens_array(["a", None])) == [6, 0]
    rows = pool.prefill_rows("a", 8)
    p0, p1 = pool.table("a")
    assert rows.dtype == np.int32
    assert list(rows[:6]) == [p0 * 4, p0 * 4 + 1, p0 * 4 + 2, p0 * 4 + 3,
                              p1 * 4, p1 * 4 + 1]
    assert (rows[6:] < 4).all()


def test_pool_refcounts_and_write_barrier():
    pool = _pool(num_pages=6, page_size=4, num_layers=1, num_kv_heads=1,
                 head_dim=4)
    pages = pool.alloc("a", 3)
    pool.incref(pages)
    assert pool.page_ref(pages[0]) == 2
    with pytest.raises(PagePoolError, match="shared"):
        pool.extend("a", 1)            # would write the shared page
    with pytest.raises(PagePoolError):
        pool.incref([PagePool.SINK])
    pool.free("a")
    assert pool.pages_in_use == 1      # still held by the extra reference
    assert pool.decref(pages) == pages
    assert pool.pages_in_use == 0


# ------------------------------------------------------ step functions

def _np_params(jmodel):
    st = jgpt.stack_gpt_weights(jmodel)
    return {"blocks": {k: np.asarray(v) for k, v in st["blocks"].items()},
            **{k: np.asarray(st[k]) for k in ("wte", "wpe", "lnf_w",
                                              "lnf_b")}}


def _to_jax(params):
    return jax.tree_util.tree_map(jnp.asarray, params)


def _to_torch(params):
    return {"blocks": {k: torch.tensor(v) for k, v in
                       params["blocks"].items()},
            **{k: torch.tensor(params[k]) for k in ("wte", "wpe", "lnf_w",
                                                    "lnf_b")}}


def test_decode_step_fn_matches_jax():
    jmodel, _, cfg = _models(seed=1)
    params = _np_params(jmodel)
    rng = np.random.default_rng(1)
    L, P, ps, nh, d = cfg.num_layers, 12, 8, cfg.num_heads, cfg.head_dim
    kp = rng.standard_normal((L, P, ps, nh, d)).astype(np.float32)
    vp = rng.standard_normal((L, P, ps, nh, d)).astype(np.float32)
    # three live sequences (ragged, one about to open a page) + an idle slot
    pt = np.array([[1, 2, 3, 0], [4, 0, 0, 0], [5, 6, 0, 0], [0, 0, 0, 0]],
                  np.int32)
    lens = np.array([19, 8, 9, 0], np.int32)
    pos = np.maximum(lens - 1, 0).astype(np.int32)
    toks = rng.integers(0, cfg.vocab_size, (4,)).astype(np.int32)
    kw = dict(eps=cfg.layer_norm_epsilon, temperature=0.0, top_k=0)
    jk, jv, jt = jengine.decode_step_fn(
        _to_jax(params), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(toks),
        jnp.asarray(pos), jnp.asarray(pt), jnp.asarray(lens),
        jax.random.key(0), use_kernel=True, **kw)
    tk, tv = torch.tensor(kp), torch.tensor(vp)
    tt = decode_step_fn(_to_torch(params), tk, tv, torch.tensor(toks),
                        torch.tensor(pos), torch.tensor(pt),
                        torch.tensor(lens), None, **kw)
    live = slice(1, None)   # page 0 (the sink) takes the idle slot's writes
    np.testing.assert_allclose(tk.numpy()[:, live], np.asarray(jk)[:, live],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tv.numpy()[:, live], np.asarray(jv)[:, live],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(tt.numpy()[:3], np.asarray(jt)[:3])


@pytest.mark.parametrize("n,bucket,use_flash", [(13, 16, False),
                                                (70, 128, True)])
def test_prefill_fn_matches_jax(n, bucket, use_flash):
    jmodel, _, cfg = _models(seed=2)
    params = _np_params(jmodel)
    pool = _pool(num_pages=20, page_size=8, num_layers=cfg.num_layers,
                 num_kv_heads=cfg.num_heads, head_dim=cfg.head_dim)
    pool.alloc("s", n)
    rows = pool.prefill_rows("s", bucket)
    ids = np.zeros((1, bucket), np.int32)
    ids[0, :n] = _prompts(cfg.vocab_size, (n,), seed=2)[0]
    shape = tuple(pool.k_pages.shape)
    kw = dict(eps=cfg.layer_norm_epsilon, temperature=0.0, top_k=0,
              use_flash=use_flash)
    jk, jv, jt = jengine.prefill_fn(
        _to_jax(params), jnp.zeros(shape), jnp.zeros(shape),
        jnp.asarray(ids), jnp.asarray(np.int32(n)), jnp.asarray(rows),
        jax.random.key(0), **kw)
    tt = prefill_fn(_to_torch(params), pool.k_pages, pool.v_pages,
                    torch.tensor(ids), n, torch.tensor(rows), None, **kw)
    np.testing.assert_allclose(pool.k_pages.numpy()[:, 1:],
                               np.asarray(jk)[:, 1:], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(pool.v_pages.numpy()[:, 1:],
                               np.asarray(jv)[:, 1:], rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))


def test_default_prefill_buckets_match_jax():
    for ps, msl in ((8, 128), (64, 1024), (16, 100)):
        assert default_prefill_buckets(ps, msl) == \
            jengine.default_prefill_buckets(ps, msl)


# --------------------------------------------------------- end to end

def _serve(engine, sched_cls, prompts, max_new):
    sched = sched_cls(engine)
    reqs = [sched.submit(p, max_new_tokens=max_new) for p in prompts]
    sched.run()
    assert all(r.state == "finished" for r in reqs)
    return [r.output_ids for r in reqs], sched


@pytest.mark.parametrize("lens,use_flash", [((5, 11, 8, 3), None),
                                            ((70, 33, 100), True)])
def test_scheduler_matches_jax_engine(lens, use_flash):
    """Greedy continuous batching: the port's engine + scheduler give the
    JAX engine's tokens, token for token, with no leaked pages. With
    ``use_flash=True`` the 64- and 128-token prefill buckets take the
    flash path on both sides."""
    jmodel, tmodel, cfg = _models(seed=3)
    prompts = _prompts(cfg.vocab_size, lens, seed=3)
    jeng = JEngine(jmodel, page_size=8, decode_buckets=(1, 2, 4),
                   autofuse=False, use_flash=use_flash)
    teng = ServingEngine(tmodel, page_size=8, decode_buckets=(1, 2, 4),
                         use_flash=use_flash, device="cpu")
    assert teng.prefill_buckets == jeng.prefill_buckets
    if use_flash:
        assert teng.status()["flash_prefill_buckets"] == [64, 128]
    ref, _ = _serve(jeng, JScheduler, prompts, 6)
    out, sched = _serve(teng, ContinuousBatchingScheduler, prompts, 6)
    for a, b, n in zip(out, ref, lens):
        np.testing.assert_array_equal(a, b, err_msg=f"prompt len {n}")
    assert teng.pool.pages_in_use == 0
    assert sched.steps > 0 and len(sched.step_times) == sched.steps


def test_scheduler_staggered_arrivals_and_summary():
    _, tmodel, cfg = _models(seed=4)
    eng = ServingEngine(tmodel, page_size=8, decode_buckets=(1, 2),
                        device="cpu")
    sched = ContinuousBatchingScheduler(eng)
    p1, p2, p3 = _prompts(cfg.vocab_size, (4, 9, 6), seed=4)
    r1 = sched.submit(p1, max_new_tokens=8)
    sched.step()
    sched.step()
    r2 = sched.submit(p2, max_new_tokens=3)
    sched.step()
    r3 = sched.submit(p3, max_new_tokens=4)
    sched.run()
    solo = ServingEngine(tmodel, page_size=8, decode_buckets=(1,),
                         device="cpu")
    for p, r, n in [(p1, r1, 8), (p2, r2, 3), (p3, r3, 4)]:
        (ref,), _ = _serve(solo, ContinuousBatchingScheduler, [p], n)
        np.testing.assert_array_equal(r.output_ids, ref)
    s = r2.summary()
    assert s["state"] == "finished" and s["new_tokens"] == 3
    assert s["queue_wait_s"] >= 0 and s["ttft_s"] > 0
    assert s["per_token_s"]["n"] == 2
    assert eng.pool.pages_in_use == 0


def test_scheduler_page_pressure_queues_requests():
    _, tmodel, cfg = _models(seed=5)
    # sink + 4 pages of 8 tokens: room for ONE (prompt 17 + 7)
    eng = ServingEngine(tmodel, page_size=8, num_pages=5, max_seq_len=32,
                        decode_buckets=(1, 2), device="cpu")
    sched = ContinuousBatchingScheduler(eng)
    pa, pb = _prompts(cfg.vocab_size, (17, 18), seed=5)
    ra = sched.submit(pa, max_new_tokens=7)
    rb = sched.submit(pb, max_new_tokens=7)
    sched.step()
    assert ra.state == "running" and rb.state == "queued"
    sched.run()
    assert ra.state == rb.state == "finished"
    assert len(ra.tokens) == len(rb.tokens) == 7
    assert eng.pool.pages_in_use == 0


def test_scheduler_rejects_and_eos():
    _, tmodel, cfg = _models(seed=6)
    eng = ServingEngine(tmodel, page_size=8, max_seq_len=32, num_pages=3,
                        decode_buckets=(1, 2), device="cpu")
    sched = ContinuousBatchingScheduler(eng, max_queue=2)
    assert sched.submit(np.zeros(30, np.int32), 10).reject_reason \
        == "too_long"
    assert sched.submit(np.zeros(8, np.int32), 0).reject_reason \
        == "max_new<1"
    assert sched.submit(np.zeros(20, np.int32), 4).reject_reason \
        == "pool_too_small"               # 3 pages needed, 2 in the pool
    (p,) = _prompts(cfg.vocab_size, (6,), seed=6)
    probe = sched.submit(p, max_new_tokens=1)
    sched.submit(p, max_new_tokens=1)
    full = sched.submit(p, max_new_tokens=1)
    assert full.reject_reason == "retry_after"
    assert 0 < full.summary()["retry_after_s"] <= 30.0
    sched.run()
    eos = probe.tokens[0]
    r = sched.submit(p, max_new_tokens=10, eos_id=eos)
    sched.run()
    assert r.state == "finished" and r.tokens == [eos]
    assert len(sched.rejected) == 4


def test_sampling_engine_is_seeded():
    """With temperature the engine draws from its own seeded generator:
    one seed gives one stream of tokens, another seed another."""
    _, tmodel, cfg = _models(seed=8)
    prompts = _prompts(cfg.vocab_size, (7, 12), seed=8)

    def serve(seed):
        eng = ServingEngine(tmodel, page_size=8, decode_buckets=(1, 2),
                            temperature=1.5, top_k=50, seed=seed,
                            device="cpu")
        out, _ = _serve(eng, ContinuousBatchingScheduler, prompts, 12)
        return np.concatenate(out)

    a, b, c = serve(0), serve(0), serve(1)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)
    assert ((a >= 0) & (a < cfg.vocab_size)).all()


def test_engine_shape_errors_and_unported_modes():
    _, tmodel, _ = _models(seed=7)
    eng = ServingEngine(tmodel, page_size=8, decode_buckets=(1, 2),
                        device="cpu")
    with pytest.raises(EngineShapeError):
        eng.decode_bucket(3)
    with pytest.raises(EngineShapeError):
        eng.prefill_bucket(10_000)
    with pytest.raises(EngineShapeError):
        eng.prefill("x", np.zeros(128, np.int32))   # no room to decode
    with pytest.raises(EngineShapeError):
        eng.decode([], bucket=3)
    with pytest.raises(ValueError, match="token ids"):
        eng.prefill("y", np.array([3, 256], np.int32))   # vocab is 256
    assert eng.pool.live_sequences == 0
    assert eng.weight_bytes() == sum(
        p.numel() * 4 for p in tmodel.parameters())
    for kw in (dict(quantize="int8"), dict(prefill_chunk=16),
               dict(prefix_cache=True), dict(disaggregated=True),
               dict(autofuse=True)):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            ServingEngine(tmodel, device="cpu", **kw)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ServingEngine.from_checkpoint("gpt.pdparams", tmodel.config)
