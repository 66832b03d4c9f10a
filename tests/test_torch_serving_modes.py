"""The port's chunked-prefill, prefix-cache and int8 serving modes against
the JAX package's.

The JAX engine is built with ``autofuse=False``: under the installed jax
its auto-fusion rewrite fails closed (every matcher raises on
``jax.core.Literal`` and leaves the program as it was), so its XLA forms,
the dense page gather of ``paged_prefill_attention`` and the
``convert -> dot -> mul(scale)`` int8 chain, are what runs either way.
In f32 they agree with the Pallas kernels the rewrite targets (the
kernels' plain versions are held against those in interpret mode in
``tests/test_torch_kernels.py``). ``aot=False`` keeps the JAX engine from
compiling every bucket up front. Everything runs on the CPU: the port's
wrappers run their plain versions on CPU tensors.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import gpt as jgpt
from paddle_tpu.quantization import export as jexport
from paddle_tpu.serving import ContinuousBatchingScheduler as JScheduler
from paddle_tpu.serving import PagePool as JPagePool
from paddle_tpu.serving import ServingEngine as JEngine
from paddle_tpu.serving import engine as jengine
from paddle_tpu.serving.prefix_cache import PrefixCache as JPrefixCache
from paddle_tpu.serving.prefix_cache import \
    make_shared_prefix_workload as jworkload
from paddle_tpu_torch.kernels import int8_matmul as tim
from paddle_tpu_torch.kernels import paged_attention as tpa
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.models.convert import gpt_state_dict_from_numpy
from paddle_tpu_torch.quantization import export as texport
from paddle_tpu_torch.serving import (ContinuousBatchingScheduler,
                                      EngineShapeError, PagePool,
                                      PrefixCache, ServingEngine,
                                      chunk_prefill_fn,
                                      decode_step_fn,
                                      make_shared_prefix_workload)

# f32 step functions: the same math, sums in other orders
STEP_TOL = dict(rtol=1e-5, atol=1e-5)


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


def _serve(engine, sched_cls, prompts, max_new, budget=None):
    sched = sched_cls(engine, prefill_token_budget=budget)
    reqs = [sched.submit(p, max_new_tokens=max_new) for p in prompts]
    sched.run()
    assert all(r.state == "finished" for r in reqs), [r.state for r in reqs]
    return sched, reqs


def _engines(jmodel, tmodel, **kw):
    return (JEngine(jmodel, autofuse=False, aot=False, **kw),
            ServingEngine(tmodel, device="cpu", **kw))


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


def _quantized_pair(params):
    return (jexport.quantize_stacked_gpt_weights(_to_jax(params)),
            texport.quantize_stacked_gpt_weights(_to_torch(params)))


# -------------------------------------------------------- quantization

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_stacked_weights_bit_equal_to_jax(dtype):
    jmodel, _, _ = _models(seed=1)
    params = _np_params(jmodel)
    jparams = jax.tree_util.tree_map(
        lambda a: jnp.asarray(a).astype(dtype), params)
    tparams = {"blocks": {k: torch.tensor(v).to(getattr(torch, dtype))
                          for k, v in params["blocks"].items()},
               **{k: torch.tensor(params[k]).to(getattr(torch, dtype))
                  for k in ("wte", "wpe", "lnf_w", "lnf_b")}}
    jq = jexport.quantize_stacked_gpt_weights(jparams)
    tq = texport.quantize_stacked_gpt_weights(tparams)
    flat_j = {**{f"blocks.{k}": v for k, v in jq["blocks"].items()},
              **{k: v for k, v in jq.items() if k != "blocks"}}
    flat_t = {**{f"blocks.{k}": v for k, v in tq["blocks"].items()},
              **{k: v for k, v in tq.items() if k != "blocks"}}
    assert flat_j.keys() == flat_t.keys()
    n_quant = 0
    for key, jv in flat_j.items():
        tv = flat_t[key]
        if isinstance(jv, dict):
            n_quant += 1
            assert tv["q"].dtype == torch.int8 and tv["s"].dtype == \
                torch.float32, key
            np.testing.assert_array_equal(tv["q"].numpy(), np.asarray(jv["q"]),
                                          err_msg=key)
            np.testing.assert_array_equal(tv["s"].numpy(), np.asarray(jv["s"]),
                                          err_msg=key)
            np.testing.assert_array_equal(
                texport.dequantize_stacked_weight(tv).numpy(),
                np.asarray(jexport.dequantize_stacked_weight(jv)),
                err_msg=key)
        else:
            assert not texport.is_quantized(tv), key
            np.testing.assert_array_equal(tv.float().numpy(),
                                          np.asarray(jv, np.float32))
    assert n_quant == 6        # wqkv, wo, w1, w2, wte, wpe


# ------------------------------------------------------ pool and trie

def _pool_script(pool_cls, cache_cls, pool_kw):
    """One scripted sequence of pool and trie operations; returns what each
    step showed, as plain data."""
    pool = pool_cls(num_pages=13, page_size=4, num_layers=1,
                    num_kv_heads=1, head_dim=4, **pool_kw)
    cache = cache_cls(pool)
    seen = []
    toks = np.arange(14, dtype=np.int32)
    pages = pool.alloc("a", 14)
    seen.append(("alloc", list(pages), pool.free_pages))
    seen.append(("insert", cache.insert(toks[:12], pages)))
    div = toks.copy()
    div[9] = 99                                  # diverges mid page 2
    nodes, boundary, cached = cache.match(div)
    seen.append(("match", [n.page for n in nodes],
                 None if boundary is None else (boundary[0].page,
                                                boundary[1]), cached))
    shared = cache.map_into("b", nodes, boundary)
    cow = pool._take_page()
    table = pool.alloc_prefixed("b", 14, shared + [cow], cached)
    pool.decref([cow])
    seen.append(("alloc_prefixed", table, pool.page_ref(cow),
                 pool.pages_shared))
    pool.extend("a", 1)                # a's trailing page is its own
    seen.append(("extend", pool.seq_len("a"), pool.table("a")))
    pool.alloc_prefixed("c", 7, pages[:2], 7)   # a partial shared page
    with pytest.raises(RuntimeError, match="shared page"):
        pool.extend("c", 1)            # the copy-on-write barrier
    pool.free("c")
    seen.append(("chunk_rows", list(pool.chunk_rows("b", 8, 8)),
                 list(pool.token_rows("b", 2, 11))))
    cache.release("b")
    pool.free("b")
    pool.free("a")
    seen.append(("evictable", cache.evictable_pages()))
    seen.append(("reclaim", cache.reclaim(2), pool.free_pages))
    st = pool.stats()
    seen.append(("stats", {k: st[k] for k in (
        "pages_in_use", "free_pages", "pages_shared", "tokens_reused",
        "prefix_lookups", "prefix_hits", "prefix_hit_rate")},
        {k: v for k, v in cache.stats().items()}))
    cache.clear()
    seen.append(("clear", pool.free_pages, cache.stats()["nodes"]))
    return seen


def test_pool_and_prefix_cache_match_jax_script():
    ref = _pool_script(JPagePool, JPrefixCache, {})
    out = _pool_script(PagePool, PrefixCache, dict(device="cpu"))
    assert out == ref


def test_shared_prefix_workload_matches_jax():
    kw = dict(n_prefixes=2, seed=5, divergence_offsets=(0, 3, 0, 9))
    for a, b in zip(make_shared_prefix_workload(256, 6, 24, 6, **kw),
                    jworkload(256, 6, 24, 6, **kw)):
        np.testing.assert_array_equal(a, b)


# ----------------------------------------------------- step functions

def _chunk_case(cfg, seed):
    """A pool whose sequence holds 19 tokens of cached prefix (pages 3, 1,
    then 5 for the chunk), a 16-token chunk at offset 19 with 11 real
    tokens."""
    rng = np.random.default_rng(seed)
    L, P, ps, nh, d = cfg.num_layers, 9, 8, cfg.num_heads, cfg.head_dim
    kp = rng.standard_normal((L, P, ps, nh, d)).astype(np.float32)
    vp = rng.standard_normal((L, P, ps, nh, d)).astype(np.float32)
    table = np.array([[3, 1, 5, 6, 0, 0]], np.int32)
    off, clen, C = 19, 11, 16
    t = off + np.arange(C)
    rows = np.where(t < off + clen, table[0][np.minimum(t // ps, 5)] * ps
                    + t % ps, t % ps).astype(np.int32)
    ids = np.zeros((1, C), np.int32)
    ids[0, :clen] = rng.integers(0, cfg.vocab_size, (clen,))
    return kp, vp, ids, off, clen, table, rows


@pytest.mark.parametrize("quantize", [False, True])
def test_chunk_prefill_fn_matches_jax(quantize):
    jmodel, _, cfg = _models(seed=2)
    params = _np_params(jmodel)
    jp, tp = _quantized_pair(params) if quantize else (_to_jax(params),
                                                      _to_torch(params))
    kp, vp, ids, off, clen, table, rows = _chunk_case(cfg, seed=2)
    kw = dict(eps=cfg.layer_norm_epsilon, temperature=0.0, top_k=0)
    jk, jv, jt = jengine.chunk_prefill_fn(
        jp, jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(ids),
        jnp.asarray(np.int32(off)), jnp.asarray(np.int32(clen)),
        jnp.asarray(table), jnp.asarray(rows), jax.random.key(0),
        compute_dtype="float32", **kw)
    tk, tv = torch.tensor(kp), torch.tensor(vp)
    n0 = tim.launches
    tt = chunk_prefill_fn(tp, tk, tv, torch.tensor(ids), off, clen,
                          torch.tensor(table), torch.tensor(rows), None,
                          compute_dtype=torch.float32, **kw)
    assert tim.launches == n0          # no kernel launches on the CPU
    live = slice(1, None)              # padded rows write the sink page
    np.testing.assert_allclose(tk.numpy()[:, live], np.asarray(jk)[:, live],
                               **STEP_TOL)
    np.testing.assert_allclose(tv.numpy()[:, live], np.asarray(jv)[:, live],
                               **STEP_TOL)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))


def test_int8_decode_step_fn_matches_jax():
    jmodel, _, cfg = _models(seed=3)
    jp, tp = _quantized_pair(_np_params(jmodel))
    rng = np.random.default_rng(3)
    L, P, ps, nh, d = cfg.num_layers, 12, 8, cfg.num_heads, cfg.head_dim
    kp = rng.standard_normal((L, P, ps, nh, d)).astype(np.float32)
    vp = rng.standard_normal((L, P, ps, nh, d)).astype(np.float32)
    pt = np.array([[1, 2, 3, 0], [4, 0, 0, 0], [5, 6, 0, 0], [0, 0, 0, 0]],
                  np.int32)
    lens = np.array([19, 8, 9, 0], np.int32)
    pos = np.maximum(lens - 1, 0).astype(np.int32)
    toks = rng.integers(0, cfg.vocab_size, (4,)).astype(np.int32)
    kw = dict(eps=cfg.layer_norm_epsilon, temperature=0.0, top_k=0)
    jk, jv, jt = jengine.decode_step_fn(
        jp, jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(toks),
        jnp.asarray(pos), jnp.asarray(pt), jnp.asarray(lens),
        jax.random.key(0), use_kernel=True, compute_dtype="float32", **kw)
    tk, tv = torch.tensor(kp), torch.tensor(vp)
    tt = decode_step_fn(tp, tk, tv, torch.tensor(toks), torch.tensor(pos),
                        torch.tensor(pt), torch.tensor(lens), None,
                        compute_dtype=torch.float32, **kw)
    live = slice(1, None)
    np.testing.assert_allclose(tk.numpy()[:, live], np.asarray(jk)[:, live],
                               **STEP_TOL)
    np.testing.assert_allclose(tv.numpy()[:, live], np.asarray(jv)[:, live],
                               **STEP_TOL)
    np.testing.assert_array_equal(tt.numpy()[:3], np.asarray(jt)[:3])


# ------------------------------------------------------------ engines

def test_prefix_cache_engine_matches_jax():
    """The prefix-cache workload with a mid-page (copy-on-write)
    divergence: greedy tokens equal to the JAX engine's and to the port's
    engine without the cache, the JAX engine's cached prefix lengths, and
    no page left but the trie's."""
    jmodel, tmodel, cfg = _models(seed=0)
    prompts = make_shared_prefix_workload(
        cfg.vocab_size, 6, prefix_len=24, suffix_len=6, seed=3,
        divergence_offsets=(0, 0, 0, 5, 0, 0))
    kw = dict(page_size=8, decode_buckets=(1, 2, 4, 8), prefix_cache=True,
              prefill_chunk=16)
    jeng, teng = _engines(jmodel, tmodel, **kw)
    _, ref = _serve(jeng, JScheduler, prompts, 5)
    _, out = _serve(teng, ContinuousBatchingScheduler, prompts, 5)
    plain = ServingEngine(tmodel, page_size=8, decode_buckets=(1, 2, 4, 8),
                          device="cpu")
    _, base = _serve(plain, ContinuousBatchingScheduler, prompts, 5)
    for a, b, c in zip(out, ref, base):
        np.testing.assert_array_equal(a.output_ids, b.output_ids)
        np.testing.assert_array_equal(a.output_ids, c.output_ids)
    cached = [r.cached_prefix_len for r in out]
    assert cached == [r.cached_prefix_len for r in ref]
    assert cached[:4] == [0, 24, 24, 19]
    st, jst = teng.pool.stats(), jeng.pool.stats()
    for key in ("tokens_reused", "prefix_lookups", "prefix_hits",
                "prefix_hit_rate", "pages_in_use"):
        assert st[key] == jst[key], key
    assert st["tokens_reused"] == sum(cached)
    assert teng.pool.live_sequences == 0
    assert all(c == 1 for c in teng.pool._refs.values())
    s = out[3].summary()
    assert s["cached_prefix_len"] == 19 and s["prefill_chunks"] >= 1
    assert teng.status()["prefix_cache"]["nodes"] == \
        jeng.status()["prefix_cache"]["nodes"]


def test_prefix_sharing_in_flight_and_cache_probe():
    """Same-prefix requests admitted in one wave share pages while they
    run, and the scheduler's cache probe moves no refcount."""
    _, tmodel, cfg = _models(seed=1)
    prompts = make_shared_prefix_workload(cfg.vocab_size, 5, prefix_len=24,
                                          suffix_len=6, seed=4)
    eng = ServingEngine(tmodel, page_size=8, decode_buckets=(1, 2, 4, 8),
                        prefix_cache=True, prefill_chunk=16, device="cpu")
    sched = ContinuousBatchingScheduler(eng)
    assert sched._cache_hit_tokens(prompts[0]) == 0
    for p in prompts:
        sched.submit(p, max_new_tokens=4)
    max_shared = 0
    while sched.pending:
        sched.step()
        max_shared = max(max_shared, eng.pool.stats()["pages_shared"])
    assert max_shared > 0
    refs = dict(eng.pool._refs)
    lookups = eng.pool.stats()["prefix_lookups"]
    # a new prompt on the shared prefix: at least the prefix's 3 pages hit
    probe = np.concatenate([prompts[1][:24], prompts[0][:6][::-1]])
    assert sched._cache_hit_tokens(probe) >= 24
    assert eng.pool._refs == refs
    assert eng.pool.stats()["prefix_lookups"] == lookups


def test_prefix_cache_eviction_and_multi_turn_match_jax():
    """A pool too small for cache and new work reclaims cached pages
    (LRU); a follow-up turn hits what is left of the pages published at
    release. Tokens, hits and evictions equal the JAX engine's."""
    jmodel, tmodel, cfg = _models(seed=2)
    kw = dict(page_size=8, num_pages=9, max_seq_len=48, decode_buckets=(1,),
              prefix_cache=True, prefill_chunk=8)
    jeng, teng = _engines(jmodel, tmodel, **kw)
    pa, pb = _prompts(cfg.vocab_size, (24, 40), seed=7)
    outs = []
    for eng, cls in ((jeng, JScheduler), (teng, ContinuousBatchingScheduler)):
        sched = cls(eng)
        ra = sched.submit(pa, max_new_tokens=4)
        sched.run()
        rb = sched.submit(pb, max_new_tokens=6)
        sched.run()
        follow = np.concatenate([pb, np.asarray(rb.tokens, np.int32)[:1]])
        rc = sched.submit(follow, max_new_tokens=2)
        sched.run()
        assert eng.prefix_cache.evictions > 0
        outs.append([ra.output_ids, rb.output_ids, rc.output_ids,
                     rc.cached_prefix_len, eng.prefix_cache.evictions])
    for a, b in zip(outs[1][:3], outs[0][:3]):
        np.testing.assert_array_equal(a, b)
    assert outs[1][3:] == outs[0][3:]
    # admitting the follow-up reclaimed the LRU leaves of its own history:
    # 2 of the 5 published pages still hit, on both sides
    assert outs[1][3] == 16


def test_chunked_prefill_stall_bound_and_tokens_match_jax():
    """Chunked engine == the JAX chunked engine token for token; per-tick
    prefill work never exceeds the budget; and decode progresses while a
    long prompt prefills."""
    jmodel, tmodel, cfg = _models(seed=4)
    rng = np.random.default_rng(11)
    short = rng.integers(0, cfg.vocab_size, (5,)).astype(np.int32)
    llong = rng.integers(0, cfg.vocab_size, (60,)).astype(np.int32)

    def drive(engine, cls):
        sched = cls(engine)
        r_s = sched.submit(short, max_new_tokens=20)
        sched.step()
        sched.step()
        toks0 = len(r_s.tokens)
        r_l = sched.submit(llong, max_new_tokens=2)
        during = []
        while sched.pending:
            sched.step()
            if r_l.state == "prefilling":
                during.append(len(r_s.tokens))
        return sched, r_s, r_l, toks0, during

    jeng, teng = _engines(jmodel, tmodel, page_size=8, decode_buckets=(1, 2),
                          prefill_chunk=8)
    s_c, rc_s, rc_l, toks0, during = drive(teng, ContinuousBatchingScheduler)
    assert max(s_c.prefill_tokens_per_tick) <= 8
    assert during and during[-1] > toks0
    assert rc_l.prefill_chunks == 8 and rc_l.summary()["prefill_chunks"] == 8
    _, rj_s, rj_l, _, _ = drive(jeng, JScheduler)
    np.testing.assert_array_equal(rc_s.output_ids, rj_s.output_ids)
    np.testing.assert_array_equal(rc_l.output_ids, rj_l.output_ids)
    assert teng.prefill_signatures() == {("chunk", 8, 16)}
    assert teng.prefill_signatures() == jeng.prefill_signatures()


@pytest.mark.parametrize("chunk", [None, 16])
def test_int8_engine_matches_jax(chunk):
    """``quantize="int8"`` alone and with ``prefill_chunk=16``: direct
    prefill + decodes (as the JAX auto-fusion parity test drives them),
    then a scheduler run, token for token against the JAX engine."""
    jmodel, tmodel, cfg = _models(seed=5)
    kw = dict(page_size=8, decode_buckets=(1, 2, 4), quantize="int8",
              prefill_chunk=chunk)
    jeng, teng = _engines(jmodel, tmodel, **kw)
    prompt = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (23,)).astype(np.int32)
    n0 = tim.launches
    assert teng.prefill("a", prompt) == jeng.prefill("a", prompt)
    toks = ([], [])
    for _ in range(4):
        jeng.pool.extend("a")
        teng.pool.extend("a")
        toks[0].append(jeng.decode(["a"])[0])
        toks[1].append(teng.decode(["a"])[0])
    assert toks[1] == toks[0]
    assert tim.launches == n0
    jeng.release("a")
    teng.release("a")
    prompts = _prompts(cfg.vocab_size, (5, 30, 12), seed=5)
    _, ref = _serve(jeng, JScheduler, prompts, 6)
    _, out = _serve(teng, ContinuousBatchingScheduler, prompts, 6)
    for a, b in zip(out, ref):
        np.testing.assert_array_equal(a.output_ids, b.output_ids)
    assert teng.weight_bytes() == jeng.weight_bytes()
    st = teng.status()
    assert st["quantize"] == "int8" and st["prefill_chunk"] == chunk
    assert teng.pool.pages_in_use == 0


def test_chunked_engine_validation_and_direct_prefill():
    _, tmodel, _ = _models(seed=6)
    with pytest.raises(ValueError, match="multiple of"):
        ServingEngine(tmodel, page_size=8, prefill_chunk=12, device="cpu")
    with pytest.raises(ValueError, match="int8"):
        ServingEngine(tmodel, page_size=8, quantize="int4", device="cpu")
    eng = ServingEngine(tmodel, page_size=8, decode_buckets=(1,),
                        prefill_chunk=16, device="cpu")
    tok = eng.prefill("a", np.zeros(20, np.int32))
    plain = ServingEngine(tmodel, page_size=8, decode_buckets=(1,),
                          device="cpu")
    assert tok == plain.prefill("a", np.zeros(20, np.int32))
    with pytest.raises(EngineShapeError, match="chunked"):
        plain.prefill_begin("b", np.zeros(4, np.int32))
    cached = ServingEngine(tmodel, page_size=8, prefix_cache=True,
                           device="cpu")
    assert cached.prefill_chunk == 64      # implied: 8 pages
    assert cached.cached_prefix_len("nobody") == 0


def test_prefill_and_int8_kernels_dispatch_plain_on_cpu():
    """On CPU tensors the wrappers run their plain versions and count no
    launch; GQA heads are refused by the chunk-prefill wrapper."""
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.standard_normal((1, 8, 2, 16)).astype(
        np.float32))
    kp = torch.from_numpy(rng.standard_normal((4, 4, 2, 16)).astype(
        np.float32))
    pt = torch.tensor([[1, 2, 3]], dtype=torch.int32)
    n0 = tpa.prefill_launches
    out = tpa.ragged_prefill_attention(q, kp, kp, pt, 3)
    assert tpa.prefill_launches == n0
    torch.testing.assert_close(out, tpa.paged_prefill_attention(q, kp, kp,
                                                                pt, 3))
    with pytest.raises(ValueError, match="num_kv_heads"):
        tpa.ragged_prefill_attention(q, kp[:, :, :1], kp[:, :, :1], pt, 3)
    with pytest.raises(ValueError, match="q_offset"):
        tpa.ragged_prefill_attention(q, kp, kp, pt, -1)
    with pytest.raises(ValueError, match="mismatch"):
        tim.int8_matmul(torch.zeros(2, 5), torch.zeros(4, 3,
                                                       dtype=torch.int8),
                        torch.ones(3))
