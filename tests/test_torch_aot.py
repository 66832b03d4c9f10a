"""The serving engines' bucket closure in the port: step functions that take
their per-request scalars as device tensors, ``aot`` and
``compile_buckets`` (CUDA graphs), ``decode_signatures``, the capture
accounting in ``status()``, and the launch counts of graph replays.

The CPU tests hold the step functions, with device-tensor scalars, against
the JAX ones (the JAX engines built with ``autofuse=False, aot=False``, as
in ``tests/test_torch_serving_modes.py``) and against their int form, and
check the engines' surface. JAX is imported inside those tests only, so
that the card tests (marked ``gpu``, skipped without a device) also run
where only PyTorch is installed:

    python -m pytest tests/test_torch_aot.py -m gpu --noconftest -q
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.kernels import flash_attention as tfa
from paddle_tpu_torch.kernels import int8_matmul as tim
from paddle_tpu_torch.kernels import moe_dispatch as tmd
from paddle_tpu_torch.kernels import paged_attention as tpa
from paddle_tpu_torch.models import ernie as ternie
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.serving import (ContinuousBatchingScheduler,
                                      MoEServingEngine, PagePool,
                                      ServingEngine, chunk_prefill_fn,
                                      make_shared_prefix_workload,
                                      moe_prefill_fn, prefill_fn)
from paddle_tpu_torch.serving import graphs

# f32 step functions against JAX: the same math, sums in other orders
STEP_TOL = dict(rtol=1e-5, atol=1e-5)
_KERNEL_MODULES = (tfa, tpa, tim, tmd)


def _i32(v):
    """A one-element int32 tensor: how the engines pass a scalar."""
    return torch.tensor([v], dtype=torch.int32)


def _gpt_models(seed):
    import paddle_tpu as paddle
    from paddle_tpu.models import gpt as jgpt
    from paddle_tpu_torch.models.convert import gpt_state_dict_from_numpy
    paddle.seed(seed)
    cfg = jgpt.gpt_tiny_config()
    jmodel = jgpt.GPTForPretraining(jgpt.GPTModel(cfg))
    state = {k: np.asarray(v._value) for k, v in jmodel.state_dict().items()}
    tmodel = tgpt.GPTForPretraining(tgpt.GPTModel(tgpt.gpt_tiny_config(),
                                                  device="cpu"))
    tmodel.load_state_dict(gpt_state_dict_from_numpy(state), strict=True)
    return jmodel, tmodel, cfg


def _gpt_params(jmodel, quantize):
    """The stacked weights as (JAX tree, torch tree), int8 leaves when
    ``quantize``."""
    import jax.numpy as jnp
    from paddle_tpu.models import gpt as jgpt
    from paddle_tpu.quantization import export as jexport
    from paddle_tpu_torch.quantization import export as texport
    st = jgpt.stack_gpt_weights(jmodel)
    params = {"blocks": {k: np.asarray(v) for k, v in st["blocks"].items()},
              **{k: np.asarray(st[k]) for k in ("wte", "wpe", "lnf_w",
                                                "lnf_b")}}

    def tree(conv, p):
        return {"blocks": {k: conv(v) for k, v in p["blocks"].items()},
                **{k: conv(v) for k, v in p.items() if k != "blocks"}}
    jp, tp = tree(jnp.asarray, params), tree(torch.tensor, params)
    if quantize:
        jp = jexport.quantize_stacked_gpt_weights(jp)
        tp = texport.quantize_stacked_gpt_weights(tp)
    return jp, tp


def _pool_arrays(cfg, num_pages, page_size, seed):
    rng = np.random.default_rng(seed)
    shape = (cfg.num_layers, num_pages, page_size, cfg.num_heads,
             cfg.head_dim)
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


@pytest.mark.parametrize("n,bucket,use_flash", [(13, 16, False),
                                                (70, 128, True)])
def test_prefill_fn_device_true_len_matches_jax_and_int(n, bucket,
                                                        use_flash):
    """``prefill_fn`` with ``true_len`` a one-element device tensor: the
    pages written and the token equal the JAX step's (at the step
    tolerance) and the int form's (bit for bit)."""
    import jax
    import jax.numpy as jnp
    from paddle_tpu.serving import engine as jengine
    jmodel, _, cfg = _gpt_models(seed=2)
    jp, tp = _gpt_params(jmodel, quantize=False)
    pool = PagePool(20, 8, num_layers=cfg.num_layers,
                    num_kv_heads=cfg.num_heads, head_dim=cfg.head_dim,
                    device="cpu")
    pool.alloc("s", n)
    rows = pool.prefill_rows("s", bucket)
    ids = np.zeros((1, bucket), np.int32)
    ids[0, :n] = np.random.default_rng(2).integers(0, cfg.vocab_size, n)
    kw = dict(eps=cfg.layer_norm_epsilon, temperature=0.0, top_k=0,
              use_flash=use_flash)
    shape = tuple(pool.k_pages.shape)
    jk, jv, jt = jengine.prefill_fn(
        jp, jnp.zeros(shape), jnp.zeros(shape), jnp.asarray(ids),
        jnp.asarray(np.int32(n)), jnp.asarray(rows), jax.random.key(0), **kw)
    outs = []
    for true_len in (_i32(n), n):
        kp, vp = torch.zeros(shape), torch.zeros(shape)
        tok = prefill_fn(tp, kp, vp, torch.tensor(ids), true_len,
                         torch.tensor(rows), None, **kw)
        outs.append((kp, vp, tok))
    kp, vp, tok = outs[0]
    np.testing.assert_allclose(kp.numpy()[:, 1:], np.asarray(jk)[:, 1:],
                               **STEP_TOL)
    np.testing.assert_allclose(vp.numpy()[:, 1:], np.asarray(jv)[:, 1:],
                               **STEP_TOL)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jt))
    for a, b in zip(outs[0], outs[1]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("quantize", [False, True])
@pytest.mark.parametrize("off,clen", [(0, 16), (8, 16), (13, 11), (27, 5)])
def test_chunk_prefill_fn_device_scalars_match_jax_and_int(quantize, off,
                                                           clen):
    """``chunk_prefill_fn`` with ``q_offset`` and ``chunk_len`` as device
    tensors, at offsets 0, page-aligned and not (13, 27 with page 8), and
    a short last chunk: the pages written and the token equal the JAX
    step's and the int form's (bit for bit)."""
    import jax
    import jax.numpy as jnp
    from paddle_tpu.serving import engine as jengine
    jmodel, _, cfg = _gpt_models(seed=3)
    jp, tp = _gpt_params(jmodel, quantize)
    C, ps, pps = 16, 8, 6
    kp0, vp0 = _pool_arrays(cfg, 8, ps, seed=3)
    table = np.array([[3, 1, 6, 2, 5, 4]], np.int32)
    t = off + np.arange(C)
    rows = np.where(np.arange(C) < clen, table[0, t // ps] * ps + t % ps,
                    t % ps).astype(np.int32)
    ids = np.zeros((1, C), np.int32)
    ids[0, :clen] = np.random.default_rng(3).integers(0, cfg.vocab_size,
                                                      clen)
    kw = dict(eps=cfg.layer_norm_epsilon, temperature=0.0, top_k=0)
    jk, jv, jt = jengine.chunk_prefill_fn(
        jp, jnp.asarray(kp0), jnp.asarray(vp0), jnp.asarray(ids),
        jnp.asarray(np.int32(off)), jnp.asarray(np.int32(clen)),
        jnp.asarray(table), jnp.asarray(rows), jax.random.key(0),
        compute_dtype="float32", **kw)
    outs = []
    for o, n in ((_i32(off), _i32(clen)), (off, clen)):
        kp, vp = torch.tensor(kp0), torch.tensor(vp0)
        tok = chunk_prefill_fn(tp, kp, vp, torch.tensor(ids), o, n,
                               torch.tensor(table), torch.tensor(rows), None,
                               compute_dtype=torch.float32, **kw)
        outs.append((kp, vp, tok))
    kp, vp, tok = outs[0]
    live = slice(1, None)              # padded rows write the sink page
    np.testing.assert_allclose(kp.numpy()[:, live], np.asarray(jk)[:, live],
                               **STEP_TOL)
    np.testing.assert_allclose(vp.numpy()[:, live], np.asarray(jv)[:, live],
                               **STEP_TOL)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jt))
    for a, b in zip(outs[0], outs[1]):
        assert torch.equal(a, b)


def _moe_cfg(mod):
    """tests/test_serving_moe.py's config, from either package."""
    return mod.ernie_moe_tiny_config(
        num_hidden_layers=2, hidden_size=32, num_attention_heads=2,
        intermediate_size=64, num_experts=4, capacity_factor=100.0,
        max_position_embeddings=64)


def _moe_models():
    import paddle_tpu as paddle
    from paddle_tpu.models import ernie as jernie
    from paddle_tpu_torch.models.convert import \
        ernie_moe_state_dict_from_numpy
    paddle.seed(0)
    jmodel = jernie.ErnieMoeForPretraining(
        jernie.ErnieMoeModel(_moe_cfg(jernie)))
    jmodel.eval()
    tmodel = ternie.ErnieMoeForPretraining(
        ternie.ErnieMoeModel(_moe_cfg(ternie), device="cpu"))
    state = {k: np.asarray(v._value) for k, v in jmodel.state_dict().items()}
    tmodel.load_state_dict(ernie_moe_state_dict_from_numpy(state),
                           strict=True)
    return jmodel, tmodel.eval()


@pytest.mark.parametrize("n", [11, 16])
def test_moe_prefill_fn_device_true_len_matches_jax_and_int(n):
    """``moe_prefill_fn`` with ``true_len`` a device tensor: the pages and
    the token equal the JAX step's and the int form's."""
    import jax
    import jax.numpy as jnp
    from paddle_tpu.models import ernie as jernie
    from paddle_tpu.serving import moe_engine as jmoe
    jmodel, tmodel = _moe_models()
    cfg = tmodel.config
    jparams, _ = jernie.stack_ernie_moe_weights(jmodel)
    tparams, _ = ternie.stack_ernie_moe_weights(tmodel)
    shape = (cfg.num_hidden_layers, 4, 8, cfg.num_attention_heads,
             cfg.head_dim)
    ids = np.zeros((1, 16), np.int32)
    ids[0, :n] = np.random.default_rng(4).integers(0, cfg.vocab_size, n)
    rows = np.array(list(range(8, 8 + n)) + [0] * (16 - n), np.int32)
    kw = dict(kinds=tuple(jernie.stack_ernie_moe_weights(jmodel)[1]),
              eps=cfg.layer_norm_eps, top_k=cfg.top_k, temperature=0.0,
              topk_sample=0, use_fused_moe=True)
    jk, jv, jt = jmoe.moe_prefill_fn(
        jparams, jnp.zeros(shape), jnp.zeros(shape), jnp.asarray(ids),
        jnp.asarray(np.int32(n)), jnp.asarray(rows), jax.random.key(0), **kw)
    outs = []
    for true_len in (_i32(n), n):
        kp, vp = torch.zeros(shape), torch.zeros(shape)
        tok = moe_prefill_fn(tparams, kp, vp, torch.from_numpy(ids),
                             true_len, torch.from_numpy(rows), None, **kw)
        outs.append((kp, vp, tok))
    kp, vp, tok = outs[0]
    np.testing.assert_allclose(kp.numpy()[:, 1:], np.asarray(jk)[:, 1:],
                               **STEP_TOL)
    np.testing.assert_allclose(vp.numpy()[:, 1:], np.asarray(jv)[:, 1:],
                               **STEP_TOL)
    assert int(tok[0]) == int(jt[0])
    for a, b in zip(outs[0], outs[1]):
        assert torch.equal(a, b)


def _prefill_case(seed=0):
    """q [2, 16, 4, 16], pages of 8, a table of 6 pages a sequence whose
    second row maps the first's two leading pages."""
    rng = np.random.default_rng(seed)
    B, C, nh, d, ps, pps = 2, 16, 4, 16, 8, 6
    npg = B * pps + 1
    pt = np.arange(1, npg, dtype=np.int32).reshape(B, pps)
    pt[1, :2] = pt[0, :2]
    return [rng.standard_normal(s).astype(np.float32) for s in
            ((B, C, nh, d), (npg, ps, nh, d), (npg, ps, nh, d))] + [pt]


@pytest.mark.parametrize("q_offset", [0, 5, 16, 27, 32])
def test_plain_chunk_prefill_takes_a_tensor_offset(q_offset):
    """The chunk prefill's plain versions with the offset as an int, a 0-d
    tensor and a one-element tensor: the XLA path bit for bit, the tiled
    version to f32 rounding (it walks every block of the table for a
    tensor), both against the JAX Pallas kernel in interpret mode."""
    import jax.numpy as jnp
    from paddle_tpu.kernels import paged_attention as jpa
    arrays = _prefill_case()
    ps = arrays[1].shape[1]
    t = [torch.from_numpy(a) for a in arrays]
    kern = np.asarray(jpa.ragged_prefill_attention(
        *map(jnp.asarray, arrays), q_offset, interpret=True))
    offsets = (q_offset, torch.tensor(q_offset), _i32(q_offset))
    xla = [tpa.paged_prefill_attention(*t, o) for o in offsets]
    wrapped = [tpa.ragged_prefill_attention(*t, o) for o in offsets]
    tiled = [tpa.ragged_prefill_reference(*t, o, block=ps) for o in offsets]
    for out in xla[1:] + wrapped:
        assert torch.equal(out, xla[0])
    for out in tiled[1:]:
        np.testing.assert_allclose(out.numpy(), tiled[0].numpy(), rtol=1e-6,
                                   atol=1e-6)
    for out in (xla[0], tiled[0], tiled[2]):
        np.testing.assert_allclose(out.numpy(), kern, rtol=1e-5, atol=1e-5)


def test_decode_signatures_match_jax():
    """Both engines' ``decode_signatures()`` against the JAX engines' for
    the same configs (the JAX engines built without their compile)."""
    from paddle_tpu.serving import MoEServingEngine as JMoE
    from paddle_tpu.serving import ServingEngine as JEngine
    jmodel, tmodel, _ = _gpt_models(seed=0)
    for kw in (dict(page_size=8, decode_buckets=(1, 2, 4)),
               dict(page_size=16, decode_buckets=(1, 3, 8),
                    prefill_chunk=32)):
        jeng = JEngine(jmodel, autofuse=False, aot=False, **kw)
        teng = ServingEngine(tmodel, device="cpu", **kw)
        assert teng.decode_signatures() == jeng.decode_signatures()
        assert teng.prefill_signatures() == jeng.prefill_signatures()
    jmoe, tmoe = _moe_models()
    kw = dict(page_size=8, decode_buckets=(1, 2, 4))
    assert MoEServingEngine(tmoe, device="cpu", **kw).decode_signatures() \
        == JMoE(jmoe, autofuse=False, aot=False, **kw).decode_signatures()


def test_aot_is_off_on_the_cpu():
    """On the CPU ``aot`` resolves to False, ``aot=True`` raises, nothing
    is captured and ``status()`` reports ``compile_s`` and
    ``aot_programs`` (0); ``compile_buckets`` raises."""
    model = tgpt.GPTForPretraining(tgpt.GPTModel(tgpt.gpt_tiny_config(),
                                                 device="cpu"))
    moe = ternie.ErnieMoeForPretraining(
        ternie.ErnieMoeModel(_moe_cfg(ternie), device="cpu")).eval()
    for cls, m in ((ServingEngine, model), (MoEServingEngine, moe)):
        eng = cls(m, page_size=8, decode_buckets=(1, 2), device="cpu")
        assert eng.aot is False and eng.compile_s == 0.0
        st = eng.status()
        assert st["aot_programs"] == 0 and st["compile_s"] == 0.0
        assert eng.graph_pool_bytes() == 0
        with pytest.raises(ValueError, match="CUDA graphs"):
            eng.compile_buckets()
        with pytest.raises(ValueError, match="aot=True"):
            cls(m, page_size=8, device="cpu", aot=True)
        assert cls(m, page_size=8, device="cpu", aot=False).aot is False


def test_engines_are_freed_without_the_garbage_collector():
    """An engine holds no reference cycle, so its graphs go when its last
    reference does, never in a later collection that could fall inside
    another engine's capture (which a graph's destruction invalidates)."""
    import gc
    import weakref
    model = tgpt.GPTForPretraining(tgpt.GPTModel(tgpt.gpt_tiny_config(),
                                                 device="cpu"))
    moe = ternie.ErnieMoeForPretraining(
        ternie.ErnieMoeModel(_moe_cfg(ternie), device="cpu")).eval()
    was = gc.isenabled()
    gc.disable()
    try:
        for cls, m, kw in ((ServingEngine, model, {}),
                           (ServingEngine, model, dict(prefix_cache=True)),
                           (MoEServingEngine, moe, {})):
            eng = cls(m, page_size=8, device="cpu", **kw)
            eng.prefill(0, np.arange(5, dtype=np.int32))
            ref = weakref.ref(eng)
            del eng
            assert ref() is None, cls
    finally:
        if was:
            gc.enable()


def test_replay_accounting_adds_recorded_deltas():
    """``counted`` records what a call moved the kernels' launch counters
    by and sets them back; each ``StepGraph`` replay (here of a stand-in
    graph) adds that again; staging writes the flat inputs into the static
    buffer. No kernel module gains an attribute."""
    names = [set(vars(m)) for m in _KERNEL_MODULES]
    before = graphs.read_counts()
    assert ("paddle_tpu_torch.kernels.paged_attention",
            "prefill_launches") in before
    assert len(before) == 8

    def step():
        tpa.launches += 2
        tmd.dispatch_launches += 1
        return torch.tensor([7], dtype=torch.int32)
    out, moved = graphs.counted(step)
    assert graphs.read_counts() == before
    assert moved == {
        ("paddle_tpu_torch.kernels.paged_attention", "launches"): 2,
        ("paddle_tpu_torch.kernels.moe_dispatch", "dispatch_launches"): 1}

    class Graph:
        replays = 0

        def replay(self):
            self.replays += 1
    static = torch.zeros(5, dtype=torch.int32)
    inputs = graphs.unpack(static, ((2,), (1, 3)))
    graph = graphs.StepGraph(Graph(), static,
                             torch.zeros(5, dtype=torch.int32), inputs, out,
                             moved)
    assert graph.stage(np.arange(5, dtype=np.int32)) is inputs
    assert inputs[1].tolist() == [[2, 3, 4]]
    try:
        for _ in range(3):
            assert graph.replay() is out
        after = graphs.read_counts()
        assert graph.graph.replays == 3
        assert {k: after[k] - before[k] for k in after
                if after[k] != before[k]} == {k: 3 * v
                                              for k, v in moved.items()}
    finally:
        tpa.launches -= 6
        tmd.dispatch_launches -= 3
    assert graphs.read_counts() == before
    assert [set(vars(m)) for m in _KERNEL_MODULES] == names
    with pytest.raises(ValueError):
        graphs.unpack(static, ((2,), (2,)))


# ------------------------------------------------------------------ card

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _gpt_model(dtype):
    cfg = tgpt.gpt_tiny_config(hidden_size=128, num_heads=2)
    model = tgpt.GPTForPretraining(tgpt.GPTModel(cfg, seed=0, device="cpu"))
    return model.to(getattr(torch, dtype)), cfg


GPT_MODES = {
    "float": dict(page_size=16),
    "int8": dict(page_size=16, quantize="int8"),
    "chunked": dict(page_size=16, prefill_chunk=32),
    "prefix": dict(page_size=16, prefix_cache=True, prefill_chunk=32),
}
SAMPLING = {"greedy": dict(), "sampled": dict(temperature=0.8, top_k=40,
                                              seed=3)}


def _serve(eng, prompts, max_new, budget=None):
    sched = ContinuousBatchingScheduler(eng, prefill_token_budget=budget)
    n0 = graphs.read_counts()
    reqs = [sched.submit(p, max_new_tokens=max_new) for p in prompts]
    sched.run()
    assert all(r.state == "finished" for r in reqs)
    assert eng.pool.pages_in_use == 0 or eng.prefix_cache is not None
    n1 = graphs.read_counts()
    return [list(r.tokens) for r in reqs], {k: n1[k] - n0[k] for k in n1}


def _gpt_prompts(cfg, mode):
    if mode == "prefix":
        return make_shared_prefix_workload(cfg.vocab_size, 5, prefix_len=40,
                                           suffix_len=9, seed=4)
    rng = np.random.default_rng(8)
    return [rng.integers(0, cfg.vocab_size, (n,)).astype(np.int32)
            for n in (70, 33, 100, 5, 47)]


def _compare(make, prompts, **serve):
    """A captured engine (``make(True)``) against an eager one
    (``make(False)``) on the same prompts: what the card tests hold."""
    runs, st = {}, {}
    for aot in (True, False):
        eng = make(aot)
        assert eng.aot is aot
        st[aot] = dict(eng.status(), pool=eng.graph_pool_bytes())
        runs[aot] = _serve(eng, prompts, 6, **serve)
        del eng
    moe = ("paddle_tpu_torch.kernels.moe_dispatch", "dispatch_launches")
    return dict(tokens_equal=runs[True][0] == runs[False][0],
                counts_equal=runs[True][1] == runs[False][1],
                programs=[st[True]["aot_programs"], st[False]["aot_programs"]],
                compile_s=st[True]["compile_s"], pool=st[True]["pool"],
                prefill_programs=1 if st[True].get("prefill_chunk")
                else len(st[True]["prefill_buckets"]),
                dispatch_launches=runs[True][1].get(moe, 0))


def _gpt_case(mode, dtype, sampling):
    model, cfg = _gpt_model(dtype)
    kw = dict(GPT_MODES[mode], decode_buckets=(1, 2, 4), use_flash=True,
              **SAMPLING[sampling])
    return _compare(lambda aot: ServingEngine(model, device="cuda", aot=aot,
                                              **kw),
                    _gpt_prompts(cfg, mode), budget=48)


def _moe_case(dtype, sampling):
    cfg = ternie.ernie_moe_tiny_config(
        num_hidden_layers=2, hidden_size=32, num_attention_heads=2,
        intermediate_size=64, num_experts=4, capacity_factor=100.0,
        max_position_embeddings=256)
    model = ternie.ErnieMoeForPretraining(
        ternie.ErnieMoeModel(cfg, seed=0, device="cpu")).eval()
    model = model.to(getattr(torch, dtype))
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, (n,)).astype(np.int32)
               for n in (5, 9, 200, 12, 140)]
    return _compare(lambda aot: MoEServingEngine(
        model, page_size=8, decode_buckets=(1, 2, 4),
        prefill_buckets=(16, 64, 256), device="cuda", aot=aot,
        **SAMPLING[sampling]), prompts)


DTYPES = ("float32", "bfloat16")


def _sampled_cases():
    """Every sampled case, by name (run in a process of its own)."""
    cases = {f"gpt-{m}-{d}": _gpt_case(m, d, "sampled")
             for m in GPT_MODES for d in DTYPES}
    cases.update({f"moe-{d}": _moe_case(d, "sampled") for d in DTYPES})
    return cases


_SAMPLED_RUNNER = """
import importlib.util, json, sys
spec = importlib.util.spec_from_file_location("aot_card_cases", sys.argv[1])
mod = importlib.util.module_from_spec(spec)
spec.loader.exec_module(mod)
mod._cuda()
print(json.dumps(mod._sampled_cases()))
"""


@pytest.fixture(scope="module")
def sampled_cases():
    """The sampled cases' results, from a fresh interpreter. Run in the
    test process, the captured sampling engines left ``torch.profiler``
    recording no forward kernels for ``tests/test_torch_gpu.py``'s route
    checks that ran after them in the same process (the cause is not
    known; ``PERF.md`` §7)."""
    import json
    import subprocess
    import sys
    from pathlib import Path
    _cuda()
    out = subprocess.run([sys.executable, "-c", _SAMPLED_RUNNER, __file__],
                         cwd=Path(__file__).resolve().parents[1],
                         capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.splitlines()[-1])


def _case(request, name, run):
    if name.endswith("sampled"):
        return request.getfixturevalue("sampled_cases")[
            name.rsplit("-", 1)[0]]
    return run()


@pytest.mark.gpu
@pytest.mark.parametrize("sampling", sorted(SAMPLING))
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("mode", sorted(GPT_MODES))
def test_captured_gpt_engine_matches_eager(mode, dtype, sampling, request):
    """The GPT engine in each mode, captured (the default on CUDA) against
    ``aot=False`` on the same prompts and seed: every token equal, and the
    same launches of every kernel (the replays counted as the eager calls
    were); one graph a decode bucket and a prefill bucket (or the chunk
    program)."""
    _cuda()
    res = _case(request, f"gpt-{mode}-{dtype}-{sampling}",
                lambda: _gpt_case(mode, dtype, sampling))
    assert res["tokens_equal"] and res["counts_equal"]
    assert res["programs"] == [3 + res["prefill_programs"], 0]
    assert res["compile_s"] > 0 and res["pool"] != 0


@pytest.mark.gpu
@pytest.mark.parametrize("sampling", sorted(SAMPLING))
@pytest.mark.parametrize("dtype", DTYPES)
def test_captured_moe_engine_matches_eager(dtype, sampling, request):
    """The MoE engine captured against ``aot=False``: every token and every
    kernel's launches equal (prefills of up to 64 tokens: the dispatch's
    one-launch route; ``prefill_buckets`` adds a 256-token bucket, the
    three-pass route)."""
    _cuda()
    res = _case(request, f"moe-{dtype}-{sampling}",
                lambda: _moe_case(dtype, sampling))
    assert res["tokens_equal"] and res["counts_equal"]
    assert res["programs"] == [6, 0] and res["dispatch_launches"] > 0


@pytest.mark.gpu
def test_replayed_decode_counts_n_eager_steps():
    """N replays of a decode bucket's graph count N times one eager step's
    launches (int8 engine: the paged decode and int8 kernels), and the
    capture itself counted nothing."""
    _cuda()
    model, cfg = _gpt_model("bfloat16")
    counts = {}
    for aot in (True, False):
        n0 = graphs.read_counts()
        eng = ServingEngine(model, device="cuda", aot=aot, page_size=16,
                            decode_buckets=(1, 2, 4), quantize="int8")
        assert graphs.read_counts() == n0
        for i, n in enumerate((20, 9, 33)):
            eng.prefill(i, np.arange(n, dtype=np.int32) % cfg.vocab_size)
        steps = 1 if not aot else 5
        n0 = graphs.read_counts()
        for _ in range(steps):
            for i in range(3):
                eng.pool.extend(i, 1)
            eng.decode([0, 1, 2])
        n1 = graphs.read_counts()
        counts[aot] = {k: (n1[k] - n0[k]) / steps for k in n1}
    assert counts[True] == counts[False]
    L = cfg.num_layers
    assert counts[False][("paddle_tpu_torch.kernels.paged_attention",
                          "launches")] == L
    assert counts[False][("paddle_tpu_torch.kernels.int8_matmul",
                          "launches")] == 4 * L + 1


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chunk_kernel_graph_serves_every_offset(dtype):
    """One CUDA graph captured around the chunk-prefill kernel with its
    offset in a device tensor, replayed at offsets 0, 37 (not on a page),
    64, 300 and 767: each replay bit-equal to an eager launch at that
    offset (an int), and within 1e-5 of the plain XLA path in f32."""
    dev = _cuda()
    dt = getattr(torch, dtype)
    gen = torch.Generator(device=dev).manual_seed(5)
    B, C, nh, d, ps, pps = 1, 256, 8, 128, 64, 16
    q = torch.randn(B, C, nh, d, device=dev, generator=gen).to(dt)
    kp = torch.randn(B * pps + 1, ps, nh, d, device=dev,
                     generator=gen).to(dt)
    vp = torch.randn(B * pps + 1, ps, nh, d, device=dev,
                     generator=gen).to(dt)
    pt = (torch.randperm(B * pps, device=dev, generator=gen) + 1).reshape(
        B, pps).to(torch.int32)
    off = torch.zeros(1, dtype=torch.int32, device=dev)
    tpa.ragged_prefill_attention(q, kp, vp, pt, off)      # built, warm
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    n0 = tpa.prefill_launches
    with torch.cuda.graph(graph):
        out = tpa.ragged_prefill_attention(q, kp, vp, pt, off)
    assert tpa.prefill_launches == n0 + 1
    for o in (0, 37, 64, 300, 767):
        off.fill_(o)
        graph.replay()
        want = tpa.ragged_prefill_attention(q, kp, vp, pt, o)
        assert torch.equal(out, want), o
        if dtype == "float32":
            ref = tpa.paged_prefill_attention(q, kp, vp, pt, o)
            assert (out - ref).abs().max().item() <= 1e-5
