"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``gpu`` and skips without a CUDA device. The file
imports neither JAX nor the JAX package, so it also runs on a machine that
has only PyTorch; there, skip the repository's conftest (which sets JAX up):

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest -q
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
                                      MoEServingEngine, ServingEngine)

# bf16 is compared after widening both sides to f32
TOL = {"float32": 1e-4, "bfloat16": 2e-2}

FLASH_CASES = {
    # name: (B, Sq, Sk, N, Nkv, D, causal, q_offset)
    "causal_d64": (2, 128, 128, 2, 2, 64, True, None),
    "causal_d128": (1, 256, 256, 8, 8, 128, True, None),
    "causal_ragged": (1, 233, 233, 8, 8, 128, True, None),
    "causal_offset": (1, 64, 160, 2, 2, 64, True, 96),
    "gqa_causal": (1, 128, 128, 4, 2, 64, True, None),
    "cross_ragged": (1, 70, 130, 2, 1, 128, False, None),
}


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_kernel_matches_plain(case, dtype):
    dev = _cuda()
    B, Sq, Sk, N, Nkv, D, causal, off = FLASH_CASES[case]
    dt = getattr(torch, dtype)
    q, k, v = (torch.from_numpy(_rand(shape, seed)).to(dev, dt)
               for shape, seed in (((B, Sq, N, D), 1), ((B, Sk, Nkv, D), 2),
                                   ((B, Sk, Nkv, D), 3)))
    n0 = tfa.launches
    o, lse = tfa.flash_attention_fwd(q, k, v, causal=causal, q_offset=off)
    torch.cuda.synchronize()
    assert tfa.launches == n0 + 1
    o_ref, lse_ref = tfa.flash_attention_reference(q, k, v, causal=causal,
                                                   q_offset=off)
    torch.testing.assert_close(o.float(), o_ref.float(), rtol=TOL[dtype],
                               atol=TOL[dtype])
    torch.testing.assert_close(lse, lse_ref, rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
def test_flash_kernel_reads_strided_qkv_views():
    """Slices of a fused [B, S, 3, N, D] projection go in without a copy."""
    dev = _cuda()
    qkv = torch.randn(1, 300, 3, 8, 128, device=dev, dtype=torch.bfloat16)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    o = tfa.flash_attention_bshd(q, k, v, causal=True)
    ref = tfa.flash_attention_bshd(*(t.cpu() for t in (q, k, v)),
                                   causal=True)
    torch.testing.assert_close(o.cpu().float(), ref.float(), rtol=2e-2,
                               atol=2e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_bwd_kernels_match_plain(case, dtype):
    """The dQ and dK/dV kernels against the plain backward, from the same
    forward residuals; each kernel launches once per call."""
    dev = _cuda()
    B, Sq, Sk, N, Nkv, D, causal, off = FLASH_CASES[case]
    dt = getattr(torch, dtype)
    q, k, v, do = (torch.from_numpy(_rand(shape, seed)).to(dev, dt)
                   for shape, seed in (((B, Sq, N, D), 1), ((B, Sk, Nkv, D), 2),
                                       ((B, Sk, Nkv, D), 3), ((B, Sq, N, D), 4)))
    o, lse = tfa.flash_attention_fwd(q, k, v, causal=causal, q_offset=off)
    n_dq, n_dkv = tfa.dq_launches, tfa.dkv_launches
    grads = tfa.flash_attention_bwd(q, k, v, o, lse, do, causal=causal,
                                    q_offset=off)
    torch.cuda.synchronize()
    assert (tfa.dq_launches, tfa.dkv_launches) == (n_dq + 1, n_dkv + 1)
    refs = tfa.flash_attention_bwd_reference(q, k, v, o, lse, do,
                                             causal=causal, q_offset=off)
    for name, g, r in zip("qkv", grads, refs):
        assert g.dtype == dt and g.shape == r.shape, name
        torch.testing.assert_close(g.float(), r.float(), rtol=TOL[dtype],
                                   atol=TOL[dtype], msg=f"d{name}")


@pytest.mark.gpu
def test_flash_function_grads_on_strided_qkv_views():
    """Gradients through the autograd Function, whose inputs are the q/k/v
    slices of a fused [B, S, 3, N, D] projection, against the same
    Function on the CPU (plain forward and backward)."""
    dev = _cuda()
    qkv = torch.from_numpy(_rand((2, 300, 3, 8, 128), 5)).to(torch.bfloat16)
    do = torch.from_numpy(_rand((2, 300, 8, 128), 6)).to(torch.bfloat16)
    grads = []
    for t, g in ((qkv.to(dev), do.to(dev)), (qkv, do)):
        t = t.requires_grad_()
        out = tfa.flash_attention_bshd(t[:, :, 0], t[:, :, 1], t[:, :, 2],
                                       causal=True)
        grads.append(torch.autograd.grad(out, t, g)[0].cpu().float())
    torch.testing.assert_close(grads[0], grads[1], rtol=2e-2, atol=2e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("nkv", [8, 4])
def test_paged_kernel_matches_plain(dtype, nkv):
    dev = _cuda()
    dt = getattr(torch, dtype)
    B, nh, d, ps, pps = 8, 8, 128, 64, 4
    npg = B * pps + 1
    q = torch.from_numpy(_rand((B, nh, d), 6)).to(dev, dt)
    kp = torch.from_numpy(_rand((npg, ps, nkv, d), 7)).to(dev, dt)
    vp = torch.from_numpy(_rand((npg, ps, nkv, d), 8)).to(dev, dt)
    perm = np.random.default_rng(5).permutation(np.arange(1, npg))
    pt = torch.from_numpy(perm.reshape(B, pps).astype(np.int32)).to(dev)
    lens = [256, 1, 0, 65, 200, 64, 129, 17]
    sl = torch.tensor(lens, dtype=torch.int32, device=dev)
    n0 = tpa.launches
    out = tpa.paged_attention_decode(q, kp, vp, pt, sl)
    torch.cuda.synchronize()
    assert tpa.launches == n0 + 1
    ref = tpa.paged_attention_reference(q, kp, vp, pt, sl)
    live = torch.tensor([n > 0 for n in lens], device=dev)
    torch.testing.assert_close(out.float()[live], ref.float()[live],
                               rtol=TOL[dtype], atol=TOL[dtype])
    assert torch.equal(out[2].float(), torch.zeros(nh, d, device=dev))


@pytest.mark.gpu
def test_kernels_refuse_what_they_do_not_take():
    dev = _cuda()
    q = torch.randn(1, 64, 2, 160, device=dev)       # head dim past 128
    with pytest.raises(ValueError, match="head dim"):
        tfa.flash_attention_bshd(q, q, q, causal=True)
    q = torch.randn(1, 64, 2, 64, device=dev, dtype=torch.float16)
    with pytest.raises(TypeError):
        tfa.flash_attention_bshd(q, q, q, causal=True)
    kp = torch.zeros(3, 4, 1, 64, device=dev)
    with pytest.raises(TypeError, match="int32"):
        tpa.paged_attention_decode(
            torch.zeros(1, 1, 64, device=dev), kp, kp,
            torch.ones(1, 2, dtype=torch.int64, device=dev),
            torch.ones(1, dtype=torch.int32, device=dev))
    q = torch.randn(1, 64, 2, 160, device=dev)        # backward, head dim 160
    lse = torch.zeros(1, 2, 64, device=dev)
    with pytest.raises(ValueError, match="head dim"):
        tfa.flash_attention_bwd(q, q, q, q, lse, q, causal=True)
    q = torch.randn(1, 64, 2, 64, device=dev)
    with pytest.raises(ValueError, match="lse"):
        tfa.flash_attention_bwd(q, q, q, q, lse.double(), q, causal=True)
    with pytest.raises(TypeError):
        h = q.half()
        tfa.flash_attention_bwd(h, h, h, h, lse, h, causal=True)


@pytest.mark.gpu
def test_engine_on_cuda_matches_cpu():
    """The engine on the card (both kernels, f32) gives the CPU engine's
    greedy tokens, and every prefill layer and decode layer launched its
    kernel once."""
    _cuda()
    cfg = tgpt.gpt_tiny_config(hidden_size=128, num_heads=2)
    model = tgpt.GPTForPretraining(tgpt.GPTModel(cfg, seed=0, device="cpu"))
    rng = np.random.default_rng(8)
    prompts = [rng.integers(0, cfg.vocab_size, (n,)).astype(np.int32)
               for n in (70, 33, 100)]
    outs = []
    for dev in ("cpu", "cuda"):
        eng = ServingEngine(model, page_size=16, decode_buckets=(1, 2, 4),
                            use_flash=True, device=dev)
        sched = ContinuousBatchingScheduler(eng)
        f0, p0 = tfa.launches, tpa.launches
        reqs = [sched.submit(p, max_new_tokens=5) for p in prompts]
        sched.run()
        assert all(r.state == "finished" for r in reqs)
        assert eng.pool.pages_in_use == 0
        outs.append([r.output_ids for r in reqs])
        if dev == "cuda":
            assert tfa.launches - f0 == cfg.num_layers * len(prompts)
            assert tpa.launches - p0 == cfg.num_layers * sched.steps
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)


@pytest.mark.gpu
def test_train_step_on_cuda_matches_cpu():
    """Three f32 steps of the trainer at d = 64 (flash forward and both
    backward kernels, remat="dots") against the same steps on the CPU;
    per step the forward kernel runs twice per layer (forward and
    recompute), each backward kernel once."""
    _cuda()
    cfg = tgpt.gpt_tiny_config(hidden_size=128, num_heads=2, num_layers=2)
    rng = np.random.default_rng(9)
    ids = rng.integers(0, cfg.vocab_size, (2, 128)).astype(np.int32)
    labels = np.roll(ids, -1, axis=1)
    cpu = tgpt.GPTForPretraining(tgpt.GPTModel(cfg, seed=0, device="cpu"))
    losses = {}
    for dev in ("cpu", "cuda"):
        model = tgpt.GPTForPretraining(tgpt.GPTModel(cfg, device=dev))
        model.load_state_dict(cpu.state_dict())
        step = tgpt.GPTHybridTrainStep(model, cfg, lr=1e-3, remat="dots",
                                       use_flash=True)
        counts = (tfa.launches, tfa.dq_launches, tfa.dkv_launches)
        losses[dev] = [step(ids, labels).item() for _ in range(3)]
        if dev == "cuda":
            L = cfg.num_layers
            assert (tfa.launches - counts[0], tfa.dq_launches - counts[1],
                    tfa.dkv_launches - counts[2]) == (6 * L, 3 * L, 3 * L)
    # f32 on both; the sums run in other orders
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=0,
                               atol=1e-4)


def _prefill_inputs(dev, dt, B, C, nh, d, ps, pps, seed):
    """q [B, C, nh, d] as the q view of a fused [B, C, 3, nh, d] projection,
    a pool of B * pps + 1 shuffled pages and its page table."""
    npg = B * pps + 1
    qkv = torch.from_numpy(_rand((B, C, 3, nh, d), seed)).to(dev, dt)
    kp = torch.from_numpy(_rand((npg, ps, nh, d), seed + 1)).to(dev, dt)
    vp = torch.from_numpy(_rand((npg, ps, nh, d), seed + 2)).to(dev, dt)
    perm = np.random.default_rng(seed).permutation(np.arange(1, npg))
    pt = torch.from_numpy(perm.reshape(B, pps).astype(np.int32)).to(dev)
    return qkv[:, :, 0], kp, vp, pt


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("C,d,ps,pps,q_offset", [
    (256, 128, 64, 16, 768), (256, 128, 64, 16, 0), (100, 64, 16, 12, 37),
    (64, 128, 8, 24, 120)])
def test_prefill_kernel_matches_plain(dtype, C, d, ps, pps, q_offset):
    """Chunk prefill at offsets 0, mid-page and late (pages past the chunk
    skipped), a ragged chunk and d = 64, against the plain version."""
    dev = _cuda()
    dt = getattr(torch, dtype)
    q, kp, vp, pt = _prefill_inputs(dev, dt, 2, C, 4, d, ps, pps, 11)
    n0 = tpa.prefill_launches
    out = tpa.ragged_prefill_attention(q, kp, vp, pt, q_offset)
    torch.cuda.synchronize()
    assert tpa.prefill_launches == n0 + 1
    ref = tpa.paged_prefill_attention(q, kp, vp, pt, q_offset)
    torch.testing.assert_close(out.float(), ref.float(), rtol=TOL[dtype],
                               atol=TOL[dtype])


def _rms_share(out, ref):
    ref = ref.float()
    return ((out.float() - ref).square().mean().sqrt()
            / ref.square().mean().sqrt()).item()


@pytest.mark.gpu
@pytest.mark.parametrize("C,d,ps,pps,q_offset", [
    (256, 128, 64, 16, 768), (256, 128, 64, 16, 0), (100, 64, 16, 12, 37),
    (64, 128, 8, 24, 120)])
def test_prefill_kernel_matches_tiled_reference(C, d, ps, pps, q_offset):
    """bf16 chunk prefill against the plain version with the kernel's own
    rounding points (f32 scores times the scale, P rounded to bf16 per
    64-position tile): rms(out - ref) / rms(ref) <= 1e-4 and the largest
    error at most one bf16 spacing of the largest output (2^-7 of max
    |ref|). The same plain version without the rounding of P must exceed
    the rms limit, so the limit sees where P is rounded."""
    dev = _cuda()
    q, kp, vp, pt = _prefill_inputs(dev, torch.bfloat16, 2, C, 4, d, ps, pps,
                                    11)
    out = tpa.ragged_prefill_attention(q, kp, vp, pt, q_offset)
    ref = tpa.ragged_prefill_reference(q, kp, vp, pt, q_offset)
    ctl = tpa.ragged_prefill_reference(q, kp, vp, pt, q_offset,
                                       round_p=False)
    assert _rms_share(out, ref) <= 1e-4
    assert (out.float() - ref.float()).abs().max().item() \
        <= 2 ** -7 * ref.float().abs().max().item()
    assert _rms_share(ctl, ref) > 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layout", ["kn", "nk"])
@pytest.mark.parametrize("M,K,N", [(1, 1024, 3072), (8, 1024, 1024),
                                   (3, 4096, 1024), (256, 1024, 4096),
                                   (5, 100, 77), (1, 1024, 50304)])
def test_int8_kernel_matches_plain(dtype, layout, M, K, N):
    dev = _cuda()
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(M + K + N)
    x = torch.from_numpy(_rand((M, K), 3)).to(dev, dt)
    shape = (K, N) if layout == "kn" else (N, K)
    w = torch.from_numpy(rng.integers(-128, 128, shape).astype(np.int8)).to(dev)
    s = torch.from_numpy(rng.uniform(1e-3, 2e-2, N).astype(np.float32)).to(dev)
    n0 = tim.launches
    out = tim.int8_matmul(x, w, s, layout=layout)
    out2 = tim.int8_matmul(x, w, s, layout=layout)
    torch.cuda.synchronize()
    assert tim.launches == n0 + 2
    assert torch.equal(out, out2)           # the split-K sum is deterministic
    ref = tim.int8_matmul_reference(x, w, s, layout)
    tol = 1e-4 if dtype == "float32" else 1e-2
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", [
    dict(prefill_chunk=32), dict(prefix_cache=True, prefill_chunk=32),
    dict(quantize="int8"),
    dict(quantize="int8", prefix_cache=True, prefill_chunk=32)])
def test_engine_modes_on_cuda_match_cpu(mode):
    """Chunked prefill, the prefix cache and int8 weights, alone and
    combined, on the card (f32) give the CPU engine's greedy tokens; every
    chunk layer launched the chunk-prefill kernel and every int8 matmul
    the int8 kernel."""
    _cuda()
    from paddle_tpu_torch.serving import make_shared_prefix_workload
    cfg = tgpt.gpt_tiny_config(hidden_size=128, num_heads=2)
    model = tgpt.GPTForPretraining(tgpt.GPTModel(cfg, seed=0, device="cpu"))
    prompts = make_shared_prefix_workload(
        cfg.vocab_size, 5, prefix_len=40, suffix_len=9, seed=2,
        divergence_offsets=(0, 0, 7))
    outs = []
    for dev in ("cpu", "cuda"):
        eng = ServingEngine(model, page_size=16, decode_buckets=(1, 2, 4),
                            device=dev, **mode)
        sched = ContinuousBatchingScheduler(eng)
        n_pre, n_int8 = tpa.prefill_launches, tim.launches
        reqs = [sched.submit(p, max_new_tokens=5) for p in prompts]
        sched.run()
        assert all(r.state == "finished" for r in reqs)
        outs.append([r.output_ids for r in reqs])
        if dev == "cpu":
            continue
        L = cfg.num_layers
        chunks = sum(r.prefill_chunks for r in reqs)
        want_pre = L * chunks if eng.prefill_chunk else 0
        assert tpa.prefill_launches - n_pre == want_pre
        if mode.get("quantize"):
            # 4 matmuls a layer and the logits per decode step and chunk;
            # a bucketed prefill runs the int8 kernel for its logits only
            want = (4 * L + 1) * (sched.steps + chunks) if eng.prefill_chunk \
                else (4 * L + 1) * sched.steps + len(reqs)
            assert tim.launches - n_int8 == want
        if mode.get("prefix_cache"):
            assert [r.cached_prefix_len for r in reqs][:3] == [0, 40, 33]
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)


# ------------------------------------------------- head dims below 128

@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [16, 32, 48, 64, 128])
def test_paged_kernels_at_every_head_dim(dtype, d):
    """The paged decode and chunk-prefill kernels at head dims 16, 32 and
    48 (run in the 64 instance, its columns past 48 masked), 64 and 128,
    against their plain versions."""
    dev = _cuda()
    dt = getattr(torch, dtype)
    B, nh, ps, pps = 4, 4, 16, 6
    npg = B * pps + 1
    q = torch.from_numpy(_rand((B, nh, d), 21)).to(dev, dt)
    kp = torch.from_numpy(_rand((npg, ps, nh, d), 22)).to(dev, dt)
    vp = torch.from_numpy(_rand((npg, ps, nh, d), 23)).to(dev, dt)
    perm = np.random.default_rng(d).permutation(np.arange(1, npg))
    pt = torch.from_numpy(perm.reshape(B, pps).astype(np.int32)).to(dev)
    sl = torch.tensor([96, 1, 0, 37], dtype=torch.int32, device=dev)
    n0, p0 = tpa.launches, tpa.prefill_launches
    out = tpa.paged_attention_decode(q, kp, vp, pt, sl)
    ref = tpa.paged_attention_reference(q, kp, vp, pt, sl)
    live = torch.tensor([True, True, False, True], device=dev)
    torch.testing.assert_close(out.float()[live], ref.float()[live],
                               rtol=TOL[dtype], atol=TOL[dtype])
    qc = torch.from_numpy(_rand((B, 40, nh, d), 24)).to(dev, dt)
    out = tpa.ragged_prefill_attention(qc, kp, vp, pt, 29)
    ref = tpa.paged_prefill_attention(qc, kp, vp, pt, 29)
    torch.testing.assert_close(out.float(), ref.float(), rtol=TOL[dtype],
                               atol=TOL[dtype])
    torch.cuda.synchronize()
    assert (tpa.launches, tpa.prefill_launches) == (n0 + 1, p0 + 1)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [16, 32, 40])
def test_flash_kernels_at_small_head_dims(dtype, d):
    """The flash forward and both backward kernels at d = 16, 32 and 40
    (the 64 instance, masked), causal with GQA, against the plain
    versions."""
    dev = _cuda()
    dt = getattr(torch, dtype)
    B, S, N, Nkv = 2, 150, 4, 2
    q, k, v, do = (torch.from_numpy(_rand(shape, seed)).to(dev, dt)
                   for shape, seed in (((B, S, N, d), 31), ((B, S, Nkv, d), 32),
                                       ((B, S, Nkv, d), 33), ((B, S, N, d), 34)))
    o, lse = tfa.flash_attention_fwd(q, k, v, causal=True)
    o_ref, lse_ref = tfa.flash_attention_reference(q, k, v, causal=True)
    torch.testing.assert_close(o.float(), o_ref.float(), rtol=TOL[dtype],
                               atol=TOL[dtype])
    torch.testing.assert_close(lse, lse_ref, rtol=1e-4, atol=1e-4)
    grads = tfa.flash_attention_bwd(q, k, v, o, lse, do, causal=True)
    refs = tfa.flash_attention_bwd_reference(q, k, v, o, lse, do,
                                             causal=True)
    for name, g, r in zip("qkv", grads, refs):
        torch.testing.assert_close(g.float(), r.float(), rtol=TOL[dtype],
                                   atol=TOL[dtype], msg=f"d{name}")


@pytest.mark.gpu
def test_gpt_tiny_engine_on_cuda_matches_cpu():
    """gpt_tiny_config (head dim 16) serves on the card through the flash
    and paged decode kernels with the CPU engine's greedy tokens (f32)."""
    _cuda()
    cfg = tgpt.gpt_tiny_config()
    assert cfg.head_dim == 16
    model = tgpt.GPTForPretraining(tgpt.GPTModel(cfg, seed=0, device="cpu"))
    rng = np.random.default_rng(9)
    prompts = [rng.integers(0, cfg.vocab_size, (n,)).astype(np.int32)
               for n in (70, 33, 100)]
    outs = []
    for dev in ("cpu", "cuda"):
        eng = ServingEngine(model, page_size=16, decode_buckets=(1, 2, 4),
                            use_flash=True, device=dev)
        sched = ContinuousBatchingScheduler(eng)
        f0, p0 = tfa.launches, tpa.launches
        reqs = [sched.submit(p, max_new_tokens=6) for p in prompts]
        sched.run()
        assert all(r.state == "finished" for r in reqs)
        outs.append([r.output_ids for r in reqs])
        if dev == "cuda":
            assert tfa.launches - f0 == cfg.num_layers * len(prompts)
            assert tpa.launches - p0 == cfg.num_layers * sched.steps
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)


# ------------------------------------------------------------------ MoE

def _dispatch_inputs(dev, dt, S, M, E, seed):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((S, M)).astype(np.float32))
    gw = torch.from_numpy((rng.standard_normal((M, E))
                           / np.sqrt(M)).astype(np.float32))
    gb = torch.from_numpy(rng.standard_normal(E).astype(np.float32) * 0.1)
    return x.to(dev, dt), gw.to(dev), gb.to(dev)


def check_dispatch(out, idx, x, gw, gb, E, C, K, kind):
    """The kernel's dispatch against the plain version: the experts it
    picked equal the plain version's except at near ties; comb_idx and
    expert_in exactly the slot rule's for the picked experts; val (where
    the picks agree), me and ce within 1e-6 of the largest |value|.
    Returns the number of near ties."""
    ref = tmd.reference_moe_dispatch(x, gw, gb, num_expert=E, capacity=C,
                                     top_k=K, gate_kind=kind)
    logits = tmd.gate_logits(x, gw, gb)
    _, pidx = tmd._top_k(logits, K)
    near = tmd.near_ties(logits, K)
    flipped = (idx.long() != pidx).any(-1)
    assert not (flipped & ~near).any(), "routing differs off a near tie"
    st, comb = tmd.dispatch_indices(idx, num_expert=E, capacity=C)
    assert torch.equal(out[1], comb)
    xp = torch.cat([x, x.new_zeros(1, x.shape[1])])
    assert torch.equal(out[0].reshape(E * C, -1), xp[st.long()])
    same = ~flipped
    for got, want in ((out[2][same], ref[2][same]), (out[3], ref[3]),
                      (out[4], tmd.F.one_hot(idx[:, 0].long(), E)
                       .float().mean(0))):
        assert (got - want).abs().max() <= 1e-6 * want.abs().max()
    return int(near.sum())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,M,E,C,K,kind", [
    (13, 32, 4, 13, 2, "gshard"),       # the tiny config, C = S
    (8, 768, 8, 8, 2, "gshard"),        # ERNIE base decode
    (512, 768, 8, 512, 2, "gshard"),    # ERNIE base prefill
    (130, 768, 8, 40, 2, "renorm"),     # ragged, dropping
    (300, 64, 6, 30, 1, "switch"),
    (77, 96, 5, 77, 3, "naive")])
def test_moe_dispatch_kernel_matches_plain(dtype, S, M, E, C, K, kind):
    dev = _cuda()
    x, gw, gb = _dispatch_inputs(dev, getattr(torch, dtype), S, M, E, S + M)
    n0 = tmd.dispatch_launches
    out, idx = tmd._launch_dispatch(x, gw, gb, E, C, K, kind)
    torch.cuda.synchronize()
    assert tmd.dispatch_launches == n0 + 1
    check_dispatch(out, idx, x, gw, gb, E, C, K, kind)
    wb = (gw.bfloat16(), gb.bfloat16())            # bf16 gate weights
    check_dispatch(*tmd._launch_dispatch(x, *wb, E, C, K, kind), x, *wb, E,
                   C, K, kind)
    # the same bits every run (no atomics)
    out2, _ = tmd._launch_dispatch(x, gw, gb, E, C, K, kind)
    for a, b in zip(out, out2):
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("w_dtype,b_dtype", [("bfloat16", "float32"),
                                             ("float32", "bfloat16")])
def test_moe_dispatch_kernel_mixed_gate_dtypes(w_dtype, b_dtype):
    """A gate weight and bias of different dtypes reach the kernel each in
    its own dtype: an f32 bias is not rounded to a bf16 weight's dtype."""
    dev = _cuda()
    S, M, E, C, K = 8, 768, 8, 8, 2
    x, gw, gb = _dispatch_inputs(dev, torch.bfloat16, S, M, E, 5)
    gw, gb = gw.to(getattr(torch, w_dtype)), gb.to(getattr(torch, b_dtype))
    check_dispatch(*tmd._launch_dispatch(x, gw, gb, E, C, K, "gshard"), x,
                   gw, gb, E, C, K, "gshard")


def _within_one_bf16_spacing(a, b):
    a, b = a.float(), b.float()
    ulp = torch.exp2(torch.floor(torch.log2(b.abs().clamp_min(1e-30))) - 7)
    return bool(((a - b).abs() <= ulp).all())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,M,E,C,K", [(13, 32, 4, 13, 2), (8, 768, 8, 8, 2),
                                       (512, 768, 8, 512, 2),
                                       (130, 768, 8, 40, 2), (9, 20, 3, 4, 3)])
def test_moe_combine_kernel_matches_plain(dtype, S, M, E, C, K):
    """The combine kernel against the plain version with its rounding
    points (f32 within 1e-6 of the largest |y|, bf16 within one bf16
    spacing) and against the einsum reference."""
    dev = _cuda()
    dt = getattr(torch, dtype)
    x, gw, gb = _dispatch_inputs(dev, torch.float32, S, 16, E, S)
    _, comb, val, _, _ = tmd.reference_moe_dispatch(
        x, gw, gb, num_expert=E, capacity=C, top_k=K)
    eo = torch.from_numpy(_rand((E * C, M), 3)).to(dev, dt)
    n0 = tmd.combine_launches
    y = tmd.fused_moe_combine(eo, val, comb)
    torch.cuda.synchronize()
    assert tmd.combine_launches == n0 + 1
    ref = tmd.combine_kernel_reference(eo, val, comb)
    einsum = tmd.reference_moe_combine(eo, val, comb)
    if dtype == "float32":
        top = ref.abs().max()
        assert (y - ref).abs().max() <= 1e-6 * top
        assert (y - einsum).abs().max() <= 1e-6 * top
    else:
        assert _within_one_bf16_spacing(y, ref)
        torch.testing.assert_close(y.float(), einsum.float(), rtol=2e-2,
                                   atol=2e-2)


def _moe_tiny_cfg(**kw):
    base = dict(num_hidden_layers=2, hidden_size=32, num_attention_heads=2,
                intermediate_size=64, num_experts=4, capacity_factor=100.0,
                max_position_embeddings=64)
    base.update(kw)
    return ternie.ernie_moe_tiny_config(**base)


@pytest.mark.gpu
def test_moe_engine_on_cuda_matches_cpu():
    """The MoE engine on the card (f32; head dim 16 through the paged
    decode kernel, both MoE kernels) gives the CPU engine's greedy tokens
    and the eager generator's; each MoE layer launches the dispatch and
    combine kernels once per prefill and decode step, each layer the
    paged decode kernel once per decode step."""
    _cuda()
    cfg = _moe_tiny_cfg()
    model = ternie.ErnieMoeForPretraining(
        ternie.ErnieMoeModel(cfg, seed=0, device="cpu")).eval()
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, (n,)).astype(np.int32)
               for n in (5, 9, 3, 12)]
    outs = []
    for dev in ("cpu", "cuda"):
        eng = MoEServingEngine(model, page_size=8, decode_buckets=(1, 2, 4),
                               device=dev)
        sched = ContinuousBatchingScheduler(eng)
        d0, c0, p0 = (tmd.dispatch_launches, tmd.combine_launches,
                      tpa.launches)
        reqs = [sched.submit(p, max_new_tokens=6) for p in prompts]
        sched.run()
        assert all(r.state == "finished" for r in reqs)
        assert eng.pool.pages_in_use == 0
        outs.append([list(r.tokens) for r in reqs])
        if dev == "cuda":
            n_moe = sum(k == "moe" for k in eng.kinds)
            calls = len(prompts) + sched.steps
            assert tmd.dispatch_launches - d0 == n_moe * calls
            assert tmd.combine_launches - c0 == n_moe * calls
            assert tpa.launches - p0 == cfg.num_hidden_layers * sched.steps
    assert outs[0] == outs[1]
    gen = ternie.ErnieMoeGenerator(model)
    for p, toks in zip(prompts, outs[1]):
        assert toks == list(gen(p, 6)[0])
