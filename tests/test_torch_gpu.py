"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``gpu`` and skips without a CUDA device. The file
imports neither JAX nor the JAX package, so it also runs on a machine that
has only PyTorch; there, skip the repository's conftest (which sets JAX up):

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest -q
"""
import contextlib
import re

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


def _fused_qkv_views(B, S, N, Nkv, D, seed):
    """q, k, v as the slices of one fused [B, S, N + 2 Nkv, D] bf16
    projection (row stride (N + 2 Nkv) D), and an output gradient."""
    qkv = torch.from_numpy(_rand((B, S, N + 2 * Nkv, D), seed)).to(
        "cuda", torch.bfloat16)
    do = torch.from_numpy(_rand((B, S, N, D), seed + 1)).to(
        "cuda", torch.bfloat16)
    return (*qkv.split([N, Nkv, Nkv], dim=2), do)


@pytest.mark.gpu
@pytest.mark.parametrize("nkv", [8, 2])
def test_flash_bwd_bf16_repeats_bit_for_bit(nkv):
    """The bf16 dQ and dK/dV kernels use no atomics: two calls on the same
    inputs (the training layout, fused-QKV views, S = 1024, 8 heads of 128;
    and GQA) give the same bits."""
    _cuda()
    q, k, v, do = _fused_qkv_views(2, 1024, 8, nkv, 128, 41)
    o, lse = tfa.flash_attention_fwd(q, k, v, causal=True)
    first = tfa.flash_attention_bwd(q, k, v, o, lse, do, causal=True)
    second = tfa.flash_attention_bwd(q, k, v, o, lse, do, causal=True)
    for name, a, b in zip("qkv", first, second):
        assert torch.equal(a, b), f"d{name}"


@pytest.mark.gpu
@pytest.mark.parametrize("d", [80, 112])
def test_flash_bwd_bf16_masked_head_dims(d):
    """bf16 at head dims the 128 instance runs masked (columns d..127
    zero-filled and never stored), causal with GQA, on fused-QKV views,
    against the plain backward."""
    _cuda()
    q, k, v, do = _fused_qkv_views(2, 300, 4, 2, d, 43)
    o, lse = tfa.flash_attention_fwd(q, k, v, causal=True)
    n_dq, n_dkv = tfa.dq_launches, tfa.dkv_launches
    grads = tfa.flash_attention_bwd(q, k, v, o, lse, do, causal=True)
    torch.cuda.synchronize()
    assert (tfa.dq_launches, tfa.dkv_launches) == (n_dq + 1, n_dkv + 1)
    refs = tfa.flash_attention_bwd_reference(q, k, v, o, lse, do,
                                             causal=True)
    for name, g, r in zip("qkv", grads, refs):
        assert g.shape == r.shape and g.dtype == torch.bfloat16, name
        torch.testing.assert_close(g.float(), r.float(), rtol=TOL["bfloat16"],
                                   atol=TOL["bfloat16"], msg=f"d{name}")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_bwd_ragged_offset_edges_in_one_tile(dtype):
    """Causal with q_offset = 100, Sq = 1000, Sk = 1100, GQA: the diagonal
    (not tile-aligned) and the Sq and Sk edges fall inside tiles."""
    dev = _cuda()
    dt = getattr(torch, dtype)
    B, Sq, Sk, N, Nkv, D, off = 1, 1000, 1100, 4, 2, 128, 100
    q, k, v, do = (torch.from_numpy(_rand(shape, seed)).to(dev, dt)
                   for shape, seed in (((B, Sq, N, D), 45), ((B, Sk, Nkv, D), 46),
                                       ((B, Sk, Nkv, D), 47), ((B, Sq, N, D), 48)))
    o, lse = tfa.flash_attention_fwd(q, k, v, causal=True, q_offset=off)
    grads = tfa.flash_attention_bwd(q, k, v, o, lse, do, causal=True,
                                    q_offset=off)
    refs = tfa.flash_attention_bwd_reference(q, k, v, o, lse, do,
                                             causal=True, q_offset=off)
    for name, g, r in zip("qkv", grads, refs):
        torch.testing.assert_close(g.float(), r.float(), rtol=TOL[dtype],
                                   atol=TOL[dtype], msg=f"d{name}")


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


# ------------------------------ bf16 attention forward on the tensor cores

def _hold_tiled(out, q, kp, vp, pt, q_offset):
    """bf16 chunk prefill against the plain version with its rounding
    points, at the limits of test_prefill_kernel_matches_tiled_reference:
    rms share <= 1e-4, largest error <= 2^-7 of max |ref|."""
    ref = tpa.ragged_prefill_reference(q, kp, vp, pt, q_offset)
    assert _rms_share(out, ref) <= 1e-4
    assert (out.float() - ref.float()).abs().max().item() \
        <= 2 ** -7 * ref.float().abs().max().item()


@pytest.mark.gpu
@pytest.mark.parametrize("nkv", [8, 2])
def test_flash_fwd_bf16_repeats_bit_for_bit(nkv):
    """The bf16 forward uses no atomics: two calls on fused-QKV views (the
    training layout, S = 1024, 8 heads of 128; and GQA) give the same
    bits, O and LSE."""
    _cuda()
    q, k, v, _ = _fused_qkv_views(2, 1024, 8, nkv, 128, 51)
    first = tfa.flash_attention_fwd(q, k, v, causal=True)
    second = tfa.flash_attention_fwd(q, k, v, causal=True)
    assert torch.equal(first[0], second[0])
    assert torch.equal(first[1], second[1])


@pytest.mark.gpu
def test_prefill_bf16_repeats_bit_for_bit():
    """Two calls of the bf16 chunk prefill give the same bits."""
    dev = _cuda()
    q, kp, vp, pt = _prefill_inputs(dev, torch.bfloat16, 2, 256, 8, 128, 64,
                                    16, 52)
    first = tpa.ragged_prefill_attention(q, kp, vp, pt, 768)
    second = tpa.ragged_prefill_attention(q, kp, vp, pt, 768)
    assert torch.equal(first, second)


@pytest.mark.gpu
@pytest.mark.parametrize("d", [16, 40, 80, 96])
def test_attention_fwd_bf16_masked_head_dims(d):
    """bf16 at head dims 16 (its own instance) and 40, 80 and 96 (columns
    past d zero-filled and never stored): the flash forward causal with
    GQA on fused-QKV views, and the chunk prefill at a mid-page offset,
    against their plain versions (the prefill also against the one with
    its rounding points)."""
    dev = _cuda()
    q, k, v, _ = _fused_qkv_views(2, 300, 4, 2, d, 53)
    n0 = tfa.launches
    o, lse = tfa.flash_attention_fwd(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert tfa.launches == n0 + 1
    o_ref, lse_ref = tfa.flash_attention_reference(q, k, v, causal=True)
    torch.testing.assert_close(o.float(), o_ref.float(),
                               rtol=TOL["bfloat16"], atol=TOL["bfloat16"])
    torch.testing.assert_close(lse, lse_ref, rtol=1e-4, atol=1e-4)
    qc, kp, vp, pt = _prefill_inputs(dev, torch.bfloat16, 2, 100, 4, d, 16,
                                     12, 54)
    out = tpa.ragged_prefill_attention(qc, kp, vp, pt, 37)
    ref = tpa.paged_prefill_attention(qc, kp, vp, pt, 37)
    assert out.shape == ref.shape
    torch.testing.assert_close(out.float(), ref.float(),
                               rtol=TOL["bfloat16"], atol=TOL["bfloat16"])
    _hold_tiled(out, qc, kp, vp, pt, 37)


@pytest.mark.gpu
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S", [65, 129, 1025])
def test_flash_fwd_bf16_gqa_views_last_tile_one_row(S, causal):
    """The bf16 forward on the q/k/v views of one fused [B, S, N + 2 Nkv,
    D] projection under GQA (8 query heads, 2 KV heads), at S = 64 j + 1:
    the last 64-row query tile (and the last K/V tile) holds one row."""
    _cuda()
    q, k, v, _ = _fused_qkv_views(2, S, 8, 2, 128, 55)
    o, lse = tfa.flash_attention_fwd(q, k, v, causal=causal)
    o_ref, lse_ref = tfa.flash_attention_reference(q, k, v, causal=causal)
    torch.testing.assert_close(o.float(), o_ref.float(),
                               rtol=TOL["bfloat16"], atol=TOL["bfloat16"])
    torch.testing.assert_close(lse, lse_ref, rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("aligned", [False, True])
@pytest.mark.parametrize("ps", [8, 16, 32, 64, 128])
def test_prefill_bf16_page_sizes(ps, aligned):
    """The bf16 chunk prefill through pages of 8 to 128 positions (each
    16-byte chunk finds its page), at a mid-page or a page-aligned offset;
    the two sequences share the pages before the offset, and the chunk's
    last 40 rows are padding (zero rows), whose outputs must be finite.
    Against ragged_prefill_reference and the XLA version."""
    dev = _cuda()
    C = 128
    off = 4 * ps + (0 if aligned else ps // 2 + 1)
    pps = (off + C + ps - 1) // ps + 1
    q, kp, vp, pt = _prefill_inputs(dev, torch.bfloat16, 2, C, 4, 128, ps,
                                    pps, 56)
    pt[1, :off // ps] = pt[0, :off // ps]
    q[:, C - 40:] = 0
    out = tpa.ragged_prefill_attention(q, kp, vp, pt, off)
    assert bool(torch.isfinite(out.float()).all())
    _hold_tiled(out, q, kp, vp, pt, off)
    ref = tpa.paged_prefill_attention(q, kp, vp, pt, off)
    torch.testing.assert_close(out.float(), ref.float(),
                               rtol=TOL["bfloat16"], atol=TOL["bfloat16"])


@pytest.mark.gpu
@pytest.mark.parametrize("B,nh,C", [(1, 4, 1), (1, 4, 17), (1, 8, 100),
                                    (2, 8, 256), (4, 8, 256)])
def test_prefill_bf16_row_groups(B, nh, C):
    """The bf16 chunk prefill runs a block of 4 warps for each group of 16
    chunk rows: chunks of 1, 17 and 100 rows (the last group partial), and
    2 and 4 sequences of 256 (more blocks than SMs), against
    ragged_prefill_reference."""
    dev = _cuda()
    q, kp, vp, pt = _prefill_inputs(dev, torch.bfloat16, B, C, nh, 128, 64,
                                    10, 57)
    n0 = tpa.prefill_launches
    out = tpa.ragged_prefill_attention(q, kp, vp, pt, 300)
    torch.cuda.synchronize()
    assert tpa.prefill_launches == n0 + 1
    assert bool(torch.isfinite(out.float()).all())
    _hold_tiled(out, q, kp, vp, pt, 300)


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


# the dispatch's routes at decode sizes and around the switch point:
# (S, M, E, C, K, kind, x row stride or None for a contiguous x)
ONE_LAUNCH_S = tmd._ONE_LAUNCH_MAX_S
DISPATCH_ROUTE_CASES = {
    "decode_s1": (1, 768, 8, 1, 2, "gshard", None),
    "decode_s2": (2, 768, 8, 2, 2, "gshard", None),
    "decode_s4": (4, 768, 8, 4, 2, "gshard", None),
    "switch_point": (ONE_LAUNCH_S, 768, 8, ONE_LAUNCH_S, 2, "gshard", None),
    "past_switch_point": (ONE_LAUNCH_S + 1, 768, 8, ONE_LAUNCH_S + 1, 2,
                          "gshard", None),
    "dropping": (8, 768, 8, 1, 2, "renorm", None),      # C < S
    "e5": (7, 96, 5, 7, 3, "naive", None),
    "e6": (9, 64, 6, 1, 1, "switch", None),             # drops too
    "m20_no_vectors": (5, 20, 4, 5, 2, "gshard", None),
    "e32_gate_unstaged": (8, 768, 32, 8, 2, "gshard", None),  # 96 KB gate_w
    "fused_x": (8, 768, 8, 8, 2, "gshard", 3 * 768),    # a slice of [S, 3M]
}


def _dispatch_route_inputs(dev, dt, S, M, E, stride, seed):
    x, gw, gb = _dispatch_inputs(dev, dt, S, M, E, seed)
    if stride is not None:           # x as the first M columns of wider rows
        wide = torch.from_numpy(_rand((S, stride), seed + 1)).to(dev, dt)
        wide[:, :M] = x
        x = wide[:, :M]
        assert x.stride(0) == stride and not x.is_contiguous()
    return x, gw, gb


@pytest.mark.gpu
@pytest.mark.parametrize("route", tmd.DISPATCH_ROUTES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(DISPATCH_ROUTE_CASES))
def test_moe_dispatch_routes_match_plain(case, dtype, route):
    """Each dispatch route against the plain version (the routing exact off
    near ties, val, me and ce within 1e-6 of the largest value), f32 and
    bf16 gate weights, two calls bit-equal; the route the shapes pick is the
    one-launch route up to the switch point and the three passes past it."""
    dev = _cuda()
    S, M, E, C, K, kind, stride = DISPATCH_ROUTE_CASES[case]
    want = "one_launch" if S <= ONE_LAUNCH_S else "three_pass"
    assert tmd.dispatch_route(S, E, K) == want
    x, gw, gb = _dispatch_route_inputs(dev, getattr(torch, dtype), S, M, E,
                                       stride, S * 7 + M)
    with tmd._dispatch_route(route):
        n0 = tmd.dispatch_launches
        out, idx = tmd._launch_dispatch(x, gw, gb, E, C, K, kind)
        torch.cuda.synchronize()
        assert tmd.dispatch_launches == n0 + 1
        check_dispatch(out, idx, x, gw, gb, E, C, K, kind)
        if E * C < S * K:
            assert (out[1] == E * C).any(), "the case drops no choice"
        wb = (gw.bfloat16(), gb.bfloat16())
        check_dispatch(*tmd._launch_dispatch(x, *wb, E, C, K, kind), x,
                       *wb, E, C, K, kind)
        out2, idx2 = tmd._launch_dispatch(x, gw, gb, E, C, K, kind)
    for a, b in zip((*out, idx), (*out2, idx2)):
        assert torch.equal(a, b)


def _moe_kernels(fn, calls=5):
    """The MoE kernel launches of ``calls`` calls of ``fn``, by name under
    the profiler (one entry per launch seen; the profiler on the card's
    machine may drop some); profiled again while it records no device
    activity at all."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(8):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == DeviceType.CUDA]
        if names:
            break
    return [n for n in names if "moe_" in n]


def _graph_moe_kernels(fn, path):
    """The MoE kernel nodes of a CUDA graph captured around one call of
    ``fn`` (by their labels in the graph's DOT dump), and the call's
    outputs after a replay."""
    try:                        # the captured graph kept for its dump
        g = torch.cuda.CUDAGraph(keep_graph=True)
    except TypeError:           # a PyTorch that keeps it in debug mode
        g = torch.cuda.CUDAGraph()
    g.enable_debug_mode()
    with torch.cuda.graph(g):
        out = fn()
    g.replay()
    torch.cuda.synchronize()
    g.debug_dump(str(path))
    labels = re.findall(r'label="([^"]*)"', path.read_text())
    return [lab for lab in labels if "moe_" in lab], out


@pytest.mark.gpu
@pytest.mark.parametrize("S", [8, ONE_LAUNCH_S + 1])
def test_moe_dispatch_launches_by_name(S, tmp_path):
    """At the decode shape S = 8 the dispatch is one kernel launch, the
    one-launch kernel; past the switch point the three passes. Read by
    name under the profiler, and counted exactly as the kernel nodes of a
    CUDA graph captured around one call, whose replay gives the eager
    call's bits."""
    dev = _cuda()
    x, gw, gb = _dispatch_inputs(dev, torch.bfloat16, S, 768, 8, 3)
    gw, gb = gw.bfloat16(), gb.bfloat16()

    def call():
        return tmd.fused_moe_dispatch(x, gw, gb, num_expert=8, capacity=S,
                                      top_k=2)
    eager = call()                                      # built and warm
    want = (("moe_dispatch_one_kernel",) if S <= ONE_LAUNCH_S else
            ("moe_gate_kernel", "moe_scan_kernel", "moe_scatter_kernel"))
    names = _moe_kernels(call)
    assert names and len(names) <= 5 * len(want), names
    assert all(any(k in n for n in names) for k in want), names
    assert all(any(k in n for k in want) for n in names), names
    nodes, out = _graph_moe_kernels(call, tmp_path / "dispatch.dot")
    assert len(nodes) == len(want) and all(
        sum(k in n for n in nodes) == 1 for k in want), nodes
    for a, b in zip(eager, out):
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,M,E,C,K", [(40, 768, 4, 5, 1), (24, 768, 6, 3, 3),
                                       (8, 768, 8, 8, 2), (3, 20, 4, 1, 3)])
def test_moe_combine_grid_drops_bit_equal(dtype, S, M, E, C, K):
    """The combine over its (token, column chunk) grid with dropped choices:
    bit-equal to the plain version with its rounding points in f32, within
    one bf16 spacing in bf16; two calls bit-equal."""
    dev = _cuda()
    dt = getattr(torch, dtype)
    x, gw, gb = _dispatch_inputs(dev, torch.float32, S, 16, E, S + K)
    _, comb, val, _, _ = tmd.reference_moe_dispatch(
        x, gw, gb, num_expert=E, capacity=C, top_k=K)
    if C * E < S * K:
        assert (comb == E * C).any(), "the case drops no choice"
    eo = torch.from_numpy(_rand((E * C, M), 5)).to(dev, dt)
    y = tmd.fused_moe_combine(eo, val, comb)
    torch.cuda.synchronize()
    ref = tmd.combine_kernel_reference(eo, val, comb)
    if dtype == "float32":
        assert torch.equal(y, ref)
    else:
        assert _within_one_bf16_spacing(y, ref)
    assert torch.equal(y, tmd.fused_moe_combine(eo, val, comb))


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


# ------------------------------ the one-pass int8 kernel, the split decode

def _int8_inputs(dev, dt, M, K, N, layout, offset, seed, x_pad=0):
    """x [M, K] (a view with row stride K + x_pad when x_pad > 0), an int8
    weight in its stored layout starting ``offset`` bytes into its buffer
    (not 16-byte aligned when offset % 16), and f32 scales."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(_rand((M, K + x_pad), seed)).to(dev, dt)[:, :K]
    shape = (K, N) if layout == "kn" else (N, K)
    buf = torch.from_numpy(rng.integers(-128, 128, K * N + offset)
                           .astype(np.int8)).to(dev)
    s = torch.from_numpy(rng.uniform(1e-4, 8e-4, N).astype(np.float32)).to(dev)
    return x, buf[offset:].view(shape), s


def _hold_int8(out, ref, dtype):
    """chip_smoke's limit: the largest error within 8e-3 (bf16, one
    rounding of the f32 result) or 1e-5 (f32, sums in another order) of
    max(1, max |ref|)."""
    top = max(1.0, ref.float().abs().max().item())
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= (8e-3 if dtype == "bfloat16" else 1e-5) * top, err


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layout", ["kn", "nk"])
@pytest.mark.parametrize("M", [1, 3, 8, 9, 17, 256])
@pytest.mark.parametrize("K,N,offset", [(1024, 1024, 0), (1000, 77, 0),
                                        (200, 3000, 3)])
def test_int8_one_pass_shapes(dtype, layout, M, K, N, offset):
    """Rows 1 to 256 (8 and 16 a block), ragged N and K, a weight that is
    not 16-byte aligned; two calls give the same bits."""
    dev = _cuda()
    x, w, s = _int8_inputs(dev, getattr(torch, dtype), M, K, N, layout,
                           offset, M * 7 + K)
    out = tim.int8_matmul(x, w, s, layout=layout)
    again = tim.int8_matmul(x, w, s, layout=layout)
    torch.cuda.synchronize()
    assert torch.equal(out, again)
    _hold_int8(out, tim.int8_matmul_reference(x, w, s, layout), dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layout", ["kn", "nk"])
@pytest.mark.parametrize("x_pad", [3, 8])
def test_int8_reads_x_with_a_row_stride(dtype, layout, x_pad):
    """x as a view whose row stride is not (3) and is (8) a multiple of 16
    bytes in bf16."""
    dev = _cuda()
    x, w, s = _int8_inputs(dev, getattr(torch, dtype), 8, 1024, 640, layout,
                           0, 11, x_pad=x_pad)
    assert x.stride(0) == 1024 + x_pad
    _hold_int8(tim.int8_matmul(x, w, s, layout=layout),
               tim.int8_matmul_reference(x, w, s, layout), dtype)


def _decode_inputs(dev, dt, B, nh, nkv, d, ps, pps, lens, seed):
    npg = B * pps + 1
    q = torch.from_numpy(_rand((B, nh, d), seed)).to(dev, dt)
    kp = torch.from_numpy(_rand((npg, ps, nkv, d), seed + 1)).to(dev, dt)
    vp = torch.from_numpy(_rand((npg, ps, nkv, d), seed + 2)).to(dev, dt)
    perm = np.random.default_rng(seed).permutation(np.arange(1, npg))
    pt = torch.from_numpy(perm.reshape(B, pps).astype(np.int32)).to(dev)
    sl = torch.tensor(lens, dtype=torch.int32, device=dev)
    return q, kp, vp, pt, sl


def _hold_decode(dtype, q, kp, vp, pt, sl, n_split):
    """The kernel at ``n_split`` against the plain version and the plain
    version in its own form, idle rows finite, two calls bit-equal."""
    scale = q.shape[-1] ** -0.5
    out = tpa._launch(q, kp, vp, pt, sl, scale, n_split=n_split)
    again = tpa._launch(q, kp, vp, pt, sl, scale, n_split=n_split)
    torch.cuda.synchronize()
    assert torch.equal(out, again)
    assert bool(torch.isfinite(out.float()).all())
    live = sl > 0
    for ref in (tpa.paged_attention_reference(q, kp, vp, pt, sl),
                tpa.paged_decode_split_reference(q, kp, vp, pt, sl,
                                                 n_split=n_split)):
        torch.testing.assert_close(out.float()[live], ref.float()[live],
                                   rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("lens", [[1, 1, 0, 1], [16, 16, 16, 0],
                                  [17, 0, 17, 33], [96, 96, 0, 96],
                                  [97, 500, 0, 200]],
                         ids=["one", "page", "page_plus_one", "full",
                              "past_the_table"])
def test_decode_split_lengths(dtype, lens):
    """Lengths 1, one page, a page and one, the whole table and past its
    reach (only the table's pages are read), each at 1, 2, 3 and 6 splits
    of the 6-page table; idle slots give finite rows."""
    dev = _cuda()
    args = _decode_inputs(dev, getattr(torch, dtype), 4, 8, 8, 128, 16, 6,
                          lens, 31)
    for n_split in (1, 2, 3, 6):
        _hold_decode(dtype, *args, n_split)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("g", [1, 2, 3, 4, 8, 12])
def test_decode_split_query_groups(dtype, g):
    """GQA: 1 to 12 query heads a KV head (up to 8 a block, 12 in two
    blocks), n_split above the live pages."""
    dev = _cuda()
    args = _decode_inputs(dev, getattr(torch, dtype), 3, 2 * g, 2, 64, 16,
                          8, [5, 40, 0], 41)
    for n_split in (1, 4, 8):
        _hold_decode(dtype, *args, n_split)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("ps", [8, 16, 32, 64, 128])
def test_decode_split_page_sizes(dtype, ps):
    """Pages of 8 to 128 positions (a 16-position step spans pages at 8),
    up to the largest split, a cluster of 8."""
    dev = _cuda()
    pps = 1024 // ps
    args = _decode_inputs(dev, getattr(torch, dtype), 4, 8, 8, 128, ps, pps,
                          [1000, 3, 0, 517], 51)
    for n_split in (1, tpa._decode_split(4, 8, 1, pps, 132), min(pps, 8)):
        _hold_decode(dtype, *args, n_split)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [16, 32, 48, 64, 80, 128])
def test_decode_split_head_dims(dtype, d):
    """Head dims at each instance's full width and masked (48, 80)."""
    dev = _cuda()
    args = _decode_inputs(dev, getattr(torch, dtype), 4, 4, 2, d, 32, 5,
                          [160, 33, 0, 64], 61 + d)
    for n_split in (1, 2, 5):
        _hold_decode(dtype, *args, n_split)


@pytest.mark.gpu
def test_decode_wrapper_splits_from_shapes_and_counts_one_launch():
    """The public wrapper picks its split from the shapes (the same for
    any lengths), launches once a call and matches the split form."""
    dev = _cuda()
    args = _decode_inputs(dev, torch.bfloat16, 8, 8, 8, 128, 64, 16,
                          [970, 545, 734, 266, 897, 162, 428, 0], 71)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    n_split = tpa._decode_split(8, 8, 1, 16, sms)
    assert 8 * 8 * n_split >= 2 * sms
    n0 = tpa.launches
    out = tpa.paged_attention_decode(*args)
    torch.cuda.synchronize()
    assert tpa.launches == n0 + 1
    torch.testing.assert_close(
        out.float(), tpa.paged_decode_split_reference(
            *args, n_split=n_split).float(), rtol=TOL["bfloat16"],
        atol=TOL["bfloat16"])


# ------------------------------------------- attention kernels on wgmma

def _kernels_run(fn):
    """The names of the CUDA kernels one call of ``fn`` launches (mangled):
    the kernel nodes of a CUDA graph captured around the call, after one
    call uncaptured, read from the graph's DOT dump. The driver lists every
    node, so the names do not depend on what ran before; the profiler,
    run after the file's other tests, has seen only some of the kernels."""
    import tempfile
    fn()
    torch.cuda.synchronize()
    try:                        # the captured graph kept for its dump
        g = torch.cuda.CUDAGraph(keep_graph=True)
    except TypeError:           # a PyTorch that keeps it in debug mode
        g = torch.cuda.CUDAGraph()
    g.enable_debug_mode()
    with torch.cuda.graph(g):
        fn()
    g.replay()
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/graph.dot"
        g.debug_dump(path)
        with open(path) as f:
            dot = f.read()
    del g
    names = set()
    for label in re.findall(r'label="([^"]*)"', dot):
        label = label.replace("\\", "")
        if "KERNEL" in label or "<<<" in label:
            m = re.search(r"([^|{}]*?)\s*<<<", label)
            names.add((m.group(1) if m else label).strip())
    return names


def _attention_kernels(fn):
    return {n for n in _kernels_run(fn)
            if "flash_fwd_" in n or "flash_bwd_d" in n}


def _hold_fwd_bwd(q, k, v, do, causal=True, q_offset=None):
    """Forward and backward against their plain versions (bf16 limits of
    the other card tests); returns the outputs."""
    o, lse = tfa.flash_attention_fwd(q, k, v, causal=causal,
                                     q_offset=q_offset)
    o_ref, lse_ref = tfa.flash_attention_reference(q, k, v, causal=causal,
                                                   q_offset=q_offset)
    torch.testing.assert_close(o.float(), o_ref.float(), rtol=TOL["bfloat16"],
                               atol=TOL["bfloat16"])
    torch.testing.assert_close(lse, lse_ref, rtol=1e-4, atol=1e-4)
    grads = tfa.flash_attention_bwd(q, k, v, o, lse, do, causal=causal,
                                    q_offset=q_offset)
    refs = tfa.flash_attention_bwd_reference(q, k, v, o, lse, do,
                                             causal=causal, q_offset=q_offset)
    for name, g, r in zip("qkv", grads, refs):
        assert g.shape == r.shape and g.dtype == torch.bfloat16, name
        torch.testing.assert_close(g.float(), r.float(), rtol=TOL["bfloat16"],
                                   atol=TOL["bfloat16"], msg=f"d{name}")
    return (o, lse) + tuple(grads)


def _routes_taken(q, k, v, do, causal=True, q_offset=None):
    def run():
        o, lse = tfa.flash_attention_fwd(q, k, v, causal=causal,
                                         q_offset=q_offset)
        tfa.flash_attention_bwd(q, k, v, o, lse, do, causal=causal,
                                q_offset=q_offset)
    return _attention_kernels(run)


@pytest.mark.gpu
@pytest.mark.parametrize("d", [16, 32, 40, 64, 80, 128])
def test_wgmma_attention_at_every_head_dim(d):
    """The wgmma forward and dK/dV kernels at each head-dim instance (16,
    32 and 64 run the D = 64 one, columns past d zero-filled by TMA) and
    at masked d = 40 and 80, on fused-QKV views under GQA, against the
    plain versions; the kernel nodes of a graph of one call show the wgmma
    kernels ran (dQ stays on mma.sync)."""
    _cuda()
    q, k, v, do = _fused_qkv_views(2, 300, 4, 2, d, 81)
    assert tfa.kernel_route(q, k, v) == "wgmma"
    assert tfa.kernel_route(q, k, v, do) == "wgmma"
    _hold_fwd_bwd(q, k, v, do)
    ran = _routes_taken(q, k, v, do)
    assert any("flash_fwd_wg_kernel" in n for n in ran), ran
    assert any("flash_bwd_dkv_wg_kernel" in n for n in ran), ran
    assert not any("flash_fwd_tc_kernel" in n or "flash_bwd_dkv_tc" in n
                   for n in ran), ran


@pytest.mark.gpu
@pytest.mark.parametrize("nkv", [4, 2])
@pytest.mark.parametrize("B,Sq,Sk,q_offset", [
    (1, 1000, 1100, 100),     # the diagonal and both edges inside tiles
    (2, 65, 65, None),        # the last 64-row tile holds one row
    (1, 129, 129, None),      # the last 128-row (forward) tile holds one
    (3, 1024, 1024, None)])   # 128-row forward blocks (they fill the card)
def test_wgmma_attention_gqa_offsets_ragged(B, Sq, Sk, q_offset, nkv):
    """GQA (8 query heads on 4 or 2 KV heads), causal with q_offset and
    Sq != Sk, and ragged last tiles of one row, through the wgmma kernels
    against the plain versions."""
    dev = _cuda()
    if Sq == Sk:
        q, k, v, do = _fused_qkv_views(B, Sq, 8, nkv, 128, 83 + Sq)
    else:
        q, k, v, do = (torch.from_numpy(_rand(shape, seed)).to(
            dev, torch.bfloat16) for shape, seed in (
                ((B, Sq, 8, 128), 84), ((B, Sk, nkv, 128), 85),
                ((B, Sk, nkv, 128), 86), ((B, Sq, 8, 128), 87)))
    assert tfa.kernel_route(q, k, v, do) == "wgmma"
    _hold_fwd_bwd(q, k, v, do, q_offset=q_offset)


@pytest.mark.gpu
@pytest.mark.parametrize("B,N", [(1, 8), (12, 8), (1, 16), (2, 16)])
def test_fwd_query_rows_matches_the_launch(B, N):
    """fwd_query_rows, given the card's SM count, names the query tile the
    C launch chose: 64 rows a consumer warpgroup, the second template
    argument of the wgmma forward in a graph of one call."""
    _cuda()
    q, k, v, _ = _fused_qkv_views(B, 1024, N, N, 128, 95)
    names = _kernels_run(lambda: tfa.flash_attention_fwd(q, k, v, True))
    groups = {int(m.group(1) or m.group(2)) for m in (
        re.search(r"flash_fwd_wg_kernel(?:<\d+, ?(\d+)>|ILi\d+ELi(\d+)E)",
                  n) for n in names) if m}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert groups == {tfa.fwd_query_rows(B, N, 1024, sms) // 64}, names


@pytest.mark.gpu
@pytest.mark.parametrize("B", [1, 2])
def test_wgmma_attention_repeats_bit_for_bit(B):
    """No atomics: two calls of the wgmma forward (64-row blocks at B = 1,
    128-row at B = 2 with 16 heads) and of the backward give the same
    bits."""
    _cuda()
    q, k, v, do = _fused_qkv_views(B, 1024, 8 * B, 2 * B, 128, 89)
    runs = [_hold_fwd_bwd(q, k, v, do) for _ in range(2)]
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_view_tma_cannot_describe_takes_mma_sync():
    """Head dim 100 on fused views: a 200-byte head stride, which a TMA
    tensor map cannot take, so the forward and dK/dV launches take the
    mma.sync kernels (by the C launch's rule, mirrored in kernel_route),
    and match the plain versions."""
    _cuda()
    q, k, v, do = _fused_qkv_views(2, 300, 4, 2, 100, 91)
    assert tfa.kernel_route(q, k, v) == "mma_sync"
    assert tfa.kernel_route(q, k, v, do) == "mma_sync"
    _hold_fwd_bwd(q, k, v, do)
    ran = _routes_taken(q, k, v, do)
    assert any("flash_fwd_tc_kernel" in n for n in ran), ran
    assert any("flash_bwd_dkv_tc_kernel" in n for n in ran), ran
    assert not any("_wg_kernel" in n for n in ran), ran


@pytest.mark.gpu
def test_mma_sync_route_runs_the_parent_kernels():
    """Inside _mma_sync_route() every bf16 launch takes the mma.sync
    kernels, which match the plain versions as the wgmma ones do; outside
    it the rule applies again."""
    _cuda()
    q, k, v, do = _fused_qkv_views(2, 300, 4, 2, 128, 93)
    with tfa._mma_sync_route():
        assert tfa.kernel_route(q, k, v, do) == "mma_sync"
        _hold_fwd_bwd(q, k, v, do)
        ran = _routes_taken(q, k, v, do)
    assert not any("_wg_kernel" in n for n in ran), ran
    assert any("flash_bwd_dkv_tc_kernel" in n for n in ran), ran
    assert tfa.kernel_route(q, k, v, do) == "wgmma"
    assert any("_wg_kernel" in n for n in _routes_taken(q, k, v, do))


def _ernie_train(model, ids, labels, steps=3):
    """``steps`` AdamW steps of ``forward_with_mlm_loss`` (f32): the losses,
    the first step's gradients and the parameters after the last step."""
    from paddle_tpu_torch.optimizer import AdamW
    opt = AdamW(learning_rate=1e-3, parameters=model.parameters())
    losses = []
    for i in range(steps):
        loss = model.forward_with_mlm_loss(ids, labels)
        loss.backward()
        if i == 0:
            grads = {n: p.grad.detach().cpu().clone()
                     for n, p in model.named_parameters()
                     if p.grad is not None}
        opt.step()
        opt.clear_grad()
        losses.append(loss.item())
    return losses, grads, {n: p.detach().cpu()
                           for n, p in model.named_parameters()}


@pytest.mark.gpu
@pytest.mark.parametrize("fused", [False, True])
def test_ernie_moe_training_step_matches_cpu(fused):
    """The tiny ERNIE-MoE training step on the card (flash kernels, and
    with ``fused`` the MoE dispatch and combine kernels) against the same
    step on the CPU (the plain versions), f32, every gate's random routing
    off: 3 AdamW steps' losses to 1e-5 relative, each first-step gradient
    to 1e-4 of its norm (the key bias's, 0 up to rounding, to 1e-4 of the
    norm of all), every parameter after 3 steps within 2e-5 (AdamW steps
    of lr = 1e-3 whose sign rounding may set near a gradient of 0)."""
    import copy
    from paddle_tpu_torch.incubate.distributed.models.moe import GShardGate
    dev = _cuda()
    cfg = ternie.ernie_moe_tiny_config(fused_dispatch=fused)
    cpu = ternie.ErnieMoeForPretraining(
        ternie.ErnieMoeModel(cfg, seed=0, device="cpu")).train()
    for m in cpu.modules():
        if isinstance(m, GShardGate):
            m.random_routing = False
    card = copy.deepcopy(cpu).to(dev)
    rng = np.random.default_rng(0)
    ids, labels = (torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 64)))
                   for _ in range(2))
    n0 = (tfa.launches, tfa.dq_launches, tfa.dkv_launches,
          tmd.dispatch_launches, tmd.combine_launches)
    got = _ernie_train(card, ids.to(dev), labels.to(dev))
    n1 = (tfa.launches, tfa.dq_launches, tfa.dkv_launches,
          tmd.dispatch_launches, tmd.combine_launches)
    want = _ernie_train(cpu, ids, labels)
    L, moe = cfg.num_hidden_layers, cfg.num_hidden_layers // cfg.moe_every
    assert [b - a for a, b in zip(n0, n1)] == \
        [3 * L] * 3 + [3 * moe * fused] * 2
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    total = sum(g.square().sum().item() for g in want[1].values()) ** 0.5
    for name, g in want[1].items():
        den = total if name.endswith("k_proj.bias") else g.norm().item()
        assert (got[1][name] - g).norm().item() <= 1e-4 * den, name
    for name, p in want[2].items():
        torch.testing.assert_close(got[2][name], p, rtol=0, atol=2e-5,
                                   msg=name)


# --------------------------------------------- ParallelTrainStep, captured
#
# The cases run in a fresh interpreter (a graph-capturing card test in the
# test process left torch.profiler recording no kernels for the route
# checks above; tests/test_torch_aot.py does the same), all at once through
# the module fixture ``train_step_card``.

def _ts_ernie(fused=False, routing=False, seed=0):
    """The 2-layer tiny ERNIE-MoE on the card, in training; every gate's
    random routing off unless ``routing``."""
    from paddle_tpu_torch.incubate.distributed.models.moe import GShardGate
    cfg = ternie.ernie_moe_tiny_config(num_hidden_layers=2,
                                       fused_dispatch=fused)
    model = ternie.ErnieMoeForPretraining(
        ternie.ErnieMoeModel(cfg, seed=seed, device="cuda")).train()
    for m in model.modules():
        if isinstance(m, GShardGate):
            m.random_routing = routing
    return model


def _ts_loss(dtype):
    from paddle_tpu_torch.amp import auto_cast

    def loss(m, ids, labels):
        with auto_cast(enable=dtype == "bfloat16", dtype="bfloat16"):
            return m.forward_with_mlm_loss(ids, labels)
    return loss


def _ts_counts():
    return [tfa.launches, tfa.dq_launches, tfa.dkv_launches,
            tmd.dispatch_launches, tmd.combine_launches]


def _ts_run(captured, dtype="float32", fused=False, routing=False, steps=3):
    """``steps`` steps of the tiny ERNIE-MoE through ParallelTrainStep from
    seed 0, captured (the default on the card) or inside the eager switch:
    the losses, the parameters after the last step, each call's launches
    and the step."""
    from paddle_tpu_torch.distributed.fleet import train_step
    from paddle_tpu_torch.optimizer import AdamW
    model = _ts_ernie(fused, routing)
    step = train_step.ParallelTrainStep(
        model, AdamW(1e-3, parameters=model.named_parameters()),
        _ts_loss(dtype))
    rng = np.random.default_rng(0)
    ids, labels = (rng.integers(0, model.config.vocab_size, (2, 64))
                   for _ in range(2))
    losses, counts = [], []
    with contextlib.nullcontext() if captured else train_step._eager_step():
        for _ in range(steps):
            c0 = _ts_counts()
            losses.append(step(ids, labels).item())
            counts.append([b - a for a, b in zip(c0, _ts_counts())])
    params = {n: p.detach().cpu() for n, p in model.named_parameters()}
    return losses, params, counts, step


def _ts_scaler_case():
    """A replay that overflows: ``lin(x).sum()`` with x all ones makes
    every gradient 3, finite at a scale of 2^126 and inf at 2^127. The
    first call (eager, then the capture) and the third are good; before
    the second the scale is set to 2^127."""
    from paddle_tpu_torch.amp import GradScaler
    from paddle_tpu_torch.distributed import ParallelTrainStep
    from paddle_tpu_torch.nn._torch_layers import Linear
    from paddle_tpu_torch.optimizer import AdamW
    lin = Linear(6, 4, generator=torch.Generator("cuda").manual_seed(0))
    opt = AdamW(1e-3, parameters=lin.named_parameters())
    scaler = GradScaler(init_loss_scaling=2.0 ** 126,
                        decr_every_n_nan_or_inf=1)
    step = ParallelTrainStep(lin, opt, lambda m, x: m(x).sum(),
                             scaler=scaler)
    x = np.ones((3, 6), np.float32)
    state = lambda: [t.detach().clone() for t in  # noqa: E731
                     list(lin.parameters()) + opt._state_tensors(
                         list(lin.parameters()))]
    out = {}
    step(x)
    before = state()
    scaler.set_init_loss_scaling(2.0 ** 127)
    step(x)
    out["overflow"] = dict(
        found_inf=step.last_found_inf, scale=scaler._scale,
        kept=all(torch.equal(a, b) for a, b in zip(before, state())))
    step(x)
    out["next"] = dict(found_inf=step.last_found_inf, scale=scaler._scale,
                       moved=not torch.equal(before[0], lin.weight))
    out["graphs"] = len(step.captured_signatures)
    return out


class _Draws(torch.nn.Module):
    """A model that draws from a generator of its own in its loss and
    keeps the draw, so a test can read what each replay drew."""

    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.ones(4, device="cuda"))
        self.rng = torch.Generator("cuda").manual_seed(7)
        self.drawn = torch.zeros(4, device="cuda")

    def loss(self, x):
        u = torch.rand(4, generator=self.rng, device="cuda")
        self.drawn.copy_(u)
        return (self.w * u * x).sum()


def _ts_draws_case():
    """The generators a module holds are registered with the graph: each
    replay draws new numbers, the ones an eager step would draw next."""
    from paddle_tpu_torch.distributed.fleet import train_step
    from paddle_tpu_torch.optimizer import SGD, AdamW
    out = {}
    for label in ("captured", "eager"):
        m = _Draws()
        step = train_step.ParallelTrainStep(
            m, SGD(0.1, parameters=m.named_parameters()),
            lambda m, x: m.loss(x))
        x = np.ones(4, np.float32)
        draws = []
        with train_step._eager_step() if label == "eager" \
                else contextlib.nullcontext():
            for _ in range(3):
                step(x)
                draws.append(m.drawn.cpu().tolist())
        out[label] = draws
    # the MoE gates' generators are found and registered
    model = _ts_ernie(routing=True)
    gens = train_step._generators(model)
    out["gate_generators"] = len(gens)
    step = train_step.ParallelTrainStep(
        model, AdamW(1e-3, parameters=model.named_parameters()),
        _ts_loss("float32"))
    rng = np.random.default_rng(0)
    ids, labels = (rng.integers(0, model.config.vocab_size, (2, 64))
                   for _ in range(2))
    states = []
    for _ in range(3):
        step(ids, labels)
        states.append([g.get_state().tolist() for g in gens])
    out["gate_states_move"] = states[0] != states[1] != states[2]
    return out


def _ts_failing_case():
    """A host sync inside the loss (a value read to the host): the first
    call raises, in the eager run before the capture, and keeps no
    graph."""
    from paddle_tpu_torch.distributed import ParallelTrainStep
    from paddle_tpu_torch.optimizer import SGD
    m = _Draws()
    step = ParallelTrainStep(m, SGD(0.1, parameters=m.named_parameters()),
                             lambda m, x: m.loss(x) * float(m.w.sum()))
    try:
        step(np.ones(4, np.float32))
    except RuntimeError as e:
        raised = str(e).splitlines()[0][:200]
    else:
        raised = None
    return dict(raised=raised, graphs=len(step.captured_signatures))


def _train_step_cases():
    """Every card case of ParallelTrainStep, as JSON-ready values."""
    out = {}
    for dtype, fused in (("float32", False), ("bfloat16", False),
                         ("bfloat16", True)):
        cap = _ts_run(True, dtype, fused)
        eag = _ts_run(False, dtype, fused)
        out[f"{dtype}_{'fused' if fused else 'gather'}"] = dict(
            losses=cap[0], eager_losses=eag[0],
            param_diff=max((cap[1][k].float() - v.float()).abs().max().item()
                           for k, v in eag[1].items()),
            counts=cap[2], eager_counts=eag[2],
            graphs=len(cap[3].captured_signatures),
            pool=cap[3].graph_pool_bytes(), capture_s=cap[3].capture_s)
    cap = _ts_run(True, routing=True, steps=4)
    eag = _ts_run(False, routing=True, steps=4)
    out["routing"] = dict(losses=cap[0], eager_losses=eag[0])
    out["scaler"] = _ts_scaler_case()
    out["draws"] = _ts_draws_case()
    out["failing"] = _ts_failing_case()
    return out


_CARD_RUNNER = """
import importlib.util, json, sys
spec = importlib.util.spec_from_file_location("gpu_cases", sys.argv[1])
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
def train_step_card():
    _cuda()
    return _in_subprocess("_train_step_cases")


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["float32_gather", "bfloat16_gather",
                                  "bfloat16_fused"])
def test_train_step_captured_equals_eager(train_step_card, case):
    """The tiny ERNIE-MoE through ParallelTrainStep, 3 steps, captured
    (the first call runs eagerly, then captures) against the eager switch
    from one seed, random routing off: every loss and parameter bit for
    bit, the same launches each call (flash L/L/L; with the fused MoE
    path one dispatch and one combine a MoE layer), one graph."""
    res = train_step_card[case]
    assert res["losses"] == res["eager_losses"]
    assert res["param_diff"] == 0.0
    assert res["losses"][-1] < res["losses"][0]
    want = [2, 2, 2] + [1, 1] if case.endswith("fused") else [2, 2, 2, 0, 0]
    assert res["counts"] == [want] * 3 == res["eager_counts"]
    assert res["graphs"] == 1 and res["pool"] != 0 and res["capture_s"] > 0


@pytest.mark.gpu
def test_train_step_replays_draw_new_numbers(train_step_card):
    """A module's own generator is registered with the graph: each replay
    draws new numbers, the ones the eager step draws; the MoE gates'
    generators (one a MoE layer) are found and move with every replay,
    and with random routing on the captured losses are finite and
    fall."""
    res = train_step_card["draws"]
    cap, eag = res["captured"], res["eager"]
    assert cap[0] != cap[1] != cap[2] and cap[0] != cap[2]
    assert cap == eag
    assert res["gate_generators"] == 1 and res["gate_states_move"]
    losses = train_step_card["routing"]["losses"]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]


@pytest.mark.gpu
def test_train_step_scaler_skips_under_capture(train_step_card):
    """An overflowing replay leaves every parameter and accumulator as it
    was, sets ``last_found_inf`` and halves the scale; the next replay
    updates."""
    res = train_step_card["scaler"]
    assert res["overflow"] == dict(found_inf=True, scale=2.0 ** 126,
                                   kept=True)
    assert res["next"] == dict(found_inf=False, scale=2.0 ** 126,
                               moved=True)
    assert res["graphs"] == 1


@pytest.mark.gpu
def test_train_step_sync_in_the_step_raises(train_step_card):
    """A loss that waits on the host fails the first call (its eager run
    raises on the sync) and keeps no graph; the ERNIE-MoE steps above
    captured, so their eager first calls waited on nothing."""
    res = train_step_card["failing"]
    assert res["raised"] is not None and res["graphs"] == 0
    assert train_step_card["bfloat16_gather"]["graphs"] == 1


@pytest.mark.gpu
def test_facade_on_cuda_matches_cpu():
    """The tensor facade on the card: ``to_tensor`` with no place lands on
    it, and a chain of ops with ``backward``, a ``create_graph`` second
    derivative, a PyLayer and a bf16 ``auto_cast`` matmul give the CPU's
    values and gradients; ``FLAGS_check_nan_inf`` raises on a NaN."""
    _cuda()
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.amp import auto_cast
    from paddle_tpu_torch.autograd import PyLayer
    from paddle_tpu_torch.framework import place as tplace

    class Cube(PyLayer):
        @staticmethod
        def forward(ctx, x):
            ctx.save_for_backward(x)
            return x * x * x

        @staticmethod
        def backward(ctx, g):
            (x,) = ctx.saved_tensor()
            return g * 3.0 * x * x

    x_np, w_np = _rand((8, 16), 1), _rand((16, 4), 2)

    def run():
        x = paddle.to_tensor(x_np, stop_gradient=False)
        w = paddle.to_tensor(w_np, stop_gradient=False)
        h = paddle.tanh(paddle.matmul(x, w)) * 2.0 + 1.0
        loss = paddle.mean(paddle.exp(h[:, :2]) + Cube.apply(h[:, 2:]))
        loss.backward()
        (g1,) = paddle.grad(paddle.sum(paddle.sin(x) * x), [x],
                            create_graph=True)
        (g2,) = paddle.grad(paddle.sum(g1), [x])
        with auto_cast(dtype="bfloat16"):
            m = paddle.matmul(x, w)
        assert m.dtype == paddle.bfloat16
        return [loss, x.grad, w.grad, g1, g2, m.astype("float32")]

    prev = tplace._current_place
    try:
        tplace._current_place = None
        assert paddle.to_tensor([1.0]).place == paddle.CUDAPlace(0)
        on_card = run()
        assert all(t.place == paddle.CUDAPlace(0) for t in on_card)
        paddle.set_flags({"FLAGS_check_nan_inf": True})
        try:
            with pytest.raises(FloatingPointError):
                paddle.log(paddle.to_tensor([-1.0]))
        finally:
            paddle.set_flags({"FLAGS_check_nan_inf": False})
        paddle.set_device("cpu")
        on_cpu = run()
    finally:
        tplace._current_place = prev
    for a, b, tol in zip(on_card, on_cpu, [1e-5] * 5 + [2e-2]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=tol, atol=tol)


# ------------------------------------------- BERT from paddle_tpu_torch.nn

def _bert_tiny(seed, **kw):
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.models import bert as tbert
    paddle.seed(seed)
    return tbert.BertForPretraining(tbert.BertModel(
        tbert.bert_tiny_config(**kw))).train()


def _bert_step(model):
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.distributed.fleet import train_step
    return train_step.ParallelTrainStep(
        model, paddle.optimizer.AdamW(1e-3, parameters=model.parameters()),
        lambda m, i, y: m.forward_with_mlm_loss(i, y))


def _bert_batch(seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.integers(0, 1024, (2, 64)).astype(np.int64)
                 for _ in range(2))


def _bert_card_cases():
    """Tiny BERT (2 layers, B = 2, S = 64) built from paddle_tpu_torch.nn
    through ParallelTrainStep on the card: captured against the eager
    switch at dropout 0 (losses, parameters, flash launches a step), and
    the masks of three replays at hidden dropout 0.2 (the facade's
    generator registered with the graph)."""
    from paddle_tpu_torch.distributed.fleet import train_step
    out = {}
    ids, labels = _bert_batch()
    for how in ("captured", "eager"):
        model = _bert_tiny(0)
        step = _bert_step(model)
        losses, counts = [], []
        with train_step._eager_step() if how == "eager" \
                else contextlib.nullcontext():
            for _ in range(3):
                c0 = _ts_counts()
                losses.append(float(step(ids, labels)))
                counts.append([a - b for a, b in zip(_ts_counts(), c0)])
        out[how] = dict(losses=losses, counts=counts, params={
            k: p._value.detach().cpu() for k, p in model.named_parameters()},
            graphs=len(step.captured_signatures))
    cap, eag = out.pop("captured"), out.pop("eager")
    out["dropout0"] = dict(
        losses=cap["losses"], eager_losses=eag["losses"],
        param_diff=max((cap["params"][k] - v).abs().max().item()
                       for k, v in eag["params"].items()),
        counts=cap["counts"], eager_counts=eag["counts"],
        graphs=cap["graphs"])
    model = _bert_tiny(1, hidden_dropout_prob=0.2)
    drop = model.bert.embeddings.dropout
    probe = torch.zeros(2, 64, 64, dtype=torch.bool, device="cuda")

    def keep_mask(layer, inputs, out):    # returns None: out stays
        probe.copy_(out._value != 0)
    drop.register_forward_post_hook(keep_mask)
    step = _bert_step(model)
    seen = []
    for _ in range(4):              # the first call captures; 3 replays
        step(ids, labels)
        seen.append(probe.clone())
    out["dropout_masks"] = dict(
        kept=[m.float().mean().item() for m in seen[1:]],
        differ=[bool((a != b).any()) for a, b in zip(seen[1:], seen[2:])],
        graphs=len(step.captured_signatures))
    return out


@pytest.fixture(scope="module")
def bert_card():
    _cuda()
    return _in_subprocess("_bert_card_cases")


@pytest.mark.gpu
def test_bert_train_step_captured_equals_eager(bert_card):
    """Tiny BERT built from the ported nn through ParallelTrainStep at
    dropout 0: the captured step's losses and parameters bit for bit the
    eager switch's over 3 steps, one graph, and the flash forward, dQ and
    dK/dV kernels 2/2/2 a step at 2 layers (attention dropout 0)."""
    res = bert_card["dropout0"]
    assert res["losses"] == res["eager_losses"]
    assert res["param_diff"] == 0.0
    assert res["losses"][-1] < res["losses"][0]
    assert res["counts"] == [[2, 2, 2, 0, 0]] * 3 == res["eager_counts"]
    assert res["graphs"] == 1


@pytest.mark.gpu
def test_bert_replays_draw_new_dropout_masks(bert_card):
    """With hidden dropout 0.2 each replay draws new masks from the
    facade's generator (registered with the graph): three replays, three
    different embedding masks, each keeping 0.8 of its 8192 elements
    within 4 sigma."""
    res = bert_card["dropout_masks"]
    assert res["graphs"] == 1
    assert all(res["differ"])
    sigma = (0.2 * 0.8 / (2 * 64 * 64)) ** 0.5
    assert all(abs(k - 0.8) <= 4 * sigma for k in res["kept"]), res


# -------------------------------------------- paddle.static on the card

def _static_bert(bf16=True):
    """bench_bert's static build at tiny BERT (2 layers, B = 2, S = 64,
    dropout 0) on the card; static mode left off."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import static
    from paddle_tpu_torch.models import bert as tbert
    paddle.seed(0)
    static.enable_static()
    try:
        main = static.Program()
        with static.program_guard(main):
            with paddle.amp.auto_cast(enable=bf16, dtype="bfloat16"):
                ids = static.data("ids", [2, 64], "int64")
                labels = static.data("labels", [2, 64], "int64")
                model = tbert.BertForPretraining(tbert.BertModel(
                    tbert.bert_tiny_config()))
                loss = model.forward_with_mlm_loss(ids, labels)
                paddle.optimizer.AdamW(
                    learning_rate=1e-3,
                    parameters=model.parameters()).minimize(loss)
    finally:
        static.disable_static()
    return main, loss


def _static_card_cases():
    """The static Executor on the card (JSON-ready): tiny BERT's program
    run 4 times (the first captures), its launches a run and graphs; a
    fetched loss after the next run; a program fed two batch shapes (two
    graphs, each replayed); the kernels of one static step read from the
    nodes of a CUDA graph captured around it; a capture that fails."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import static
    from paddle_tpu_torch.framework.graphs import eager_step
    out = {}
    main, loss = _static_bert()
    ids, labels = _bert_batch()
    feed = {"ids": paddle.to_tensor(ids), "labels": paddle.to_tensor(labels)}
    exe = static.Executor()
    losses, counts, graphs, captures = [], [], [], []
    for _ in range(4):
        c0 = _ts_counts()
        losses.append(float(exe.run(main, feed=feed, fetch_list=[loss])[0]))
        counts.append([a - b for a, b in zip(_ts_counts(), c0)])
        graphs.append(len(exe.graphs(main)))
        captures.append(exe.capture_s)
    r1 = exe.run(main, feed=feed, fetch_list=[loss], return_numpy=False)[0]
    v1 = float(r1)
    r2 = exe.run(main, feed=feed, fetch_list=[loss], return_numpy=False)[0]
    torch.cuda.synchronize()
    out["bert"] = dict(
        losses=losses, counts=counts, graphs=graphs,
        captured_once=captures[0] > 0 and len(set(captures)) == 1,
        fetch=[v1, float(r1), float(r2)],
        aliased=r1._value.data_ptr() == r2._value.data_ptr())
    # two feed signatures: two graphs, each replayed
    static.enable_static()
    try:
        prog = static.Program()
        with static.program_guard(prog):
            x = static.data("x", [4, 8], "float32")
            y = (paddle.nn.Linear(8, 3)(x) ** 2).sum()
    finally:
        static.disable_static()
    sums = []
    for n in (4, 6, 4, 6):
        a = np.ones((n, 8), np.float32)
        sums.append(float(exe.run(prog, feed={"x": a}, fetch_list=[y])[0]))
    out["signatures"] = dict(graphs=sorted(s[0][0][0] for s in
                                           exe.graphs(prog)), sums=sums)
    # the kernels of one static step, from a graph captured around it
    main_k, loss_k = _static_bert()
    exe_k = static.Executor()
    with eager_step():
        names = _attention_kernels(lambda: exe_k.run(
            main_k, feed=feed, fetch_list=[loss_k], return_numpy=False))
    out["kernels"] = sorted(names)
    # a host read inside the program: the first run raises, no graph kept
    static.enable_static()
    try:
        bad = static.Program()
        with static.program_guard(bad):
            x = static.data("x", [4], "float32")
            z = static.Print(x * 2.0, message="host read")
    finally:
        static.disable_static()
    try:
        exe.run(bad, feed={"x": np.ones(4, np.float32)}, fetch_list=[z])
    except RuntimeError as e:
        raised = str(e).splitlines()[0][:200]
    else:
        raised = None
    out["failing"] = dict(raised=raised, graphs=len(exe.graphs(bad)))
    return out


@pytest.fixture(scope="module")
def static_card():
    _cuda()
    return _in_subprocess("_static_card_cases")


@pytest.mark.gpu
def test_static_executor_captures_once_and_replays(static_card):
    """bench_bert's static program at tiny BERT under auto_cast(bf16): one
    graph for its feed signature, captured by the first run alone; every
    run launches the flash forward, dQ and dK/dV 2/2/2 (the first run's
    eager step, then replays); falling losses."""
    res = static_card["bert"]
    assert res["graphs"] == [1, 1, 1, 1]
    assert res["captured_once"]
    assert res["counts"] == [[2, 2, 2, 0, 0]] * 4
    assert res["losses"][-1] < res["losses"][0]


@pytest.mark.gpu
def test_static_fetch_does_not_alias_the_graph(static_card):
    """A loss fetched with return_numpy=False keeps its value after the
    next run overwrites the graph's output."""
    v1, r1_after, r2 = static_card["bert"]["fetch"]
    assert r1_after == v1 and r2 != v1
    assert not static_card["bert"]["aliased"]


@pytest.mark.gpu
def test_static_graph_per_feed_signature(static_card):
    """Feeds of two batch shapes: two graphs, and each replay gives the
    value its first run gave."""
    res = static_card["signatures"]
    assert res["graphs"] == [4, 6]
    assert res["sums"][0] == res["sums"][2] and res["sums"][1] == \
        res["sums"][3]


@pytest.mark.gpu
def test_static_program_launches_rows_1_to_3(static_card):
    """The kernel nodes of a CUDA graph captured around one static step
    (bf16, attention dropout 0): the wgmma flash forward, the dQ pass and
    the wgmma dK/dV pass."""
    names = static_card["kernels"]
    assert any("flash_fwd_wg" in n for n in names), names
    assert any("flash_bwd_dq" in n for n in names), names
    assert any("flash_bwd_dkv_wg" in n for n in names), names


@pytest.mark.gpu
def test_static_failed_capture_raises(static_card):
    """A program that reads a value on the host (static.Print) raises in
    its first run, before any capture, and keeps no graph."""
    res = static_card["failing"]
    assert res["raised"] is not None and res["graphs"] == 0


# ------------------------------------- convolutions and pools on the card

# (function, input shapes, keyword arguments); inputs drawn from seeds
CONV_POOL_CARD = {
    "conv1d": ("conv1d", [(2, 4, 9), (6, 4, 3), (6,)], dict(padding=1)),
    "conv2d": ("conv2d", [(2, 4, 9, 8), (6, 4, 3, 3), (6,)],
               dict(padding=1)),
    "conv2d_same_stride2": ("conv2d", [(2, 4, 9, 8), (6, 4, 3, 3)],
                            dict(stride=2, padding="SAME")),
    "conv2d_groups_dilation": ("conv2d", [(2, 4, 9, 8), (6, 2, 3, 3)],
                               dict(padding=2, dilation=2, groups=2)),
    "conv2d_nhwc": ("conv2d", [(2, 9, 8, 4), (6, 4, 3, 3), (6,)],
                    dict(padding=[0, 1, 2, 1], data_format="NHWC")),
    "conv2d_resnet_stem": ("conv2d", [(2, 3, 32, 32), (8, 3, 7, 7)],
                           dict(stride=2, padding=3)),
    "conv3d": ("conv3d", [(1, 4, 5, 6, 5), (6, 4, 3, 3, 3)],
               dict(stride=2, padding="SAME")),
    "conv1d_transpose": ("conv1d_transpose", [(2, 4, 5), (4, 3, 3), (3,)],
                         dict(stride=2, padding=1, output_padding=1)),
    "conv2d_transpose": ("conv2d_transpose", [(2, 4, 5, 4), (4, 3, 3, 3)],
                         dict(stride=2, padding=1, output_size=[10, 8])),
    "conv2d_transpose_groups": ("conv2d_transpose",
                                [(2, 4, 5, 4), (4, 3, 3, 3), (6,)],
                                dict(groups=2, padding=[1, 0, 0, 2],
                                     stride=3, output_padding=2)),
    "conv3d_transpose": ("conv3d_transpose", [(1, 4, 3, 4, 3),
                                              (4, 3, 3, 3, 3)],
                         dict(stride=2, padding=1)),
    "max_pool2d": ("max_pool2d", [(2, 4, 9, 8)],
                   dict(kernel_size=3, stride=2, padding=1)),
    "max_pool2d_wide_pad": ("max_pool2d", [(2, 4, 9, 8)],
                            dict(kernel_size=2, padding=2)),
    "max_pool3d": ("max_pool3d", [(1, 4, 5, 6, 5)], dict(kernel_size=2)),
    "avg_pool1d": ("avg_pool1d", [(2, 4, 9)],
                   dict(kernel_size=3, stride=2, padding=1)),
    "avg_pool2d_same": ("avg_pool2d", [(2, 4, 9, 8)],
                        dict(kernel_size=3, stride=2, padding="SAME")),
    "avg_pool2d_inclusive_nhwc": ("avg_pool2d", [(2, 9, 8, 4)],
                                  dict(kernel_size=3, padding=1,
                                       exclusive=False, data_format="NHWC")),
    "adaptive_avg_pool2d": ("adaptive_avg_pool2d", [(2, 4, 9, 8)],
                            dict(output_size=(1, 1))),
    "adaptive_avg_pool2d_bins": ("adaptive_avg_pool2d", [(2, 4, 9, 8)],
                                 dict(output_size=(4, 3))),
    "adaptive_max_pool2d": ("adaptive_max_pool2d", [(2, 4, 9, 8)],
                            dict(output_size=(4, 3))),
    "adaptive_avg_pool3d": ("adaptive_avg_pool3d", [(1, 4, 5, 6, 5)],
                            dict(output_size=(2, 4, 3))),
}


def _facade_on(dev, arrays):
    """Facade Tensors of ``arrays`` on ``dev`` ("cpu" or "gpu"), the
    current place put back."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.framework import place
    prev = place._current_place
    paddle.set_device(dev)
    try:
        return [paddle.to_tensor(a, stop_gradient=a.dtype.kind != "f")
                for a in arrays]
    finally:
        place._current_place = prev


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(CONV_POOL_CARD))
def test_conv_pool_on_card_match_cpu(case):
    """Each convolution and pool on CUDA tensors (cuDNN and ATen) against
    the same call on the CPU: the output and the gradients of sum(out * w)
    over every float input, f32 with TF32 off."""
    _cuda()
    import paddle_tpu_torch as paddle
    torch.backends.cudnn.allow_tf32 = False
    fn, shapes, kw = CONV_POOL_CARD[case]
    arrays = [_rand(s, i + 1) for i, s in enumerate(shapes)]
    got = {}
    for dev in ("cpu", "gpu"):
        ins = _facade_on(dev, arrays)
        out = getattr(paddle.nn.functional, fn)(*ins, **kw)
        w = _facade_on(dev, [_rand(out.shape, 9)])[0]
        paddle.sum(out * w).backward()
        assert out._value.device.type == ("cuda" if dev == "gpu" else "cpu")
        got[dev] = [out.numpy()] + [t.grad.numpy() for t in ins]
    for i, (a, b) in enumerate(zip(got["gpu"], got["cpu"])):
        np.testing.assert_allclose(a, b, rtol=TOL["float32"],
                                   atol=TOL["float32"],
                                   err_msg=f"{case} output/grad {i}")


@pytest.mark.gpu
def test_int_max_pool_on_card_matches_cpu():
    """An integer max pool (the padded-view route) on the card equals the
    CPU's exactly."""
    _cuda()
    import paddle_tpu_torch as paddle
    x = np.random.default_rng(4).integers(-50, 50, (2, 3, 7, 6))
    outs = [paddle.nn.functional.max_pool2d(
        _facade_on(dev, [x])[0], 3, 2, 1).numpy() for dev in ("cpu", "gpu")]
    np.testing.assert_array_equal(outs[1], outs[0])


# ------------------------- the static Executor's fetch and ResNet on the card

def _static_fetch_card_cases():
    """A fetched parameter (Linear(3, 2) under SGD(0.5)) and a fetched BN
    running mean (BatchNorm2D under SGD(0.1)) over 3 runs on the card: the
    first run (eager step + capture), then replays. For each run: is the
    fetch the value before the run, does it still read so after the last
    run, and did the run move the tensor (JSON-ready)."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import static
    out = {}
    for name, shape in (("linear", [4, 3]), ("bn", [4, 3, 2, 2])):
        static.enable_static()
        try:
            main = static.Program()
            with static.program_guard(main):
                x = static.data("x", shape, "float32")
                if name == "linear":
                    layer = paddle.nn.Linear(3, 2)
                    target = layer.weight
                else:
                    layer = paddle.nn.BatchNorm2D(3)
                    target = layer._mean
                loss = paddle.mean(layer(x))
                paddle.optimizer.SGD(0.5, parameters=layer.parameters()) \
                    .minimize(loss)
        finally:
            static.disable_static()
        feed = {"x": _rand(shape, 5)}
        exe = static.Executor()
        before, fetched = [], []
        for _ in range(3):
            before.append(target._value.detach().clone())
            r = exe.run(main, feed=feed, fetch_list=[loss, target],
                        return_numpy=False)
            fetched.append(r[1]._value)
        torch.cuda.synchronize()
        out[name] = dict(
            pre_update=[torch.equal(f, b) for f, b in zip(fetched, before)],
            moved=[not torch.equal(a, b) for a, b in
                   zip(before[1:] + [target._value], before)],
            fresh=[f.data_ptr() != target._value.data_ptr()
                   for f in fetched],
            graphs=len(exe.graphs(main)))
    return out


@pytest.fixture(scope="module")
def static_fetch_card():
    _cuda()
    return _in_subprocess("_static_fetch_card_cases")


@pytest.mark.gpu
@pytest.mark.parametrize("what", ["linear", "bn"])
def test_static_fetch_is_pre_update_on_card(static_fetch_card, what):
    """The first run (the eager step) and every replay return the value
    the run read, in storage of their own that later runs leave alone,
    while each run moves the parameter or buffer."""
    res = static_fetch_card[what]
    assert res["pre_update"] == [True] * 3
    assert res["moved"] == [True] * 3
    assert res["fresh"] == [True] * 3
    assert res["graphs"] == 1


def _static_resnet18(seed):
    """bench_resnet50's build with resnet18, 10 classes, B = 4, 3 x 64 x 64,
    f32, on the card; static mode left off."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import static
    paddle.seed(seed)
    static.enable_static()
    try:
        main = static.Program()
        with static.program_guard(main):
            img = static.data("img", [4, 3, 64, 64], "float32")
            label = static.data("label", [4], "int64")
            net = paddle.vision.models.resnet18(num_classes=10)
            loss = paddle.nn.functional.cross_entropy(net(img), label)
            paddle.optimizer.Momentum(
                learning_rate=0.1, momentum=0.9,
                parameters=net.parameters()).minimize(loss)
    finally:
        static.disable_static()
    return main, loss, net


def _static_resnet_card_cases():
    """resnet18's static step captured (3 runs: the first captures) against
    the same program from the same seed run eagerly (``eager_step``), with
    cudnn.deterministic on: losses, every parameter and BN buffer, graphs,
    launches of the kernel table (JSON-ready)."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import static
    from paddle_tpu_torch.framework.graphs import eager_step
    torch.backends.cudnn.deterministic = True
    rng = np.random.default_rng(3)
    feed = {"img": paddle.to_tensor(rng.standard_normal(
                (4, 3, 64, 64)).astype(np.float32)),
            "label": paddle.to_tensor(rng.integers(0, 10, 4))}
    runs = {}
    for mode in ("captured", "eager"):
        main, loss, net = _static_resnet18(5)
        exe = static.Executor()
        c0 = _ts_counts()
        with (eager_step() if mode == "eager" else contextlib.nullcontext()):
            losses = [float(exe.run(main, feed=feed, fetch_list=[loss])[0])
                      for _ in range(3)]
        runs[mode] = dict(
            losses=losses, graphs=len(exe.graphs(main)),
            counts=[a - b for a, b in zip(_ts_counts(), c0)],
            state={k: v._value.detach().clone()
                   for k, v in net.state_dict().items()})
    cap, eag = runs["captured"], runs["eager"]
    return dict(losses=cap["losses"], eager_losses=eag["losses"],
                graphs=[cap["graphs"], eag["graphs"]],
                counts=cap["counts"], n_state=len(cap["state"]),
                differing=[k for k, v in cap["state"].items()
                           if not torch.equal(v, eag["state"][k])])


@pytest.fixture(scope="module")
def static_resnet_card():
    _cuda()
    return _in_subprocess("_static_resnet_card_cases")


@pytest.mark.gpu
def test_static_resnet18_captured_equals_eager(static_resnet_card):
    """resnet18's static Momentum step, one CUDA graph replayed, equals the
    same program run eagerly bit for bit over 3 runs: losses, 62
    parameters and 40 BN buffers; no kernel of the table launches."""
    res = static_resnet_card
    assert res["losses"] == res["eager_losses"]
    assert all(np.isfinite(res["losses"]))
    assert res["n_state"] == 102 and res["differing"] == []
    assert res["graphs"] == [1, 0]
    assert res["counts"] == [0] * 5
