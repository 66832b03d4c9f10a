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
from paddle_tpu_torch.kernels import paged_attention as tpa
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.serving import ContinuousBatchingScheduler, ServingEngine

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
    q = torch.randn(1, 64, 2, 96, device=dev)        # head dim 96
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
    q = torch.randn(1, 64, 2, 96, device=dev)         # backward, head dim 96
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
