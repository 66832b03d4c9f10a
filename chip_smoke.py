"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py [--json-out PATH]

Six phases, one result per line:

1. device and build — the card's name and power limit, and the build of
   every CUDA kernel from ``paddle_tpu_torch/csrc`` with nvcc for sm_90a;
2. ``flash``, ``flash_bwd``, ``paged`` — each kernel against its plain
   PyTorch version on the card, in bf16 and f32: the flash forward and the
   paged decode at the serving shapes; the flash backward (dQ and dK/dV
   kernels) over the forward's cases and a causal ``q_offset`` case, and
   through the autograd Function against autograd of the plain forward;
   then the forward and the backward at the training shape, on the q/k/v
   views of one fused QKV tensor, with a control that shows the bf16
   gradient limit tells the kernels' rounding points from none. Each
   kernel's time (CUDA events), its plain
   version's time, its bound and one PyTorch library call as a yardstick;
3. ``serving`` — the serving main path at the full width of GPT-345M (24
   layers, hidden 1024, 8 heads of 128, vocab 50304, random weights from a
   seed): eight ragged requests through ``ServingEngine`` +
   ``ContinuousBatchingScheduler``, in bf16 and in f32. bf16: after a
   warm-up that touches every prefill and decode bucket, the batch is
   served three times (throughput, latency, memory and kernel launch
   counts of each run); then host against device time per decode step
   by CUDA events, and eight prefills and 16 decode steps under
   ``torch.profiler`` for the device time by kernel group. f32: every
   generated token is checked against the plain dense model,
   teacher-forced;
4. ``training`` — the training main path: ``GPTHybridTrainStep`` on
   GPT-345M at full width (B = 12, S = 1024, bf16 compute, f32 masters and
   moments, ``remat="dots"``), 3 warm-up and 5 timed steps on one repeated
   batch (tokens/s, step time, MFU, peak memory, every loss, and the flash
   kernels' launches per step, checked exactly), then one step split into
   forward + backward and AdamW by CUDA events and one step under
   ``torch.profiler``. Then, in f32 at full width and 4 layers, the
   kernel path against the plain attention path, and ``remat="dots"``
   against no remat: first-step gradients and three steps of losses.

Exits non-zero, without the final line, when CUDA is unavailable or any
phase fails. The last line is ``{"ok": true, "device": {...}}``; the line
before it is the card's ``nvidia-smi`` name and power limit, and before
that one JSON object holds the per-kernel numbers.
"""
from __future__ import annotations

import argparse
import copy
import json
import math
import os
import subprocess
import sys
import time
import traceback

# published H100 SXM peaks (dense): bf16 tensor cores and HBM3 bandwidth
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES_PER_S = 3.35e12

PROMPT_LENS = (937, 512, 701, 233, 864, 129, 395, 620)
MAX_NEW = 64
N_RUNS = 3          # bf16 serving runs, each timed and counted on its own

# kernel vs plain version: the largest |out - ref|, held to about twice
# the error each kernel showed on the card (bf16 shows one or two bf16
# spacings), and in bf16 the mean signed error along ref, over the mean
# |ref|: round-to-nearest leaves it near 0, truncation makes it ~ -3e-3.
TOL = {("flash", "float32"): 1e-4, ("flash", "bfloat16"): 8e-3,
       ("paged", "float32"): 1e-4, ("paged", "bfloat16"): 5e-3,
       # gradients, as a share of the largest |ref| (at least 1), beside
       # GRAD_TOL below: the Function's reference rounds neither P before
       # P^T dO nor dS, so up to S rounding errors of dS add up there
       ("flash_bwd", "float32"): 1e-4, ("flash_bwd", "bfloat16"): 8e-3,
       ("flash_autograd", "float32"): 1e-4,
       ("flash_autograd", "bfloat16"): 2e-2}
# gradients, also: (the largest |out - ref| / (|ref| + rms(ref)) over the
# elements, rms(out - ref) / rms(ref)). One bf16 spacing is at most 2^-7
# (7.8e-3) of an element. "flash_bwd" holds the kernels against the plain
# backward, which rounds where they do (P before P^T dO, dS before dS K
# and dS^T Q), so they differ only where a sum in another order flips a
# rounding: on an H100, bf16 up to 4.3e-3 elementwise and 6.7e-5 rms
# (GQA dv), f32 1.1e-5 and 5.9e-7. The control, the plain backward in f32
# (no rounding of P or dS) rounded to bf16 at the end, gave 2.5e-3 rms
# there and must fail the bf16 rms limit at the training shape, or the
# check could not tell the rounding points apart. "flash_autograd" holds
# the Function against autograd of the plain forward, which rounds
# neither P in the backward nor dS (seen: bf16 5.8e-2 elementwise, 4.3e-3
# rms; f32 7.0e-6 and 7.7e-7).
GRAD_TOL = {("flash_bwd", "float32"): (1e-4, 1e-5),
            ("flash_bwd", "bfloat16"): (8e-3, 2e-4),
            ("flash_autograd", "float32"): (1e-4, 1e-5),
            ("flash_autograd", "bfloat16"): (1.2e-1, 1e-2)}
BIAS_TOL = 1e-3

# the trainer: bench_gpt's "345m" row (B = 12, S = 1024, remat "dots")
TRAIN_B, TRAIN_S, WARMUP_STEPS, TIMED_STEPS = 12, 1024, 3, 5
# f32 trainer checks at 4 layers: each gradient's |a - b| / |b| (norms)
# and the loss of 3 steps. Kernel vs plain attention: f32 on both, sums in
# other orders. "dots" vs no remat: the recompute repeats the same
# deterministic kernels, so they should agree to rounding or better.
GRAD_REL_TOL = {"kernel_vs_plain": 1e-4, "dots_vs_none": 1e-6}
TRAIN_LOSS_TOL = 1e-4


def _log(msg):
    print(msg, flush=True)


def _nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _time_ms(torch, fn, iters, warmup=3):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _check(kernel, out, ref, dtype, scale=1.0):
    """(max abs error, relative bias, ok) of ``out`` against ``ref``,
    compared in f32; the tolerance is ``TOL * scale``."""
    ref = ref.float()
    err = out.float() - ref
    max_err = err.abs().max().item()
    bias = ((err * ref.sign()).mean() / ref.abs().mean()).item()
    ok = max_err <= TOL[kernel, dtype] * scale and (
        dtype == "float32" or abs(bias) <= BIAS_TOL)
    return max_err, bias, ok and math.isfinite(max_err)


def _tol_text(kernel, dtype):
    text = f"tol {TOL[kernel, dtype]:g}"
    return text if dtype == "float32" else f"{text}, bias tol {BIAS_TOL:g}"


def _bound(flops, nbytes, dtype):
    t_ops = flops / PEAK_FLOPS[dtype]
    t_bytes = nbytes / PEAK_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


# ----------------------------------------------------------------- phase 1

def phase_build(res):
    from paddle_tpu_torch.kernels import _build
    t0 = time.perf_counter()
    _build.build(force=True)
    _build.load_library()
    res["build_s"] = time.perf_counter() - t0
    _log(f"build: {res['build_s']:.2f} s ({_build.library_path()})")
    for line in _build.build_log["ptxas"].splitlines():
        if "Used" in line or line.startswith("=="):
            _log(f"  {line.strip()}")


# ----------------------------------------------------------------- phase 2

def phase_flash(torch, res):
    from paddle_tpu_torch.kernels import flash_attention as fa
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    cases = []
    for dt in ("bfloat16", "float32"):
        for s in (256, 512, 1024):
            cases.append((dt, 1, s, 8, 8, 128))
        cases += [(dt, 1, 233, 8, 8, 128), (dt, 1, 512, 8, 4, 128),
                  (dt, 1, 512, 16, 16, 64)]
    worst = {}
    main = None
    for dt, b, s, n, nkv, d in cases:
        dtype = getattr(torch, dt)
        q = torch.randn(b, s, n, d, device=dev, generator=gen).to(dtype)
        k = torch.randn(b, s, nkv, d, device=dev, generator=gen).to(dtype)
        v = torch.randn(b, s, nkv, d, device=dev, generator=gen).to(dtype)
        o, lse = fa.flash_attention_fwd(q, k, v, causal=True)
        torch.cuda.synchronize()
        o_ref, lse_ref = fa.flash_attention_reference(q, k, v, causal=True)
        err, bias, ok = _check("flash", o, o_ref, dt)
        lse_err = (lse - lse_ref).abs().max().item()
        ok = ok and lse_err <= 1e-3
        _log(f"flash_attention_fwd {dt} B={b} S={s} nh={n} nkv={nkv} d={d} "
             f"causal: max_abs_err={err:.3e} bias={bias:.2e} "
             f"({_tol_text('flash', dt)}) lse_err={lse_err:.3e} "
             f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"flash kernel disagrees at {dt} S={s}")
        worst[dt] = max(worst.get(dt, 0.0), err)
        if (dt, s, n, d) == ("bfloat16", 1024, 8, 128):
            main = (q, k, v, err)
    q, k, v, err = main
    b, s, n, d = q.shape
    ms = _time_ms(torch, lambda: fa.flash_attention_fwd(q, k, v, True), 50)
    plain_ms = _time_ms(
        torch, lambda: fa.flash_attention_reference(q, k, v, True), 20)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_ms = _time_ms(torch, lambda: sdpa(qt, kt, vt, is_causal=True), 50)
    pairs = s * (s + 1) // 2                 # causal (query, key) pairs
    flops = 4 * d * pairs * n * b
    nbytes = 4 * q.numel() * q.element_size() + b * n * s * 4   # q k v o + lse
    bound_ms, by = _bound(flops, nbytes, "bfloat16")
    _log(f"flash_attention_fwd bf16 S=1024: kernel {ms:.4f} ms, plain "
         f"{plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, bound {bound_ms:.5f} ms "
         f"({by}: {flops / 1e9:.3f} GFLOP, {nbytes / 1e6:.3f} MB)")
    res["flash"] = dict(
        name="flash_attention_fwd", route="cuda",
        source="paddle_tpu_torch/csrc/flash_attention_fwd.cu",
        replaces="paddle_tpu/kernels/flash_attention.py:150",
        launches=None, max_abs_err=err, ms=ms, plain_ms=plain_ms,
        bound_ms=bound_ms, bound_by=by, library_ms=lib_ms)
    res["flash_worst_err"] = worst


def _grad_err(g, r):
    """(largest |g - r|, largest |g - r| / (|r| + rms(r)), rms(g - r) /
    rms(r), mean signed error along r over mean |r|), in f32."""
    r = r.float()
    e = g.float() - r
    rms = r.square().mean().sqrt().clamp_min(1e-30)
    return (e.abs().max().item(), (e.abs() / (r.abs() + rms)).max().item(),
            (e.square().mean().sqrt() / rms).item(),
            ((e * r.sign()).mean() / r.abs().mean().clamp_min(1e-30)).item())


def _check_grads(label, kernel, dt, got, refs):
    """Hold (dq, dk, dv) against the plain version's; returns each one's
    (largest abs error, rms error over rms(ref))."""
    elem_tol, rms_tol = GRAD_TOL[kernel, dt]
    errs = {}
    for name, g, r in zip(("dq", "dk", "dv"), got, refs):
        err, elem, rms, bias = _grad_err(g, r)
        abs_tol = TOL[kernel, dt] * max(1.0, r.float().abs().max().item())
        ok = (err <= abs_tol and elem <= elem_tol and rms <= rms_tol
              and (dt == "float32" or abs(bias) <= BIAS_TOL))
        _log(f"  {label} {name}: max_abs_err={err:.3e} (tol {abs_tol:.3g}"
             f" = {TOL[kernel, dt]:g} x max(1, max |ref|)) elementwise="
             f"{elem:.3e} (tol {elem_tol:g}) rms={rms:.3e} (tol "
             f"{rms_tol:g}) bias={bias:.2e}"
             f"{'' if dt == 'float32' else f' (tol {BIAS_TOL:g})'} "
             f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"flash backward {name} disagrees: {label}")
        errs[name] = (err, rms)
    return errs


def phase_flash_bwd(torch, res):
    from paddle_tpu_torch.kernels import flash_attention as fa
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(4)
    randn = lambda *shape: torch.randn(*shape, device=dev,  # noqa: E731
                                       generator=gen)
    cases = []      # (dtype, B, Sq, Sk, N, Nkv, D, q_offset)
    for dt in ("bfloat16", "float32"):
        for s in (256, 512, 1024):
            cases.append((dt, 1, s, s, 8, 8, 128, None))
        cases += [(dt, 1, 233, 233, 8, 8, 128, None),
                  (dt, 1, 512, 512, 8, 4, 128, None),
                  (dt, 1, 512, 512, 16, 16, 64, None),
                  (dt, 1, 256, 768, 8, 8, 128, 512)]
    for dt, b, sq, sk, n, nkv, d, off in cases:
        dtype = getattr(torch, dt)
        q, do = (randn(b, sq, n, d).to(dtype) for _ in range(2))
        k, v = (randn(b, sk, nkv, d).to(dtype) for _ in range(2))
        o, lse = fa.flash_attention_fwd(q, k, v, True, q_offset=off)
        n0 = (fa.dq_launches, fa.dkv_launches)
        got = fa.flash_attention_bwd(q, k, v, o, lse, do, True, q_offset=off)
        torch.cuda.synchronize()
        if (fa.dq_launches, fa.dkv_launches) != (n0[0] + 1, n0[1] + 1):
            raise AssertionError("backward kernels did not launch once each")
        refs = fa.flash_attention_bwd_reference(q, k, v, o, lse, do, True,
                                                q_offset=off)
        label = (f"flash_attention_bwd {dt} B={b} Sq={sq} Sk={sk} nh={n} "
                 f"nkv={nkv} d={d} causal q_offset={off}")
        _log(label)
        _check_grads("kernels vs plain", "flash_bwd", dt, got, refs)

    # the autograd Function against autograd of the plain forward
    for dt in ("bfloat16", "float32"):
        dtype = getattr(torch, dt)
        q, do = (randn(1, 512, 8, 128).to(dtype) for _ in range(2))
        k, v = (randn(1, 512, 4, 128).to(dtype) for _ in range(2))
        leaves = [t.requires_grad_() for t in (q, k, v)]
        got = torch.autograd.grad(
            fa.flash_attention_bshd(*leaves, causal=True), leaves, do)
        refs = torch.autograd.grad(
            fa.flash_attention_reference(*leaves, causal=True)[0], leaves, do)
        _log(f"flash_attention_bshd autograd {dt} S=512 nh=8 nkv=4 d=128")
        _check_grads("Function vs autograd of the plain forward",
                     "flash_autograd", dt, got, refs)

    # the training shape, on the q/k/v views of one fused [B, S, 3, N, D]
    # projection as gpt_block passes them: the forward and the backward
    # wrapper against their plain versions, then each kernel's time
    b, s, n, d = TRAIN_B, TRAIN_S, 8, 128
    qkv = randn(b, s, 3, n, d).to(torch.bfloat16)
    q, k, v = qkv.unbind(2)
    do = randn(b, s, n, d).to(torch.bfloat16)
    o, lse = fa.flash_attention_fwd(q, k, v, True)
    o_ref, lse_ref = fa.flash_attention_reference(q, k, v, True)
    err, bias, ok = _check("flash", o, o_ref, "bfloat16")
    lse_err = (lse - lse_ref).abs().max().item()
    ok = ok and lse_err <= 1e-3
    _log(f"flash_attention_fwd bfloat16 B={b} S={s} nh={n} d={d} causal, "
         f"strided q/k/v views of a fused QKV (the training shape): "
         f"max_abs_err={err:.3e} bias={bias:.2e} "
         f"({_tol_text('flash', 'bfloat16')}) lse_err={lse_err:.3e} "
         f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("flash forward disagrees at the training shape")
    del o_ref, lse_ref
    got = fa.flash_attention_bwd(q, k, v, o, lse, do, True)
    refs = fa.flash_attention_bwd_reference(q, k, v, o, lse, do, True)
    _log(f"flash_attention_bwd bfloat16 B={b} S={s} nh={n} d={d} causal, "
         f"the same views (the training shape)")
    errs = _check_grads("kernels vs plain", "flash_bwd", "bfloat16", got,
                        refs)
    # the control: no rounding of P or dS, which the rms limit must refuse
    ctl = [t.to(torch.bfloat16) for t in fa.flash_attention_bwd_reference(
        q.float(), k.float(), v.float(), o.float(), lse, do.float(), True)]
    rms_tol = GRAD_TOL["flash_bwd", "bfloat16"][1]
    ctl_rms = {name: _grad_err(c, r)[2]
               for name, c, r in zip(("dq", "dk", "dv"), ctl, refs)}
    _log("  control (plain backward without the P and dS rounding) vs "
         "plain: rms " + ", ".join(f"{name} {x:.3e}" for name, x in
                                  ctl_rms.items())
         + f" (must exceed the limit {rms_tol:g})")
    if min(ctl_rms.values()) <= rms_tol:
        raise AssertionError("the bf16 rms limit does not tell the rounding "
                             "points apart")
    res["flash_bwd_control_rms"] = ctl_rms
    del refs, got, ctl
    scale = 1.0 / math.sqrt(d)
    fwd_ms = _time_ms(torch, lambda: fa.flash_attention_fwd(q, k, v, True),
                      20)
    _, delta = fa._launch_dq(q, k, v, o, lse, do, True, scale, 0)
    dq_ms = _time_ms(torch, lambda: fa._launch_dq(
        q, k, v, o, lse, do, True, scale, 0), 20)
    dkv_ms = _time_ms(torch, lambda: fa._launch_dkv(
        q, k, v, do, lse, delta, True, scale, 0), 20)
    plain_ms = _time_ms(torch, lambda: fa.flash_attention_bwd_reference(
        q, k, v, o, lse, do, True), 5, warmup=1)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_()
                  for t in (q, k, v))
    dot = do.transpose(1, 2).contiguous()
    sdpa_fwd_ms = _time_ms(torch, lambda: sdpa(qt, kt, vt, is_causal=True),
                           20)
    sdpa_both_ms = _time_ms(torch, lambda: torch.autograd.grad(
        sdpa(qt, kt, vt, is_causal=True), (qt, kt, vt), dot), 20)
    lib_ms = sdpa_both_ms - sdpa_fwd_ms
    pairs = s * (s + 1) // 2 * b * n      # causal (query, key) pairs
    tensor = q.numel() * q.element_size()
    rows = b * n * s * 4                  # one f32 per query row
    dq_flops = 3 * 2 * d * pairs + 2 * d * b * n * s       # + Delta
    dq_bytes = 5 * tensor + rows + tensor + rows   # q k v o dO lse | dq Delta
    dkv_flops = 4 * 2 * d * pairs
    dkv_bytes = 4 * tensor + 2 * rows + 2 * tensor  # q k v dO lse Delta | dk dv
    out = {}
    for key, name, ms, flops, nbytes, err in (
            ("flash_bwd_dq", "flash_attention_bwd_dq", dq_ms, dq_flops,
             dq_bytes, errs["dq"][0]),
            ("flash_bwd_dkv", "flash_attention_bwd_dkv", dkv_ms, dkv_flops,
             dkv_bytes, max(errs["dk"][0], errs["dv"][0]))):
        bound_ms, by = _bound(flops, nbytes, "bfloat16")
        _log(f"{name} bf16 B={b} S={s} nh={n} d={d} causal: kernel "
             f"{ms:.4f} ms, bound {bound_ms:.5f} ms ({by}: "
             f"{flops / 1e9:.3f} GFLOP, {nbytes / 1e6:.3f} MB), "
             f"{flops / ms / 1e9:.2f} TFLOP/s")
        out[key] = dict(
            name=name, route="cuda",
            source="paddle_tpu_torch/csrc/flash_attention_bwd.cu",
            replaces=("paddle_tpu/kernels/flash_attention.py:238"
                      if key == "flash_bwd_dq" else
                      "paddle_tpu/kernels/flash_attention.py:283"),
            launches=None, max_abs_err=err, ms=ms, plain_ms=plain_ms,
            bound_ms=bound_ms, bound_by=by, library_ms=lib_ms)
    fwd_bound, fwd_by = _bound(4 * d * pairs, 4 * tensor + rows, "bfloat16")
    _log(f"flash_attention_fwd bf16 B={b} S={s} nh={n} d={d} causal, the "
         f"training shape: kernel {fwd_ms:.4f} ms, bound {fwd_bound:.5f} ms "
         f"({fwd_by})")
    _log(f"flash backward bf16 at the training shape: dq + dkv kernels "
         f"{dq_ms + dkv_ms:.4f} ms; plain backward (dq, dk, dv) "
         f"{plain_ms:.4f} ms; SDPA backward (autograd.grad of "
         f"F.scaled_dot_product_attention(is_causal=True), less its "
         f"forward {sdpa_fwd_ms:.4f} ms) {lib_ms:.4f} ms")
    res.update(out)


def phase_paged(torch, res):
    from paddle_tpu_torch.kernels import paged_attention as pa
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    B, nh, nkv, d, ps, pps = 8, 8, 8, 128, 64, 16
    n_layers = 8        # cycled while timing: 270 MB of pages > 50 MB L2
    npg = B * pps + 1
    lens = [970, 545, 734, 266, 897, 162, 428, 0]   # ragged, one idle slot
    perm = torch.randperm(npg - 1, device=dev, generator=gen) + 1
    pt = perm.reshape(B, pps).to(torch.int32).contiguous()
    sl = torch.tensor(lens, dtype=torch.int32, device=dev)
    live = torch.tensor([n > 0 for n in lens], device=dev)
    for dt in ("bfloat16", "float32"):
        dtype = getattr(torch, dt)
        kp = torch.randn(n_layers, npg, ps, nkv, d, device=dev,
                         generator=gen).to(dtype)
        vp = torch.randn(n_layers, npg, ps, nkv, d, device=dev,
                         generator=gen).to(dtype)
        q = torch.randn(B, nh, d, device=dev, generator=gen).to(dtype)
        out = pa.paged_attention_decode(q, kp[0], vp[0], pt, sl)
        torch.cuda.synchronize()
        ref = pa.paged_attention_reference(q, kp[0], vp[0], pt, sl)
        err, bias, ok = _check("paged", out[live], ref[live], dt)
        finite = bool(torch.isfinite(out.float()).all())
        ok = ok and finite
        _log(f"paged_attention_decode {dt} B={B} nh={nh} nkv={nkv} d={d} "
             f"page={ps} pages/seq={pps} lens={lens}: max_abs_err={err:.3e} "
             f"bias={bias:.2e} ({_tol_text('paged', dt)}) idle row "
             f"finite={finite} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"paged kernel disagrees at {dt}")
        if dt != "bfloat16":
            continue
        def cycling(fn, step=[0]):
            def run():          # one layer's pages per call, as decode does
                i = step[0] % n_layers
                step[0] += 1
                return fn(q, kp[i], vp[i], pt, sl)
            return run
        ms = _time_ms(torch, cycling(pa.paged_attention_decode), 200)
        plain_ms = _time_ms(torch, cycling(pa.paged_attention_reference), 20)
        tokens = sum(lens)
        nbytes = (2 * tokens * nkv * d * kp.element_size()       # K and V
                  + 2 * q.numel() * q.element_size()             # q and out
                  + pt.numel() * 4 + sl.numel() * 4)
        flops = 4 * nh * d * tokens
        bound_ms, by = _bound(flops, nbytes, "bfloat16")
        _log(f"paged_attention_decode bf16 bucket 8 ({tokens} live tokens): "
             f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library none, "
             f"bound {bound_ms:.5f} ms ({by}: {nbytes / 1e6:.3f} MB)")
        res["paged"] = dict(
            name="paged_attention_decode", route="cuda",
            source="paddle_tpu_torch/csrc/paged_attention_decode.cu",
            replaces="paddle_tpu/kernels/paged_attention.py:80",
            launches=None, max_abs_err=err, ms=ms, plain_ms=plain_ms,
            bound_ms=bound_ms, bound_by=by, library_ms=None)
        del kp, vp


# ----------------------------------------------------------------- phase 3

def _engine(model):
    from paddle_tpu_torch.serving import ServingEngine
    return ServingEngine(model, page_size=64, decode_buckets=(1, 2, 4, 8),
                         prefill_buckets=(256, 512, 1024), device="cuda")


def _serve(eng, cfg, np):
    from paddle_tpu_torch.serving import ContinuousBatchingScheduler
    sched = ContinuousBatchingScheduler(eng)
    rng = np.random.default_rng(1)
    reqs = [sched.submit(rng.integers(0, cfg.vocab_size, (s,)).astype(
        np.int32), max_new_tokens=MAX_NEW) for s in PROMPT_LENS]
    sched.run()
    return sched, reqs


def _warm(eng, cfg, np):
    """Touch every prefill bucket and every decode bucket once (cuBLAS
    shapes, lazily loaded kernels, the allocator) before anything is
    timed."""
    rng = np.random.default_rng(3)
    lens = (100, 300, 700, 1000, 200, 400, 600, 800)
    assert {eng.prefill_bucket(n) for n in lens} == set(eng.prefill_buckets)
    rids = [f"warm{i}" for i in range(len(lens))]
    for rid, n in zip(rids, lens):
        eng.prefill(rid, rng.integers(0, cfg.vocab_size, (n,)).astype(
            np.int32))
    for b in eng.decode_buckets:
        for rid in rids[:b]:
            eng.pool.extend(rid, 1)
        eng.decode(rids[:b], b)
    for rid in rids:
        eng.release(rid)


def _pct(values, p):
    st = sorted(values)
    return st[min(len(st) - 1, int(p * len(st)))]


def _serve_counted(torch, np, eng, cfg):
    """One bf16 serving run of the main path, with the kernels' launch
    counts set to 0 just before it and read just after."""
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.kernels import paged_attention as pa
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.launches = 0
    pa.launches = 0
    t0 = time.perf_counter()
    sched, reqs = _serve(eng, cfg, np)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    new = sum(len(r.tokens) for r in reqs)
    ttft = [r.summary()["ttft_s"] for r in reqs]
    e2e = dict(tokens_per_s=new / wall, wall_s=wall, new_tokens=new,
               decode_steps=sched.steps,
               per_token_p50_ms=_pct(sched.step_times, 0.5) * 1e3,
               per_token_p95_ms=_pct(sched.step_times, 0.95) * 1e3,
               ttft_mean_ms=sum(ttft) / len(ttft) * 1e3,
               max_memory_allocated_bytes=torch.cuda.max_memory_allocated(),
               flash_launches=fa.launches, paged_launches=pa.launches)
    want_flash = cfg.num_layers * len(PROMPT_LENS)
    want_paged = cfg.num_layers * sched.steps
    if e2e["flash_launches"] != want_flash or \
            e2e["paged_launches"] != want_paged:
        raise AssertionError(
            f"launch counts flash {e2e['flash_launches']} (want "
            f"{want_flash}), paged {e2e['paged_launches']} (want "
            f"{want_paged})")
    if not all(r.state == "finished" and len(r.tokens) == MAX_NEW
               for r in reqs) or eng.pool.pages_in_use:
        raise AssertionError("unfinished requests or leaked pages")
    return e2e, [list(r.tokens) for r in reqs]


def _decode_split(torch, np, eng, cfg, n_steps=16):
    """Host against device time of a bf16 decode step at bucket 8, by
    CUDA events, over the eight prompts. Each step is run twice:

    * served, as the scheduler runs it: ``upload`` is the host time to
      copy the step's inputs to the card (blocking copies), ``issue`` that
      plus the time to launch the step, ``step`` the time until its tokens
      are on the host;
    * held: after the upload, a device-side sleep holds the stream for
      longer than the host takes to launch the step, so the events around
      the launches time the device's work alone (``device``), with no
      wait for the host in it.
    """
    rng = np.random.default_rng(2)
    rids = [f"split{i}" for i in range(len(PROMPT_LENS))]
    for rid, n in zip(rids, PROMPT_LENS):
        eng.prefill(rid, rng.integers(0, cfg.vocab_size, (n,)).astype(
            np.int32))
    ev = lambda: torch.cuda.Event(enable_timing=True)    # noqa: E731
    sleep_cycles = 400_000_000
    s0, s1 = ev(), ev()
    s0.record()
    torch.cuda._sleep(sleep_cycles)
    s1.record()
    s1.synchronize()
    sleep_ms = s0.elapsed_time(s1)
    rows = {"upload_ms": [], "issue_ms": [], "step_ms": [], "device_ms": [],
            "held_issue_ms": []}
    for _ in range(n_steps):
        for rid in rids:
            eng.pool.extend(rid, 1)
        t0 = time.perf_counter()
        inputs = eng._decode_inputs(rids)
        tu = time.perf_counter()
        nxt = eng._launch_decode(inputs)
        t1 = time.perf_counter()
        nxt.tolist()
        t2 = time.perf_counter()
        rows["upload_ms"].append((tu - t0) * 1e3)
        rows["issue_ms"].append((t1 - t0) * 1e3)
        rows["step_ms"].append((t2 - t0) * 1e3)
        for rid in rids:
            eng.pool.extend(rid, 1)
        inputs = eng._decode_inputs(rids)
        e0, e1 = ev(), ev()
        torch.cuda._sleep(sleep_cycles)
        e0.record()
        t0 = time.perf_counter()
        eng._launch_decode(inputs)
        t1 = time.perf_counter()
        e1.record()
        e1.synchronize()
        rows["held_issue_ms"].append((t1 - t0) * 1e3)
        rows["device_ms"].append(e0.elapsed_time(e1))
    for rid in rids:
        eng.release(rid)
    if max(rows["held_issue_ms"]) > 0.8 * sleep_ms:
        raise AssertionError(f"the device sleep ({sleep_ms:.1f} ms) did not "
                             f"outlast the host's launches")
    out = {k + "_p50": _pct(v, 0.5) for k, v in rows.items()}
    out.update(n_steps=n_steps, sleep_ms=sleep_ms,
               device_share=out["device_ms_p50"] / out["step_ms_p50"],
               samples=rows)
    _log(f"decode step bf16, bucket 8, p50 of {n_steps}: host upload "
         f"{out['upload_ms_p50']:.3f} ms, upload + issue "
         f"{out['issue_ms_p50']:.3f} ms, step to tokens on host "
         f"{out['step_ms_p50']:.3f} ms, device work (CUDA events, stream "
         f"held) {out['device_ms_p50']:.3f} ms, device share "
         f"{out['device_share']:.3f}")
    return out


def _device_time(torch, fn):
    """Run ``fn`` under ``torch.profiler`` (CUDA activity only, to keep
    the host overhead low). Returns the host wall seconds and the device
    microseconds by kernel name; an empty dict when the profiler saw no
    device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) \
                + e.time_range.elapsed_us()
    return wall, by_name


def _kernel_group(name):
    if "flash_fwd_kernel" in name:
        return "flash_attention_fwd"
    if "flash_bwd_dq_kernel" in name:
        return "flash_attention_bwd_dq"
    if "flash_bwd_dkv_kernel" in name:
        return "flash_attention_bwd_dkv"
    if "paged_decode_kernel" in name:
        return "paged_attention_decode"
    if any(s in name.lower() for s in ("gemm", "gemv", "xmma", "cutlass",
                                       "nvjet")):
        return "matmul (cuBLAS)"
    if name.startswith("Memcpy") or name.startswith("Memset"):
        return "memcpy/memset"
    return "other (elementwise and reductions)"


def _profile_engine(torch, np, eng, cfg):
    """Where the time goes in the bf16 engine: the eight prefills, then
    16 decode steps at bucket 8, each window under the profiler. Prints
    the device busy share (device time / host wall time) and the device
    time by kernel group. Profiling slows the host, so the busy share
    read here is a lower bound for an unprofiled run."""
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab_size, (s,)).astype(np.int32)
               for s in PROMPT_LENS]
    rids = [f"profile{i}" for i in range(len(prompts))]
    n_decode = 16

    def prefill_all():
        for rid, p in zip(rids, prompts):
            eng.prefill(rid, p)

    def decode_steps():
        for _ in range(n_decode):
            for rid in rids:
                eng.pool.extend(rid, 1)
            eng.decode(rids)

    out = {}
    for window, fn in (("prefill x8", prefill_all),
                       (f"decode x{n_decode} (bucket 8)", decode_steps)):
        wall, by_name = _device_time(torch, fn)
        busy_us = sum(by_name.values())
        groups = {}
        for name, us in by_name.items():
            g = _kernel_group(name)
            groups[g] = groups.get(g, 0.0) + us
        row = dict(wall_ms=wall * 1e3,
                   device_ms=busy_us / 1e3 if by_name else None,
                   busy_share=busy_us / 1e6 / wall if by_name else None,
                   device_ms_by_group={g: us / 1e3 for g, us in
                                       sorted(groups.items(),
                                              key=lambda kv: -kv[1])})
        out[window] = row
        if not by_name:
            _log(f"profile {window}: wall {row['wall_ms']:.2f} ms, device "
                 f"time not measured (the profiler saw no CUDA activity)")
            continue
        split = ", ".join(f"{g} {ms:.3f} ms"
                          for g, ms in row["device_ms_by_group"].items())
        _log(f"profile {window}: wall {row['wall_ms']:.2f} ms, device busy "
             f"{row['device_ms']:.3f} ms (share {row['busy_share']:.3f}); "
             f"{split}")
        for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
            _log(f"  {us / 1e3:9.3f} ms  {name[:100]}")
    for rid in rids:
        eng.release(rid)
    if eng.pool.pages_in_use:
        raise AssertionError("profile windows leaked pages")
    return out


def phase_serving(torch, np, res):
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.kernels import paged_attention as pa
    from paddle_tpu_torch.models.gpt import (GPTForPretraining, GPTModel,
                                             gpt_345m_config)
    cfg = gpt_345m_config(max_position_embeddings=1024, num_heads=8)
    _log(f"config: layers={cfg.num_layers} hidden={cfg.hidden_size} "
         f"heads={cfg.num_heads} head_dim={cfg.head_dim} "
         f"vocab={cfg.vocab_size} max_pos={cfg.max_position_embeddings}")
    model = GPTForPretraining(GPTModel(cfg, seed=0, device="cuda")).eval()

    # ---- bf16: the measured runs -----------------------------------------
    eng = _engine(copy.deepcopy(model).to(torch.bfloat16))
    _warm(eng, cfg, np)
    runs = []
    for k in range(N_RUNS):
        e2e, tokens = _serve_counted(torch, np, eng, cfg)
        runs.append(e2e)
        _log(f"serving bf16 run {k + 1}/{N_RUNS}: " + json.dumps(e2e))
        if k == 0:
            bf16_tokens = tokens
        elif tokens != bf16_tokens:
            res["bf16_runs_differ"] = True
            _log(f"serving bf16 run {k + 1}: tokens differ from run 1")
    res["serving_bf16_runs"] = runs
    res["serving_bf16"] = runs[0]
    res["decode_split_bf16"] = _decode_split(torch, np, eng, cfg)
    res["profile_bf16"] = _profile_engine(torch, np, eng, cfg)
    del eng
    want_flash = cfg.num_layers * len(PROMPT_LENS)

    # ---- f32: correctness against the plain dense model ------------------
    eng = _engine(model)
    fa.launches = 0
    pa.launches = 0
    sched, reqs = _serve(eng, cfg, np)
    torch.cuda.synchronize()
    if fa.launches != want_flash or \
            pa.launches != cfg.num_layers * sched.steps:
        raise AssertionError(f"f32 launch counts {fa.launches}, "
                             f"{pa.launches}")
    if not all(r.state == "finished" for r in reqs) or eng.pool.pages_in_use:
        raise AssertionError("f32 run: unfinished requests or leaked pages")
    checked = near_ties = 0
    with torch.no_grad():
        for r in reqs:
            ids = torch.from_numpy(r.output_ids.astype(np.int64)).cuda()
            logits = model(ids[None, :-1])[0].float()
            n = len(r.prompt)
            for i, tok in enumerate(r.tokens):
                row = logits[n - 1 + i]
                if not bool(torch.isfinite(row).all()):
                    raise AssertionError(f"non-finite logits, rid {r.rid}")
                top2 = torch.topk(row, 2)
                checked += 1
                if int(top2.indices[0]) == tok:
                    continue
                gap = float(top2.values[0] - top2.values[1])
                if gap < 1e-3 and row[tok] >= top2.values[1]:
                    near_ties += 1
                    continue
                raise AssertionError(
                    f"rid {r.rid} token {i}: engine {tok}, reference "
                    f"argmax {int(top2.indices[0])} (top-2 gap {gap:.3e})")
    agree = sum(a == b for x, y in zip(bf16_tokens, reqs)
                for a, b in zip(x, y.tokens))
    res["serving_f32"] = dict(tokens_checked=checked, near_ties=near_ties,
                              bf16_f32_token_agreement=agree / checked)
    _log(f"serving f32: {checked} generated tokens equal the dense "
         f"reference's argmax (near ties, gap < 1e-3: {near_ties}); "
         f"bf16 tokens equal to f32: {agree}/{checked}")


# ----------------------------------------------------------------- phase 4

def _flash_counts():
    from paddle_tpu_torch.kernels import flash_attention as fa
    return fa.launches, fa.dq_launches, fa.dkv_launches


def _train_main(torch, np, res):
    """The training main path at GPT-345M width, bf16, remat "dots"."""
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.models.gpt import (
        GPTForPretraining, GPTHybridTrainStep, GPTModel, gpt_345m_config,
        model_flops_per_token)
    cfg = gpt_345m_config(max_position_embeddings=1024, num_heads=8)
    model = GPTForPretraining(GPTModel(cfg, seed=0, device="cuda"))
    step = GPTHybridTrainStep(model, cfg, None, n_micro=1, lr=1e-4,
                              remat="dots", compute_dtype="bfloat16")
    rng = np.random.default_rng(0)
    ids = rng.integers(0, cfg.vocab_size, (TRAIN_B, TRAIN_S)).astype(
        np.int32)
    labels = np.roll(ids, -1, axis=1).astype(np.int32)
    _log(f"training: GPT-345M layers={cfg.num_layers} hidden="
         f"{cfg.hidden_size} heads={cfg.num_heads}x{cfg.head_dim} vocab="
         f"{cfg.vocab_size}, B={TRAIN_B} S={TRAIN_S}, bf16 compute, f32 "
         f"masters and moments, remat='dots', AdamW lr=1e-4")
    losses = [step(ids, labels).item() for _ in range(WARMUP_STEPS)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.launches = fa.dq_launches = fa.dkv_launches = 0
    times, per_step = [], []
    for _ in range(TIMED_STEPS):
        c0 = _flash_counts()
        t0 = time.perf_counter()
        losses.append(step(ids, labels).item())
        times.append(time.perf_counter() - t0)
        per_step.append([b - a for a, b in zip(c0, _flash_counts())])
    counts = _flash_counts()
    peak = torch.cuda.max_memory_allocated()
    L = cfg.num_layers
    want = [2 * L, L, L]     # forward + recompute under "dots"; dQ; dK/dV
    tokens_per_s = TRAIN_B * TRAIN_S * TIMED_STEPS / sum(times)
    fpt = model_flops_per_token(cfg, TRAIN_S)[0]
    e2e = dict(tokens_per_s=tokens_per_s,
               step_p50_ms=_pct(times, 0.5) * 1e3,
               step_ms=[t * 1e3 for t in times],
               mfu=tokens_per_s * fpt / PEAK_FLOPS["bfloat16"],
               flops_per_token=fpt,
               max_memory_allocated_bytes=peak, losses=losses,
               launches_per_step=per_step,
               launches=dict(zip(("flash_fwd", "flash_bwd_dq",
                                  "flash_bwd_dkv"), counts)))
    _log(f"training bf16, {TIMED_STEPS} timed steps after {WARMUP_STEPS} "
         f"warm-up: {tokens_per_s:.1f} tokens/s, step p50 "
         f"{e2e['step_p50_ms']:.2f} ms (steps "
         f"{', '.join(f'{t:.2f}' for t in e2e['step_ms'])} ms), MFU "
         f"{e2e['mfu']:.4f} of {PEAK_FLOPS['bfloat16']:.3g} FLOP/s "
         f"({fpt:.4g} FLOP/token), peak memory {peak} bytes; on "
         f"{res.get('nvidia_smi')}")
    _log(f"training losses (warm-up, then timed): "
         f"{', '.join(f'{x:.6f}' for x in losses)}")
    _log(f"training flash launches per step (fwd, dq, dkv): {per_step}; "
         f"want {want} each")
    res["training_bf16"] = e2e
    if any(c != want for c in per_step):
        raise AssertionError(f"launches per step {per_step}, want {want}")
    if not all(math.isfinite(x) for x in losses) or losses[-1] >= losses[0]:
        raise AssertionError(f"losses not finite or not falling: {losses}")

    # where a step's time goes: forward + backward against AdamW (CUDA
    # events), then one step under the profiler by kernel group
    ev = lambda: torch.cuda.Event(enable_timing=True)    # noqa: E731
    e0, e1, e2 = ev(), ev(), ev()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    e0.record()
    _, grads = step.loss_and_grads(ids, labels)
    e1.record()
    t1 = time.perf_counter()
    step._t += 1
    step._adamw(grads, 1e-4, step._t)
    e2.record()
    e2.synchronize()
    t2 = time.perf_counter()
    split = dict(fwd_bwd_device_ms=e0.elapsed_time(e1),
                 adamw_device_ms=e1.elapsed_time(e2),
                 fwd_bwd_host_issue_ms=(t1 - t0) * 1e3,
                 step_wall_ms=(t2 - t0) * 1e3)
    del grads
    _log(f"training step split (CUDA events): forward + backward "
         f"{split['fwd_bwd_device_ms']:.2f} ms, AdamW "
         f"{split['adamw_device_ms']:.2f} ms; host issue of forward + "
         f"backward {split['fwd_bwd_host_issue_ms']:.2f} ms; wall "
         f"{split['step_wall_ms']:.2f} ms")
    wall, by_name = _device_time(torch, lambda: step(ids, labels).item())
    groups = {}
    for name, us in by_name.items():
        groups[_kernel_group(name)] = groups.get(_kernel_group(name), 0.0) \
            + us
    busy_us = sum(by_name.values())
    split.update(
        profiled_wall_ms=wall * 1e3,
        profiled_device_ms=busy_us / 1e3 if by_name else None,
        busy_share=busy_us / 1e6 / wall if by_name else None,
        device_ms_by_group={g: us / 1e3 for g, us in sorted(
            groups.items(), key=lambda kv: -kv[1])})
    res["training_profile"] = split
    if by_name:
        _log(f"profile one training step: wall {wall * 1e3:.2f} ms, device "
             f"busy {busy_us / 1e3:.2f} ms (share {split['busy_share']:.3f}); "
             + ", ".join(f"{g} {ms:.3f} ms" for g, ms in
                         split["device_ms_by_group"].items()))
        for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]:
            _log(f"  {us / 1e3:9.3f} ms  {name[:100]}")
    else:
        _log("profile one training step: device time not measured (the "
             "profiler saw no CUDA activity)")


def _grad_rel_err(got, ref):
    """The largest |a - b| / |b| (norms) over the leaves of two gradient
    trees, and the name of its leaf."""
    flat = lambda t: {**{f"blocks.{k}": v for k, v in t["blocks"].items()},
                      **{k: v for k, v in t.items() if k != "blocks"}}
    got, ref = flat(got), flat(ref)
    worst, where = 0.0, None
    for key, r in ref.items():
        rel = ((got[key].float() - r.float()).norm()
               / r.float().norm().clamp_min(1e-30)).item()
        if not math.isfinite(rel) or rel > worst:
            worst, where = rel, key
    return worst, where


def _train_f32_check(torch, np, res):
    """f32 trainer at full width, 4 layers, B = 2: the kernel path against
    the plain attention path, and remat "dots" against no remat."""
    from paddle_tpu_torch.models.gpt import (
        GPTForPretraining, GPTHybridTrainStep, GPTModel, gpt_345m_config)
    cfg = gpt_345m_config(max_position_embeddings=1024, num_heads=8,
                          num_layers=4)
    base = GPTForPretraining(GPTModel(cfg, seed=1, device="cuda"))
    rng = np.random.default_rng(1)
    ids = rng.integers(0, cfg.vocab_size, (2, TRAIN_S)).astype(np.int32)
    labels = np.roll(ids, -1, axis=1).astype(np.int32)

    def run(use_flash, remat):
        step = GPTHybridTrainStep(copy.deepcopy(base), cfg, None, lr=1e-4,
                                  remat=remat, use_flash=use_flash)
        _, grads = step.loss_and_grads(ids, labels)
        losses = [step(ids, labels).item() for _ in range(3)]
        return grads, losses

    runs = {"plain": run(False, False), "kernel": run(True, False),
            "kernel_dots": run(True, "dots")}
    out = {}
    for what, a, b in (("kernel_vs_plain", "kernel", "plain"),
                       ("dots_vs_none", "kernel_dots", "kernel")):
        rel, where = _grad_rel_err(runs[a][0], runs[b][0])
        dloss = max(abs(x - y) for x, y in zip(runs[a][1], runs[b][1]))
        ok = rel <= GRAD_REL_TOL[what] and dloss <= TRAIN_LOSS_TOL
        out[what] = dict(grad_rel_err=rel, worst_leaf=where,
                         loss_abs_err=dloss, losses=runs[a][1],
                         ref_losses=runs[b][1])
        _log(f"training f32 4 layers B=2 S={TRAIN_S}, {a} vs {b}: first-step "
             f"gradients max |a-b|/|b| = {rel:.3e} ({where}; tol "
             f"{GRAD_REL_TOL[what]:g}), losses of 3 steps "
             f"{[round(x, 6) for x in runs[a][1]]} vs "
             f"{[round(x, 6) for x in runs[b][1]]}, max diff {dloss:.3e} "
             f"(tol {TRAIN_LOSS_TOL:g}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"f32 trainer check {what} failed")
    res["training_f32"] = out


def phase_training(torch, np, res):
    _train_main(torch, np, res)
    torch.cuda.empty_cache()
    _train_f32_check(torch, np, res)


# --------------------------------------------------------------------- main

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json-out", help="also write every result here")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    import numpy as np
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    res: dict = {}
    failed = []
    smi = None
    try:
        smi = res["nvidia_smi"] = _nvidia_smi()
        _log(f"nvidia-smi: {smi}")
    except (OSError, subprocess.SubprocessError) as e:
        failed.append("nvidia-smi")
        _log(f"nvidia-smi FAILED: {e}")
    kind = torch.cuda.get_device_name(0)
    _log(f"device: {kind} x{torch.cuda.device_count()}, torch "
         f"{torch.__version__}, cuda {torch.version.cuda}; host: "
         f"{os.cpu_count()} cpus, {len(os.sched_getaffinity(0))} usable, "
         f"{torch.get_num_threads()} torch threads")
    phases = [("build", lambda: phase_build(res)),
              ("flash", lambda: phase_flash(torch, res)),
              ("flash_bwd", lambda: phase_flash_bwd(torch, res)),
              ("paged", lambda: phase_paged(torch, res)),
              ("serving", lambda: phase_serving(torch, np, res)),
              ("training", lambda: phase_training(torch, np, res))]
    for name, fn in phases:
        t0 = time.perf_counter()
        try:
            fn()
            _log(f"phase {name}: ok ({time.perf_counter() - t0:.1f} s)")
        except Exception:  # report every phase, then fail the run
            failed.append(name)
            traceback.print_exc()
            _log(f"phase {name}: FAILED")
            if name == "build":
                break
    res.update(nvidia_smi=smi, device=kind, failed=failed)
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(res, f, indent=1, default=str)
    if failed:
        _log(f"chip_smoke: failed phases {failed}")
        return 1
    # launches: each kernel's count over its main path's counted run (the
    # first bf16 serving run; the five timed training steps), by path
    train = res["training_bf16"]["launches"]
    res["flash"]["launches"] = res["serving_bf16"]["flash_launches"]
    res["flash"]["launches_by_path"] = dict(
        serving=res["serving_bf16"]["flash_launches"],
        training=train["flash_fwd"])
    for key in ("flash_bwd_dq", "flash_bwd_dkv"):
        res[key]["launches"] = train[key]
        res[key]["launches_by_path"] = dict(training=train[key])
    res["paged"]["launches"] = res["serving_bf16"]["paged_launches"]
    res["paged"]["launches_by_path"] = dict(
        serving=res["serving_bf16"]["paged_launches"])
    print(json.dumps({"kernels": [res[k] for k in (
        "flash", "flash_bwd_dq", "flash_bwd_dkv", "paged")]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
