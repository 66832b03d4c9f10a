"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py [--json-out PATH]

Twelve phases, one result per line:

1. device and build — the card's name and power limit, and the build of
   every CUDA kernel from ``paddle_tpu_torch/csrc`` with nvcc for sm_90a;
2. ``flash``, ``flash_bwd``, ``paged`` — each kernel against its plain
   PyTorch version on the card, in bf16 and f32 (bf16 attention runs on
   the tensor cores: the flash forward and the dK/dV pass on ``wgmma``
   fed by TMA where a tensor map can describe the views, else, and for
   the dQ pass, on ``mma.sync``; f32 on the CUDA cores; the phases read
   the bf16 instances' registers and spills from the build log, count
   HGMMA and UTMALDG in the wgmma kernels' SASS, and the profiler's
   kernel names show which kernel each dtype and view ran, the wgmma
   ones timed beside the ``mma.sync`` ones): the flash forward at
   the serving shapes, a causal ``q_offset`` case, a masked head dim (d =
   80, GQA) and the training shape on the q/k/v views of one fused QKV
   tensor, two calls there bit-equal, timed at the serving and the
   training shape beside SDPA, and its errors over 6 other seeds logged;
   the paged decode at the serving shapes (GPT-345M's and ERNIE-MoE
   base's, 12 heads of 64), also against its plain version in the kernel's
   own form (``paged_decode_split_reference``), two calls bit-equal, its
   instances' registers and spills read from the build log, and timed at
   both shapes with the stream held beside SDPA; the flash backward (dQ and dK/dV kernels)
   over the forward's cases, and through the autograd Function against
   autograd of the plain forward; then the backward at the training
   shape, on the fused views, with a control that shows the bf16
   gradient limit tells the kernels' rounding points from none, and two
   backward calls (also under GQA) bit-equal. Each kernel's time (CUDA
   events), its plain version's time, its bound and one PyTorch library
   call as a yardstick (TFLOP/s beside SDPA's);
3. ``paged_prefill``, ``int8`` — the ragged chunk-prefill kernel and the
   int8 dequant-matmul kernel against their plain versions in bf16 and
   f32 (chunk offsets 0, mid-page and late, a padded chunk, d = 64 and
   128, two sequences sharing prefix pages, four sequences (more bf16
   blocks than SMs), each case held to its own scale, also
   against a plain version with the kernel's rounding points and a
   control without the rounding of P, two calls bit-equal and 6 other
   seeds logged; the five GPT-345M
   weight shapes at M = 1, 8, 9 and 256 and odd sizes, two calls
   bit-equal, the instances' registers and spills from the build log),
   each timed at its serving shape (with the stream held, so the host's
   issue does not enter) against its bound and a PyTorch yardstick, the
   int8 shapes at M = 1, 2, 4 and 8 and the "kn" ones at 256 beside cuBLAS
   on the dequantized weight; ``moe_dispatch`` — the
   MoE dispatch and combine kernels against their plain versions in f32
   and bf16 at ERNIE-MoE base width (M = 768, E = 8, top-2): the decode
   and prefill shapes, a ragged S = 130, a capacity-dropping S = 4096,
   every gate kind; the routing held exactly off router near ties
   (counted and printed) and the public wrapper to the same bits, the
   combine against the plain version with its rounding points and against
   the einsum reference; both timed at the two serving shapes with the
   stream held, the combine beside ``F.embedding_bag``;
4. ``serving`` — the serving main path at the full width of GPT-345M (24
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
5. ``serving_prefix`` — the chunked engine with and without the prefix
   cache at GPT-345M width: eight prompts sharing a 768-token prefix
   (page 64, chunk 256, prefill budget 896 tokens a tick), bf16 counted
   runs after a warm-up and, with the cache, the same traffic with 8 new
   tokens under ``torch.profiler``; then f32, where every token with the
   cache equals the token without it;
6. ``serving_int8`` — the eight ragged requests of ``serving`` with
   ``quantize="int8"``: a bf16 counted run beside the float engine's, the
   host/device split of a decode step and 16 decode steps under
   ``torch.profiler``, then f32, where every token
   equals the argmax of the dense model on the dequantized weights;
7. ``serving_moe`` — the ERNIE-MoE serving path at the full width of
   ``ernie_moe_base_config`` (12 layers, hidden 768, 12 heads of 64, 8
   experts top-2 in every second layer, vocab 30522, 512 positions,
   random weights from a seed): eight ragged requests through
   ``MoEServingEngine`` + ``ContinuousBatchingScheduler``, page 64. bf16:
   after a warm-up over every bucket one counted run (exact launches of
   the dispatch, combine and paged decode kernels, none of the others),
   then 16 decode steps under ``torch.profiler``; f32: every generated
   token against the argmax of the eager ``ErnieMoeForPretraining``
   (gather path, plain attention), teacher-forced under the causal mask;
8. ``training`` — the training main path: ``GPTHybridTrainStep`` on
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
that one JSON object holds the per-kernel numbers (eight kernels).
"""
from __future__ import annotations

import argparse
import contextlib
import copy
import json
import math
import os
import re
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
HOLD_CYCLES = 100_000_000   # ~50 ms of device sleep to hold the stream
# the shared-prefix cell: 8 requests of a 768-token prefix and a 128-token
# suffix, chunks of 256 and a prefill budget of 896 tokens a tick
PREFIX_LEN, SUFFIX_LEN, N_PREFIX_REQS, CHUNK, BUDGET = 768, 128, 8, 256, 896
# the MoE serving cell: ERNIE-MoE base, eight ragged prompts (<= 437 + 64
# new tokens within the 512 positions)
MOE_PROMPT_LENS = (437, 256, 350, 116, 432, 64, 197, 310)
# the MoE kernels: (label, S, C, top_k, gate kind) at M = 768, E = 8
MOE_M, MOE_E = 768, 8
MOE_CASES = (("decode", 8, 8, 2, "gshard"), ("prefill", 512, 512, 2, "gshard"),
             ("ragged", 130, 130, 2, "gshard"),
             ("dropping", 4096, 640, 2, "gshard"),
             ("naive", 512, 512, 2, "naive"), ("switch", 512, 512, 1, "switch"),
             ("renorm", 512, 512, 2, "renorm"))
# MoE dispatch: a token whose k-th and (k+1)-th logits lie within this of
# each other is a router near tie (a rounding of the gate product may flip
# it); off near ties the routing, comb_idx and expert_in must be exact, and
# val, me and ce within MOE_REL of the largest |value| (f32 sums in another
# order)
MOE_NEAR_TIE = 1e-5
MOE_REL = 1e-6
# MoE combine, bf16, against the einsum reference (one rounding of an f32
# sum, where the kernel rounds val, each product and each add to bf16):
# (the largest |out - ref| over max |ref|, rms(out - ref) / rms(ref))
MOE_COMBINE_EINSUM_TOL = (2 ** -6, 5e-3)
# the GPT-345M weight shapes of the int8 kernel: (name, K, N, layout)
INT8_SHAPES = (("wqkv", 1024, 3072, "kn"), ("wo", 1024, 1024, "kn"),
               ("w1", 1024, 4096, "kn"), ("w2", 4096, 1024, "kn"),
               ("logits", 1024, 50304, "nk"))
INT8_DECODE_M = (1, 2, 4, 8)     # the decode buckets' rows

# kernel vs plain version: the largest |out - ref|, held to about twice
# the error each kernel showed on the card (bf16 shows one or two bf16
# spacings), and in bf16 the mean signed error along ref, over the mean
# |ref|: round-to-nearest leaves it near 0, truncation makes it ~ -3e-3.
TOL = {("flash", "float32"): 1e-4, ("flash", "bfloat16"): 8e-3,
       ("paged", "float32"): 1e-4, ("paged", "bfloat16"): 5e-3,
       # int8 matmul, as a share of the largest |ref|: f32 sums in another
       # order; bf16 one rounding of the f32 result (2^-8 of the largest)
       ("int8", "float32"): 1e-5, ("int8", "bfloat16"): 8e-3,
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
# rounding: on an H100, bf16 (the tensor-core kernels) up to 6.4e-3
# elementwise and 8.4e-5 rms (dk at the training shape), f32 1.1e-5 and
# 5.9e-7. The elementwise limit depends on that order: over 6 other
# random inputs at the training shape the bf16 kernels exceed it in 2
# (the earlier CUDA-core bf16 kernels, which summed S and dP in cuBLAS's
# order, in 1; tools/torch_flash_bwd_stats.py). The control, the plain
# backward in f32 (no rounding of P or dS) rounded to bf16 at the end,
# gave 2.5e-3 rms there and must fail the bf16 rms limit at the
# training shape, or the check could not tell the rounding points apart.
# "flash_autograd" holds the Function against autograd of the plain
# forward, which rounds neither P in the backward nor dS (seen: bf16
# 5.8e-2 elementwise, 4.3e-3 rms; f32 7.0e-6 and 7.7e-7).
GRAD_TOL = {("flash_bwd", "float32"): (1e-4, 1e-5),
            ("flash_bwd", "bfloat16"): (8e-3, 2e-4),
            ("flash_autograd", "float32"): (1e-4, 1e-5),
            ("flash_autograd", "bfloat16"): (1.2e-1, 1e-2)}
BIAS_TOL = 1e-3
# the chunk prefill kernel, each case held to its own scale: (the largest
# |out - ref| over max |ref|, rms(out - ref) / rms(ref)). "xla": against
# its plain version, the XLA path, which rounds the bf16 scores, divides
# them by sqrt(d) in bf16 and rounds the softmax output to bf16, where
# the kernel scales f32 scores and rounds exp(S - m) per 64-position tile
# (seen on an H100: bf16 up to 1.56e-2 of max |ref| and 6.1e-3 rms).
# "tiled": against ragged_prefill_reference, the plain version with the
# kernel's rounding points, which differs only where a sum in another
# order flips a rounding (seen: bf16 up to 1.6e-3 of max |ref|, held to
# one bf16 spacing of the largest output, 2^-7; 3.5e-5 rms). Its control,
# the same without the rounding of P (seen: 2.0e-3 to 2.4e-3 rms), must
# fail the bf16 "tiled" rms limit in every case, or the check could not
# see where P is rounded. f32 on both: up to 1.6e-6 and 7.6e-7 rms.
PREFILL_TOL = {("xla", "float32"): (4e-6, 2e-6),
               ("xla", "bfloat16"): (3e-2, 1e-2),
               ("tiled", "float32"): (4e-6, 2e-6),
               ("tiled", "bfloat16"): (2 ** -7, 1e-4)}

# the trainer: bench_gpt's "345m" row (B = 12, S = 1024, remat "dots")
TRAIN_B, TRAIN_S, WARMUP_STEPS, TIMED_STEPS = 12, 1024, 3, 5
# f32 trainer checks at 4 layers: each gradient's |a - b| / |b| (norms)
# and the loss of 3 steps. Kernel vs plain attention: f32 on both, sums in
# other orders. "dots" vs no remat: the recompute repeats the same
# deterministic kernels, so they should agree to rounding or better.
GRAD_REL_TOL = {"kernel_vs_plain": 1e-4, "dots_vs_none": 1e-6}
TRAIN_LOSS_TOL = 1e-4


_T0 = time.perf_counter()


def _log(msg):
    print(msg, flush=True)


def _stamp(what):
    """A line with the seconds since the script started, to see where a
    phase spends its time."""
    _log(f"  [{time.perf_counter() - _T0:.1f} s] {what}")


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


def _time_held_ms(torch, fn, iters, warmup=3):
    """Device time per call of ``fn``: a device-side sleep holds the stream
    while the host enqueues the calls, so the events around them time the
    device's work alone, not the host's issue (which is slower than the
    device for a kernel of a few microseconds). Fails if the sleep did not
    outlast the enqueue."""
    for _ in range(warmup):
        fn()
    ev = lambda: torch.cuda.Event(enable_timing=True)    # noqa: E731
    s0, s1, start, end = ev(), ev(), ev(), ev()
    torch.cuda.synchronize()
    s0.record()
    torch.cuda._sleep(HOLD_CYCLES)
    s1.record()
    s1.synchronize()
    sleep_ms = s0.elapsed_time(s1)
    torch.cuda._sleep(HOLD_CYCLES)
    t0 = time.perf_counter()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    issue_ms = (time.perf_counter() - t0) * 1e3
    end.synchronize()
    if issue_ms > 0.8 * sleep_ms:
        raise AssertionError(f"the device sleep ({sleep_ms:.1f} ms) did not "
                             f"outlast the host's enqueue ({issue_ms:.1f} ms)")
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

def _flash_case(torch, fa, dt, q, k, v, off, label, mma_sync=False):
    """The flash forward against its plain version on ``q, k, v`` (causal,
    ``q_offset`` ``off``), on the route the views take and, with
    ``mma_sync``, again on the ``mma.sync`` kernel against the same plain
    outputs: returns the largest error."""
    o_ref, lse_ref = fa.flash_attention_reference(q, k, v, causal=True,
                                                  q_offset=off)
    routes = [(fa.kernel_route(q, k, v), contextlib.nullcontext)]
    if mma_sync:
        routes.append(("mma_sync", fa._mma_sync_route))
    worst = 0.0
    for route, ctx in routes:
        with ctx():
            o, lse = fa.flash_attention_fwd(q, k, v, causal=True,
                                            q_offset=off)
        torch.cuda.synchronize()
        err, bias, ok = _check("flash", o, o_ref, dt)
        lse_err = (lse - lse_ref).abs().max().item()
        ok = ok and lse_err <= 1e-3
        _log(f"flash_attention_fwd {dt} {label} causal, {route} route: "
             f"max_abs_err={err:.3e} bias={bias:.2e} "
             f"({_tol_text('flash', dt)}) lse_err={lse_err:.3e} "
             f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"flash kernel disagrees at {dt} {label} "
                                 f"({route} route)")
        worst = max(worst, err)
    return worst


def _kernel_names(torch, fn, calls=3, attempts=4):
    """The names of the kernels ``fn`` launches, by the profiler over a
    few calls; profiled again, up to ``attempts`` times in all, while the
    profiler records no device activity at all (it then measured nothing;
    the card's machine has shown that for two profiles in a row)."""
    def run():
        for _ in range(calls):
            fn()
    names = _device_time(torch, run)[1]
    for _ in range(attempts - 1):
        if names:
            break
        _log("  the profiler recorded no device activity; profiling again")
        names = _device_time(torch, run)[1]
    return sorted(names)


def _check_routes(torch, what, fns, names):
    """Each ``fns[label] = (fn, want)`` ran the kernel named ``want`` and no
    other of ``names`` (the kernels that compute ``what``), by the names
    the profiler sees."""
    for label, (fn, want) in fns.items():
        ran = [n for n in _kernel_names(torch, fn)
               if any(k in n for k in names)]
        _log(f"{what} {label} launches: {ran}")
        if not ran or any(want not in n for n in ran):
            raise AssertionError(f"{what} {label} did not run {want}: {ran} "
                                 f"(all kernels seen: {_kernel_names(torch, fn)})")


# the kernels of each route (flash_attention.kernel_route): wgmma, mma.sync
# (tensor cores, bf16) and the CUDA-core f32 kernel
FLASH_FWD_KERNELS = dict(wgmma="flash_fwd_wg_kernel",
                         mma_sync="flash_fwd_tc_kernel",
                         cuda_core="flash_fwd_kernel")
FLASH_DKV_KERNELS = dict(wgmma="flash_bwd_dkv_wg_kernel",
                         mma_sync="flash_bwd_dkv_tc_kernel",
                         cuda_core="flash_bwd_dkv_kernel")


def _route_cases(torch, fa, views, launch):
    """``launch(*views)`` on bf16 main-path views (``views``: the training
    shape's fused-QKV views at B = 1), the same under
    ``fa._mma_sync_route()``, in f32, and on a bf16 view TMA cannot
    describe (head dim 100: a 200-byte head stride), each with the route
    ``fa.kernel_route`` names for it."""
    def under_mma_sync():
        with fa._mma_sync_route():
            launch(*views)
    odd = torch.randn(1, 256, len(views) + 1, 1, 100, device="cuda").to(
        torch.bfloat16).unbind(2)[:len(views)]
    f32 = [t.float() for t in views]
    cases = {"bf16 main-path views": (lambda: launch(*views),
                                      fa.kernel_route(*views)),
             "bf16 under _mma_sync_route": (under_mma_sync, "mma_sync"),
             "f32": (lambda: launch(*f32), fa.kernel_route(*f32)),
             "bf16 head dim 100": (lambda: launch(*odd),
                                   fa.kernel_route(*odd))}
    want = dict(zip(cases, ("wgmma", "mma_sync", "cuda_core", "mma_sync")))
    for label, (_, route) in cases.items():
        if route != want[label]:
            raise AssertionError(f"kernel_route gives {route} for {label}, "
                                 f"not {want[label]}")
    return cases


def _fwd_rows_launched(torch, fa, q, k, v):
    """The query rows a block of the wgmma forward owned in a launch on
    ``q, k, v``: 64 times its consumer warpgroups, the second template
    argument of the kernel the profiler saw (``flash_fwd_wg_kernel<D,
    NC>``)."""
    names = _kernel_names(torch, lambda: fa.flash_attention_fwd(q, k, v,
                                                                True))
    found = {int(m.group(1)) for m in (
        re.search(r"flash_fwd_wg_kernel<\d+, (\d+)>", n) for n in names)
        if m}
    if len(found) != 1:
        raise AssertionError(f"no single wgmma forward among {names}")
    return 64 * found.pop()


def phase_flash(torch, res):
    from paddle_tpu_torch.kernels import flash_attention as fa
    _ptxas_check(res, "flash_fwd", (FLASH_FWD_TC,), 8, gate=_d128)
    _wgmma_check(res, "flash_fwd_wg", FLASH_FWD_WG, 4)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    randn = lambda *shape: torch.randn(*shape, device=dev,  # noqa: E731
                                       generator=gen)
    cases = []      # (dtype, B, Sq, Sk, N, Nkv, D, q_offset)
    for dt in ("bfloat16", "float32"):
        for s in (256, 512, 1024):
            cases.append((dt, 1, s, s, 8, 8, 128, None))
        cases += [(dt, 1, 233, 233, 8, 8, 128, None),
                  (dt, 1, 512, 512, 8, 4, 128, None),
                  (dt, 1, 512, 512, 16, 16, 64, None)]
    for dt in ("bfloat16", "float32"):
        cases += [(dt, 1, 256, 768, 8, 8, 128, 512),
                  # a masked head dim of the 128 instance, GQA
                  (dt, 1, 512, 512, 8, 4, 80, None)]
    worst = {}
    main = None
    for dt, b, sq, sk, n, nkv, d, off in cases:
        dtype = getattr(torch, dt)
        q = randn(b, sq, n, d).to(dtype)
        k = randn(b, sk, nkv, d).to(dtype)
        v = randn(b, sk, nkv, d).to(dtype)
        serving = (dt, sq, n, d) == ("bfloat16", 1024, 8, 128)
        err = _flash_case(torch, fa, dt, q, k, v, off,
                          f"B={b} Sq={sq} Sk={sk} nh={n} nkv={nkv} d={d} "
                          f"q_offset={off}", mma_sync=serving)
        worst[dt] = max(worst.get(dt, 0.0), err)
        if serving:
            main = (q, k, v, err)
    # views TMA cannot describe (head dim 100: a 200-byte head stride),
    # which take the mma.sync kernel: the views of a fused [B, S, 3, N, D]
    # and, under GQA, of a fused [B, S, N + 2 Nkv, D] projection
    for n, nkv, off, sk in ((8, 8, None, 512), (8, 4, 256, 768)):
        fused = randn(1, sk, n + 2 * nkv, 100).to(torch.bfloat16)
        q, k, v = fused.split([n, nkv, nkv], dim=2)
        q = q[:, sk - 512:] if off is not None else q
        if fa.kernel_route(q, k, v) != "mma_sync":
            raise AssertionError("head dim 100 views do not route to the "
                                 "mma.sync forward")
        worst["bfloat16"] = max(worst["bfloat16"], _flash_case(
            torch, fa, "bfloat16", q, k, v, off,
            f"B=1 Sq=512 Sk={sk} nh={n} nkv={nkv} d=100 q_offset={off}, "
            f"views of a fused QKV (200-byte head stride)"))
    # the training shape, on the q/k/v views of one fused [B, S, 3, N, D]
    # projection as gpt_block passes them
    tb, ts, tn, td = TRAIN_B, TRAIN_S, 8, 128
    qkv = randn(tb, ts, 3, tn, td).to(torch.bfloat16)
    tq, tk, tv = qkv.unbind(2)
    worst["bfloat16"] = max(worst["bfloat16"], _flash_case(
        torch, fa, "bfloat16", tq, tk, tv, None,
        f"B={tb} S={ts} nh={tn} d={td}, strided q/k/v views of a fused QKV "
        f"(the training shape)", mma_sync=True))
    # no atomics: a second call gives the same bits
    first = fa.flash_attention_fwd(tq, tk, tv, True)
    second = fa.flash_attention_fwd(tq, tk, tv, True)
    same = all(torch.equal(a, b) for a, b in zip(first, second))
    _log(f"  two forward calls bit-equal at the training shape: {same}")
    res["flash_bit_equal"] = same
    if not same:
        raise AssertionError("two forward calls on the same inputs differ")
    del first, second
    cases = _route_cases(
        torch, fa, [x[:1] for x in (tq, tk, tv)],
        lambda q, k, v: fa.flash_attention_fwd(q, k, v, True))
    _check_routes(torch, "flash_attention_fwd", {
        label: (fn, FLASH_FWD_KERNELS[route])
        for label, (fn, route) in cases.items()},
        tuple(FLASH_FWD_KERNELS.values()))
    res["flash_routes"] = {label: route for label, (_, route) in
                           cases.items()}

    # timed with the stream held: at the serving shape the kernel takes
    # less time than the wrapper's host issue
    sdpa = torch.nn.functional.scaled_dot_product_attention
    timings = {}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for label, (q, k, v) in (("serving", main[:3]),
                             ("training", (tq, tk, tv))):
        b, s, n, d = q.shape
        rows = _fwd_rows_launched(torch, fa, q, k, v)
        _log(f"flash_attention_fwd bf16 {label} shape: the launch took "
             f"{rows} query rows a block, fwd_query_rows on {sms} SMs "
             f"{fa.fwd_query_rows(b, n, s, sms)}")
        if rows != fa.fwd_query_rows(b, n, s, sms):
            raise AssertionError("fwd_query_rows disagrees with the launch")
        ms = _time_held_ms(
            torch, lambda: fa.flash_attention_fwd(q, k, v, True),
            50 if b == 1 else 20)
        with fa._mma_sync_route():   # the parent's kernel, in this call
            mma_ms = _time_held_ms(
                torch, lambda: fa.flash_attention_fwd(q, k, v, True),
                50 if b == 1 else 20)
        plain_ms = _time_held_ms(
            torch, lambda: fa.flash_attention_reference(q, k, v, True),
            20 if b == 1 else 3, warmup=3 if b == 1 else 1)
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        lib_ms = _time_held_ms(
            torch, lambda: sdpa(qt, kt, vt, is_causal=True),
            50 if b == 1 else 20)
        extra = {}
        if label == "training":     # SDPA also on the same strided views
            qv, kv, vv = (t.transpose(1, 2) for t in (q, k, v))
            extra["library_views_ms"] = _time_held_ms(
                torch, lambda: sdpa(qv, kv, vv, is_causal=True), 20)
        pairs = s * (s + 1) // 2                 # causal (query, key) pairs
        flops = 4 * d * pairs * n * b
        nbytes = 4 * q.numel() * q.element_size() + b * n * s * 4  # qkvo+lse
        bound_ms, by = _bound(flops, nbytes, "bfloat16")
        timings[label] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                              bound_ms=bound_ms, bound_by=by,
                              tflops=flops / ms / 1e9, gflop=flops / 1e9,
                              mbytes=nbytes / 1e6, mma_sync_ms=mma_ms,
                              mma_sync_tflops=flops / mma_ms / 1e9,
                              query_rows=rows, **extra)
        views = (f", sdpa on the same strided views "
                 f"{extra['library_views_ms']:.4f} ms" if extra else "")
        _log(f"flash_attention_fwd bf16 {label} shape B={b} S={s} nh={n} "
             f"d={d} causal: wgmma kernel "
             f"({timings[label]['query_rows']} query rows a block, {sms} "
             f"SMs) {ms:.4f} ms ({flops / ms / 1e9:.1f} "
             f"TFLOP/s), the mma.sync kernel {mma_ms:.4f} ms "
             f"({flops / mma_ms / 1e9:.1f} TFLOP/s), plain {plain_ms:.4f} "
             f"ms, sdpa (contiguous "
             f"[B, N, S, D] copies) {lib_ms:.4f} ms ({flops / lib_ms / 1e9:.1f}"
             f" TFLOP/s){views}, bound {bound_ms:.5f} ms ({by}: "
             f"{flops / 1e9:.3f} GFLOP, {nbytes / 1e6:.3f} MB)")
    del qkv, tq, tk, tv
    res["flash_seeds"] = _flash_seed_sweep(torch, fa)
    t = timings["serving"]
    res["flash"] = dict(
        name="flash_attention_fwd", route="cuda",
        source="paddle_tpu_torch/csrc/flash_attention_fwd_wg.cu",
        replaces="paddle_tpu/kernels/flash_attention.py:150",
        launches=None, max_abs_err=main[3], ms=t["ms"],
        plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
        bound_by=t["bound_by"], library_ms=t["library_ms"],
        mma_sync_ms=t["mma_sync_ms"], training_shape=timings["training"])
    res["flash_worst_err"] = worst


def _flash_seed_sweep(torch, fa, seeds=6):
    """The bf16 forward's errors at S = 1024 (B = 1, 8 heads of 128,
    causal) over other random inputs: logged, not held to the limits."""
    rows = []
    for seed in range(seeds):
        gen = torch.Generator(device="cuda").manual_seed(1000 + seed)
        q, k, v = (torch.randn(1, 1024, 8, 128, device="cuda",
                               generator=gen).to(torch.bfloat16)
                   for _ in range(3))
        o, lse = fa.flash_attention_fwd(q, k, v, True)
        o_ref, lse_ref = fa.flash_attention_reference(q, k, v, True)
        err, bias, ok = _check("flash", o, o_ref, "bfloat16")
        lse_err = (lse - lse_ref).abs().max().item()
        rows.append(dict(seed=1000 + seed, max_abs_err=err, bias=bias,
                         lse_err=lse_err, within=ok and lse_err <= 1e-3))
    _log("flash_attention_fwd bf16 S=1024 over 6 other seeds (logged, not "
         "gating): " + "; ".join(
             f"max_abs_err={r['max_abs_err']:.3e} bias={r['bias']:.2e} "
             f"lse_err={r['lse_err']:.2e}{'' if r['within'] else ' OVER'}"
             for r in rows))
    return rows


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


def _ptxas_kernels(log):
    """{mangled kernel: (registers, spill store bytes, spill load bytes)}
    from the ``-Xptxas -v`` output of a build."""
    out, cur, spill = {}, None, (0, 0)
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function '|Function properties "
                      r"for )([^' ]+)", line)
        if m:
            cur = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spill = (int(m.group(1)), int(m.group(2)))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and cur:
            out[cur] = (int(m.group(1)),) + spill
            spill = (0, 0)
    return out


# the tensor-core kernels' instances in the build log (mangled names):
# head dim D, full width or masked
FLASH_FWD_TC = r"flash_fwd_tc_kernelILi(?P<D>\d+)ELb(?P<full>[01])E"
PREFILL_TC = r"paged_prefill_tc_kernelILi(?P<D>\d+)ELb(?P<full>[01])E"
FLASH_BWD_TC = (r"flash_bwd_(?P<pass>dq|dkv)_tc_kernelILi(?P<D>\d+)ELb"
                r"(?P<full>[01])E")


# the paged decode and int8 kernels' instances in the build log (mangled
# names): dtype (f: float), head dim D, full width or masked, query heads
# G a block; the int8 layout (0: "kn", 1: "nk") and n8 tiles of x
PAGED_DECODE = (r"paged_decode_split_kernelI(?P<T>f|13__nv_bfloat16)Li"
                r"(?P<D>\d+)ELb(?P<full>[01])ELi(?P<G>\d+)E")
INT8_MM = (r"int8_mm_kernelI(?P<T>f|13__nv_bfloat16)Li(?P<layout>[01])ELi"
           r"(?P<MT>[12])E")


def _ptxas_check(res, key, patterns, count, gate=lambda label: True):
    """Registers and spills of every instance of a kernel (the mangled
    names ``patterns`` match), from the build log; fails if an instance is
    missing or one that ``gate`` names (by its label) spills."""
    from paddle_tpu_torch.kernels import _build
    rows = {}
    for name, (regs, st, ld) in _ptxas_kernels(
            _build.build_log["ptxas"]).items():
        for pat in patterns:
            m = re.search(pat, name)
            if m:
                kind = m.group(0).split("_kernelI")[0] + "_kernel"
                label = kind + " " + " ".join(
                    f"{k}={'f32' if v == 'f' else 'bf16' if k == 'T' else v}"
                    for k, v in m.groupdict().items())
                rows[label] = dict(registers=regs, spill_store_bytes=st,
                                   spill_load_bytes=ld)
    res[f"{key}_ptxas"] = rows
    regs = [v["registers"] for v in rows.values()]
    spilled = sorted(k for k, v in rows.items()
                     if v["spill_store_bytes"] or v["spill_load_bytes"])
    _log(f"{key} instances (ptxas): {len(rows)} of {count}, registers "
         f"{min(regs, default=0)}-{max(regs, default=0)}; " + "; ".join(
             f"{k}: {v['registers']}" for k, v in sorted(rows.items())
             if v["registers"] == max(regs)) + f"; spilled: {spilled}")
    if len(rows) != count:
        raise AssertionError(f"found {len(rows)} of the {count} {key} "
                             f"instances in the build log")
    if any(gate(k) for k in spilled):
        raise AssertionError(f"{key} instances spill: {spilled}")


def _d128(label):
    return "D=128" in label


# the wgmma kernels' instances (mangled names): head dim D, consumer
# warpgroups NC of the forward
FLASH_FWD_WG = r"flash_fwd_wg_kernelILi(?P<D>\d+)ELi(?P<NC>\d)E"
FLASH_DKV_WG = r"flash_bwd_dkv_wg_kernelILi(?P<D>\d+)EE"


def _sass_counts(pattern):
    """{mangled kernel: {"HGMMA": n, "UTMALDG": n}} for the kernels of the
    built library whose names match ``pattern``: the warpgroup MMA and TMA
    load instructions in their SASS (``cuobjdump -sass``)."""
    from pathlib import Path

    from paddle_tpu_torch.kernels import _build
    cuobjdump = Path(_build._nvcc()).parent / "cuobjdump"
    sass = subprocess.run(
        [str(cuobjdump), "-sass", str(_build.library_path())],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        timeout=300, check=True).stdout
    out = {}
    for block in sass.split("Function : ")[1:]:
        name = block.split("\n", 1)[0].strip()
        if re.search(pattern, name):
            out[name] = {op: len(re.findall(rf"\b{op}\b", block))
                         for op in ("HGMMA", "UTMALDG")}
    return out


def _wgmma_check(res, key, pattern, count):
    """The wgmma kernels' instances: registers and spills from the build
    log (none may spill), and HGMMA and UTMALDG in the SASS of each (fails
    if either is missing: the kernel would not be on wgmma and TMA)."""
    _ptxas_check(res, key, (pattern,), count)
    sass = _sass_counts(pattern)
    res[f"{key}_sass"] = sass
    _log(f"{key} SASS: " + "; ".join(
        f"{re.search(pattern, k).group(0)}: HGMMA {v['HGMMA']}, UTMALDG "
        f"{v['UTMALDG']}" for k, v in sorted(sass.items())))
    if len(sass) != count or not all(v["HGMMA"] and v["UTMALDG"]
                                     for v in sass.values()):
        raise AssertionError(f"{key}: {len(sass)} of {count} instances in "
                             f"the SASS, each must hold HGMMA and UTMALDG")


def phase_flash_bwd(torch, res):
    from paddle_tpu_torch.kernels import flash_attention as fa
    _ptxas_check(res, "flash_bwd", (FLASH_BWD_TC,), 16, gate=_d128)
    _wgmma_check(res, "flash_bwd_wg", FLASH_DKV_WG, 2)
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
    # a masked head dim of the 128 instance: columns 80..127 zero-filled
    cases.append(("bfloat16", 1, 512, 512, 8, 4, 80, None))
    cases = [(c, False) for c in cases]
    # views TMA cannot describe (head dim 100: a 200-byte head stride),
    # which take the mma.sync dK/dV kernel: the views of a fused
    # [B, S, 3, N, D] and, under GQA, of a fused [B, S, N + 2 Nkv, D]
    # projection
    cases += [(("bfloat16", 1, 512, 512, 8, 8, 100, None), True),
              (("bfloat16", 1, 512, 768, 8, 4, 100, 256), True)]
    for (dt, b, sq, sk, n, nkv, d, off), fused in cases:
        dtype = getattr(torch, dt)
        if fused:
            q, k, v = randn(b, sk, n + 2 * nkv, d).to(dtype).split(
                [n, nkv, nkv], dim=2)
            q, do = q[:, sk - sq:], randn(b, sq, n, d).to(dtype)
            if fa.kernel_route(q, k, v, do) != "mma_sync":
                raise AssertionError("head dim 100 views do not route to "
                                     "the mma.sync dK/dV pass")
        else:
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
                 f"nkv={nkv} d={d} causal q_offset={off}, "
                 f"{fa.kernel_route(q, k, v, do)} route")
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
    # the mma.sync dK/dV kernel (timed below as the parent's) on the same
    # inputs, against the same plain outputs
    with fa._mma_sync_route():
        got_mma = fa.flash_attention_bwd(q, k, v, o, lse, do, True)
    _log("  the same under the mma.sync route (the mma.sync dK/dV kernel)")
    _check_grads("mma.sync kernels vs plain", "flash_bwd", "bfloat16",
                 got_mma, refs)
    del got_mma
    # no atomics: a second call gives the same bits, also under GQA on the
    # views of one fused [B, S, N + 2 Nkv, D] projection
    again = fa.flash_attention_bwd(q, k, v, o, lse, do, True)
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    nkv = 2
    qkv_g = randn(b, s, n + 2 * nkv, d).to(torch.bfloat16)
    qg, kg, vg = qkv_g.split([n, nkv, nkv], dim=2)
    og, lseg = fa.flash_attention_fwd(qg, kg, vg, True)
    runs = [fa.flash_attention_bwd(qg, kg, vg, og, lseg, do, True)
            for _ in range(2)]
    same_gqa = all(torch.equal(a, b) for a, b in zip(*runs))
    _log(f"  two backward calls bit-equal: training shape {same}, GQA "
         f"nh={n} nkv={nkv} on fused views {same_gqa}")
    res["flash_bwd_bit_equal"] = dict(training_shape=same, gqa=same_gqa)
    if not (same and same_gqa):
        raise AssertionError("two backward calls on the same inputs differ")
    del again, runs, qkv_g, qg, kg, vg, og, lseg
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
    _, delta = fa._launch_dq(q, k, v, o, lse, do, True, scale, 0)
    cases = _route_cases(
        torch, fa, [x[:1] for x in (q, k, v, do)],
        lambda q1, k1, v1, do1: fa._launch_dkv(
            q1, k1, v1, do1, lse[:1], delta[:1], True, scale, 0))
    _check_routes(torch, "flash_attention_bwd_dkv", {
        label: (fn, FLASH_DKV_KERNELS[route])
        for label, (fn, route) in cases.items()},
        tuple(FLASH_DKV_KERNELS.values()))
    res["flash_bwd_dkv_routes"] = {label: route for label, (_, route) in
                                   cases.items()}
    dq_ms = _time_ms(torch, lambda: fa._launch_dq(
        q, k, v, o, lse, do, True, scale, 0), 20)
    dkv_ms = _time_ms(torch, lambda: fa._launch_dkv(
        q, k, v, do, lse, delta, True, scale, 0), 20)
    with fa._mma_sync_route():       # the parent's dK/dV kernel, this call
        dkv_mma_ms = _time_ms(torch, lambda: fa._launch_dkv(
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
        parent = (f"; the mma.sync kernel {dkv_mma_ms:.4f} ms, "
                  f"{flops / dkv_mma_ms / 1e9:.2f} TFLOP/s"
                  if key == "flash_bwd_dkv" else "")
        _log(f"{name} bf16 B={b} S={s} nh={n} d={d} causal: kernel "
             f"{ms:.4f} ms, bound {bound_ms:.5f} ms ({by}: "
             f"{flops / 1e9:.3f} GFLOP, {nbytes / 1e6:.3f} MB), "
             f"{flops / ms / 1e9:.2f} TFLOP/s{parent}")
        out[key] = dict(
            name=name, route="cuda",
            source=("paddle_tpu_torch/csrc/flash_attention_bwd_tc.cuh"
                    if key == "flash_bwd_dq" else
                    "paddle_tpu_torch/csrc/flash_attention_bwd_wg.cu"),
            replaces=("paddle_tpu/kernels/flash_attention.py:238"
                      if key == "flash_bwd_dq" else
                      "paddle_tpu/kernels/flash_attention.py:283"),
            launches=None, max_abs_err=err, ms=ms, plain_ms=plain_ms,
            bound_ms=bound_ms, bound_by=by, library_ms=lib_ms,
            tflops=flops / ms / 1e9)
        if key == "flash_bwd_dkv":
            out[key].update(mma_sync_ms=dkv_mma_ms,
                            mma_sync_tflops=flops / dkv_mma_ms / 1e9)
    _log(f"flash backward bf16 at the training shape: dq + dkv kernels "
         f"{dq_ms + dkv_ms:.4f} ms; plain backward (dq, dk, dv) "
         f"{plain_ms:.4f} ms; SDPA backward (autograd.grad of "
         f"F.scaled_dot_product_attention(is_causal=True), less its "
         f"forward {sdpa_fwd_ms:.4f} ms) {lib_ms:.4f} ms")
    # achieved rates: the pair executes 7 products of the causal half (S
    # and dP in both passes); a single-pass backward such as SDPA's 5
    pair_flops = dq_flops + dkv_flops
    sdpa_flops = 5 * 2 * d * pairs
    rates = dict(pair_tflops=pair_flops / (dq_ms + dkv_ms) / 1e9,
                 pair_gflop=pair_flops / 1e9,
                 sdpa_tflops=sdpa_flops / lib_ms / 1e9,
                 sdpa_gflop=sdpa_flops / 1e9)
    _log(f"flash backward bf16 achieved: dq + dkv {rates['pair_tflops']:.1f}"
         f" TFLOP/s ({rates['pair_gflop']:.2f} GFLOP executed); SDPA "
         f"backward {rates['sdpa_tflops']:.1f} TFLOP/s ({rates['sdpa_gflop']:.2f}"
         f" GFLOP, 5 products); of {PEAK_FLOPS['bfloat16'] / 1e12:.0f} "
         f"TFLOP/s bf16")
    res["flash_bwd_rates"] = rates
    res.update(out)


def _page_table(torch, gen, B, pps):
    """[B, pps] int32: each sequence's pages, shuffled over pages 1..B*pps."""
    perm = torch.randperm(B * pps, device="cuda", generator=gen) + 1
    return perm.reshape(B, pps).to(torch.int32).contiguous()


def _paged_case(torch, pa, gen, dt, pt, nh, nkv, d, ps, lens, n_layers=1):
    """The paged decode kernel against its plain version and against the
    plain version in the kernel's own form (``paged_decode_split_reference``
    at the wrapper's split) on the first of ``n_layers`` layers of random
    pages, through the page table ``pt``, at ragged ``lens`` (0: an idle
    slot, whose row must stay finite); two calls must give the same bits.
    Returns (q, kp, vp, sl, err)."""
    dev = torch.device("cuda")
    dtype = getattr(torch, dt)
    B, pps = pt.shape
    npg = B * pps + 1
    sl = torch.tensor(lens, dtype=torch.int32, device=dev)
    live = torch.tensor([n > 0 for n in lens], device=dev)
    kp = torch.randn(n_layers, npg, ps, nkv, d, device=dev,
                     generator=gen).to(dtype)
    vp = torch.randn(n_layers, npg, ps, nkv, d, device=dev,
                     generator=gen).to(dtype)
    q = torch.randn(B, nh, d, device=dev, generator=gen).to(dtype)
    out = pa.paged_attention_decode(q, kp[0], vp[0], pt, sl)
    again = pa.paged_attention_decode(q, kp[0], vp[0], pt, sl)
    torch.cuda.synchronize()
    same = torch.equal(out, again)
    ref = pa.paged_attention_reference(q, kp[0], vp[0], pt, sl)
    n_split = pa._decode_split(B, nkv, nh // nkv, pps, pa._sm_count(dev))
    split_ref = pa.paged_decode_split_reference(q, kp[0], vp[0], pt, sl,
                                                n_split=n_split)
    err, bias, ok = _check("paged", out[live], ref[live], dt)
    err_s, bias_s, ok_s = _check("paged", out[live], split_ref[live], dt)
    finite = bool(torch.isfinite(out.float()).all())
    ok = ok and ok_s and finite and same
    _log(f"paged_attention_decode {dt} B={B} nh={nh} nkv={nkv} d={d} "
         f"page={ps} pages/seq={pps} lens={list(lens)} n_split={n_split}: "
         f"max_abs_err={err:.3e} bias={bias:.2e}, against the split form "
         f"{err_s:.3e} bias={bias_s:.2e} ({_tol_text('paged', dt)}) idle "
         f"row finite={finite} two calls bit-equal={same} "
         f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"paged kernel disagrees at {dt}, d={d}")
    return q, kp, vp, sl, err


def _time_paged(torch, pa, q, kp, vp, pt, sl, label):
    """The bf16 kernel, its plain version and the SDPA yardstick over the
    layers of ``kp``/``vp`` in turn (one layer's pages per call, as decode
    does), each with the stream held; the bound from this run's live
    tokens."""
    dev = q.device
    B, nh, d = q.shape
    n_layers, _, ps, nkv, _ = kp.shape
    pps = pt.shape[1]

    def cycling(fn, step=[0]):
        def run():
            i = step[0] % n_layers
            step[0] += 1
            return fn(q, kp[i], vp[i], pt, sl)
        return run
    ms = _time_held_ms(torch, cycling(pa.paged_attention_decode), 200)
    plain_ms = _time_held_ms(torch, cycling(pa.paged_attention_reference), 20)
    # the yardstick: SDPA with a length mask over each layer's K/V gathered
    # dense (the gather not timed); the idle slot attends its first
    # position so its row stays finite
    idx = pt.long()
    dense = [tuple(t[i][idx].reshape(B, pps * ps, nkv, d).transpose(1, 2)
                   .contiguous() for t in (kp, vp)) for i in range(n_layers)]
    qs = q[:, :, None, :]                                  # [B, nh, 1, d]
    keep = (torch.arange(pps * ps, device=dev)[None, :]
            < sl.clamp_min(1).long()[:, None])[:, None, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def lib(step=[0]):
        i = step[0] % n_layers
        step[0] += 1
        return sdpa(qs, dense[i][0], dense[i][1], attn_mask=keep,
                    enable_gqa=nkv != nh)
    lib_ms = _time_held_ms(torch, lib, 200)
    del dense
    tokens = int(sl.clamp(0, pps * ps).sum().item())
    nbytes = (2 * tokens * nkv * d * kp.element_size()       # K and V
              + 2 * q.numel() * q.element_size()             # q and out
              + pt.numel() * 4 + sl.numel() * 4)
    flops = 4 * nh * d * tokens
    bound_ms, by = _bound(flops, nbytes, "bfloat16")
    n_split = pa._decode_split(B, nkv, nh // nkv, pps, pa._sm_count(dev))
    _log(f"paged_attention_decode bf16 {label} ({tokens} live tokens, "
         f"n_split {n_split}): kernel {ms:.4f} ms ({nbytes / ms / 1e6:.1f} "
         f"GB/s), plain {plain_ms:.4f} ms, sdpa (dense K/V, length mask) "
         f"{lib_ms:.4f} ms, bound {bound_ms:.5f} ms ({by}: "
         f"{nbytes / 1e6:.3f} MB)")
    return dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                bound_ms=bound_ms, bound_by=by, n_split=n_split,
                tokens=tokens, mbytes=nbytes / 1e6)


def phase_paged(torch, res):
    from paddle_tpu_torch.kernels import paged_attention as pa
    _ptxas_check(res, "paged_decode", (PAGED_DECODE,), 64)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    B, nh, nkv, d, ps, pps = 8, 8, 8, 128, 64, 16
    n_layers = 8        # cycled while timing: 270 MB of pages > 50 MB L2
    lens = [970, 545, 734, 266, 897, 162, 428, 0]   # ragged, one idle slot
    pt = _page_table(torch, gen, B, pps)
    for dt in ("bfloat16", "float32"):
        q, kp, vp, sl, err = _paged_case(torch, pa, gen, dt, pt, nh, nkv, d,
                                         ps, lens, n_layers)
        if dt == "bfloat16":
            t = _time_paged(torch, pa, q, kp, vp, pt, sl, "bucket 8")
            res["paged"] = dict(
                name="paged_attention_decode", route="cuda",
                source="paddle_tpu_torch/csrc/paged_attention_decode.cuh",
                replaces="paddle_tpu/kernels/paged_attention.py:80",
                launches=None, max_abs_err=err, **t)
        del kp, vp
    # the MoE serving path's shape (other instances of the kernel):
    # ERNIE-MoE base, 12 heads of 64, 8 pages of 64 (512 positions), the MoE
    # cell's lengths after its 64 new tokens, one idle slot; 8 layers cycled
    # while timing (101 MB)
    moe_lens = [n + MAX_NEW for n in MOE_PROMPT_LENS[:7]] + [0]
    pt = _page_table(torch, gen, 8, 512 // 64)
    res["paged_moe_shape_err"] = {}
    for dt in ("bfloat16", "float32"):
        q, kp, vp, sl, err = _paged_case(torch, pa, gen, dt, pt, 12, 12, 64,
                                         64, moe_lens, n_layers)
        res["paged_moe_shape_err"][dt] = err
        if dt == "bfloat16":
            res["paged"]["moe_shape"] = _time_paged(
                torch, pa, q, kp, vp, pt, sl, "MoE shape")
        del kp, vp


def _prefill_case(torch, gen, dt, B, C, nh, d, ps, pps, n_shared=0,
                  pad_rows=0):
    """q as the q view of a fused [B, C, 3, nh, d] projection (as the chunk
    program passes it), a pool of shuffled pages and its page table; the
    second sequence maps the first's leading ``n_shared`` pages; the last
    ``pad_rows`` chunk rows are padding (zero rows)."""
    dev = torch.device("cuda")
    dtype = getattr(torch, dt)
    npg = B * pps + 1
    qkv = torch.randn(B, C, 3, nh, d, device=dev, generator=gen).to(dtype)
    if pad_rows:
        qkv[:, C - pad_rows:] = 0
    kp = torch.randn(npg, ps, nh, d, device=dev, generator=gen).to(dtype)
    vp = torch.randn(npg, ps, nh, d, device=dev, generator=gen).to(dtype)
    perm = torch.randperm(npg - 1, device=dev, generator=gen) + 1
    pt = perm.reshape(B, pps).to(torch.int32)
    if n_shared:
        pt[1, :n_shared] = pt[0, :n_shared]
    return qkv[:, :, 0], kp, vp, pt.contiguous()


def _scaled_err(out, ref):
    """(largest |out - ref|, that over max |ref|, rms(out - ref) /
    rms(ref), mean signed error along ref over mean |ref|), in f32."""
    ref = ref.float()
    e = out.float() - ref
    err = e.abs().max().item()
    return (err, err / ref.abs().max().clamp_min(1e-30).item(),
            (e.square().mean().sqrt()
             / ref.square().mean().sqrt().clamp_min(1e-30)).item(),
            ((e * ref.sign()).mean()
             / ref.abs().mean().clamp_min(1e-30)).item())


def _prefill_errors(torch, pa, dt, q, kp, vp, pt, off):
    """The chunk prefill kernel against its two plain versions (and, in
    bf16, the control against the tiled one): (row of readings, log text,
    within every limit)."""
    out = pa.ragged_prefill_attention(q, kp, vp, pt, off)
    torch.cuda.synchronize()
    finite = bool(torch.isfinite(out.float()).all())
    tiled = pa.ragged_prefill_reference(q, kp, vp, pt, off)
    refs = {"xla": pa.paged_prefill_attention(q, kp, vp, pt, off),
            "tiled": tiled}
    text, ok, row = [], finite, dict(finite=finite)
    for name, ref in refs.items():
        err, share, rms, bias = _scaled_err(out, ref)
        share_tol, rms_tol = PREFILL_TOL[name, dt]
        good = share <= share_tol and rms <= rms_tol and (
            dt == "float32" or abs(bias) <= BIAS_TOL)
        ok = ok and good
        row[name] = dict(max_abs_err=err, share=share, rms=rms, bias=bias)
        text.append(f"vs {name}: max_abs_err={err:.3e} = {share:.3e}"
                    f" of max |ref| (tol {share_tol:g}), rms="
                    f"{rms:.3e} (tol {rms_tol:g}), bias={bias:.2e}")
    if dt == "bfloat16":
        ctl = pa.ragged_prefill_reference(q, kp, vp, pt, off, round_p=False)
        row["control_rms"] = _scaled_err(ctl, tiled)[2]
        text.append(f"control (P not rounded) vs tiled: rms="
                    f"{row['control_rms']:.3e} (must exceed "
                    f"{PREFILL_TOL['tiled', dt][1]:g})")
        ok = ok and row["control_rms"] > PREFILL_TOL["tiled", dt][1]
    return row, "; ".join(text), ok


def phase_paged_prefill(torch, res):
    from paddle_tpu_torch.kernels import paged_attention as pa
    _ptxas_check(res, "paged_prefill", (PREFILL_TC,), 8, gate=_d128)
    gen = torch.Generator(device="cuda").manual_seed(5)
    # (B, C, nh, d, ps, pps, q_offset, n_shared, pad_rows)
    cases = [(1, 256, 8, 128, 64, 16, 0, 0, 0),       # the first chunk
             (1, 256, 8, 128, 64, 16, 37, 0, 0),      # mid-page offset
             (1, 256, 8, 128, 64, 16, 256, 0, 0),     # pages 8-15 skipped
             (1, 256, 8, 128, 64, 16, 768, 0, 0),     # the serving shape
             (1, 256, 8, 128, 64, 16, 640, 0, 128),   # a padded last chunk
             (1, 256, 16, 64, 64, 16, 512, 0, 0),     # d = 64
             (2, 256, 8, 128, 64, 16, 768, 12, 0)]    # a shared prefix
    more = [(4, 256, 8, 128, 64, 16, 300, 0, 0)]      # more blocks than SMs
    worst, readings, failed = {}, [], []
    for dt, case in ([(dt, c) for dt in ("bfloat16", "float32")
                      for c in cases]
                     + [(dt, c) for dt in ("bfloat16", "float32")
                        for c in more]):
        B, C, nh, d, ps, pps, off, shared, pad = case
        q, kp, vp, pt = _prefill_case(torch, gen, dt, B, C, nh, d, ps, pps,
                                      shared, pad)
        row, text, ok = _prefill_errors(torch, pa, dt, q, kp, vp, pt, off)
        row.update(dtype=dt, q_offset=off, d=d, B=B, pad_rows=pad)
        _log(f"ragged_prefill_attention {dt} B={B} C={C} nh={nh} d={d} "
             f"page={ps} pages/seq={pps} q_offset={off} shared_pages="
             f"{shared} pad_rows={pad}: " + text
             + f"{'' if dt == 'float32' else f' (bias tol {BIAS_TOL:g})'}"
             f" finite={row['finite']} {'ok' if ok else 'FAIL'}")
        if not ok:
            failed.append(f"{dt} q_offset={off} d={d} B={B}")
        readings.append(row)
        worst[dt] = max(worst.get(dt, 0.0), row["xla"]["max_abs_err"])
    res["paged_prefill_cases"] = readings
    if failed:       # every case is logged first, then the phase fails
        raise AssertionError(f"chunk prefill kernel disagrees: {failed}")
    # the serving shape, bf16: 24 layers' pools cycled (108 MB > 50 MB L2)
    B, C, nh, d, ps, pps, off = 1, 256, 8, 128, 64, 16, 768
    n_layers = 24
    pools = [_prefill_case(torch, gen, "bfloat16", B, C, nh, d, ps, pps)
             for _ in range(n_layers)]
    q, _, _, pt = pools[0]
    # no atomics: a second call gives the same bits
    same = torch.equal(*(pa.ragged_prefill_attention(q, pools[0][1],
                                                      pools[0][2], pt, off)
                         for _ in range(2)))
    _log(f"  two chunk-prefill calls bit-equal at the serving shape: {same}")
    res["paged_prefill_bit_equal"] = same
    if not same:
        raise AssertionError("two chunk-prefill calls on the same inputs "
                             "differ")
    prefill_kernels = dict(bfloat16="paged_prefill_tc_kernel",
                           float32="paged_prefill_kernel")
    _check_routes(torch, "ragged_prefill_attention", {
        dt: (lambda t=getattr(torch, dt): pa.ragged_prefill_attention(
            q.to(t), pools[0][1].to(t), pools[0][2].to(t), pt, off),
            prefill_kernels[dt])
        for dt in ("bfloat16", "float32")}, tuple(prefill_kernels.values()))

    def cycling(fn, step=[0]):
        def run():
            i = step[0] % n_layers
            step[0] += 1
            return fn(q, pools[i][1], pools[i][2], pt, off)
        return run
    ms = _time_held_ms(torch, cycling(pa.ragged_prefill_attention), 100)
    plain_ms = _time_held_ms(torch, cycling(pa.paged_prefill_attention), 20)
    # the yardstick: SDPA with an explicit causal-offset mask over K/V
    # already gathered dense (the gather not timed)
    T = off + C
    dense = []
    for _, kp, vp, _ in pools:
        idx = pt[0].long()
        kd = kp[idx].reshape(1, pps * ps, nh, d)[:, :T].transpose(1, 2)
        vd = vp[idx].reshape(1, pps * ps, nh, d)[:, :T].transpose(1, 2)
        dense.append((kd.contiguous(), vd.contiguous()))
    qt = q.transpose(1, 2).contiguous()
    mask = (torch.arange(T, device="cuda")[None, :]
            <= off + torch.arange(C, device="cuda")[:, None])
    sdpa = torch.nn.functional.scaled_dot_product_attention
    step = [0]

    def lib():
        i = step[0] % n_layers
        step[0] += 1
        return sdpa(qt, dense[i][0], dense[i][1], attn_mask=mask)
    lib_ms = _time_held_ms(torch, lib, 100)
    pairs = C * off + C * (C + 1) // 2       # (row, visible position) pairs
    flops = 4 * d * pairs * nh * B
    item = q.element_size()
    nbytes = (2 * B * C * nh * d * item          # q and out
              + 2 * B * T * nh * d * item         # the K and V reached
              + pt.numel() * 4)
    bound_ms, by = _bound(flops, nbytes, "bfloat16")
    _log(f"ragged_prefill_attention bf16 C={C} nh={nh} d={d} page={ps} "
         f"q_offset={off}: kernel {ms:.4f} ms ({flops / ms / 1e9:.1f} "
         f"TFLOP/s), plain {plain_ms:.4f} ms, sdpa (dense K/V, offset mask) "
         f"{lib_ms:.4f} ms ({flops / lib_ms / 1e9:.1f} TFLOP/s), bound "
         f"{bound_ms:.5f} ms ({by}: {flops / 1e9:.3f} GFLOP, "
         f"{nbytes / 1e6:.3f} MB)")
    del pools, dense
    res["paged_prefill_seeds"] = _prefill_seed_sweep(torch, pa)
    res["paged_prefill"] = dict(
        name="ragged_prefill_attention", route="cuda",
        source="paddle_tpu_torch/csrc/attention_fwd_tc.cuh",
        replaces="paddle_tpu/kernels/paged_attention.py:191",
        launches=None, max_abs_err=worst["bfloat16"], ms=ms,
        plain_ms=plain_ms, bound_ms=bound_ms, bound_by=by,
        library_ms=lib_ms, tflops=flops / ms / 1e9, max_abs_err_tiled=max(
            r["tiled"]["max_abs_err"] for r in readings
            if r["dtype"] == "bfloat16"))
    res["paged_prefill_worst_err"] = worst


def _prefill_seed_sweep(torch, pa, seeds=6):
    """The bf16 chunk prefill's errors at the serving shape (C = 256, 8
    heads of 128, page 64, offset 768) over other random inputs: logged,
    not held to the limits."""
    rows = []
    for seed in range(seeds):
        gen = torch.Generator(device="cuda").manual_seed(1000 + seed)
        q, kp, vp, pt = _prefill_case(torch, gen, "bfloat16", 1, 256, 8, 128,
                                      64, 16)
        row, _, ok = _prefill_errors(torch, pa, "bfloat16", q, kp, vp, pt,
                                     768)
        rows.append(dict(row, seed=1000 + seed, within=ok))
    _log("ragged_prefill_attention bf16 serving shape over 6 other seeds "
         "(logged, not gating): " + "; ".join(
             f"xla {r['xla']['share']:.2e}/{r['xla']['rms']:.2e}, tiled "
             f"{r['tiled']['share']:.2e}/{r['tiled']['rms']:.2e}, control "
             f"{r['control_rms']:.2e}{'' if r['within'] else ' OVER'}"
             for r in rows) + " (share of max |ref| / rms)")
    return rows


def _int8_weight(torch, gen, K, N, layout, offset=0):
    """A random int8 weight in its stored layout, and per-column scales of
    a GPT-like magnitude (|w| up to ~0.1); ``offset`` bytes into a buffer
    make a weight that is not 16-byte aligned."""
    shape = (K, N) if layout == "kn" else (N, K)
    buf = torch.randint(-128, 128, (K * N + offset,), device="cuda",
                        generator=gen, dtype=torch.int8)
    w = buf[offset:].view(shape)
    s = torch.rand(N, device="cuda", generator=gen) * 7e-4 + 1e-4
    return w, s


def phase_int8(torch, res):
    from paddle_tpu_torch.kernels import int8_matmul as im
    _ptxas_check(res, "int8", (INT8_MM,), 6)
    gen = torch.Generator(device="cuda").manual_seed(6)
    cases = [(name, M, K, N, layout, 0) for name, K, N, layout in INT8_SHAPES
             for M in (1, 8, 9, 256)]
    cases += [("odd_kn", 3, 100, 77, "kn", 0), ("odd_nk", 5, 1000, 50, "nk", 0),
              ("ragged_n", 1, 1024, 3000, "kn", 0),
              ("unaligned_kn", 8, 1024, 1024, "kn", 3),
              ("unaligned_nk", 8, 1000, 640, "nk", 1)]
    worst = {}
    for dt in ("bfloat16", "float32"):
        dtype = getattr(torch, dt)
        for name, M, K, N, layout, offset in cases:
            w, s = _int8_weight(torch, gen, K, N, layout, offset)
            x = torch.randn(M, K, device="cuda", generator=gen).to(dtype)
            out = im.int8_matmul(x, w, s, layout=layout)
            again = im.int8_matmul(x, w, s, layout=layout)
            torch.cuda.synchronize()
            same = torch.equal(out, again)
            ref = im.int8_matmul_reference(x, w, s, layout)
            top = max(1.0, ref.float().abs().max().item())
            err, bias, ok = _check("int8", out, ref, dt, scale=top)
            ok = ok and same
            _log(f"int8_matmul {dt} {name} M={M} K={K} N={N} layout={layout}"
                 f"{' unaligned' if offset else ''}: max_abs_err={err:.3e} "
                 f"(tol {TOL['int8', dt]:g} x {top:.3g}) bias={bias:.2e} two "
                 f"calls bit-equal={same} {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"int8 kernel disagrees: {dt} {name} M={M}")
            worst[dt] = max(worst.get(dt, 0.0), err)
    # each shape at M = 1, 2, 4, 8 (decode) and the "kn" shapes at M = 256
    # (the int8 chunked prefill), bf16, over enough weight copies to stream
    # from device memory (> 150 MB), each beside a cuBLAS bf16 matmul on a
    # weight dequantized ahead of time (twice the bytes, no scale), all with
    # the stream held; the plain version at M = 8
    rows = {}
    for name, K, N, layout in INT8_SHAPES:
        n_copy = max(2, math.ceil(150e6 / (K * N)))
        ws = [_int8_weight(torch, gen, K, N, layout) for _ in range(n_copy)]
        dq = [(w.to(torch.bfloat16) if layout == "kn"
               else w.t().to(torch.bfloat16).contiguous()) for w, _ in ws]

        def cyc(fn, step=[0]):
            def run():
                i = step[0] % n_copy
                step[0] += 1
                return fn(i)
            return run
        rows[name] = {}
        for M in INT8_DECODE_M + ((256,) if layout == "kn" else ()):
            x = torch.randn(M, K, device="cuda", generator=gen).to(
                torch.bfloat16)
            ms = _time_held_ms(torch, cyc(lambda i: im.int8_matmul(
                x, ws[i][0], ws[i][1], layout=layout)), 100)
            lib_ms = _time_held_ms(
                torch, cyc(lambda i: torch.matmul(x, dq[i])), 100)
            nbytes = K * N + 4 * N + 2 * M * K + 2 * M * N
            bound_ms, by = _bound(2 * M * K * N, nbytes, "bfloat16")
            row = dict(M=M, K=K, N=N, layout=layout, ms=ms, library_ms=lib_ms,
                       bound_ms=bound_ms, bound_by=by)
            if M == 8:
                row["plain_ms"] = _time_held_ms(
                    torch, cyc(lambda i: im.int8_matmul_reference(
                        x, ws[i][0], ws[i][1], layout)), 20)
            rows[name][M] = row
            _log(f"int8_matmul bf16 {name} M={M} K={K} N={N} ({layout}): "
                 f"kernel {ms:.4f} ms ({nbytes / ms / 1e6:.1f} GB/s), cuBLAS "
                 f"bf16 on the dequantized weight {lib_ms:.4f} ms"
                 + (f", plain {row['plain_ms']:.4f} ms" if M == 8 else "")
                 + f", bound {bound_ms:.5f} ms ({by}: {nbytes / 1e6:.3f} MB)")
        del ws, dq
    total = {k: sum(r[8][k] for r in rows.values())
             for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
    _log(f"int8_matmul bf16 M=8, the five shapes of a decode layer and its "
         f"logits: kernel {total['ms']:.4f} ms, plain {total['plain_ms']:.4f}"
         f" ms, cuBLAS {total['library_ms']:.4f} ms, bound "
         f"{total['bound_ms']:.5f} ms")
    res["int8"] = dict(
        name="int8_matmul", route="cuda",
        source="paddle_tpu_torch/csrc/int8_matmul.cu",
        replaces="paddle_tpu/kernels/int8_matmul.py:52",
        launches=None, max_abs_err=worst["bfloat16"], ms=total["ms"],
        plain_ms=total["plain_ms"], bound_ms=total["bound_ms"],
        bound_by="bytes", library_ms=total["library_ms"],
        timed="sum over wqkv, wo, w1, w2 and the logits at M = 8",
        shapes=rows)
    res["int8_worst_err"] = worst


def _moe_inputs(torch, gen, dt, S):
    """x [S, 768] (unit-variance rows, as a LayerNorm leaves them) in
    ``dt``, and an ERNIE-initialised gate (normal(0, 0.02)) in ``dt``, as
    the engine passes it."""
    dtype = getattr(torch, dt)
    x = torch.randn(S, MOE_M, device="cuda", generator=gen).to(dtype)
    gw = (torch.randn(MOE_M, MOE_E, device="cuda", generator=gen)
          * 0.02).to(dtype)
    gb = (torch.randn(MOE_E, device="cuda", generator=gen) * 0.02).to(dtype)
    return x, gw, gb


def _max_rel(got, want):
    """The largest |got - want| over the largest |want|."""
    top = want.float().abs().max().item()
    return (got.float() - want.float()).abs().max().item() / max(top, 1e-30)


def _check_dispatch(torch, md, x, gw, gb, C, K, kind):
    """The dispatch kernel against its plain version. The experts the kernel
    picked equal the plain version's except at router near ties; given its
    picks, comb_idx and expert_in are exactly the slot rule's and the row
    gather's; val (where the picks agree), me and ce within MOE_REL of the
    largest |value|. The public wrapper (its autograd Function and device
    routing, as the engine calls it) gives the same bits as the launch whose
    picks are read. Returns a reading, with ``ok``."""
    E = MOE_E
    out, idx = md._launch_dispatch(x, gw, gb, E, C, K, kind)
    pub = md.fused_moe_dispatch(x, gw, gb, num_expert=E, capacity=C,
                                top_k=K, gate_kind=kind)
    torch.cuda.synchronize()
    wrapper_same = all(bool(torch.equal(a, b)) for a, b in zip(pub, out))
    ref = md.reference_moe_dispatch(x, gw, gb, num_expert=E, capacity=C,
                                    top_k=K, gate_kind=kind)
    logits = md.gate_logits(x, gw, gb)
    _, pidx = md._top_k(logits, K)
    near = md.near_ties(logits, K, MOE_NEAR_TIE)
    flipped = (idx.long() != pidx).any(-1)
    st, comb = md.dispatch_indices(idx, num_expert=E, capacity=C)
    xp = torch.cat([x, x.new_zeros(1, MOE_M)])
    exact = bool(torch.equal(out[1], comb)) and bool(
        torch.equal(out[0].reshape(E * C, MOE_M), xp[st.long()]))
    same = ~flipped
    ce = torch.nn.functional.one_hot(idx[:, 0].long(), E).float().mean(0)
    rel = dict(val=_max_rel(out[2][same], ref[2][same]),
               me=_max_rel(out[3], ref[3]), ce=_max_rel(out[4], ce))
    val_abs = (out[2][same] - ref[2][same]).abs().max().item()
    off_tie = int((flipped & ~near).sum())
    dropped = int((out[1] == E * C).sum())
    ok = exact and wrapper_same and off_tie == 0 \
        and max(rel.values()) <= MOE_REL
    return dict(near_ties=int(near.sum()), flipped=int(flipped.sum()),
                wrapper_same=wrapper_same,
                val_max_abs_err=val_abs,
                flipped_off_tie=off_tie, exact=exact, dropped=dropped,
                exact_vs_plain=bool(torch.equal(out[1], ref[1])),
                ok=ok, **{f"{k}_rel": v for k, v in rel.items()})


def _check_combine(torch, md, dt, eo, val, comb):
    """The combine kernel against the plain version with its rounding
    points (f32: MOE_REL of max |ref|; bf16: within one bf16 spacing of
    each element) and against the einsum reference (f32: MOE_REL; bf16:
    MOE_COMBINE_EINSUM_TOL)."""
    y = md.fused_moe_combine(eo, val, comb)
    torch.cuda.synchronize()
    ref = md.combine_kernel_reference(eo, val, comb)
    ein = md.reference_moe_combine(eo, val, comb)
    err_ref = _max_rel(y, ref)
    _, share, rms, _ = _scaled_err(y, ein)
    if dt == "float32":
        ok = err_ref <= MOE_REL and share <= MOE_REL
    else:
        r = ref.float()
        ulp = torch.exp2(torch.floor(torch.log2(r.abs().clamp_min(1e-30))) - 7)
        spacings = ((y.float() - r).abs() / ulp).max().item()
        ok = spacings <= 1 and share <= MOE_COMBINE_EINSUM_TOL[0] \
            and rms <= MOE_COMBINE_EINSUM_TOL[1]
    row = dict(max_rel_vs_kernel_form=err_ref, einsum_share=share,
               einsum_rms=rms, ok=ok,
               max_abs_err=(y.float() - ref.float()).abs().max().item())
    if dt == "bfloat16":
        row["bf16_spacings_vs_kernel_form"] = spacings
    return row


def phase_moe_dispatch(torch, res):
    from paddle_tpu_torch.kernels import moe_dispatch as md
    gen = torch.Generator(device="cuda").manual_seed(8)
    readings, failed = [], []
    near_total = 0
    for dt in ("bfloat16", "float32"):
        for label, S, C, K, kind in MOE_CASES:
            x, gw, gb = _moe_inputs(torch, gen, dt, S)
            row = dict(case=label, dtype=dt, S=S, C=C, top_k=K, kind=kind)
            row["dispatch"] = d = _check_dispatch(torch, md, x, gw, gb, C, K,
                                                  kind)
            near_total += d["near_ties"]
            _, comb, val, _, _ = md.reference_moe_dispatch(
                x, gw, gb, num_expert=MOE_E, capacity=C, top_k=K,
                gate_kind=kind)
            eo = torch.randn(MOE_E * C, MOE_M, device="cuda",
                             generator=gen).to(getattr(torch, dt))
            row["combine"] = c = _check_combine(torch, md, dt, eo, val, comb)
            _log(f"moe {dt} {label} S={S} C={C} k={K} {kind}: dispatch "
                 f"near ties {d['near_ties']}, picks differing {d['flipped']} "
                 f"({d['flipped_off_tie']} off a near tie), comb_idx and "
                 f"expert_in exact {d['exact']} (equal to the plain version's "
                 f"{d['exact_vs_plain']}), wrapper's bits equal "
                 f"{d['wrapper_same']}, dropped {d['dropped']}, val/me/ce "
                 f"{d['val_rel']:.2e}/{d['me_rel']:.2e}/{d['ce_rel']:.2e} of "
                 f"max (tol {MOE_REL:g}) {'ok' if d['ok'] else 'FAIL'}; "
                 f"combine vs kernel form {c['max_rel_vs_kernel_form']:.2e}"
                 + (f" ({c['bf16_spacings_vs_kernel_form']:.2f} bf16 spacings)"
                    if dt == "bfloat16" else "")
                 + f", vs einsum {c['einsum_share']:.2e} of max, rms "
                 f"{c['einsum_rms']:.2e} {'ok' if c['ok'] else 'FAIL'}")
            if not (d["ok"] and c["ok"]):
                failed.append(f"{dt} {label}")
            readings.append(row)
    _log(f"moe router near ties (k-th and (k+1)-th logits within "
         f"{MOE_NEAR_TIE:g}) over all cases: {near_total}")
    res["moe_cases"] = readings
    res["moe_near_ties"] = near_total
    if failed:
        raise AssertionError(f"MoE kernels disagree: {failed}")
    # time both kernels at the serving shapes, bf16, the stream held; the
    # combine's library call is F.embedding_bag (sum of rows weighted per
    # sample) over the rows with a zero row appended for the sentinel and
    # val in the rows' dtype, both made once and not timed
    shapes = {}
    for label, S in (("decode", 8), ("prefill", 512)):
        C, K = S, 2
        x, gw, gb = _moe_inputs(torch, gen, "bfloat16", S)
        kw = dict(num_expert=MOE_E, capacity=C, top_k=K)
        with torch.no_grad():
            ei, comb, val, _, _ = md.fused_moe_dispatch(x, gw, gb, **kw)
            eo = torch.randn(MOE_E * C, MOE_M, device="cuda",
                             generator=gen).to(ei.dtype)
            eo_pad = torch.cat([eo, eo.new_zeros(1, MOE_M)])
            val_dt = val.to(eo.dtype)

            def lib():
                return torch.nn.functional.embedding_bag(
                    comb, eo_pad, per_sample_weights=val_dt, mode="sum",
                    padding_idx=MOE_E * C)
            lib_y = lib()
            _, lib_share, lib_rms, _ = _scaled_err(
                lib_y, md.reference_moe_combine(eo, val, comb))
            if not (lib_share <= MOE_COMBINE_EINSUM_TOL[0]
                    and lib_rms <= MOE_COMBINE_EINSUM_TOL[1]):
                raise AssertionError(
                    f"embedding_bag does not compute the combine at {label}: "
                    f"{lib_share:.2e} of max, rms {lib_rms:.2e}")
            t = dict(
                dispatch=_time_held_ms(torch, lambda: md.fused_moe_dispatch(
                    x, gw, gb, **kw), 100),
                dispatch_plain=_time_held_ms(
                    torch, lambda: md.reference_moe_dispatch(x, gw, gb, **kw),
                    20),
                combine=_time_held_ms(torch, lambda: md.fused_moe_combine(
                    eo, val, comb), 100),
                combine_plain=_time_held_ms(
                    torch, lambda: md.combine_kernel_reference(eo, val, comb),
                    20),
                combine_einsum=_time_held_ms(
                    torch, lambda: md.reference_moe_combine(eo, val, comb),
                    20),
                combine_library=_time_held_ms(torch, lib, 100))
        item = x.element_size()
        d_bytes = (S * MOE_M * item + MOE_M * MOE_E * item + MOE_E * item
                   + MOE_E * C * MOE_M * item          # the whole buffer
                   + S * K * 8 + 2 * MOE_E * 4)        # comb, val, me, ce
        d_bound, d_by = _bound(2 * S * MOE_M * MOE_E, d_bytes, "bfloat16")
        kept = int((comb < MOE_E * C).sum())
        c_bytes = kept * MOE_M * item + S * MOE_M * item + S * K * 8
        c_bound, c_by = _bound(2 * kept * MOE_M, c_bytes, "bfloat16")
        shapes[label] = dict(S=S, C=C, **{f"{k}_ms": v for k, v in t.items()},
                             dispatch_bound_ms=d_bound, dispatch_bound_by=d_by,
                             dispatch_bytes=d_bytes, combine_bound_ms=c_bound,
                             combine_bound_by=c_by, combine_bytes=c_bytes)
        _log(f"moe bf16 {label} S={S} C={C} M={MOE_M} E={MOE_E} k={K}: "
             f"dispatch kernel {t['dispatch']:.4f} ms, plain "
             f"{t['dispatch_plain']:.4f} ms, bound {d_bound:.5f} ms ({d_by}: "
             f"{d_bytes / 1e6:.3f} MB); combine kernel {t['combine']:.4f} ms,"
             f" plain {t['combine_plain']:.4f} ms (einsum "
             f"{t['combine_einsum']:.4f} ms), embedding_bag "
             f"{t['combine_library']:.4f} ms (vs einsum {lib_share:.2e} of "
             f"max, rms {lib_rms:.2e}), bound {c_bound:.5f} ms ({c_by}: "
             f"{c_bytes / 1e6:.3f} MB); dispatch library none")
    dec = shapes["decode"]
    worst = lambda dt, part, key: max(                  # noqa: E731
        r[part][key] for r in readings if r["dtype"] == dt)
    res["moe_dispatch"] = dict(
        name="moe_dispatch", route="cuda",
        source="paddle_tpu_torch/csrc/moe_dispatch.cu",
        replaces="paddle_tpu/kernels/moe_dispatch.py:199",
        launches=None, max_abs_err=worst("bfloat16", "dispatch",
                                         "val_max_abs_err"),
        ms=dec["dispatch_ms"], plain_ms=dec["dispatch_plain_ms"],
        bound_ms=dec["dispatch_bound_ms"], bound_by=dec["dispatch_bound_by"],
        library_ms=None, timed="the decode shape S = C = 8, M = 768, E = 8",
        shapes=shapes)
    res["moe_combine"] = dict(
        name="moe_combine", route="cuda",
        source="paddle_tpu_torch/csrc/moe_dispatch.cu",
        replaces="paddle_tpu/kernels/moe_dispatch.py:413",
        launches=None, max_abs_err=worst("bfloat16", "combine",
                                         "max_abs_err"),
        ms=dec["combine_ms"], plain_ms=dec["combine_plain_ms"],
        bound_ms=dec["combine_bound_ms"], bound_by=dec["combine_bound_by"],
        library_ms=dec["combine_library_ms"],
        timed="the decode shape S = C = 8, M = 768, k = 2; library: "
              "F.embedding_bag(mode='sum', per_sample_weights)",
        shapes=shapes)


# ----------------------------------------------------------------- phase 3

def _engine(model, **kw):
    from paddle_tpu_torch.serving import ServingEngine
    return ServingEngine(model, page_size=64, decode_buckets=(1, 2, 4, 8),
                         prefill_buckets=(256, 512, 1024), device="cuda", **kw)


def _prompts(cfg, np):
    """The eight ragged prompts of the serving cell."""
    rng = np.random.default_rng(1)
    return [rng.integers(0, cfg.vocab_size, (n,)).astype(np.int32)
            for n in PROMPT_LENS]


def _warm(eng, cfg, np, lens=(100, 300, 700, 1000, 200, 400, 600, 800)):
    """Touch every prefill bucket and every decode bucket once (cuBLAS
    shapes, lazily loaded kernels, the allocator) before anything is
    timed."""
    rng = np.random.default_rng(3)
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


def _run_sched(torch, sched, prompts, max_new):
    """Submit every prompt at t = 0 and step to the end; returns the
    requests, the wall seconds and the peak of pages shared in flight."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reqs = [sched.submit(p, max_new_tokens=max_new) for p in prompts]
    peak_shared = 0
    while sched.pending:
        sched.step()
        peak_shared = max(peak_shared, sched.engine.pool.pages_shared)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    sched.run()                          # evicts the last finished
    if not all(r.state == "finished" and len(r.tokens) == max_new
               for r in reqs):
        raise AssertionError("unfinished requests")
    return reqs, wall, peak_shared


def _e2e(sched, reqs, wall):
    ttft = sorted(r.summary()["ttft_s"] * 1e3 for r in reqs)
    new = sum(len(r.tokens) for r in reqs)
    return dict(tokens_per_s=new / wall, wall_s=wall, new_tokens=new,
                decode_steps=sched.steps,
                per_token_p50_ms=_pct(sched.step_times, 0.5) * 1e3,
                per_token_p95_ms=_pct(sched.step_times, 0.95) * 1e3,
                ttft_mean_ms=sum(ttft) / len(ttft), ttft_p95_ms=_pct(ttft, 0.95),
                ttft_ms=ttft)


def _gpt_launches(eng, steps, n):
    """The GPT engine's launches for ``n`` prefills and ``steps`` decode
    steps: the flash kernel once a layer per prefill, the paged decode
    kernel once a layer per decode step, and with int8 weights the int8
    kernel for the 4 block matmuls of every layer and the logits per
    decode step and each prefill's logits."""
    L = eng.cfg.num_layers
    want = dict(flash=L * n, paged=L * steps)
    if eng.quantize:
        want["int8"] = (4 * L + 1) * steps + n
    return want


def _serve_counted(torch, np, eng, cfg, label, prompts=None,
                   launches=_gpt_launches):
    """One serving run of the eight ragged prompts (or ``prompts``), with
    the kernels' launch counts set to 0 just before it and read just
    after, and held exactly to ``launches(eng, decode steps, prompts)``
    (kernels it does not name: 0). Returns (e2e, requests)."""
    from paddle_tpu_torch.serving import ContinuousBatchingScheduler
    sched = ContinuousBatchingScheduler(eng)
    prompts = _prompts(cfg, np) if prompts is None else prompts
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    reqs, wall, _ = _run_sched(torch, sched, prompts, MAX_NEW)
    counts = _counts()
    _check_counts(label, counts, launches(eng, sched.steps, len(prompts)))
    if eng.pool.pages_in_use:
        raise AssertionError(f"{label}: leaked pages")
    e2e = _e2e(sched, reqs, wall)
    e2e.update(launches=counts, weight_bytes=eng.weight_bytes(),
               max_memory_allocated_bytes=torch.cuda.max_memory_allocated())
    return e2e, reqs


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
    sleep_cycles = 2 * HOLD_CYCLES       # a step's issue takes 11-21 ms
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
    if "flash_fwd_" in name:          # the f32 kernel, the bf16 _wg and _tc
        return "flash_attention_fwd"
    if "flash_bwd_dq_" in name:       # the f32 kernel and the bf16 _tc one
        return "flash_attention_bwd_dq"
    if "flash_bwd_dkv_" in name:      # the f32 kernel, the bf16 _wg and _tc
        return "flash_attention_bwd_dkv"
    if "paged_decode_" in name:
        return "paged_attention_decode"
    if "paged_prefill_" in name:      # the f32 kernel and the bf16 _tc one
        return "ragged_prefill_attention"
    if "int8_mm_" in name:
        return "int8_matmul"
    if any(s in name for s in ("moe_gate_kernel", "moe_scan_kernel",
                               "moe_scatter_kernel")):
        return "moe_dispatch"
    if "moe_combine_kernel" in name:
        return "moe_combine"
    if any(s in name.lower() for s in ("gemm", "gemv", "xmma", "cutlass",
                                       "nvjet")):
        return "matmul (cuBLAS)"
    if name.startswith("Memcpy") or name.startswith("Memset"):
        return "memcpy/memset"
    return "other (elementwise and reductions)"


# the kernel each attention group runs in bf16 on the main paths' views
BF16_ATTENTION_KERNELS = {
    "flash_attention_fwd": FLASH_FWD_KERNELS["wgmma"],
    "flash_attention_bwd_dq": "flash_bwd_dq_tc_kernel",
    "flash_attention_bwd_dkv": FLASH_DKV_KERNELS["wgmma"],
    "ragged_prefill_attention": "paged_prefill_tc_kernel"}


def _group_times(by_name):
    """Device microseconds by kernel group. Every window profiled here
    runs bf16 on the main paths' views, so its attention kernels must be
    the wgmma (flash forward, dK/dV) and mma.sync (dQ, chunk prefill)
    ones: raises if an attention kernel of another name ran."""
    groups = {}
    for name, us in by_name.items():
        g = _kernel_group(name)
        groups[g] = groups.get(g, 0.0) + us
        want = BF16_ATTENTION_KERNELS.get(g)
        if want is not None and want not in name:
            raise AssertionError(f"a bf16 window ran {name}, not {want}")
    return groups


def _profile_engine(torch, np, eng, cfg, prefill=True, lens=PROMPT_LENS):
    """Where the time goes in the bf16 engine: the eight prefills of
    ``lens`` tokens (unless ``prefill`` is false, when they run
    unprofiled), then 16 decode steps at bucket 8, each window under the
    profiler. Prints the device busy share (device time / host wall time)
    and the device time by kernel group. Profiling slows the host, so the
    busy share read here is a lower bound for an unprofiled run."""
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab_size, (s,)).astype(np.int32)
               for s in lens]
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
    windows = [(f"decode x{n_decode} (bucket 8)", decode_steps)]
    if prefill:
        windows.insert(0, ("prefill x8", prefill_all))
    else:
        prefill_all()
    for window, fn in windows:
        wall, by_name = _device_time(torch, fn)
        busy_us = sum(by_name.values())
        groups = _group_times(by_name)
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


def _check_tokens(torch, np, model, reqs, forward=None):
    """Every generated token of ``reqs`` against the argmax of ``model``
    (dense, teacher-forced on the request's own output; ``forward(ids
    [1, S])`` -> logits, ``model(ids)`` when None): equal, or a near tie
    (top-2 gap < 1e-3, the token among the top two), counted. Returns
    (tokens checked, near ties)."""
    forward = model if forward is None else forward
    checked = near_ties = 0
    with torch.no_grad():
        for r in reqs:
            ids = torch.from_numpy(r.output_ids.astype(np.int64)).cuda()
            logits = forward(ids[None, :-1])[0].float()
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
    return checked, near_ties


def phase_serving(torch, np, res):
    model, cfg = _model_345m(torch)
    _log(f"config: layers={cfg.num_layers} hidden={cfg.hidden_size} "
         f"heads={cfg.num_heads} head_dim={cfg.head_dim} "
         f"vocab={cfg.vocab_size} max_pos={cfg.max_position_embeddings}")

    # ---- bf16: the measured runs -----------------------------------------
    eng = _engine(copy.deepcopy(model).to(torch.bfloat16))
    _warm(eng, cfg, np)
    runs = []
    for k in range(N_RUNS):
        e2e, reqs = _serve_counted(torch, np, eng, cfg, "serving bf16")
        tokens = [list(r.tokens) for r in reqs]
        runs.append(e2e)
        _log(f"serving bf16 run {k + 1}/{N_RUNS}: " + json.dumps(
            {k: v for k, v in e2e.items() if k != "ttft_ms"}))
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

    # ---- f32: correctness against the plain dense model ------------------
    _, reqs = _serve_counted(torch, np, _engine(model), cfg, "serving f32")
    checked, near_ties = _check_tokens(torch, np, model, reqs)
    agree = sum(a == b for x, y in zip(bf16_tokens, reqs)
                for a, b in zip(x, y.tokens))
    res["serving_f32"] = dict(tokens_checked=checked, near_ties=near_ties,
                              bf16_f32_token_agreement=agree / checked)
    _log(f"serving f32: {checked} generated tokens equal the dense "
         f"reference's argmax (near ties, gap < 1e-3: {near_ties}); "
         f"bf16 tokens equal to f32: {agree}/{checked}")


def _counts():
    """Every kernel wrapper's launch count, by kernel."""
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.kernels import int8_matmul as im
    from paddle_tpu_torch.kernels import moe_dispatch as md
    from paddle_tpu_torch.kernels import paged_attention as pa
    return dict(flash=fa.launches, flash_bwd_dq=fa.dq_launches,
                flash_bwd_dkv=fa.dkv_launches, paged=pa.launches,
                paged_prefill=pa.prefill_launches, int8=im.launches,
                moe_dispatch=md.dispatch_launches,
                moe_combine=md.combine_launches)


def _zero_counts():
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.kernels import int8_matmul as im
    from paddle_tpu_torch.kernels import moe_dispatch as md
    from paddle_tpu_torch.kernels import paged_attention as pa
    fa.launches = fa.dq_launches = fa.dkv_launches = 0
    pa.launches = pa.prefill_launches = 0
    im.launches = 0
    md.dispatch_launches = md.combine_launches = 0


def _check_counts(what, got, want):
    """Launch counts of a counted run, held exactly; kernels not named in
    ``want`` must not have launched."""
    full = {k: want.get(k, 0) for k in got}
    if got != full:
        raise AssertionError(f"{what}: launch counts {got}, want {full}")


def _model_345m(torch, seed=0):
    from paddle_tpu_torch.models.gpt import (GPTForPretraining, GPTModel,
                                             gpt_345m_config)
    cfg = gpt_345m_config(max_position_embeddings=1024, num_heads=8)
    return GPTForPretraining(GPTModel(cfg, seed=seed, device="cuda")).eval(), \
        cfg


def _prefix_run(torch, eng, prompts, label, max_new=MAX_NEW):
    """One counted run of the shared-prefix traffic; launch counts held
    exactly: the chunk kernel once a layer per chunk, the paged decode
    kernel once a layer per decode step, nothing else."""
    from paddle_tpu_torch.serving import ContinuousBatchingScheduler
    if eng.prefix_cache is not None:
        eng.prefix_cache.clear()             # every run starts cold
    sched = ContinuousBatchingScheduler(eng, prefill_token_budget=BUDGET)
    _zero_counts()
    reqs, wall, peak_shared = _run_sched(torch, sched, prompts, max_new)
    counts = _counts()
    L = eng.cfg.num_layers
    chunks = sum(r.prefill_chunks for r in reqs)
    _check_counts(label, counts, dict(paged_prefill=L * chunks,
                                      paged=L * sched.steps))
    if eng.pool.live_sequences:
        raise AssertionError(f"{label}: sequences left in the pool")
    e2e = _e2e(sched, reqs, wall)
    e2e.update(cached_prefix_lens=[r.cached_prefix_len for r in reqs],
               prefill_chunks=chunks, peak_pages_shared=peak_shared,
               launches=counts,
               max_prefill_tokens_per_tick=max(sched.prefill_tokens_per_tick),
               pool=eng.pool.stats())
    return e2e, reqs


def _check_same_tokens(torch, np, model, got, ref):
    """Every token of ``got`` equal to ``ref``'s at the same place; at a
    request's first difference, ``ref``'s dense argmax must be a near tie
    (top-2 gap < 1e-3, both tokens among the top two), counted, and the
    rest of that request is not compared. Returns (compared, near ties)."""
    compared = near_ties = 0
    with torch.no_grad():
        for a, b in zip(got, ref):
            for i, (x, y) in enumerate(zip(a.tokens, b.tokens)):
                compared += 1
                if x == y:
                    continue
                ids = torch.from_numpy(b.output_ids.astype(np.int64)).cuda()
                row = model(ids[None, :-1])[0].float()[len(b.prompt) - 1 + i]
                top2 = torch.topk(row, 2)
                gap = float(top2.values[0] - top2.values[1])
                if gap < 1e-3 and {x, y} <= set(top2.indices.tolist()):
                    near_ties += 1
                    break
                raise AssertionError(
                    f"rid {a.rid} token {i}: {x} with the cache, {y} without "
                    f"(top-2 gap {gap:.3e})")
    return compared, near_ties


def phase_serving_prefix(torch, np, res):
    from paddle_tpu_torch.serving import make_shared_prefix_workload
    model, cfg = _model_345m(torch)
    prompts = make_shared_prefix_workload(cfg.vocab_size, N_PREFIX_REQS,
                                          prefix_len=PREFIX_LEN,
                                          suffix_len=SUFFIX_LEN, seed=2)
    warm = make_shared_prefix_workload(cfg.vocab_size, 3, PREFIX_LEN,
                                       SUFFIX_LEN, seed=7)
    _log(f"serving_prefix: {N_PREFIX_REQS} requests, a shared prefix of "
         f"{PREFIX_LEN} tokens + {SUFFIX_LEN} of their own, {MAX_NEW} new "
         f"tokens each; page 64, chunk {CHUNK}, prefill budget {BUDGET} "
         f"tokens a tick")
    out = {}
    bf16 = copy.deepcopy(model).to(torch.bfloat16)
    for cache in (True, False):
        label = f"serving_prefix bf16 cache={'on' if cache else 'off'}"
        eng = _engine(bf16, prefill_chunk=CHUNK, prefix_cache=cache)
        _stamp(f"{label}: engine built")
        _prefix_run(torch, eng, warm, label + " warm-up")
        _stamp(f"{label}: warmed up")
        e2e, _ = _prefix_run(torch, eng, prompts, label)
        out["bf16_cache_" + ("on" if cache else "off")] = e2e
        _log(f"{label}: " + json.dumps({k: v for k, v in e2e.items()
                                       if k not in ("pool", "ttft_ms")}))
        if cache:
            # the prefill-heavy window: the same traffic with 8 new tokens
            # (the decode step is the float engine's, profiled in phase
            # serving; the profiler's own cost, ~1 s per 10,000 kernels,
            # keeps this to one window)
            _log(f"{label}, 8 new tokens, profiled:")
            out["profile_8_new_cache_on"] = _profile_run(
                torch, lambda: _prefix_run(torch, eng, prompts,
                                           label + " profiled", max_new=8))
        del eng
    del bf16
    on = out["bf16_cache_on"]
    # the first request misses; every later one reuses at least the prefix
    # (a suffix that starts like an earlier one's reuses a few rows more)
    cached = on["cached_prefix_lens"]
    if cached[0] != 0 or min(cached[1:]) < PREFIX_LEN \
            or on["peak_pages_shared"] < PREFIX_LEN // 64:
        raise AssertionError(f"prefix cache reuse: {on['cached_prefix_lens']}"
                             f", peak pages shared {on['peak_pages_shared']}")
    # f32: the cache changes no token
    _stamp("serving_prefix bf16 done")
    reqs = {}
    for cache in (True, False):
        eng = _engine(model, prefill_chunk=CHUNK, prefix_cache=cache)
        _, reqs[cache] = _prefix_run(
            torch, eng, prompts, f"serving_prefix f32 cache={cache}")
        del eng
    _stamp("serving_prefix f32 runs done")
    checked, near_off = _check_tokens(torch, np, model, reqs[False])
    compared, near = _check_same_tokens(torch, np, model, reqs[True],
                                        reqs[False])
    out["f32"] = dict(tokens_checked_vs_dense=checked,
                      near_ties_vs_dense=near_off,
                      tokens_compared_on_vs_off=compared,
                      near_ties_on_vs_off=near,
                      cached_prefix_lens=[r.cached_prefix_len
                                          for r in reqs[True]])
    _log(f"serving_prefix f32: cache off, {checked} tokens equal the dense "
         f"argmax (near ties {near_off}); cache on, {compared} tokens equal "
         f"the cache-off run's (near ties {near})")
    res["serving_prefix"] = out


def _dequantized_model(torch, model, params):
    """A copy of ``model`` carrying the dequantized (f32) weights of the
    int8 engine's ``params``."""
    from paddle_tpu_torch.quantization.export import dequantize_stacked_weight
    dense = copy.deepcopy(model)
    gpt = dense.gpt
    with torch.no_grad():
        for k, v in params["blocks"].items():
            full = dequantize_stacked_weight(v, torch.float32)
            for i, layer in enumerate(gpt.layers):
                getattr(layer, k).copy_(full[i])
        gpt.embeddings.word_embeddings.copy_(
            dequantize_stacked_weight(params["wte"]))
        gpt.embeddings.position_embeddings.copy_(
            dequantize_stacked_weight(params["wpe"]))
    return dense


def phase_serving_int8(torch, np, res):
    model, cfg = _model_345m(torch)
    eng = _engine(copy.deepcopy(model).to(torch.bfloat16), quantize="int8")
    _stamp("serving_int8 bf16 engine built")
    _warm(eng, cfg, np)
    _stamp("serving_int8 bf16 warmed up")
    e2e, _ = _serve_counted(torch, np, eng, cfg, "serving_int8 bf16")
    float_e2e = res.get("serving_bf16", {})
    _log("serving_int8 bf16: " + json.dumps(
        {k: v for k, v in e2e.items() if k != "ttft_ms"}))
    _log(f"serving_int8 bf16 beside the float engine (phase serving, run 1): "
         f"tokens/s {e2e['tokens_per_s']:.1f} vs "
         f"{float_e2e.get('tokens_per_s', float('nan')):.1f}, per-token p50 "
         f"{e2e['per_token_p50_ms']:.2f} vs "
         f"{float_e2e.get('per_token_p50_ms', float('nan')):.2f} ms, weights "
         f"{e2e['weight_bytes']} vs {float_e2e.get('weight_bytes')} bytes")
    split = _decode_split(torch, np, eng, cfg)
    _log("serving_int8 bf16, the decode window of phase serving's profile:")
    prof = _profile_engine(torch, np, eng, cfg, prefill=False)
    del eng
    # f32: every token against the dense model on the dequantized weights
    _stamp("serving_int8 bf16 done")
    eng = _engine(model, quantize="int8")
    _stamp("serving_int8 f32 engine built")
    _, reqs = _serve_counted(torch, np, eng, cfg, "serving_int8 f32")
    _stamp("serving_int8 f32 run done")
    dense = _dequantized_model(torch, model, eng.params)
    del eng
    checked, near = _check_tokens(torch, np, dense, reqs)
    _log(f"serving_int8 f32: {checked} generated tokens equal the argmax of "
         f"the dense model on the dequantized weights (near ties, gap < "
         f"1e-3: {near})")
    res["serving_int8"] = dict(bf16=e2e, profile=prof, decode_split=split,
                               f32=dict(tokens_checked=checked,
                                        near_ties=near))


def _moe_launches(eng, steps, n):
    """The MoE engine's launches for ``n`` prefills and ``steps`` decode
    steps: the dispatch and combine kernels once per MoE layer per prefill
    and per decode step, the paged decode kernel once a layer per decode
    step."""
    n_moe = sum(k == "moe" for k in eng.kinds)
    return dict(moe_dispatch=n_moe * (n + steps),
                moe_combine=n_moe * (n + steps),
                paged=len(eng.kinds) * steps)


def phase_serving_moe(torch, np, res):
    from paddle_tpu_torch.models.ernie import (ErnieMoeForPretraining,
                                               ErnieMoeModel,
                                               ernie_moe_base_config)
    from paddle_tpu_torch.serving import MoEServingEngine
    cfg = ernie_moe_base_config(capacity_factor=100.0)
    model = ErnieMoeForPretraining(ErnieMoeModel(cfg, seed=0,
                                                 device="cuda")).eval()
    n_params = sum(p.numel() for p in model.parameters())
    _log(f"serving_moe config: layers={cfg.num_hidden_layers} hidden="
         f"{cfg.hidden_size} heads={cfg.num_attention_heads} head_dim="
         f"{cfg.head_dim} experts={cfg.num_experts} top_k={cfg.top_k} "
         f"moe_every={cfg.moe_every} vocab={cfg.vocab_size} max_pos="
         f"{cfg.max_position_embeddings}; {n_params} parameters")
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, cfg.vocab_size, (n,)).astype(np.int32)
               for n in MOE_PROMPT_LENS]

    def engine(m):
        return MoEServingEngine(m, page_size=64, decode_buckets=(1, 2, 4, 8),
                                device="cuda")
    out = {}
    eng = engine(copy.deepcopy(model).to(torch.bfloat16))
    _warm(eng, cfg, np, lens=(50, 100, 200, 400, 60, 120, 240, 480))
    _stamp("serving_moe bf16 warmed up")
    e2e, _ = _serve_counted(torch, np, eng, cfg, "serving_moe bf16",
                            prompts=prompts, launches=_moe_launches)
    out["bf16"] = e2e
    _log("serving_moe bf16: " + json.dumps(
        {k: v for k, v in e2e.items() if k != "ttft_ms"}))
    _log("serving_moe bf16, 16 decode steps at bucket 8, profiled:")
    out["profile"] = _profile_engine(torch, np, eng, cfg, prefill=False,
                                     lens=MOE_PROMPT_LENS)
    del eng
    _stamp("serving_moe bf16 done")
    # f32: every token against the eager model's argmax, teacher-forced
    # under the causal mask (one forward per request)
    eng = engine(model)
    _, reqs = _serve_counted(torch, np, eng, cfg, "serving_moe f32",
                             prompts=prompts, launches=_moe_launches)
    del eng

    def causal_forward(ids):
        S = ids.shape[1]
        mask = torch.ones(S, S, dtype=torch.bool, device=ids.device).tril()
        return model(ids, attention_mask=mask[None, None])
    checked, near = _check_tokens(torch, np, model, reqs, causal_forward)
    out["f32"] = dict(tokens_checked=checked, near_ties=near)
    _log(f"serving_moe f32: {checked} generated tokens equal the eager "
         f"model's argmax (near ties, gap < 1e-3: {near})")
    res["serving_moe"] = out


def _profile_run(torch, fn):
    """One more run of ``fn`` under ``torch.profiler``: wall, device busy
    share and device time by kernel group (a lower bound on the busy share
    of an unprofiled run)."""
    wall, by_name = _device_time(torch, fn)
    groups = _group_times(by_name)
    busy_us = sum(by_name.values())
    row = dict(wall_ms=wall * 1e3,
               device_ms=busy_us / 1e3 if by_name else None,
               busy_share=busy_us / 1e6 / wall if by_name else None,
               device_ms_by_group={g: us / 1e3 for g, us in sorted(
                   groups.items(), key=lambda kv: -kv[1])})
    if by_name:
        _log(f"  profiled run: wall {row['wall_ms']:.2f} ms, device busy "
             f"{row['device_ms']:.3f} ms (share {row['busy_share']:.3f}); "
             + ", ".join(f"{g} {ms:.3f} ms"
                         for g, ms in row["device_ms_by_group"].items()))
    else:
        _log("  profiled run: device time not measured (the profiler saw no "
             "CUDA activity)")
    return row


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
    groups = _group_times(by_name)
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
              ("paged_prefill", lambda: phase_paged_prefill(torch, res)),
              ("int8", lambda: phase_int8(torch, res)),
              ("moe_dispatch", lambda: phase_moe_dispatch(torch, res)),
              ("serving", lambda: phase_serving(torch, np, res)),
              ("serving_prefix", lambda: phase_serving_prefix(torch, np, res)),
              ("serving_int8", lambda: phase_serving_int8(torch, np, res)),
              ("serving_moe", lambda: phase_serving_moe(torch, np, res)),
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
    # first bf16 serving run; the five timed training steps; the bf16
    # cache-on shared-prefix run; the bf16 int8 run; the bf16 MoE run), by
    # path
    train = res["training_bf16"]["launches"]
    res["flash"]["launches"] = res["serving_bf16"]["launches"]["flash"]
    res["flash"]["launches_by_path"] = dict(
        serving=res["serving_bf16"]["launches"]["flash"],
        training=train["flash_fwd"])
    for key in ("flash_bwd_dq", "flash_bwd_dkv"):
        res[key]["launches"] = train[key]
        res[key]["launches_by_path"] = dict(training=train[key])
    prefix = res["serving_prefix"]["bf16_cache_on"]["launches"]
    prefix_off = res["serving_prefix"]["bf16_cache_off"]["launches"]
    int8 = res["serving_int8"]["bf16"]["launches"]
    res["paged"]["launches"] = res["serving_bf16"]["launches"]["paged"]
    res["paged"]["launches_by_path"] = dict(
        serving=res["serving_bf16"]["launches"]["paged"],
        serving_prefix=prefix["paged"], serving_int8=int8["paged"])
    res["flash"]["launches_by_path"]["serving_int8"] = int8["flash"]
    res["paged_prefill"]["launches"] = prefix["paged_prefill"]
    res["paged_prefill"]["launches_by_path"] = dict(
        serving_prefix=prefix["paged_prefill"],
        serving_prefix_cache_off=prefix_off["paged_prefill"])
    res["int8"]["launches"] = int8["int8"]
    res["int8"]["launches_by_path"] = dict(serving_int8=int8["int8"])
    moe = res["serving_moe"]["bf16"]["launches"]
    res["paged"]["launches_by_path"]["serving_moe"] = moe["paged"]
    for key in ("moe_dispatch", "moe_combine"):
        res[key]["launches"] = moe[key]
        res[key]["launches_by_path"] = dict(serving_moe=moe[key])
    print(json.dumps({"kernels": [
        {k: v for k, v in res[key].items() if k != "shapes"} for key in (
            "flash", "flash_bwd_dq", "flash_bwd_dkv", "paged",
            "paged_prefill", "int8", "moe_dispatch", "moe_combine")]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
