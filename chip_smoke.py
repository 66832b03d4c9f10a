"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py [--json-out PATH]

Three phases, one result per line:

1. device and build — the card's name and power limit, and the build of
   every CUDA kernel from ``paddle_tpu_torch/csrc`` with nvcc for sm_90a;
2. kernels against their plain PyTorch versions on the card, at the
   serving shapes, in bf16 and f32, with each kernel's time (CUDA events),
   its plain version's time, its bound and one PyTorch library call as a
   yardstick;
3. the serving main path at the full width of GPT-345M (24 layers,
   hidden 1024, 8 heads of 128, vocab 50304, random weights from a seed):
   eight ragged requests through ``ServingEngine`` +
   ``ContinuousBatchingScheduler``, in bf16 and in f32. bf16: after a
   warm-up that touches every prefill and decode bucket, the batch is
   served three times (throughput, latency, memory and kernel launch
   counts of each run); then host against device time per decode step
   by CUDA events, and eight prefills and 16 decode steps under
   ``torch.profiler`` for the device time by kernel group. f32: every
   generated token is checked against the plain dense model,
   teacher-forced.

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
       ("paged", "float32"): 1e-4, ("paged", "bfloat16"): 5e-3}
BIAS_TOL = 1e-3


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


def _check(kernel, out, ref, dtype):
    """(max abs error, relative bias, ok) of ``out`` against ``ref``,
    compared in f32."""
    ref = ref.float()
    err = out.float() - ref
    max_err = err.abs().max().item()
    bias = ((err * ref.sign()).mean() / ref.abs().mean()).item()
    ok = max_err <= TOL[kernel, dtype] and (
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
    if "paged_decode_kernel" in name:
        return "paged_attention_decode"
    if any(s in name.lower() for s in ("gemm", "gemv", "xmma", "cutlass",
                                       "nvjet")):
        return "matmul (cuBLAS)"
    if name.startswith("Memcpy") or name.startswith("Memset"):
        return "memcpy/memset"
    return "other (elementwise, layer norm, index_copy, argmax)"


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
        smi = _nvidia_smi()
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
              ("paged", lambda: phase_paged(torch, res)),
              ("serving", lambda: phase_serving(torch, np, res))]
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
    res["flash"]["launches"] = res["serving_bf16"]["flash_launches"]
    res["paged"]["launches"] = res["serving_bf16"]["paged_launches"]
    print(json.dumps({"kernels": [res["flash"], res["paged"]]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
