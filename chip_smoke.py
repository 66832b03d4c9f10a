"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py [--json-out PATH] [--parent ROOT]

Eighteen phases, one result per line, in this order: build,
tensor_api, flash, flash_bwd, paged, paged_prefill, int8, moe_dispatch,
serving, serving_prefix, serving_int8, serving_moe, checkpoint, training,
training_moe, training_bert, training_bert_static, training_resnet50:

1. device and build — the card's name and power limit, and the build of
   every CUDA kernel from ``paddle_tpu_torch/csrc`` with nvcc for sm_90a;
2. ``flash``, ``flash_bwd``, ``paged`` — each kernel against its plain
   PyTorch version on the card, in bf16 and f32 (bf16 attention runs on
   the tensor cores: the flash forward and the dK/dV pass on ``wgmma``
   fed by TMA where a tensor map can describe the views, else, and for
   the dQ pass, on ``mma.sync``; f32 on the CUDA cores; the phases read
   the bf16 instances' registers and spills from the build log, count
   HGMMA and UTMALDG in the wgmma kernels' SASS, and the kernel nodes
   of a CUDA graph captured around one call show which kernel each
   dtype and view ran, the wgmma
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
   seeds logged, one call captured in a CUDA graph with its offset in
   device memory and replayed at five offsets, each bit-equal to an eager
   launch there; the five GPT-345M
   weight shapes at M = 1, 8, 9 and 256 and odd sizes, two calls
   bit-equal, the instances' registers and spills from the build log),
   each timed at its serving shape (with the stream held, so the host's
   issue does not enter) against its bound and a PyTorch yardstick, the
   int8 shapes at M = 1, 2, 4 and 8 and the "kn" ones at 256 beside cuBLAS
   on the dequantized weight; ``moe_dispatch`` — the
   MoE dispatch and combine kernels against their plain versions in f32
   and bf16 at ERNIE-MoE base width (M = 768, E = 8, top-2): the decode
   shapes S = 1, 2, 4, 8, the prefill shape, a ragged S = 130, a
   capacity-dropping S = 4096, every gate kind, the dispatch on each of
   its two routes (one launch, three passes) where the shapes fit it; the
   routing held exactly off router near ties (counted and printed), the
   public wrapper and a second launch to the same bits, the combine
   against the plain version with its rounding points and against the
   einsum reference; the route of the two serving shapes by kernel name;
   both routes timed over S = 1-512 and the combine at S = 1, 2, 4, 8 and
   512 beside ``F.embedding_bag``, with the stream held, and with
   ``--parent ROOT`` beside the MoE kernels of the tree under ROOT (e.g.
   the parent commit's, unpacked with ``git archive``), in turns;
4. ``serving`` — the serving main path at the full width of GPT-345M (24
   layers, hidden 1024, 8 heads of 128, vocab 50304, random weights from a
   seed): eight ragged requests through ``ServingEngine`` +
   ``ContinuousBatchingScheduler``, in bf16 and in f32. The serving phases
   run the engines as they come, each bucket program captured as a CUDA
   graph (capture time, graphs and pool memory printed), and hold them
   against an eager engine (``aot=False``) on the same prompts: every
   token equal, tokens/s side by side. Launch counts are exact over graph
   replays too. bf16: after a warm-up that touches every prefill and
   decode bucket, the batch is served three times (throughput, latency,
   memory and kernel launch counts of each run); then host against
   device time per decode step by CUDA events, captured and eager, and
   eight prefills and 16 decode steps under ``torch.profiler`` for the
   device time by kernel group; a sampled run (temperature 0.8, top-k 40)
   captured and eager from one seed, every token equal. f32: every
   generated token is checked against the plain dense model,
   teacher-forced;
5. ``serving_prefix`` — the chunked engine with and without the prefix
   cache at GPT-345M width: eight prompts sharing a 768-token prefix
   (page 64, chunk 256, prefill budget 896 tokens a tick), bf16 counted
   runs after a warm-up and, with the cache, the same traffic with 8 new
   tokens under ``torch.profiler``; then f32, where every token with the
   cache equals the token without it; with the cache, an eager engine in
   bf16 and f32, every token equal;
6. ``serving_int8`` — the eight ragged requests of ``serving`` with
   ``quantize="int8"``: a bf16 counted run beside the float engine's, the
   host/device split of a decode step and 16 decode steps under
   ``torch.profiler``, then f32, where every token
   equals the argmax of the dense model on the dequantized weights; an
   eager engine in bf16 and f32, every token equal;
7. ``serving_moe`` — the ERNIE-MoE serving path at the full width of
   ``ernie_moe_base_config`` (12 layers, hidden 768, 12 heads of 64, 8
   experts top-2 in every second layer, vocab 30522, 512 positions,
   random weights from a seed): eight ragged requests through
   ``MoEServingEngine`` + ``ContinuousBatchingScheduler``, page 64. bf16:
   after a warm-up over every bucket one counted run (exact launches of
   the dispatch, combine and paged decode kernels, none of the others),
   then 16 decode steps under ``torch.profiler``, and an eager engine's
   counted run, every token equal; f32: every generated
   token against the argmax of the eager ``ErnieMoeForPretraining``
   (gather path, plain attention), teacher-forced under the causal mask;
8. ``training`` — the training main path: ``GPTHybridTrainStep`` on
   GPT-345M at full width (B = 12, S = 1024, bf16 compute, f32 masters and
   moments, ``remat="dots"``) on one repeated batch. First 5 eager steps
   (``_eager_step()``; step time, host issue, peak memory), freed; then
   the step as it runs on CUDA, captured as one CUDA graph by its first
   call (that call's time, the capture's, graphs held, pool bytes), 5
   steps whose losses and masters must equal the eager run's bit for bit,
   then 5 timed replays (tokens/s, step time, host staging + launch, MFU,
   peak memory, every loss, and the flash kernels' launches per step,
   counted through replays and checked exactly); one captured step
   between CUDA events (device time against host issue), the eager
   step's forward + backward against AdamW, and one captured step under
   ``torch.profiler``. Then, in f32 at full width and 4 layers, the
   kernel path against the plain attention path, and ``remat="dots"``
   against no remat: first-step gradients and three steps of losses.
9. ``training_moe`` — ERNIE-MoE pretraining, the step of
   ``bench_ernie_moe`` (BASELINE config #5) through the dygraph entry
   points: ``ErnieMoeForPretraining`` at ``ernie_moe_base_config()`` (12
   layers, hidden 768, 12 heads of 64, 8 experts top-2 in every second
   layer, vocab 30522; f32 parameters from a seed), B = 16, S = 512,
   ``forward_with_mlm_loss`` under ``amp.auto_cast(bf16)``, backward,
   ``AdamW(lr=1e-4)``. (a) 2 warm-up and 10 timed steps: tokens/s, step
   p50, host issue against the device's span between events (and host
   waits inside a step, by the sync debug mode), MFU, peak memory, every loss (finite, falling), the flash
   launches of each step (12 forward, 12 dQ, 12 dK/dV; no MoE kernel: the
   default config takes the gather path), the attention passes' kernels
   by name, and one step under ``torch.profiler``; (b) the fused MoE
   dispatch and combine in training (random routing off) against the
   gather path from the same weights, f32, 3 steps each: losses,
   first-step gradients and parameters after step 1, 6 dispatch and 6
   combine launches a step on the three-pass route; (c) 2 layers at base
   widths, B = 2: the loss and every gradient with the kernels against
   the same model with every kernel on its plain version, f32 and bf16;
   then the flash backward's errors over 6 seeds at [16, 512, 12, 64]
   non-causal beside the training shape's (no seed over the elementwise
   limit, and the kernel's Delta the plain version's bit for bit, at
   both), and rows 1-3 and 7-8 checked and timed at this path's shapes
   (the dispatch and combine at S = 8192 in f32, as O1 hands them over)
   beside their plain versions, bounds and library calls; (d) the same
   step through ``ParallelTrainStep``, captured as one CUDA graph: the
   first call (the eager step, then the capture) and one replay, then 10
   timed replays with the default gates (random routing on): tokens/s,
   step p50, host staging + launch against the device's span, the
   profiled busy share, MFU, peak memory, capture time and pool bytes,
   host syncs in the first call and in a replay (none allowed), the
   flash launches each replay counts (12/12/12), the gates' generators
   moving with every replay, and 5 steps under the eager switch from the
   same weights (captured = eager printed); captured = eager bit for bit
   over 5 steps with random routing off, on the gather path and with
   ``fused_dispatch=True`` (6 dispatch and 6 combine launches a replay);
   a ``GradScaler`` whose overflowing replay must keep every parameter
   and accumulator, set ``last_found_inf`` and halve the scale;
10. ``tensor_api`` — the tensor facade (``import paddle_tpu_torch as
    paddle``) on the card against the same ops on the CPU, at the CPU
    tests' tolerances, each check's error printed: ``to_tensor`` with no
    place lands on the card; elementwise ops, a matmul chain through a
    ``PyLayer`` with ``backward``, a ``paddle.grad(create_graph=True)``
    second derivative, topk, cumsum, gather, argmax, and a matmul under
    ``auto_cast(bf16)``; ``FLAGS_check_nan_inf`` raises on a planted NaN;
11. ``checkpoint`` — the engines' warm start: a GPT-345M
    ``GPTForPretraining`` state (f32, the ``serving`` phase's seed) saved
    with ``paddle.save`` and served through ``ServingEngine.from_checkpoint``
    (captured) on the ``serving`` prompts, also from bare ``GPTModel``
    keys and with ``quantize="int8"``, and ``MoEServingEngine.from_checkpoint``
    at ``ernie_moe_base_config(capacity_factor=100.0)`` on the
    ``serving_moe`` prompts: every greedy token (16 a request) equal to an
    engine built from the same model in memory, launches counted exactly;
    the save and load times, the checkpoint bytes, ``from_checkpoint``'s
    time and the time to the first token after it printed beside the
    card's name and power limit (int8 reads the full-key file again);
12. ``training_bert`` — BERT-base pretraining (``bench_bert``, BASELINE
    config #2) with a model built only from the ported ``paddle.nn``:
    ``BertForPretraining(BertModel(bert_base_config()))`` (12 layers,
    hidden 768, 12 heads of 64, FFN 3072, V = 30522, dropout 0.1 / 0.1;
    f32 weights from ``paddle.seed(0)``), B = 16, S = 512, ids and labels
    from ``default_rng(0)``, ``forward_with_mlm_loss`` under
    ``auto_cast(bf16)``, ``AdamW(1e-4)``, through ``ParallelTrainStep``
    captured as one CUDA graph. (a) the published config (the attention
    dropout sends the JAX gate's attention to its dense form, so no kernel
    of the table launches, which is held): the first call and one replay,
    10 timed replays (tokens/s, step p50, host staging + launch against
    the device's span, MFU at ``model_flops_per_token``, peak memory,
    first-call and capture time, pool bytes, host syncs: none allowed),
    one profiled replay (busy share, kernel groups, the largest kernels),
    the dropout masks of two replays (kept share over every hidden
    dropout within 3 sigma of 0.9; the embeddings' masks differ), and the
    eager facade step beside it; (b) ``attention_probs_dropout_prob=0``
    (the flash route): the same replays with rows 1-3 launched 12/12/12 a
    replay, captured = eager bit for bit over 5 steps with all dropout at
    0, and at 2 layers, B = 2, the loss and every gradient with the
    kernels against the plain versions in f32 and bf16;
13. ``training_bert_static`` — BERT-base on the static path, as
    ``bench_bert`` runs it: its build (``bench.py:534-549``) under
    ``enable_static``, a ``program_guard`` and ``auto_cast(bf16)``
    (``static.data`` ids and labels [16, 512] int64,
    ``forward_with_mlm_loss``, ``AdamW(1e-4).minimize``), device-resident
    feeds, ``Executor.run(..., return_numpy=False)``: one CUDA graph per
    feed signature. (a) the published config (no kernel of the table,
    held) and (b) attention dropout 0 (rows 1-3 12/12/12 a run): 2
    warm-up runs, 10 timed runs with one sync (tokens/s, the device's span
    a run between events, MFU, peak memory), host staging + launch with
    the device idle, one profiled run, the first run, capture time, graphs
    and pool bytes; checks: falling finite losses, no host sync in the
    first run or a replay, one graph for the feed signature, a fetched
    loss kept after the next run, and in (a) the embeddings' dropout
    masks new every replay. Then static = dygraph: the program against
    ``ParallelTrainStep``'s captured step from the same weights, batch
    and draws at attention dropout 0, 3 runs (the program's second on
    numpy feeds), every loss and trained parameter bit for bit, f32 at 2
    layers and bf16 at full width; ``training_bert``'s tokens/s from the
    same call beside it;
14. ``training_resnet50`` — ResNet-50 (BASELINE config #1) built from the
    ported ``paddle.vision.models`` (``resnet50(num_classes=1000)``,
    25,557,032 f32 parameters and 106 BN buffers from a seed), B = 128,
    3 x 224 x 224 images and labels from ``default_rng(0)``,
    ``cross_entropy``, ``Momentum(0.1, 0.9)`` under ``auto_cast(bf16)``.
    (a) ``bench_resnet50``'s static build and run sequence
    (``bench.py:495-504`` through ``:451-457``): ``static.data``, the
    model, ``minimize``, device-resident feeds, ``Executor.run(...,
    return_numpy=False)``, one CUDA graph per feed signature; first two
    runs on an Executor of their own fetching ``conv1.weight`` and
    ``bn1._mean`` too (the first run's eager step and a replay: each fetch
    the value before its run, in storage of its own that the next run
    leaves alone), then 2 warm-up and 10 timed runs with one sync. (b) the
    same model from the same seed through ``ParallelTrainStep`` with the
    loss under ``auto_cast(bf16)``, captured: 2 warm-up and 10 timed
    replays. Each part: imgs/s, step p50 and the device's span, host
    staging + launch, peak memory, the first step and the capture, pool
    bytes, one profiled step (busy share; cuDNN's convolutions and layout
    transposes, the fc's GEMM, casts, the BN reductions and elementwise
    work), MFU at bench.py's 3 x 4.1e9 FLOP/img and at 3 x 2 FLOP a
    multiply-add counted from the model's conv and fc shapes; checks:
    finite losses, every BN buffer moved by every step, no host sync in
    the first call or a replay, one graph, no kernel of the table
    launched. Then static = dygraph with ``cudnn.deterministic`` on for
    both: 3 runs (the program's second on numpy feeds) against 3
    ``ParallelTrainStep`` calls from the same weights and batch, every
    loss, parameter and BN buffer bit for bit, in f32 with ``resnet18``
    at B = 4, 3 x 64 x 64 and in bf16 at full width.

Exits non-zero, without the final line, when CUDA is unavailable or any
phase fails. The last line is ``{"ok": true, "device": {...}}``; the line
before it is the card's ``nvidia-smi`` name and power limit, and before
that one JSON object holds the per-kernel numbers (eight kernels).
"""
from __future__ import annotations

import argparse
import contextlib
import copy
import gc
import json
import math
import os
import re
import subprocess
import sys
import tempfile
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
             ("renorm", 512, 512, 2, "renorm"),
             ("decode_s1", 1, 1, 2, "gshard"), ("decode_s2", 2, 2, 2, "gshard"),
             ("decode_s4", 4, 4, 2, "gshard"))
# the dispatch routes' timed sweep and the combine's timed sizes (C = S)
MOE_SWEEP_S = (1, 2, 4, 8, 16, 32, 64, 128, 130, 256, 512)
MOE_COMBINE_S = (1, 2, 4, 8, 512)
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
TRAIN_B, TRAIN_S, TIMED_STEPS = 12, 1024, 5
# the captured step against the eager one: this many steps from one seed,
# every loss and every master bit-equal
GRAPH_CHECK_STEPS = 5
# f32 trainer checks at 4 layers: each gradient's |a - b| / |b| (norms)
# and the loss of 3 steps. Kernel vs plain attention: f32 on both, sums in
# other orders. "dots" vs no remat: the recompute repeats the same
# deterministic kernels, so they should agree to rounding or better.
GRAD_REL_TOL = {"kernel_vs_plain": 1e-4, "dots_vs_none": 1e-6}
TRAIN_LOSS_TOL = 1e-4
# ERNIE-MoE pretraining: bench_ernie_moe (bench.py:567) at
# ernie_moe_base_config(), B = 16, S = 512, AdamW lr 1e-4 under
# auto_cast(bf16); 2 warm-up steps, then 10 timed ones on one batch
MOE_TRAIN_B, MOE_TRAIN_S, MOE_TRAIN_WARMUP, MOE_TRAIN_STEPS = 16, 512, 2, 10
# fused against gather MoE training, f32 (under auto_cast the gather path's
# gate product runs in bf16 and the fused kernel's in f32, so the two
# route tokens apart): 3 steps each from the same weights, every gate's
# random routing off. The losses to TRAIN_LOSS_TOL; each first-step
# gradient's |a - b| / |b| (norms; for the key projections' biases, whose
# gradient is 0 up to rounding, over the norm of all the gradients) to
# GRAD_REL_TOL["kernel_vs_plain"];
# every parameter after step 1 within MOE_PARAM_TOL (AdamW's first step
# moves an element by lr g / (|g| + eps), at most lr = 1e-4, whatever |g|:
# an element whose gradient is near 0 may step either way, so one lr)
MOE_FUSED_STEPS = 3
MOE_PARAM_TOL = 1e-4
# ParallelTrainStep captured against its eager switch: this many steps
# from one seed, every loss and parameter bit-equal
MOE_GRAPH_STEPS = 5
# kernel against plain at 2 layers (one dense, one MoE; base widths;
# B = 2, S = 512), the loss and every gradient (|a - b| / |b| as in the
# fused check): f32 the trainer's limits
# (GRAD_REL_TOL["kernel_vs_plain"], TRAIN_LOSS_TOL); bf16 under
# auto_cast, where the kernels round where the plain versions do, but a
# sum in another order flips some roundings of the attention's bf16
# outputs, which the bf16 products after it carry on: each gradient's
# |a - b| / |b| to 1.5e-2 and the loss to 1e-4, about twice the errors
# seen on an H100 (6.6e-3, 4.4e-5; the plain model in bf16 against f32:
# 1.27e-2)
MOE_KVP_TOL = {"float32": (1e-4, 1e-4), "bfloat16": (1.5e-2, 1e-4)}
MOE_KVP_B = 2
# rows 1-3 at the ERNIE-MoE training shape: [B, S, N, d], non-causal
MOE_ATTN_SHAPE = (16, 512, 12, 64)
# BERT-base pretraining: bench_bert (bench.py:522, BASELINE config #2) at
# bert_base_config(), B = 16, S = 512, AdamW lr 1e-4 under auto_cast(bf16),
# through ParallelTrainStep: 2 warm calls (the first captures), then 10
# timed replays on one batch; captured against eager over 5 steps with all
# dropout at 0
BERT_TRAIN_B, BERT_TRAIN_S, BERT_TRAIN_WARMUP, BERT_TRAIN_STEPS = \
    16, 512, 2, 10
BERT_GRAPH_STEPS = 5
# BERT-base on the static path (bench_bert's literal build): the runs the
# static program is held to ParallelTrainStep over, bit for bit
BERT_STATIC_RUNS = 3
# ResNet-50 (BASELINE config #1): bench_resnet50 (bench.py:488) at B = 128,
# 3 x 224 x 224, 1000 classes, Momentum(0.1, 0.9) under auto_cast(bf16),
# on its static path and through ParallelTrainStep: 2 warm-up steps (the
# first captures), 10 timed; the static program held to ParallelTrainStep
# bit for bit over 3 steps; bench.py's FLOP count a trained image
RESNET_B, RESNET_HW, RESNET_CLASSES = 128, 224, 1000
RESNET_WARMUP, RESNET_STEPS, RESNET_EQUAL_STEPS = 2, 10, 3
RESNET_BENCH_FLOP_PER_IMG = 3 * 4.1e9


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


def _kernel_names(torch, fn):
    """The kernels one call of ``fn`` launches, one name per launch: the
    kernel nodes of a CUDA graph captured around the call (after one call
    uncaptured), read from the graph's DOT dump after a replay. The CUDA
    driver lists every node, so the names and their count are exact; the
    profiler on the card's machine has recorded no device activity at
    all for small windows, eight profiles in a row."""
    fn()
    torch.cuda.synchronize()
    try:                        # the captured graph kept for its dump
        graph = torch.cuda.CUDAGraph(keep_graph=True)
    except TypeError:           # a PyTorch that keeps it in debug mode
        graph = torch.cuda.CUDAGraph()
    graph.enable_debug_mode()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "graph.dot")
        graph.debug_dump(path)
        with open(path) as f:
            dot = f.read()
    del graph
    names = []
    for label in re.findall(r'label="([^"]*)"', dot):
        label = label.replace("\\", "")
        if "KERNEL" not in label and "<<<" not in label:
            continue
        # the kernel's name stands before its launch configuration
        m = re.search(r"([^|{}]*?)\s*<<<", label)
        names.append((m.group(1) if m else label).strip())
    if not names:
        raise AssertionError(f"a graph of one call holds no kernel node: "
                             f"{dot[:2000]}")
    return names


def _check_routes(torch, what, fns, names):
    """Each ``fns[label] = (fn, want)`` ran the kernel named ``want`` and no
    other of ``names`` (the kernels that compute ``what``), by the kernel
    nodes of a graph of one call."""
    for label, (fn, want) in fns.items():
        seen = _kernel_names(torch, fn)
        ran = [n for n in seen if any(k in n for k in names)]
        _log(f"{what} {label} launches: {ran}")
        if not ran or any(want not in n for n in ran):
            raise AssertionError(f"{what} {label} did not run {want}: {ran} "
                                 f"(all kernels seen: {seen})")


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
    argument of the kernel launched (``flash_fwd_wg_kernel<D, NC>``,
    mangled ``flash_fwd_wg_kernelILiDELiNCE``)."""
    names = _kernel_names(torch, lambda: fa.flash_attention_fwd(q, k, v,
                                                                True))
    found = {int(m.group(1) or m.group(2)) for m in (
        re.search(r"flash_fwd_wg_kernel(?:<\d+, ?(\d+)>|ILi\d+ELi(\d+)E)",
                  n) for n in names) if m}
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
    # SDPA's backward alone: its flash backward op on its own forward's
    # saved outputs, the stream held; beside it, the same as the held
    # forward + backward less the held forward
    aten = torch.ops.aten
    with torch.no_grad():
        saved = aten._scaled_dot_product_flash_attention(
            qt.detach(), kt.detach(), vt.detach(), 0.0, True)
    o_s, lse_s, cum_q, cum_k, max_q, max_k, ph_seed, ph_off = saved[:8]
    lib_ms = _time_held_ms(
        torch, lambda: aten._scaled_dot_product_flash_attention_backward(
            dot, qt.detach(), kt.detach(), vt.detach(), o_s, lse_s, cum_q,
            cum_k, max_q, max_k, 0.0, True, ph_seed, ph_off), 20)
    def sdpa_both():
        return torch.autograd.grad(sdpa(qt, kt, vt, is_causal=True),
                                   (qt, kt, vt), dot)
    sdpa_fwd_ms = _time_held_ms(
        torch, lambda: sdpa(qt, kt, vt, is_causal=True), 20)
    sdpa_both_ms = _time_held_ms(torch, sdpa_both, 20)
    from torch.nn.attention import SDPBackend, sdpa_kernel
    with sdpa_kernel([SDPBackend.FLASH_ATTENTION]):  # its flash backend
        flash_both_ms = _time_held_ms(torch, sdpa_both, 20)
        flash_fwd_ms = _time_held_ms(
            torch, lambda: sdpa(qt, kt, vt, is_causal=True), 20)
    res["flash_bwd_sdpa"] = dict(
        backward_op_ms=lib_ms, forward_ms=sdpa_fwd_ms,
        forward_backward_ms=sdpa_both_ms,
        difference_ms=sdpa_both_ms - sdpa_fwd_ms,
        flash_backend_difference_ms=flash_both_ms - flash_fwd_ms)
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
         f"{plain_ms:.4f} ms; SDPA backward "
         f"(aten._scaled_dot_product_flash_attention_backward, held) "
         f"{lib_ms:.4f} ms (the kernels {(dq_ms + dkv_ms) / lib_ms:.2f}x); "
         f"held forward + backward {sdpa_both_ms:.4f} ms less the held "
         f"forward {sdpa_fwd_ms:.4f} ms: {sdpa_both_ms - sdpa_fwd_ms:.4f} ms "
         f"(with the flash backend alone: {flash_both_ms:.4f} - "
         f"{flash_fwd_ms:.4f} = {flash_both_ms - flash_fwd_ms:.4f} ms)")
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
    res["paged_prefill_graph_offsets"] = _prefill_graph_offsets(
        torch, pa, q, pools[0][1], pools[0][2], pt)
    prefill_kernels = dict(bfloat16="paged_prefill_tc_kernel",
                           float32="paged_prefill_kernel")
    _check_routes(torch, "ragged_prefill_attention", {
        dt: (lambda t=getattr(torch, dt): pa.ragged_prefill_attention(
            q.to(t), pools[0][1].to(t), pools[0][2].to(t), pt, off),
            prefill_kernels[dt])
        for dt in ("bfloat16", "float32")}, tuple(prefill_kernels.values()))

    def cycling(fn, o, step=[0]):
        def run():
            i = step[0] % n_layers
            step[0] += 1
            return fn(q, pools[i][1], pools[i][2], pt, o)
        return run
    # the kernel reads its offset from the device, as the chunk program
    # passes it
    off_dev = torch.full((1,), off, dtype=torch.int32, device="cuda")
    ms = _time_held_ms(torch, cycling(pa.ragged_prefill_attention, off_dev),
                       100)
    plain_ms = _time_held_ms(torch, cycling(pa.paged_prefill_attention, off),
                             20)
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


# chunk offsets of the captured chunk-prefill call (page 64): the first
# chunk, mid-page, page-aligned and the serving shape's
GRAPH_OFFSETS = (0, 37, 256, 500, 768)


def _prefill_graph_offsets(torch, pa, q, kp, vp, pt):
    """One chunk-prefill call captured in a CUDA graph, its offset a device
    int32, replayed at each of ``GRAPH_OFFSETS`` (bf16 and f32): every
    replay bit-equal to an eager launch at that offset, passed as an int.
    This is what lets one chunk program serve every chunk and every cached
    prefix length."""
    rows = {}
    for dt in ("bfloat16", "float32"):
        t = getattr(torch, dt)
        qd, kd, vd = q.to(t), kp.to(t), vp.to(t)
        off = torch.zeros(1, dtype=torch.int32, device="cuda")
        pa.ragged_prefill_attention(qd, kd, vd, pt, off)
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = pa.ragged_prefill_attention(qd, kd, vd, pt, off)
        equal = {}
        for o in GRAPH_OFFSETS:
            off.fill_(o)
            graph.replay()
            equal[o] = torch.equal(
                out, pa.ragged_prefill_attention(qd, kd, vd, pt, o))
        rows[dt] = equal
        _log(f"  chunk prefill {dt}, one captured call replayed at offsets "
             f"{list(GRAPH_OFFSETS)}: bit-equal to eager launches "
             f"{list(equal.values())}")
        if not all(equal.values()):
            raise AssertionError(f"chunk prefill {dt}: a replay differs "
                                 f"from the eager launch: {equal}")
    return rows


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


def _check_dispatch(torch, md, x, gw, gb, C, K, kind, route):
    """The dispatch kernel on ``route`` against its plain version. The
    experts the kernel picked equal the plain version's except at router
    near ties; given its picks, comb_idx and expert_in are exactly the slot
    rule's and the row gather's; val (where the picks agree), me and ce
    within MOE_REL of the largest |value|. The public wrapper (its autograd
    Function and device routing, as the engine calls it) gives the same
    bits as the launch whose picks are read, and so does a second launch.
    Returns a reading, with ``ok``."""
    E = MOE_E
    with md._dispatch_route(route):
        out, idx = md._launch_dispatch(x, gw, gb, E, C, K, kind)
        pub = md.fused_moe_dispatch(x, gw, gb, num_expert=E, capacity=C,
                                    top_k=K, gate_kind=kind)
        again, idx2 = md._launch_dispatch(x, gw, gb, E, C, K, kind)
    torch.cuda.synchronize()
    wrapper_same = all(bool(torch.equal(a, b)) for a, b in zip(pub, out))
    runs_same = all(bool(torch.equal(a, b))
                    for a, b in zip((*out, idx), (*again, idx2)))
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
    ok = exact and wrapper_same and runs_same and off_tie == 0 \
        and max(rel.values()) <= MOE_REL
    return dict(route=route, near_ties=int(near.sum()),
                flipped=int(flipped.sum()), wrapper_same=wrapper_same,
                runs_same=runs_same, val_max_abs_err=val_abs,
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
               einsum_rms=rms, ok=ok, bit_equal=bool(torch.equal(y, ref)),
               max_abs_err=(y.float() - ref.float()).abs().max().item())
    if dt == "bfloat16":
        row["bf16_spacings_vs_kernel_form"] = spacings
    return row


def _load_moe_tree(root, name="parent"):
    """The MoE kernels' wrapper module of another tree (``--parent``: for
    instance the parent commit's ``paddle_tpu_torch``, unpacked with ``git
    archive`` under ``root``), importable beside this tree's as
    ``ptt_<name>.kernels.moe_dispatch``. Its own ``_build`` builds that
    tree's ``common.cu`` and ``moe_dispatch.cu`` alone, into
    ``build/moe_<name>`` of this tree, and binds only the MoE entries."""
    import importlib
    import types
    from pathlib import Path
    pkg = Path(root).resolve() / "paddle_tpu_torch"
    base = f"ptt_{name}"
    for mod_name, path in ((base, pkg), (f"{base}.kernels", pkg / "kernels")):
        mod = types.ModuleType(mod_name)
        mod.__path__ = [str(path)]
        sys.modules[mod_name] = mod
    build = importlib.import_module(f"{base}.kernels._build")
    csrc = build._CSRC
    build._sources = lambda: [csrc / "common.cu", csrc / "moe_dispatch.cu"]
    build._SIGNATURES = {k: v for k, v in build._SIGNATURES.items()
                         if k.startswith("ptt_moe_")}
    build._BUILD_DIR = Path(__file__).resolve().parent / "build" / \
        f"moe_{name}"
    md = importlib.import_module(f"{base}.kernels.moe_dispatch")
    build.build(force=True)
    build.load_library()
    return md


# the kernels of each dispatch route, by name
MOE_ROUTE_KERNELS = dict(one_launch=("moe_dispatch_one_kernel",),
                         three_pass=("moe_gate_kernel", "moe_scan_kernel",
                                     "moe_scatter_kernel"))


def _dispatch_bytes(S, C, K, item):
    """Bytes the dispatch must move: x, gate_w and gate_b read once, the
    whole [E * C, M] buffer, comb, val, me and ce written once."""
    return (S * MOE_M * item + MOE_M * MOE_E * item + MOE_E * item
            + MOE_E * C * MOE_M * item + S * K * 8 + 2 * MOE_E * 4)


def _moe_timings(torch, md, gen, parent):
    """bf16, the stream held, C = S, top-2: both dispatch routes over
    MOE_SWEEP_S and the combine at MOE_COMBINE_S, each beside the plain
    versions, the combine's library call and, with ``parent``, the parent
    tree's kernels, in turns (parent, this tree, this tree, parent)."""
    K = 2
    kw = lambda S: dict(num_expert=MOE_E, capacity=S, top_k=K)  # noqa: E731
    sweep = {}
    for S in MOE_SWEEP_S:
        x, gw, gb = _moe_inputs(torch, gen, "bfloat16", S)
        routes = [r for r in md.DISPATCH_ROUTES
                  if r == "three_pass" or md._one_launch_fits(S, MOE_E, K)]

        def ours(route):
            with md._dispatch_route(route):
                return _time_held_ms(torch, lambda: md.fused_moe_dispatch(
                    x, gw, gb, **kw(S)), 100)
        with torch.no_grad():
            t = {}
            if parent is not None:
                t["parent"] = [_time_held_ms(
                    torch, lambda: parent.fused_moe_dispatch(
                        x, gw, gb, **kw(S)), 100)]
            for r in routes:
                t[r] = [ours(r)]
            for r in reversed(routes):
                t[r].append(ours(r))
            if parent is not None:
                t["parent"].append(_time_held_ms(
                    torch, lambda: parent.fused_moe_dispatch(
                        x, gw, gb, **kw(S)), 100))
            plain = _time_held_ms(torch, lambda: md.reference_moe_dispatch(
                x, gw, gb, **kw(S)), 20)
        ms = {k: sum(v) / len(v) for k, v in t.items()}
        bound, by = _bound(2 * S * MOE_M * MOE_E,
                           _dispatch_bytes(S, S, K, 2), "bfloat16")
        sweep[S] = dict(S=S, route=md.dispatch_route(S, MOE_E, K),
                        **{f"{k}_ms": v for k, v in ms.items()},
                        runs_ms=t, plain_ms=plain, bound_ms=bound,
                        bound_by=by, bytes=_dispatch_bytes(S, S, K, 2))
        _log(f"moe dispatch bf16 S=C={S}: " + ", ".join(
            f"{k} {v:.4f} ms ({'/'.join(f'{u:.4f}' for u in t[k])})"
            for k, v in ms.items())
            + f"; plain {plain:.4f} ms, bound {bound:.6f} ms ({by}); the "
            f"shapes take {sweep[S]['route']}")
    combine = {}
    for S in MOE_COMBINE_S:
        x, gw, gb = _moe_inputs(torch, gen, "bfloat16", S)
        with torch.no_grad():
            ei, comb, val, _, _ = md.fused_moe_dispatch(x, gw, gb, **kw(S))
            eo = torch.randn(MOE_E * S, MOE_M, device="cuda",
                             generator=gen).to(ei.dtype)
            # the library call: F.embedding_bag (sum of rows weighted per
            # sample) over the rows with a zero row appended for the
            # sentinel and val in the rows' dtype, both made once, not timed
            eo_pad = torch.cat([eo, eo.new_zeros(1, MOE_M)])
            val_dt = val.to(eo.dtype)

            def lib():
                return torch.nn.functional.embedding_bag(
                    comb, eo_pad, per_sample_weights=val_dt, mode="sum",
                    padding_idx=MOE_E * S)
            _, lib_share, lib_rms, _ = _scaled_err(
                lib(), md.reference_moe_combine(eo, val, comb))
            if not (lib_share <= MOE_COMBINE_EINSUM_TOL[0]
                    and lib_rms <= MOE_COMBINE_EINSUM_TOL[1]):
                raise AssertionError(
                    f"embedding_bag does not compute the combine at S={S}: "
                    f"{lib_share:.2e} of max, rms {lib_rms:.2e}")
            fns = dict(kernel=lambda: md.fused_moe_combine(eo, val, comb),
                       library=lib)
            if parent is not None:
                fns["parent"] = lambda: parent.fused_moe_combine(eo, val,
                                                                 comb)
            order = [k for k in ("parent", "kernel", "library") if k in fns]
            t = {k: [] for k in order}
            for k in order + order[::-1]:
                t[k].append(_time_held_ms(torch, fns[k], 100))
            plain = _time_held_ms(
                torch, lambda: md.combine_kernel_reference(eo, val, comb), 20)
            einsum = _time_held_ms(
                torch, lambda: md.reference_moe_combine(eo, val, comb), 20)
        ms = {k: sum(v) / len(v) for k, v in t.items()}
        kept = int((comb < MOE_E * S).sum())
        nbytes = kept * MOE_M * 2 + S * MOE_M * 2 + S * K * 8
        bound, by = _bound(2 * kept * MOE_M, nbytes, "bfloat16")
        combine[S] = dict(S=S, **{f"{k}_ms": v for k, v in ms.items()},
                          runs_ms=t, plain_ms=plain, einsum_ms=einsum,
                          bound_ms=bound, bound_by=by, bytes=nbytes,
                          library_share=lib_share, library_rms=lib_rms)
        _log(f"moe combine bf16 S={S}: " + ", ".join(
            f"{k} {v:.4f} ms ({'/'.join(f'{u:.4f}' for u in t[k])})"
            for k, v in ms.items())
            + f" (embedding_bag vs einsum {lib_share:.2e} of max, rms "
            f"{lib_rms:.2e}); plain {plain:.4f} ms (einsum {einsum:.4f}), "
            f"bound {bound:.6f} ms ({by}: {nbytes / 1e6:.4f} MB)")
    return sweep, combine


def phase_moe_dispatch(torch, res, parent_root=None):
    from paddle_tpu_torch.kernels import moe_dispatch as md
    gen = torch.Generator(device="cuda").manual_seed(8)
    readings, failed = [], []
    near_total = 0
    for dt in ("bfloat16", "float32"):
        for label, S, C, K, kind in MOE_CASES:
            x, gw, gb = _moe_inputs(torch, gen, dt, S)
            row = dict(case=label, dtype=dt, S=S, C=C, top_k=K, kind=kind,
                       route=md.dispatch_route(S, MOE_E, K), dispatch={})
            for route in md.DISPATCH_ROUTES:
                if route == "one_launch" \
                        and not md._one_launch_fits(S, MOE_E, K):
                    continue
                row["dispatch"][route] = d = _check_dispatch(
                    torch, md, x, gw, gb, C, K, kind, route)
                near_total += d["near_ties"]
                _log(f"moe {dt} {label} S={S} C={C} k={K} {kind}, {route}"
                     f"{' (the shapes take it)' if route == row['route'] else ''}"
                     f": dispatch near ties {d['near_ties']}, picks "
                     f"differing {d['flipped']} ({d['flipped_off_tie']} off "
                     f"a near tie), comb_idx and expert_in exact "
                     f"{d['exact']} (equal to the plain version's "
                     f"{d['exact_vs_plain']}), wrapper's bits equal "
                     f"{d['wrapper_same']}, two runs equal {d['runs_same']},"
                     f" dropped {d['dropped']}, val/me/ce "
                     f"{d['val_rel']:.2e}/{d['me_rel']:.2e}/{d['ce_rel']:.2e}"
                     f" of max (tol {MOE_REL:g}) "
                     f"{'ok' if d['ok'] else 'FAIL'}")
                if not d["ok"]:
                    failed.append(f"{dt} {label} dispatch {route}")
            _, comb, val, _, _ = md.reference_moe_dispatch(
                x, gw, gb, num_expert=MOE_E, capacity=C, top_k=K,
                gate_kind=kind)
            eo = torch.randn(MOE_E * C, MOE_M, device="cuda",
                             generator=gen).to(getattr(torch, dt))
            row["combine"] = c = _check_combine(torch, md, dt, eo, val, comb)
            _log(f"moe {dt} {label} S={S}: combine vs kernel form "
                 f"{c['max_rel_vs_kernel_form']:.2e} (bit-equal "
                 f"{c['bit_equal']}"
                 + (f", {c['bf16_spacings_vs_kernel_form']:.2f} bf16 spacings"
                    if dt == "bfloat16" else "")
                 + f"), vs einsum {c['einsum_share']:.2e} of max, rms "
                 f"{c['einsum_rms']:.2e} {'ok' if c['ok'] else 'FAIL'}")
            if not c["ok"]:
                failed.append(f"{dt} {label} combine")
            readings.append(row)
    _log(f"moe router near ties (k-th and (k+1)-th logits within "
         f"{MOE_NEAR_TIE:g}) over all cases and routes: {near_total}")
    res["moe_cases"] = readings
    res["moe_near_ties"] = near_total
    if failed:
        raise AssertionError(f"MoE kernels disagree: {failed}")
    # the route each serving shape takes, by the names of the kernels one
    # call launches
    launched = {}
    for label, S in (("decode", 8), ("prefill", 512)):
        x, gw, gb = _moe_inputs(torch, gen, "bfloat16", S)
        names = [n for n in _kernel_names(torch, lambda: md.fused_moe_dispatch(
            x, gw, gb, num_expert=MOE_E, capacity=S, top_k=2)) if "moe_" in n]
        route = md.dispatch_route(S, MOE_E, 2)
        want = MOE_ROUTE_KERNELS[route]
        _log(f"moe dispatch {label} S={S} ({route}), one call: {names}")
        if len(names) != len(want) or not all(
                sum(k in n for n in names) == 1 for k in want):
            raise AssertionError(f"a {label} dispatch call did not launch "
                                 f"{want}, each once: {names}")
        launched[label] = dict(route=route, kernels=names)
    res["moe_dispatch_launched"] = launched
    parent = None
    if parent_root is not None:
        parent = _load_moe_tree(parent_root)
        _log(f"moe: the parent tree's kernels from {parent_root}")
    sweep, combine = _moe_timings(torch, md, gen, parent)
    res["moe_sweep"], res["moe_combine_sizes"] = sweep, combine
    worst = lambda dt, part, key: max(                  # noqa: E731
        r[part][key] for r in readings if r["dtype"] == dt)
    dec, dec_c = sweep[8], combine[8]
    res["moe_dispatch"] = dict(
        name="moe_dispatch", route="cuda",
        source="paddle_tpu_torch/csrc/moe_dispatch.cu",
        replaces="paddle_tpu/kernels/moe_dispatch.py:199",
        launches=None, max_abs_err=max(
            d["val_max_abs_err"] for r in readings
            if r["dtype"] == "bfloat16" for d in r["dispatch"].values()),
        ms=dec[dec["route"] + "_ms"], plain_ms=dec["plain_ms"],
        bound_ms=dec["bound_ms"], bound_by=dec["bound_by"],
        library_ms=None, timed=f"the decode shape S = C = 8, M = 768, E = "
        f"8, top-2, the {dec['route']} route", kernel_route=dec["route"],
        switch_point=md._ONE_LAUNCH_MAX_S)
    res["moe_combine"] = dict(
        name="moe_combine", route="cuda",
        source="paddle_tpu_torch/csrc/moe_dispatch.cu",
        replaces="paddle_tpu/kernels/moe_dispatch.py:413",
        launches=None, max_abs_err=worst("bfloat16", "combine",
                                         "max_abs_err"),
        ms=dec_c["kernel_ms"], plain_ms=dec_c["plain_ms"],
        bound_ms=dec_c["bound_ms"], bound_by=dec_c["bound_by"],
        library_ms=dec_c["library_ms"],
        timed="the decode shape S = C = 8, M = 768, k = 2; library: "
              "F.embedding_bag(mode='sum', per_sample_weights)")


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
                   launches=_gpt_launches, max_new=MAX_NEW):
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
    reqs, wall, _ = _run_sched(torch, sched, prompts, max_new)
    counts = _counts()
    _check_counts(label, counts, launches(eng, sched.steps, len(prompts)))
    if eng.pool.pages_in_use:
        raise AssertionError(f"{label}: leaked pages")
    e2e = _e2e(sched, reqs, wall)
    e2e.update(launches=counts, weight_bytes=eng.weight_bytes(),
               max_memory_allocated_bytes=torch.cuda.max_memory_allocated())
    return e2e, reqs


def _capture_info(eng, label):
    """What capturing ``eng``'s bucket programs cost: seconds, graphs held
    and the bytes of their shared memory pool (logged)."""
    info = dict(compile_s=eng.compile_s,
                aot_programs=eng.status()["aot_programs"],
                graph_pool_bytes=eng.graph_pool_bytes())
    pool = info["graph_pool_bytes"]
    _log(f"{label}: {info['aot_programs']} CUDA graphs captured in "
         f"{eng.compile_s:.2f} s, graph pool "
         f"{'not measured' if pool is None else f'{pool / 2**20:.1f} MiB'}")
    return info


def _same_tokens(label, got, want):
    """Every token of the captured engine's requests ``got`` equal to the
    eager engine's ``want`` at the same place (greedy or sampled with the
    same seed); raises at the first difference. Returns the count."""
    n = 0
    for a, b in zip(got, want, strict=True):
        if list(a.tokens) != list(b.tokens):
            i = next((i for i, (x, y) in enumerate(zip(a.tokens, b.tokens))
                      if x != y), min(len(a.tokens), len(b.tokens)))
            raise AssertionError(
                f"{label}: rid {a.rid} token {i}: captured "
                f"{list(a.tokens)[i:i + 1]}, eager {list(b.tokens)[i:i + 1]}")
        n += len(a.tokens)
    return n


def _beside(label, cap, eager):
    """The captured and the eager engine's run side by side (logged)."""
    _log(f"{label}, captured vs eager (aot=False): tokens/s "
         f"{cap['tokens_per_s']:.1f} vs {eager['tokens_per_s']:.1f} "
         f"({cap['tokens_per_s'] / eager['tokens_per_s']:.2f}x), per-token "
         f"p50 {cap['per_token_p50_ms']:.2f} vs "
         f"{eager['per_token_p50_ms']:.2f} ms, TTFT mean "
         f"{cap['ttft_mean_ms']:.1f} vs {eager['ttft_mean_ms']:.1f} ms")
    return dict(tokens_per_s=cap["tokens_per_s"],
                eager_tokens_per_s=eager["tokens_per_s"],
                per_token_p50_ms=cap["per_token_p50_ms"],
                eager_per_token_p50_ms=eager["per_token_p50_ms"],
                ttft_mean_ms=cap["ttft_mean_ms"],
                eager_ttft_mean_ms=eager["ttft_mean_ms"])


def _eager_check(torch, np, model, cfg, label, reqs, warm=True,
                 run=None, **kw):
    """One eager engine (``aot=False``) on ``model`` serving the same
    prompts as the captured run ``reqs`` (``run(eng)`` -> (e2e, requests);
    a counted run of the eight ragged prompts by default): every token
    equal. Returns (the eager run's e2e, the tokens compared)."""
    eng = _engine(model, aot=False, **kw)
    if warm:
        _warm(eng, cfg, np)
    if run is None:
        e2e, got = _serve_counted(torch, np, eng, cfg, label + " eager",
                                  prompts=[r.prompt for r in reqs])
    else:
        e2e, got = run(eng)
    del eng
    n = _same_tokens(label, reqs, got)
    _log(f"{label}: {n} tokens of the captured engine equal the eager "
         f"engine's")
    return e2e, n


def _decode_split(torch, np, eng, cfg, n_steps=16):
    """Host against device time of a bf16 decode step at bucket 8, by
    CUDA events, over the eight prompts. Each step is run twice:

    * served, as the scheduler runs it: ``upload`` is the host time to
      move the step's inputs to the card (for an eager engine a blocking
      copy; for a captured one a write into pinned memory and a
      non-blocking copy into the bucket graph's inputs), ``issue`` that
      plus the time to launch the step (one graph replay when captured),
      ``step`` the time until its tokens are on the host;
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
    how = "captured" if eng.status()["aot_programs"] else "eager"
    _log(f"decode step bf16 ({how}), "
         f"bucket 8, p50 of {n_steps}: host upload "
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
    if any(s in name for s in ("moe_dispatch_one_kernel", "moe_gate_kernel",
                               "moe_scan_kernel", "moe_scatter_kernel")):
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
                                              key=lambda kv: -kv[1])},
                   moe_kernels=sorted(n for n in by_name if "moe_" in n))
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

    # ---- bf16: the measured runs of the captured engine (the default) ----
    bf16 = copy.deepcopy(model).to(torch.bfloat16)
    eng = _engine(bf16)
    res["serving_bf16_capture"] = _capture_info(eng, "serving bf16")
    _warm(eng, cfg, np)
    runs = []
    for k in range(N_RUNS):
        e2e, reqs = _serve_counted(torch, np, eng, cfg, "serving bf16")
        tokens = [list(r.tokens) for r in reqs]
        runs.append(e2e)
        _log(f"serving bf16 run {k + 1}/{N_RUNS}: " + json.dumps(
            {k: v for k, v in e2e.items() if k != "ttft_ms"}))
        if k == 0:
            bf16_tokens, bf16_reqs = tokens, reqs
        elif tokens != bf16_tokens:
            res["bf16_runs_differ"] = True
            _log(f"serving bf16 run {k + 1}: tokens differ from run 1")
    res["serving_bf16_runs"] = runs
    res["serving_bf16"] = runs[0]
    res["decode_split_bf16"] = _decode_split(torch, np, eng, cfg)
    res["profile_bf16"] = _profile_engine(torch, np, eng, cfg)
    del eng
    # the eager engine on the same prompts: every token equal; its decode
    # step split beside the captured one's
    eager = _engine(bf16, aot=False)
    _warm(eager, cfg, np)
    e2e, got = _serve_counted(torch, np, eager, cfg, "serving bf16 eager")
    n = _same_tokens("serving bf16", bf16_reqs, got)
    res["serving_bf16_eager"] = e2e
    res["serving_bf16_beside_eager"] = dict(
        _beside("serving bf16", runs[0], e2e), tokens_equal=n)
    res["decode_split_bf16_eager"] = _decode_split(torch, np, eager, cfg)
    del eager
    # sampling (temperature 0.8, top-k 40), captured and eager from one
    # seed: every token equal
    sampled = {}
    for aot in (True, False):
        e = _engine(bf16, aot=aot, temperature=0.8, top_k=40, seed=11)
        _, sampled[aot] = _serve_counted(
            torch, np, e, cfg, f"serving bf16 sampled aot={aot}")
        del e
    n = _same_tokens("serving bf16 sampled", sampled[True], sampled[False])
    res["serving_bf16_sampled_tokens_equal"] = n
    _log(f"serving bf16 sampled (temperature 0.8, top-k 40, seed 11): {n} "
         f"tokens of the captured engine equal the eager engine's")
    del bf16, sampled

    # ---- f32: correctness against the plain dense model ------------------
    eng = _engine(model)
    res["serving_f32_capture"] = _capture_info(eng, "serving f32")
    _, reqs = _serve_counted(torch, np, eng, cfg, "serving f32")
    del eng
    checked, near_ties = _check_tokens(torch, np, model, reqs)
    agree = sum(a == b for x, y in zip(bf16_tokens, reqs)
                for a, b in zip(x, y.tokens))
    _, n = _eager_check(torch, np, model, cfg, "serving f32", reqs,
                        warm=False)
    res["serving_f32"] = dict(tokens_checked=checked, near_ties=near_ties,
                              bf16_f32_token_agreement=agree / checked,
                              eager_tokens_equal=n)
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
        out["bf16_capture_" + ("on" if cache else "off")] = _capture_info(
            eng, label)
        _prefix_run(torch, eng, warm, label + " warm-up")
        _stamp(f"{label}: warmed up")
        e2e, reqs = _prefix_run(torch, eng, prompts, label)
        if cache:
            bf16_reqs = reqs
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

    def eager_run(label):
        def run(eng):
            _prefix_run(torch, eng, warm, label + " warm-up")
            return _prefix_run(torch, eng, prompts, label)
        return run
    label = "serving_prefix bf16 cache=on"
    e2e, n = _eager_check(torch, np, bf16, cfg, label, bf16_reqs, warm=False,
                          run=eager_run(label + " eager"),
                          prefill_chunk=CHUNK, prefix_cache=True)
    out["bf16_cache_on_eager"] = e2e
    out["bf16_cache_on_beside_eager"] = dict(
        _beside(label, out["bf16_cache_on"], e2e), tokens_equal=n)
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
    _, n = _eager_check(
        torch, np, model, cfg, "serving_prefix f32 cache=on", reqs[True],
        warm=False, prefill_chunk=CHUNK, prefix_cache=True,
        run=lambda eng: _prefix_run(torch, eng, prompts,
                                    "serving_prefix f32 cache=on eager"))
    out["f32"] = dict(tokens_checked_vs_dense=checked,
                      near_ties_vs_dense=near_off,
                      tokens_compared_on_vs_off=compared,
                      near_ties_on_vs_off=near,
                      eager_tokens_equal=n,
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
    bf16 = copy.deepcopy(model).to(torch.bfloat16)
    eng = _engine(bf16, quantize="int8")
    _stamp("serving_int8 bf16 engine built")
    capture = _capture_info(eng, "serving_int8 bf16")
    _warm(eng, cfg, np)
    _stamp("serving_int8 bf16 warmed up")
    e2e, bf16_reqs = _serve_counted(torch, np, eng, cfg, "serving_int8 bf16")
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
    eager, n = _eager_check(torch, np, bf16, cfg, "serving_int8 bf16",
                            bf16_reqs, quantize="int8")
    beside = dict(_beside("serving_int8 bf16", e2e, eager), tokens_equal=n)
    del bf16
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
    _, n = _eager_check(torch, np, model, cfg, "serving_int8 f32", reqs,
                        warm=False, quantize="int8")
    res["serving_int8"] = dict(bf16=e2e, profile=prof, decode_split=split,
                               capture=capture, bf16_eager=eager,
                               beside_eager=beside,
                               f32=dict(tokens_checked=checked,
                                        near_ties=near,
                                        eager_tokens_equal=n))


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

    def engine(m, aot=None):
        return MoEServingEngine(m, page_size=64, decode_buckets=(1, 2, 4, 8),
                                device="cuda", aot=aot)
    warm_lens = (50, 100, 200, 400, 60, 120, 240, 480)
    out = {}
    bf16 = copy.deepcopy(model).to(torch.bfloat16)
    eng = engine(bf16)
    out["capture"] = _capture_info(eng, "serving_moe bf16")
    _warm(eng, cfg, np, lens=warm_lens)
    _stamp("serving_moe bf16 warmed up")
    e2e, bf16_reqs = _serve_counted(torch, np, eng, cfg, "serving_moe bf16",
                                    prompts=prompts, launches=_moe_launches)
    out["bf16"] = e2e
    _log("serving_moe bf16: " + json.dumps(
        {k: v for k, v in e2e.items() if k != "ttft_ms"}))
    _log("serving_moe bf16, 16 decode steps at bucket 8, profiled:")
    out["profile"] = _profile_engine(torch, np, eng, cfg, prefill=False,
                                     lens=MOE_PROMPT_LENS)
    # the dispatch route of the decode steps (8 tokens), by kernel name
    from paddle_tpu_torch.kernels import moe_dispatch as md
    route = md.dispatch_route(8, cfg.num_experts, cfg.top_k)
    seen = next(iter(out["profile"].values()))["moe_kernels"]
    _log(f"serving_moe bf16 decode at bucket 8: route {route}, MoE kernels "
         f"{seen}")
    other = [k for r, ks in MOE_ROUTE_KERNELS.items() if r != route
             for k in ks]
    if seen and (not all(any(k in n for n in seen)
                         for k in MOE_ROUTE_KERNELS[route])
                 or any(k in n for n in seen for k in other)):
        raise AssertionError(f"the decode steps did not run the {route} "
                             f"dispatch: {seen}")
    del eng
    # the eager engine on the same prompts: every token equal
    eng = engine(bf16, aot=False)
    _warm(eng, cfg, np, lens=warm_lens)
    eager, got = _serve_counted(torch, np, eng, cfg, "serving_moe bf16 eager",
                                prompts=prompts, launches=_moe_launches)
    del eng, bf16
    n = _same_tokens("serving_moe bf16", bf16_reqs, got)
    _log(f"serving_moe bf16: {n} tokens of the captured engine equal the "
         f"eager engine's")
    out["bf16_eager"] = eager
    out["beside_eager"] = dict(_beside("serving_moe bf16", e2e, eager),
                               tokens_equal=n)
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


# ---------------------------------------------------------------- tensor_api

# the facade on the card against the same ops on the CPU, at the CPU
# tests' tolerances: f32 rtol 1e-5 / atol 1e-6 elementwise, 1e-5 / 1e-5
# for matmul, reductions and gradients; bf16 (auto_cast) 1e-2; integer
# results exactly
FACADE_TOL = {"elementwise": (1e-5, 1e-6), "reduction": (1e-5, 1e-5),
              "bfloat16": (1e-2, 1e-2), "exact": (0.0, 0.0)}


def _facade_checks(paddle, np):
    """One pass of the facade checks on the current place: {name: (kind,
    numpy result)}."""
    from paddle_tpu_torch.amp import auto_cast
    from paddle_tpu_torch.autograd import PyLayer

    class Cube(PyLayer):
        @staticmethod
        def forward(ctx, x):
            ctx.save_for_backward(x)
            return x * x * x

        @staticmethod
        def backward(ctx, g):
            (x,) = ctx.saved_tensor()
            return g * 3.0 * x * x

    rng = np.random.default_rng(5)
    x_np = rng.standard_normal((64, 128)).astype(np.float32)
    w_np = (rng.standard_normal((128, 32)) * 0.1).astype(np.float32)
    out = {}
    x = paddle.to_tensor(x_np, stop_gradient=False)
    w = paddle.to_tensor(w_np, stop_gradient=False)
    e = paddle.exp(paddle.tanh(x) * 0.5) + paddle.sqrt(paddle.abs(x) + 1.0)
    out["elementwise"] = ("elementwise", e)
    h = paddle.tanh(paddle.matmul(x, w))
    loss = paddle.mean(paddle.square(h[:, :16]) + Cube.apply(h[:, 16:]))
    loss.backward()
    out.update(loss=("reduction", loss), grad_x=("reduction", x.grad),
               grad_w=("reduction", w.grad))
    (g1,) = paddle.grad(paddle.sum(paddle.sin(x) * x), [x],
                        create_graph=True)
    (g2,) = paddle.grad(paddle.sum(g1 * g1), [x])
    out.update(grad_create_graph=("reduction", g1),
               second_derivative=("reduction", g2))
    vals, idx = paddle.topk(x, 4, axis=1)
    out.update(topk_values=("elementwise", vals), topk_indices=("exact", idx),
               cumsum=("reduction", paddle.cumsum(x, axis=1)),
               gather=("elementwise", paddle.gather(x, paddle.to_tensor(
                   np.array([3, 0, 63])), axis=0)),
               argmax=("exact", paddle.argmax(x, axis=0)))
    with auto_cast(dtype="bfloat16"):
        m = paddle.matmul(x, w)
    if m.dtype != paddle.bfloat16:
        raise AssertionError(f"auto_cast matmul gave {m.dtype}")
    out["auto_cast_matmul"] = ("bfloat16", m.astype("float32"))
    return {k: (kind, t.numpy()) for k, (kind, t) in out.items()}


def phase_tensor_api(torch, np, res):
    """The tensor facade on the card (``import paddle_tpu_torch as
    paddle``) against the same ops on the CPU."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.framework import place as tplace
    prev = tplace._current_place
    try:
        tplace._current_place = None            # the default: the card
        t = paddle.to_tensor([1.0, 2.0])
        if t.place != paddle.CUDAPlace(0) or not t._value.is_cuda:
            raise AssertionError(f"to_tensor landed on {t.place}")
        _log(f"tensor_api: to_tensor with no place -> {t.place} "
             f"({paddle.get_device()})")
        t0 = time.perf_counter()
        card = _facade_checks(paddle, np)
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
        paddle.set_flags({"FLAGS_check_nan_inf": True})
        try:
            paddle.log(paddle.to_tensor([1.0, -1.0]))
        except FloatingPointError as e:
            nan_msg = str(e)
        else:
            raise AssertionError("FLAGS_check_nan_inf did not raise")
        finally:
            paddle.set_flags({"FLAGS_check_nan_inf": False})
        _log(f"tensor_api: FLAGS_check_nan_inf raised: {nan_msg}")
        paddle.set_device("cpu")
        cpu = _facade_checks(paddle, np)
    finally:
        tplace._current_place = prev
    errs = {}
    for name, (kind, got) in card.items():
        want = cpu[name][1]
        rtol, atol = FACADE_TOL[kind]
        err = float(np.max(np.abs(got.astype(np.float64)
                                  - want.astype(np.float64))))
        errs[name] = err
        ok = (np.array_equal(got, want) if kind == "exact" else
              np.allclose(got, want, rtol=rtol, atol=atol))
        _log(f"tensor_api {name}: card vs CPU max |err| {err:.3e} "
             f"({kind}: rtol {rtol}, atol {atol}) {'ok' if ok else 'FAIL'}")
        if not ok or got.dtype != want.dtype:
            raise AssertionError(f"tensor_api {name}: card and CPU differ")
    res["tensor_api"] = dict(max_abs_err=errs, card_pass_s=card_s,
                             nan_check=nan_msg)


# ---------------------------------------------------------------- checkpoint

CKPT_MAX_NEW = 16     # new tokens a request in the checkpoint phase


def _ckpt_serve(torch, np, eng, cfg, label, prompts, launches):
    """A counted scheduler run of ``prompts`` (``CKPT_MAX_NEW`` new tokens
    each); returns (tokens per request, launch counts)."""
    e2e, reqs = _serve_counted(torch, np, eng, cfg, label, prompts=prompts,
                               launches=launches, max_new=CKPT_MAX_NEW)
    return [list(r.tokens) for r in reqs], e2e["launches"]


def _first_token_ms(torch, np, eng, prompt):
    """The first token of one request on a fresh engine: submit to the
    sampled token on the host (ms)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tok = eng.prefill("first", prompt)
    int(tok)
    ms = (time.perf_counter() - t0) * 1e3
    eng.release("first")
    return ms


def _ckpt_save(torch, tmp, label, obj, time_load=True):
    """``paddle.save`` of ``obj`` under ``tmp``, timed, and (with
    ``time_load``) one ``paddle.load`` of it, timed. Returns (path, dict
    of the numbers)."""
    import paddle_tpu_torch as paddle
    path = os.path.join(tmp, f"{label}.pdparams")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    paddle.save(obj, path)
    info = dict(save_s=time.perf_counter() - t0,
                checkpoint_bytes=os.path.getsize(path))
    if time_load:
        t0 = time.perf_counter()
        paddle.load(path, return_numpy=True)
        info["load_s"] = time.perf_counter() - t0
    return path, info


def _ckpt_case(torch, np, res, label, path, saved, build, reference, cfg,
               prompts, launches):
    """An engine from the checkpoint at ``path`` (``build(path)``, the
    engine's ``from_checkpoint``): its build time, the time of its first
    token, and its greedy tokens on ``prompts`` held to ``reference``'s
    (an engine built from the model in memory), launches counted."""
    t0 = time.perf_counter()
    eng = build(path)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    first_ms = _first_token_ms(torch, np, eng, prompts[0])
    got, counts = _ckpt_serve(torch, np, eng, cfg, f"checkpoint {label}",
                              prompts, launches)
    capture_s = eng.compile_s
    del eng
    want, _ = _ckpt_serve(torch, np, reference, cfg,
                          f"checkpoint {label} in memory", prompts, launches)
    n = sum(len(t) for t in got)
    if got != want:
        bad = next(i for i, (a, b) in enumerate(zip(got, want)) if a != b)
        raise AssertionError(f"checkpoint {label}: request {bad} tokens "
                             f"{got[bad]} vs the in-memory engine's "
                             f"{want[bad]}")
    out = dict(saved, from_checkpoint_s=build_s, capture_s=capture_s,
               first_token_ms=first_ms,
               load_to_first_token_s=build_s + first_ms / 1e3,
               tokens_equal=n, launches=counts)
    io = ", ".join(f"{k[:-2]} {v:.2f} s" for k, v in saved.items()
                   if k.endswith("_s"))
    _log(f"checkpoint {label} [{res.get('nvidia_smi')}]: "
         f"{io + ', ' if io else ''}"
         + (f"{saved['checkpoint_bytes']} bytes, " if saved
            else "the gpt_full file, ") +
         f"from_checkpoint {build_s:.2f} s (capture {capture_s:.2f} s), "
         f"first token {first_ms:.2f} ms after it; {n} greedy tokens equal "
         f"the in-memory engine's; launches {counts}")
    return out


def phase_checkpoint(torch, np, res):
    """GPT-345M and ERNIE-MoE base served from a ``paddle.save``d state
    through the engines' ``from_checkpoint`` (f32, captured), against
    engines built from the same models in memory."""
    from paddle_tpu_torch.models.ernie import (ErnieMoeForPretraining,
                                               ErnieMoeModel,
                                               ernie_moe_base_config)
    from paddle_tpu_torch.serving import MoEServingEngine, ServingEngine
    out = {}
    model, cfg = _model_345m(torch)
    prompts = _prompts(cfg, np)
    kw = dict(page_size=64, decode_buckets=(1, 2, 4, 8),
              prefill_buckets=(256, 512, 1024), device="cuda")
    with tempfile.TemporaryDirectory() as tmp:
        full, saved = _ckpt_save(torch, tmp, "gpt_full", model.state_dict())
        bare, saved_bare = _ckpt_save(torch, tmp, "gpt_bare",
                                      model.gpt.state_dict(),
                                      time_load=False)
        ref = _engine(model)
        out["gpt_full"] = _ckpt_case(
            torch, np, res, "gpt_full", full, saved,
            lambda p: ServingEngine.from_checkpoint(p, cfg, **kw), ref, cfg,
            prompts, _gpt_launches)
        out["gpt_bare"] = _ckpt_case(
            torch, np, res, "gpt_bare", bare, saved_bare,
            lambda p: ServingEngine.from_checkpoint(p, cfg, **kw), ref, cfg,
            prompts, _gpt_launches)
        del ref
        os.unlink(bare)
        ref = _engine(model, quantize="int8")
        out["gpt_int8"] = _ckpt_case(     # from the gpt_full file
            torch, np, res, "gpt_int8", full, {},
            lambda p: ServingEngine.from_checkpoint(p, cfg, quantize="int8",
                                                    **kw),
            ref, cfg, prompts, _gpt_launches)
        del ref, model
        os.unlink(full)
        _stamp("checkpoint gpt done")
        mcfg = ernie_moe_base_config(capacity_factor=100.0)
        moe = ErnieMoeForPretraining(ErnieMoeModel(mcfg, seed=0,
                                                   device="cuda")).eval()
        rng = np.random.default_rng(11)
        mprompts = [rng.integers(0, mcfg.vocab_size, (n,)).astype(np.int32)
                    for n in MOE_PROMPT_LENS]
        mkw = dict(page_size=64, decode_buckets=(1, 2, 4, 8), device="cuda")
        path, saved = _ckpt_save(torch, tmp, "moe", moe.state_dict())
        ref = MoEServingEngine(moe, **mkw)
        out["moe"] = _ckpt_case(
            torch, np, res, "moe", path, saved,
            lambda p: MoEServingEngine.from_checkpoint(p, mcfg, **mkw),
            ref, mcfg, mprompts, _moe_launches)
        del ref, moe
    res["checkpoint"] = out


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


def _masters(torch, step):
    """A copy of the step's masters, by name."""
    from paddle_tpu_torch.models.gpt import _tree_items
    return {".".join(k): v.detach().clone()
            for k, v in _tree_items(step.params)}


def _train_steps(torch, step, ids, labels, n):
    """``n`` steps: each loss, the wall time of each step to its loss on
    the host, and the host time of each call alone (staging and launch on
    a captured step)."""
    losses, walls, issues = [], [], []
    for _ in range(n):
        t0 = time.perf_counter()
        loss = step(ids, labels)
        t1 = time.perf_counter()
        losses.append(loss.item())
        walls.append(time.perf_counter() - t0)
        issues.append(t1 - t0)
    return losses, walls, issues


def _train_main(torch, np, res):
    """The training main path at GPT-345M width, bf16, remat "dots": the
    eager step's first steps as the yardstick, then the captured step."""
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.models.gpt import (
        GPTForPretraining, GPTHybridTrainStep, GPTModel, _eager_step,
        gpt_345m_config, model_flops_per_token)
    cfg = gpt_345m_config(max_position_embeddings=1024, num_heads=8)
    model = GPTForPretraining(GPTModel(cfg, seed=0, device="cuda"))
    make = lambda: GPTHybridTrainStep(  # noqa: E731
        model, cfg, None, n_micro=1, lr=1e-4, remat="dots",
        compute_dtype="bfloat16")
    rng = np.random.default_rng(0)
    ids = rng.integers(0, cfg.vocab_size, (TRAIN_B, TRAIN_S)).astype(
        np.int32)
    labels = np.roll(ids, -1, axis=1).astype(np.int32)
    _log(f"training: GPT-345M layers={cfg.num_layers} hidden="
         f"{cfg.hidden_size} heads={cfg.num_heads}x{cfg.head_dim} vocab="
         f"{cfg.vocab_size}, B={TRAIN_B} S={TRAIN_S}, bf16 compute, f32 "
         f"masters and moments, remat='dots', AdamW lr=1e-4")

    # the eager step: GRAPH_CHECK_STEPS steps, its masters kept, then freed
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with _eager_step():
        eager = make()
        e_losses, e_walls, e_issues = _train_steps(torch, eager, ids, labels,
                                                   GRAPH_CHECK_STEPS)
    e_peak = torch.cuda.max_memory_allocated()
    e_masters = _masters(torch, eager)
    del eager
    torch.cuda.empty_cache()
    eager_row = dict(losses=e_losses, step_ms=[t * 1e3 for t in e_walls],
                     step_p50_ms=_pct(e_walls[1:], 0.5) * 1e3,
                     host_issue_p50_ms=_pct(e_issues[1:], 0.5) * 1e3,
                     max_memory_allocated_bytes=e_peak)
    _log(f"training eager, {GRAPH_CHECK_STEPS} steps: step p50 "
         f"{eager_row['step_p50_ms']:.2f} ms (first "
         f"{eager_row['step_ms'][0]:.2f}), host issue p50 "
         f"{eager_row['host_issue_p50_ms']:.2f} ms, peak memory {e_peak} "
         f"bytes")

    # the captured step from the same weights: the first call runs the
    # step and captures it, the rest replay; held against the eager run
    torch.cuda.reset_peak_memory_stats()
    step = make()
    c_losses, c_walls, _ = _train_steps(torch, step, ids, labels,
                                        GRAPH_CHECK_STEPS)
    diff = max((v.float() - e_masters[k].float()).abs().max().item()
               for k, v in _masters(torch, step).items())
    del e_masters
    same = c_losses == e_losses and diff == 0.0
    graph = dict(first_call_ms=c_walls[0] * 1e3, capture_s=step.capture_s,
                 graphs=len(step.captured_shapes),
                 pool_bytes=step.graph_pool_bytes(),
                 eager_first_step_ms=e_walls[0] * 1e3,
                 losses=c_losses, max_abs_master_diff=diff,
                 equal_to_eager=same)
    _log(f"training captured: first call (one step + capture) "
         f"{graph['first_call_ms']:.2f} ms, of which capture "
         f"{step.capture_s * 1e3:.2f} ms (the eager step's first: "
         f"{graph['eager_first_step_ms']:.2f} ms); graphs "
         f"{graph['graphs']}, pool {graph['pool_bytes']} bytes")
    _log(f"training captured vs eager over {GRAPH_CHECK_STEPS} steps: "
         f"losses {c_losses} vs {e_losses}; masters max |diff| {diff:.3e}: "
         f"{'bit-equal' if same else 'DIFFER'}")
    res["training_graph"] = graph
    res["training_eager"] = eager_row
    if not same:
        raise AssertionError("captured training step differs from eager")

    fa.launches = fa.dq_launches = fa.dkv_launches = 0
    times, per_step, issues, losses = [], [], [], []
    for _ in range(TIMED_STEPS):
        c0 = _flash_counts()
        got = _train_steps(torch, step, ids, labels, 1)
        losses += got[0]
        times += got[1]
        issues += got[2]
        per_step.append([b - a for a, b in zip(c0, _flash_counts())])
    counts = _flash_counts()
    peak = torch.cuda.max_memory_allocated()
    losses = e_losses + losses
    L = cfg.num_layers
    want = [2 * L, L, L]     # forward + recompute under "dots"; dQ; dK/dV
    tokens_per_s = TRAIN_B * TRAIN_S * TIMED_STEPS / sum(times)
    fpt = model_flops_per_token(cfg, TRAIN_S)[0]
    e2e = dict(tokens_per_s=tokens_per_s,
               step_p50_ms=_pct(times, 0.5) * 1e3,
               step_ms=[t * 1e3 for t in times],
               host_issue_p50_ms=_pct(issues, 0.5) * 1e3,
               host_issue_ms=[t * 1e3 for t in issues],
               mfu=tokens_per_s * fpt / PEAK_FLOPS["bfloat16"],
               flops_per_token=fpt,
               max_memory_allocated_bytes=peak, losses=losses,
               launches_per_step=per_step,
               launches=dict(zip(("flash_fwd", "flash_bwd_dq",
                                  "flash_bwd_dkv"), counts)))
    _log(f"training bf16 captured, {TIMED_STEPS} timed steps after "
         f"{GRAPH_CHECK_STEPS}: {tokens_per_s:.1f} tokens/s, step p50 "
         f"{e2e['step_p50_ms']:.2f} ms (steps "
         f"{', '.join(f'{t:.2f}' for t in e2e['step_ms'])} ms), host "
         f"stage + launch p50 {e2e['host_issue_p50_ms']:.3f} ms, MFU "
         f"{e2e['mfu']:.4f} of {PEAK_FLOPS['bfloat16']:.3g} FLOP/s "
         f"({fpt:.4g} FLOP/token), peak memory {peak} bytes (eager "
         f"{e_peak}); on {res.get('nvidia_smi')}")
    _log(f"training losses (eager {GRAPH_CHECK_STEPS}, then the timed "
         f"captured steps): {', '.join(f'{x:.6f}' for x in losses)}")
    _log(f"training flash launches per step (fwd, dq, dkv): {per_step}; "
         f"want {want} each")
    res["training_bf16"] = e2e
    if any(c != want for c in per_step):
        raise AssertionError(f"launches per step {per_step}, want {want}")
    if not all(math.isfinite(x) for x in losses) or losses[-1] >= losses[0]:
        raise AssertionError(f"losses not finite or not falling: {losses}")

    # where a captured step's time goes: the host's staging and launch
    # against the device's work between two events around the call
    ev = lambda: torch.cuda.Event(enable_timing=True)    # noqa: E731
    e0, e1 = ev(), ev()
    torch.cuda.synchronize()
    e0.record()
    t0 = time.perf_counter()
    loss = step(ids, labels)
    t1 = time.perf_counter()
    e1.record()
    e1.synchronize()
    t2 = time.perf_counter()
    del loss
    split = dict(captured_device_ms=e0.elapsed_time(e1),
                 captured_host_issue_ms=(t1 - t0) * 1e3,
                 captured_wall_ms=(t2 - t0) * 1e3)
    # and the eager step's: forward + backward against AdamW (CUDA events)
    e0, e1, e2 = ev(), ev(), ev()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    e0.record()
    _, grads = step._loss_and_grads(*step._inputs(ids, labels))
    e1.record()
    t1 = time.perf_counter()
    step._t += 1
    step._adamw(grads, *step._scalars(1e-4, step._t))
    e2.record()
    e2.synchronize()
    t2 = time.perf_counter()
    split.update(fwd_bwd_device_ms=e0.elapsed_time(e1),
                 adamw_device_ms=e1.elapsed_time(e2),
                 fwd_bwd_host_issue_ms=(t1 - t0) * 1e3,
                 step_wall_ms=(t2 - t0) * 1e3)
    del grads
    _log(f"training captured step (CUDA events around one call): device "
         f"{split['captured_device_ms']:.2f} ms, host stage + launch "
         f"{split['captured_host_issue_ms']:.3f} ms, wall "
         f"{split['captured_wall_ms']:.2f} ms")
    _log(f"training eager step split (CUDA events): forward + backward "
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
        _log(f"profile one captured training step: wall {wall * 1e3:.2f} "
             f"ms, device busy {busy_us / 1e3:.2f} ms (share "
             f"{split['busy_share']:.3f}); "
             + ", ".join(f"{g} {ms:.3f} ms" for g, ms in
                         split["device_ms_by_group"].items()))
        for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]:
            _log(f"  {us / 1e3:9.3f} ms  {name[:100]}")
    else:
        _log("profile one captured training step: device time not measured "
             "(the profiler saw no CUDA activity)")


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


# ----------------------------------------------------------------- phase 5

def _moe_model(torch, seed, **kw):
    """``ErnieMoeForPretraining`` at ``ernie_moe_base_config(**kw)`` on the
    card, f32 parameters from ``seed``, in training mode."""
    from paddle_tpu_torch.models.ernie import (
        ErnieMoeForPretraining, ErnieMoeModel, ernie_moe_base_config)
    cfg = ernie_moe_base_config(**kw)
    return ErnieMoeForPretraining(ErnieMoeModel(cfg, seed=seed,
                                                device="cuda")).train()


def _no_random_routing(model):
    from paddle_tpu_torch.incubate.distributed.models.moe import GShardGate
    for m in model.modules():
        if isinstance(m, GShardGate):
            m.random_routing = False


def _moe_paths(model):
    """The path each MoE layer takes in training, and why."""
    out = {}
    for i, blk in enumerate(model.ernie.layers):
        moe = getattr(blk, "moe", None)
        if moe is None:
            continue
        kind = moe._fused_gate_kind() if moe.fused_dispatch else None
        out[f"layer {i}"] = (
            f"fused ({kind})" if kind else
            "gather (fused_dispatch=False)" if not moe.fused_dispatch else
            "gather (the gate draws random numbers in training)")
    return out


def _moe_np_batch(np, cfg, b=MOE_TRAIN_B, seed=0):
    """ids and labels in [0, V), as bench_ernie_moe draws them, as numpy
    arrays."""
    rng = np.random.default_rng(seed)
    return tuple(rng.integers(0, cfg.vocab_size, (b, MOE_TRAIN_S))
                 .astype(np.int64) for _ in range(2))


def _moe_batch(torch, np, cfg, b, seed):
    """ids and labels in [0, V), as bench_ernie_moe draws them, on the
    card."""
    return tuple(torch.from_numpy(a).cuda()
                 for a in _moe_np_batch(np, cfg, b, seed))


def _moe_step(torch, model, opt, ids, labels, bf16):
    """One dygraph step as a user writes it: the loss under ``auto_cast``
    (bf16 when ``bf16``), backward, AdamW, clear the gradients."""
    from paddle_tpu_torch.amp import auto_cast
    with auto_cast(enable=bf16, dtype="bfloat16"):
        loss = model.forward_with_mlm_loss(ids, labels)
    loss.backward()
    opt.step()
    opt.clear_grad()
    return loss.detach()


def _moe_flops_per_token(cfg, S):
    """Model FLOPs of one trained token: 3 times the forward's (the
    backward twice the forward). The forward: 2 FLOPs for every weight a
    token meets (q, k, v and out projections, the dense FFNs, the top_k
    experts and the gate of each MoE layer, the head's transform and tied
    decoder; not the embedding lookups, capacity padding or dropped
    choices) and 4 S H a layer for attention (S^T and P V over S keys)."""
    H, F, L = cfg.hidden_size, cfg.intermediate_size, cfg.num_hidden_layers
    n_moe = sum(1 for i in range(L)
                if cfg.moe_every and (i + 1) % cfg.moe_every == 0)
    weights = (4 * H * H * L + 2 * H * F * (L - n_moe)
               + n_moe * (cfg.top_k * 2 * H * F + H * cfg.num_experts)
               + H * H + H * cfg.vocab_size)
    return 3 * (2 * weights + 4 * S * H * L)


def _syncs_in(torch, fn):
    """Host waits on the device inside one call of ``fn``, by
    ``torch.cuda.set_sync_debug_mode("warn")``."""
    import warnings
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return [str(w.message)[:120] for w in seen
            if "called a synchronizing" in str(w.message)]


def _moe_train_main(torch, np, res):
    """(a) bench_ernie_moe's step in the port at full width: 2 warm-up and
    10 timed dygraph steps, bf16 O1, AdamW."""
    from paddle_tpu_torch.amp import auto_cast
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.optimizer import AdamW
    model = _moe_model(torch, 0)
    cfg = model.config
    B, S, L = MOE_TRAIN_B, MOE_TRAIN_S, cfg.num_hidden_layers
    opt = AdamW(learning_rate=1e-4, parameters=model.parameters())
    ids, labels = _moe_batch(torch, np, cfg, B, 0)
    n_params = sum(p.numel() for p in model.parameters())
    paths = _moe_paths(model)
    _log(f"training_moe (a): ErnieMoeForPretraining at ernie_moe_base_config"
         f"(): layers={L} hidden={cfg.hidden_size} heads="
         f"{cfg.num_attention_heads}x{cfg.head_dim} ffn="
         f"{cfg.intermediate_size} experts={cfg.num_experts} top-"
         f"{cfg.top_k} every {cfg.moe_every} vocab={cfg.vocab_size}, "
         f"{n_params} parameters (f32), B={B} S={S}, auto_cast bf16 (O1), "
         f"AdamW lr=1e-4; MoE paths {paths}")
    step = lambda: _moe_step(torch, model, opt, ids, labels, True)  # noqa: E731
    for _ in range(MOE_TRAIN_WARMUP):
        step()
    syncs = _syncs_in(torch, step)
    _log(f"training_moe (a): host waits on the device inside a step: "
         f"{len(syncs)} {syncs[:3]}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ev = lambda: torch.cuda.Event(enable_timing=True)    # noqa: E731
    losses, walls, issues, spans, per_step = [], [], [], [], []
    _zero_counts()
    for _ in range(MOE_TRAIN_STEPS):
        c0 = _counts()
        e0, e1 = ev(), ev()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        e0.record()
        loss = step()
        t1 = time.perf_counter()
        e1.record()
        e1.synchronize()
        walls.append(time.perf_counter() - t0)
        issues.append(t1 - t0)
        spans.append(e0.elapsed_time(e1))
        losses.append(loss.item())
        per_step.append({k: v - c0[k] for k, v in _counts().items()})
    counts = _counts()
    peak = torch.cuda.max_memory_allocated()
    want = dict(flash=L, flash_bwd_dq=L, flash_bwd_dkv=L)
    for i, got in enumerate(per_step):
        _check_counts(f"training_moe (a) step {i}", got, want)
    if not all(math.isfinite(x) for x in losses) or losses[-1] >= losses[0]:
        raise AssertionError(f"training_moe losses not finite or not "
                             f"falling: {losses}")
    fpt = _moe_flops_per_token(cfg, S)
    tokens_per_s = B * S * MOE_TRAIN_STEPS / sum(walls)
    issue_p50 = _pct(issues, 0.5) * 1e3
    wall, by_name = _device_time(torch, step)
    groups = _group_times(by_name)
    busy_us = sum(by_name.values())
    e2e = dict(tokens_per_s=tokens_per_s, step_p50_ms=_pct(walls, 0.5) * 1e3,
               step_ms=[t * 1e3 for t in walls], host_issue_p50_ms=issue_p50,
               host_issue_ms=[t * 1e3 for t in issues],
               device_span_p50_ms=_pct(spans, 0.5),
               host_syncs_in_step=len(syncs),
               mfu=tokens_per_s * fpt / PEAK_FLOPS["bfloat16"],
               flops_per_token=fpt, n_params=n_params,
               max_memory_allocated_bytes=peak, losses=losses,
               launches=counts, launches_per_step=per_step[0],
               moe_paths=paths, profiled_wall_ms=wall * 1e3,
               profiled_device_ms=busy_us / 1e3 if by_name else None,
               busy_share=busy_us / 1e6 / wall if by_name else None,
               device_ms_by_group={g: us / 1e3 for g, us in sorted(
                   groups.items(), key=lambda kv: -kv[1])})
    _log(f"training_moe (a) bf16 O1, {MOE_TRAIN_STEPS} timed steps after "
         f"{MOE_TRAIN_WARMUP}: {tokens_per_s:.1f} tokens/s, step p50 "
         f"{e2e['step_p50_ms']:.2f} ms (steps "
         f"{', '.join(f'{t * 1e3:.2f}' for t in walls)} ms), host issue "
         f"p50 {issue_p50:.2f} ms, device span between events p50 "
         f"{e2e['device_span_p50_ms']:.2f} ms; MFU {e2e['mfu']:.4f} of {PEAK_FLOPS['bfloat16']:.3g} FLOP/s "
         f"({fpt:.4g} FLOP/token: 3 x (2 x the weights a token meets, top-"
         f"{cfg.top_k} experts, + 4 S H per layer)); peak memory {peak} "
         f"bytes; on {res.get('nvidia_smi')}")
    _log(f"training_moe (a) losses: {', '.join(f'{x:.6f}' for x in losses)}")
    _log(f"training_moe (a) launches per step {per_step[0]}, want {want}; "
         f"in all {counts}")
    if by_name:
        _log(f"profile one training_moe step: wall {wall * 1e3:.2f} ms, "
             f"device busy {busy_us / 1e3:.2f} ms (share "
             f"{e2e['busy_share']:.3f}); " + ", ".join(
                 f"{g} {ms:.3f} ms"
                 for g, ms in e2e["device_ms_by_group"].items()))
        for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:12]:
            _log(f"  {us / 1e3:9.3f} ms  {name[:100]}")
    else:
        _log("profile one training_moe step: device time not measured (the "
             "profiler saw no CUDA activity)")
    # the route of each attention pass on the model's own q/k/v, by the
    # kernel nodes of a graph of one call
    attn = model.ernie.layers[0].inner.self_attn
    split = lambda t: t.reshape(B, S, cfg.num_attention_heads,  # noqa: E731
                                cfg.head_dim)
    with torch.no_grad(), auto_cast(dtype="bfloat16"):
        x = model.ernie.embeddings(ids)
        q, k, v = (split(p(x)) for p in (attn.q_proj, attn.k_proj,
                                         attn.v_proj))
    route = fa.kernel_route(q, k, v)
    o, lse = fa.flash_attention_fwd(q, k, v)
    do = torch.randn_like(o)
    names = dict(
        fwd=_kernel_names(torch, lambda: fa.flash_attention_fwd(q, k, v)),
        bwd=_kernel_names(torch, lambda: fa.flash_attention_bwd(
            q, k, v, o, lse, do)))
    ran = {p: [n for n in ns if "flash_" in n] for p, ns in names.items()}
    _log(f"training_moe attention on layer 0's q/k/v {tuple(q.shape)} "
         f"{q.dtype} ({route} route): forward {ran['fwd']}; backward "
         f"{ran['bwd']}")
    want_names = (FLASH_FWD_KERNELS["wgmma"], "flash_bwd_dq_tc_kernel",
                  FLASH_DKV_KERNELS["wgmma"])
    if route != "wgmma" or len(ran["fwd"]) != 1 or len(ran["bwd"]) != 2 \
            or want_names[0] not in ran["fwd"][0] \
            or not all(any(w in n for n in ran["bwd"])
                       for w in want_names[1:]):
        raise AssertionError(f"training_moe attention did not run "
                             f"{want_names}: {ran}")
    e2e["attention_kernels"] = dict(route=route, **ran)
    res["training_moe_bf16"] = e2e


def _leaf_rel_err(got, ref):
    """The leaves of two ``{name: gradient}`` dicts by |a - b| / |b|
    (norms), worst first, as ``[(error, name), ...]``. A key projection's
    bias has a gradient of 0 in exact arithmetic (the softmax ignores a
    constant added to a row), so both sides hold rounding noise there: its
    |a - b| is taken over the norm of all the leaves instead."""
    total = math.sqrt(sum(r.float().square().sum().item()
                          for r in ref.values()))
    errs = []
    for key, r in ref.items():
        r = r.float()
        den = total if key.endswith("k_proj.bias") else r.norm().item()
        rel = (got[key].float() - r).norm().item() / max(den, 1e-30)
        errs.append((rel if math.isfinite(rel) else math.inf, key))
    return sorted(errs, reverse=True)


def _moe_fused_check(torch, np, res):
    """(b) The fused MoE dispatch and combine in training against the
    gather path: f32, 3 steps each from the same weights."""
    from paddle_tpu_torch.optimizer import AdamW
    runs = {}
    for name, fused in (("gather", False), ("fused", True)):
        model = _moe_model(torch, 1, fused_dispatch=fused)
        _no_random_routing(model)
        cfg, L = model.config, model.config.num_hidden_layers
        ids, labels = _moe_batch(torch, np, cfg, MOE_TRAIN_B, 1)
        opt = AdamW(learning_rate=1e-4, parameters=model.parameters())
        paths = _moe_paths(model)
        losses, per_step = [], []
        _zero_counts()
        for i in range(MOE_FUSED_STEPS):
            c0 = _counts()
            loss = model.forward_with_mlm_loss(ids, labels)
            loss.backward()
            if i == 0:
                grads = {n: p.grad.detach().clone()
                         for n, p in model.named_parameters()
                         if p.grad is not None}
            opt.step()
            opt.clear_grad()
            if i == 0:
                params = {n: p.detach().clone()
                          for n, p in model.named_parameters()}
            losses.append(loss.item())
            per_step.append({k: v - c0[k] for k, v in _counts().items()})
        runs[name] = dict(losses=losses, grads=grads, params=params,
                          launches=_counts(), per_step=per_step, paths=paths)
        n_moe = sum(1 for p in paths.values() if p.startswith("fused"))
        want = dict(flash=L, flash_bwd_dq=L, flash_bwd_dkv=L)
        if fused:
            if n_moe != L // cfg.moe_every:
                raise AssertionError(f"not every MoE layer fused: {paths}")
            want.update(moe_dispatch=n_moe, moe_combine=n_moe)
        for i, got in enumerate(per_step):
            _check_counts(f"training_moe (b) {name} step {i}", got, want)
        _log(f"training_moe (b) {name}, f32, random routing off: MoE paths "
             f"{paths}; losses {losses}; launches per step {per_step[0]}")
        del model, opt
        torch.cuda.empty_cache()
    f, g = runs["fused"], runs["gather"]
    dloss = max(abs(a - b) for a, b in zip(f["losses"], g["losses"]))
    errs = _leaf_rel_err(f["grads"], g["grads"])
    worst, where = errs[0]
    pdiff = max((f["params"][k] - v).abs().max().item()
                for k, v in g["params"].items())
    tol = GRAD_REL_TOL["kernel_vs_plain"]
    ok = dloss <= TRAIN_LOSS_TOL and worst <= tol and pdiff <= MOE_PARAM_TOL
    out = dict(losses_fused=f["losses"], losses_gather=g["losses"],
               loss_abs_err=dloss, grad_rel_err=worst, worst_leaf=where,
               worst_leaves=errs[:4],
               param_max_abs_diff_step1=pdiff, launches=f["launches"],
               launches_per_step=f["per_step"][0], moe_paths=f["paths"],
               gather_paths=g["paths"])
    _log(f"training_moe (b) fused vs gather, f32, {MOE_FUSED_STEPS} steps: "
         f"losses max diff {dloss:.3e} (tol {TRAIN_LOSS_TOL:g}); first-step "
         f"gradients max |a-b|/|b| {worst:.3e} ({where}; tol {tol:g}; "
         f"then " + ", ".join(f"{k} {e:.2e}" for e, k in errs[1:4])
         + f"); parameters after step 1 max |diff| {pdiff:.3e} (tol "
         f"{MOE_PARAM_TOL:g}) {'ok' if ok else 'FAIL'}")
    res["training_moe_fused"] = out
    if not ok:
        raise AssertionError("fused MoE training disagrees with the gather "
                             "path")


@contextlib.contextmanager
def _plain_kernels():
    """Inside, the flash forward and backward and the MoE dispatch and
    combine wrappers run their plain versions on the CUDA tensors they are
    given (the model and its autograd Functions unchanged): the same model
    with every kernel on its plain version."""
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.kernels import moe_dispatch as md
    saved = (fa.flash_attention_fwd, fa.flash_attention_bwd, md._dispatch,
             md._combine)
    fa.flash_attention_fwd = fa.flash_attention_reference
    fa.flash_attention_bwd = fa.flash_attention_bwd_reference
    md._dispatch = lambda x, gw, gb, E, C, K, kind: \
        md.reference_moe_dispatch(x, gw, gb, num_expert=E, capacity=C,
                                  top_k=K, gate_kind=kind)
    md._combine = md.combine_kernel_reference
    try:
        yield
    finally:
        (fa.flash_attention_fwd, fa.flash_attention_bwd, md._dispatch,
         md._combine) = saved


def _moe_kernel_vs_plain(torch, np, res):
    """(c) 2 layers (one dense, one MoE with the fused kernels), base
    widths, B = 2, S = 512: the loss and every gradient with the kernels
    against the same model with every kernel on its plain version, f32 and
    bf16 under auto_cast."""
    from paddle_tpu_torch.amp import auto_cast
    base = _moe_model(torch, 2, num_hidden_layers=2, fused_dispatch=True)
    _no_random_routing(base)
    ids, labels = _moe_batch(torch, np, base.config, MOE_KVP_B, 2)
    runs, out = {}, {}
    for dt in ("float32", "bfloat16"):
        for which in ("kernel", "plain"):
            model = copy.deepcopy(base)
            ctx = _plain_kernels if which == "plain" else contextlib.nullcontext
            _zero_counts()
            with ctx():
                with auto_cast(enable=dt == "bfloat16", dtype="bfloat16"):
                    loss = model.forward_with_mlm_loss(ids, labels)
                loss.backward()
            counts = _counts()
            want = {} if which == "plain" else dict(
                flash=2, flash_bwd_dq=2, flash_bwd_dkv=2, moe_dispatch=1,
                moe_combine=1)
            _check_counts(f"training_moe (c) {dt} {which}", counts, want)
            runs[dt, which] = (loss.item(), {
                n: p.grad for n, p in model.named_parameters()
                if p.grad is not None})
            del model
        grad_tol, loss_tol = MOE_KVP_TOL[dt]
        (lk, gk), (lp, gp) = runs[dt, "kernel"], runs[dt, "plain"]
        errs = _leaf_rel_err(gk, gp)
        worst, where = errs[0]
        ok = abs(lk - lp) <= loss_tol and worst <= grad_tol
        out[dt] = dict(loss_kernel=lk, loss_plain=lp,
                       loss_abs_err=abs(lk - lp), grad_rel_err=worst,
                       worst_leaf=where, worst_leaves=errs[:4], ok=ok)
        _log(f"training_moe (c) 2 layers B={MOE_KVP_B} S={MOE_TRAIN_S} "
             f"{dt}, kernels vs plain versions: loss {lk:.6f} vs {lp:.6f} "
             f"(|diff| {abs(lk - lp):.3e}, tol {loss_tol:g}); gradients "
             f"max |a-b|/|b| {worst:.3e} ({where}; tol {grad_tol:g}; then "
             + ", ".join(f"{k} {e:.2e}" for e, k in errs[1:4])
             + f") {'ok' if ok else 'FAIL'}")
    # the scale bf16 itself sets: the plain model in bf16 against f32
    (_, g16), (_, g32) = runs["bfloat16", "plain"], runs["float32", "plain"]
    out["bf16_vs_f32_plain_grad_rel"] = _leaf_rel_err(g16, g32)[0][0]
    _log(f"training_moe (c) for scale, the plain model bf16 vs f32: "
         f"gradients max |a-b|/|b| {out['bf16_vs_f32_plain_grad_rel']:.3e}")
    res["training_moe_kernel_vs_plain"] = out
    if not all(out[dt]["ok"] for dt in ("float32", "bfloat16")):
        raise AssertionError("training_moe kernels disagree with their plain "
                             "versions")


def _flash_bwd_seed_stats(torch, fa, shape, causal, fused, seeds=6):
    """dq, dk and dv of the bf16 kernels against the plain backward over
    seeds 0..5 (the inputs of tools/torch_flash_bwd_stats.py where
    ``fused``: the q/k/v views of one [B, S, 3, N, D] tensor): per seed,
    each gradient's largest error and rms error against the limits."""
    b, s, n, d = shape
    elem_tol, rms_tol = GRAD_TOL["flash_bwd", "bfloat16"]
    rows = []
    for seed in range(seeds):
        gen = torch.Generator(device="cuda").manual_seed(seed)
        randn = lambda *sh: torch.randn(*sh, device="cuda",  # noqa: E731
                                        generator=gen).to(torch.bfloat16)
        if fused:
            q, k, v = randn(b, s, 3, n, d).unbind(2)
        else:
            q, k, v = (randn(b, s, n, d) for _ in range(3))
        do = randn(b, s, n, d)
        o, lse = fa.flash_attention_fwd(q, k, v, causal)
        got = fa.flash_attention_bwd(q, k, v, o, lse, do, causal)
        refs = fa.flash_attention_bwd_reference(q, k, v, o, lse, do, causal)
        _, delta = fa._launch_dq(q, k, v, o, lse, do, causal,
                                 1.0 / math.sqrt(d), 0)
        row = dict(delta_bit_equal=bool(torch.equal(
            delta, (do.float() * o.float()).sum(-1).transpose(1, 2))))
        for name, g, r in zip(("dq", "dk", "dv"), got, refs):
            err, elem, rms, _ = _grad_err(g, r)
            abs_tol = TOL["flash_bwd", "bfloat16"] * max(
                1.0, r.float().abs().max().item())
            row[name] = dict(max_abs_err=err, elementwise=elem, rms=rms,
                             elem_over=elem > elem_tol,
                             within_abs_and_rms=err <= abs_tol
                             and rms <= rms_tol)
        rows.append(row)
        del got, refs, o, lse
    over = {g: sum(r[g]["elem_over"] for r in rows) for g in ("dq", "dk",
                                                               "dv")}
    over["delta_not_bit_equal"] = sum(not r["delta_bit_equal"] for r in rows)
    return rows, over


def _moe_attention_timings(torch, fa, res):
    """Rows 1-3 at the ERNIE-MoE training shape [16, 512, 12, 64],
    non-causal bf16, on separate q/k/v as the model's projections give
    them: the errors over 6 seeds beside the training shape's, then each
    kernel's time with the stream held, its plain version's, its bound and
    SDPA's forward and flash backward."""
    b, s, n, d = MOE_ATTN_SHAPE
    rows, over = _flash_bwd_seed_stats(torch, fa, MOE_ATTN_SHAPE, False,
                                       False)
    rows128, over128 = _flash_bwd_seed_stats(
        torch, fa, (TRAIN_B, TRAIN_S, 8, 128), True, True)
    fmt = lambda rs: "; ".join(" ".join(                 # noqa: E731
        f"{g} {r[g]['elementwise']:.2e}/{r[g]['rms']:.2e}"
        + ("*" if r[g]["elem_over"] else "") for g in ("dq", "dk", "dv"))
        for r in rs)
    _log(f"flash backward bf16 over seeds 0-5, elementwise/rms (* over the "
         f"{GRAD_TOL['flash_bwd', 'bfloat16'][0]:g} elementwise limit): "
         f"[{b}, {s}, {n}, {d}] non-causal: {fmt(rows)}; over {over}")
    _log(f"  the training shape [{TRAIN_B}, {TRAIN_S}, 8, 128] causal, fused "
         f"views (tools/torch_flash_bwd_stats.py's inputs): {fmt(rows128)}; "
         f"over {over128}")
    res["training_moe_flash_bwd_seeds"] = dict(
        shape=list(MOE_ATTN_SHAPE), rows=rows, over=over,
        training_shape_rows=rows128, training_shape_over=over128)
    bad = [i for i, r in enumerate(rows)
           if not all(r[g]["within_abs_and_rms"] for g in ("dq", "dk", "dv"))]
    if bad or any(over.values()) or any(over128.values()):
        raise AssertionError(
            f"flash backward: seeds over the max-abs or rms limit at "
            f"{MOE_ATTN_SHAPE} {bad}; seeds over the elementwise limit, or "
            f"whose Delta is not the plain version's bit for bit: {over} at "
            f"{MOE_ATTN_SHAPE}, {over128} at the training shape (every count "
            f"must be 0)")
    gen = torch.Generator(device="cuda").manual_seed(5)
    q, k, v, do = (torch.randn(b, s, n, d, device="cuda", generator=gen).to(
        torch.bfloat16) for _ in range(4))
    scale = 1.0 / math.sqrt(d)
    o, lse = fa.flash_attention_fwd(q, k, v)
    o_ref, _ = fa.flash_attention_reference(q, k, v)
    fwd_err, _, fwd_ok = _check("flash", o, o_ref, "bfloat16")
    if not fwd_ok:
        raise AssertionError(f"flash forward disagrees at {MOE_ATTN_SHAPE}")
    _, delta = fa._launch_dq(q, k, v, o, lse, do, False, scale, 0)
    with torch.no_grad():
        fwd_ms = _time_held_ms(torch, lambda: fa._launch(
            q, k, v, False, scale, 0), 20)
        dq_ms = _time_held_ms(torch, lambda: fa._launch_dq(
            q, k, v, o, lse, do, False, scale, 0), 20)
        dkv_ms = _time_held_ms(torch, lambda: fa._launch_dkv(
            q, k, v, do, lse, delta, False, scale, 0), 20)
        fwd_plain = _time_held_ms(torch, lambda: fa.flash_attention_reference(
            q, k, v), 5, warmup=1)
        bwd_plain = _time_held_ms(
            torch, lambda: fa.flash_attention_bwd_reference(
                q, k, v, o, lse, do), 5, warmup=1)
        qt, kt, vt, dot = (t.transpose(1, 2).contiguous()
                           for t in (q, k, v, do))
        sdpa = torch.nn.functional.scaled_dot_product_attention
        sdpa_fwd = _time_held_ms(torch, lambda: sdpa(qt, kt, vt), 20)
        aten = torch.ops.aten
        saved = aten._scaled_dot_product_flash_attention(qt, kt, vt, 0.0,
                                                         False)
        o_s, lse_s, cum_q, cum_k, max_q, max_k, ph_seed, ph_off = saved[:8]
        sdpa_bwd = _time_held_ms(
            torch, lambda: aten._scaled_dot_product_flash_attention_backward(
                dot, qt, kt, vt, o_s, lse_s, cum_q, cum_k, max_q, max_k, 0.0,
                False, ph_seed, ph_off), 20)
    pairs = s * s * b * n                 # non-causal (query, key) pairs
    tensor = q.numel() * q.element_size()
    rrows = b * n * s * 4
    shape = f"[{b}, {s}, {n}, {d}] non-causal bf16"
    specs = (
        ("flash", fwd_ms, fwd_plain, sdpa_fwd, 2 * 2 * d * pairs,
         4 * tensor + rrows, fwd_err,
         "SDPA forward on [B, N, S, d] copies, held"),
        ("flash_bwd_dq", dq_ms, bwd_plain, sdpa_bwd,
         3 * 2 * d * pairs + 2 * d * b * n * s, 6 * tensor + 2 * rrows,
         rows[0]["dq"]["max_abs_err"],
         "aten._scaled_dot_product_flash_attention_backward (dq, dk, dv), "
         "held"),
        ("flash_bwd_dkv", dkv_ms, bwd_plain, sdpa_bwd, 4 * 2 * d * pairs,
         6 * tensor + 2 * rrows, max(rows[0]["dk"]["max_abs_err"],
                                     rows[0]["dv"]["max_abs_err"]),
         "the same SDPA backward op, held"))
    for key, ms, plain, lib, flops, nbytes, err, lib_what in specs:
        bound, by = _bound(flops, nbytes, "bfloat16")
        res[key]["at_training_moe"] = dict(
            shape=shape, ms=ms, plain_ms=plain, bound_ms=bound, bound_by=by,
            library_ms=lib, library=lib_what, max_abs_err=err,
            tflops=flops / ms / 1e9)
        _log(f"{key} at {shape}: kernel {ms:.4f} ms ({flops / ms / 1e9:.1f} "
             f"TFLOP/s), plain {plain:.4f} ms, bound {bound:.5f} ms ({by}: "
             f"{flops / 1e9:.3f} GFLOP, {nbytes / 1e6:.3f} MB), library "
             f"{lib:.4f} ms ({lib_what}); max_abs_err {err:.3e}")


def _moe_dispatch_timings(torch, md, res):
    """Rows 7-8 at the ERNIE-MoE training shape: S = 8192 tokens of 768 in
    f32 (a layer norm's output under O1), E = 8, top-2 GShard, C =
    int(1.2 * 2 * 8192 / 8) = 2457: checked against the plain versions as
    the moe_dispatch phase checks them, the route by kernel name, and
    timed with the stream held beside the plain versions and, for the
    combine, F.embedding_bag."""
    S, K = MOE_TRAIN_B * MOE_TRAIN_S, 2
    C = int(1.2 * K * S / MOE_E)
    gen = torch.Generator(device="cuda").manual_seed(9)
    x, gw, gb = _moe_inputs(torch, gen, "float32", S)
    route = md.dispatch_route(S, MOE_E, K)
    d = _check_dispatch(torch, md, x, gw, gb, C, K, "gshard", route)
    names = [n for n in _kernel_names(torch, lambda: md.fused_moe_dispatch(
        x, gw, gb, num_expert=MOE_E, capacity=C, top_k=K)) if "moe_" in n]
    _, comb, val, _, _ = md.reference_moe_dispatch(
        x, gw, gb, num_expert=MOE_E, capacity=C, top_k=K)
    eo = torch.randn(MOE_E * C, MOE_M, device="cuda", generator=gen)
    c = _check_combine(torch, md, "float32", eo, val, comb)
    _log(f"moe f32 training shape S={S} C={C} k={K} gshard, {route}: "
         f"dispatch near ties {d['near_ties']}, picks differing "
         f"{d['flipped']} ({d['flipped_off_tie']} off a near tie), exact "
         f"{d['exact']}, dropped {d['dropped']}, val/me/ce "
         f"{d['val_rel']:.2e}/{d['me_rel']:.2e}/{d['ce_rel']:.2e} "
         f"{'ok' if d['ok'] else 'FAIL'}; one call launched {names}; "
         f"combine vs kernel form {c['max_rel_vs_kernel_form']:.2e}, vs "
         f"einsum {c['einsum_share']:.2e} {'ok' if c['ok'] else 'FAIL'}")
    want = MOE_ROUTE_KERNELS[route]
    if not (d["ok"] and c["ok"]) or route != "three_pass" \
            or len(names) != len(want) \
            or not all(sum(k in n for n in names) == 1 for k in want):
        raise AssertionError(f"MoE kernels at the training shape: dispatch "
                             f"{d}, combine {c}, kernels {names}")
    eo_pad = torch.cat([eo, eo.new_zeros(1, MOE_M)])
    kw = dict(num_expert=MOE_E, capacity=C, top_k=K)
    with torch.no_grad():
        disp_ms = _time_held_ms(torch, lambda: md.fused_moe_dispatch(
            x, gw, gb, **kw), 20)
        disp_plain = _time_held_ms(torch, lambda: md.reference_moe_dispatch(
            x, gw, gb, **kw), 5, warmup=1)
        comb_ms = _time_held_ms(torch, lambda: md.fused_moe_combine(
            eo, val, comb), 20)
        comb_plain = _time_held_ms(torch, lambda: md.combine_kernel_reference(
            eo, val, comb), 5, warmup=1)
        comb_lib = _time_held_ms(torch, lambda: torch.nn.functional.
                                 embedding_bag(comb, eo_pad,
                                               per_sample_weights=val,
                                               mode="sum",
                                               padding_idx=MOE_E * C), 20)
    kept = int((comb < MOE_E * C).sum())
    shape = f"S = {S}, M = {MOE_M}, E = {MOE_E}, C = {C}, top-2, f32"
    specs = (("moe_dispatch", disp_ms, disp_plain, None,
              2 * S * MOE_M * MOE_E, _dispatch_bytes(S, C, K, 4),
              d["val_max_abs_err"], "none"),
             ("moe_combine", comb_ms, comb_plain, comb_lib,
              2 * kept * MOE_M, kept * MOE_M * 4 + S * MOE_M * 4 + S * K * 8,
              c["max_abs_err"], "F.embedding_bag(mode='sum', "
              "per_sample_weights), held"))
    for key, ms, plain, lib, flops, nbytes, err, lib_what in specs:
        bound, by = _bound(flops, nbytes, "float32")
        res[key]["at_training_moe"] = dict(
            shape=shape, route=route, ms=ms, plain_ms=plain, bound_ms=bound,
            bound_by=by, library_ms=lib, library=lib_what, max_abs_err=err,
            dropped=d["dropped"], kernels=names)
        _log(f"{key} at {shape}: kernel {ms:.4f} ms, plain {plain:.4f} ms, "
             f"bound {bound:.5f} ms ({by}: {nbytes / 1e6:.3f} MB), library "
             + (f"{lib:.4f} ms" if lib is not None else "none")
             + f"; max_abs_err {err:.3e}")


def _moe_loss_bf16(model, ids, labels):
    """``forward_with_mlm_loss`` under ``auto_cast(bf16)``: the loss_fn a
    user hands ParallelTrainStep (auto_cast inside it, as in the JAX
    tests)."""
    from paddle_tpu_torch.amp import auto_cast
    with auto_cast(dtype="bfloat16"):
        return model.forward_with_mlm_loss(ids, labels)


def _moe_train_step(torch, model):
    from paddle_tpu_torch.distributed import ParallelTrainStep
    from paddle_tpu_torch.optimizer import AdamW
    return ParallelTrainStep(model, AdamW(
        learning_rate=1e-4, parameters=model.named_parameters()),
        _moe_loss_bf16)


def _moe_captured_main(torch, np, res):
    """(d) bench_ernie_moe's step through ParallelTrainStep, captured as
    one CUDA graph: the first call (eager step, then the capture) and one
    replay to warm up, 10 timed replays, the default gates (random routing
    on); then 5 steps under the eager switch from the same weights."""
    from paddle_tpu_torch.distributed.fleet import train_step
    model = _moe_model(torch, 0)
    cfg = model.config
    B, S, L = MOE_TRAIN_B, MOE_TRAIN_S, cfg.num_hidden_layers
    ids, labels = _moe_np_batch(np, cfg)
    step = _moe_train_step(torch, model)
    gens = train_step._generators(model)
    paths = _moe_paths(model)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    first = []
    t0 = time.perf_counter()
    first_syncs = _syncs_in(torch, lambda: first.append(step(ids, labels)))
    losses = [first[0].item()]
    first_s = time.perf_counter() - t0
    losses.append(step(ids, labels).item())
    ev = lambda: torch.cuda.Event(enable_timing=True)    # noqa: E731
    walls, issues, spans, per_step, gate_states = [], [], [], [], []
    _zero_counts()
    for _ in range(MOE_TRAIN_STEPS):
        c0 = _counts()
        e0, e1 = ev(), ev()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        e0.record()
        loss = step(ids, labels)
        t1 = time.perf_counter()
        e1.record()
        e1.synchronize()
        walls.append(time.perf_counter() - t0)
        issues.append(t1 - t0)
        spans.append(e0.elapsed_time(e1))
        losses.append(loss.item())
        per_step.append({k: v - c0[k] for k, v in _counts().items()})
        gate_states.append([g.get_state().tolist() for g in gens])
    counts = _counts()
    peak = torch.cuda.max_memory_allocated()
    want = dict(flash=L, flash_bwd_dq=L, flash_bwd_dkv=L)
    for i, got in enumerate(per_step):
        _check_counts(f"training_moe (d) replay {i}", got, want)
    timed = losses[2:]
    if not all(math.isfinite(x) for x in timed) or timed[-1] >= timed[0]:
        raise AssertionError(f"training_moe (d) losses not finite or not "
                             f"falling: {losses}")
    moved = all(a != b for a, b in zip(gate_states, gate_states[1:]))
    if len(gens) != L // cfg.moe_every or not moved:
        raise AssertionError(f"training_moe (d): {len(gens)} gate "
                             f"generators, their states move with every "
                             f"replay: {moved}")
    replay_syncs = _syncs_in(torch, lambda: step(ids, labels))
    if first_syncs or replay_syncs:
        raise AssertionError(f"training_moe (d) host syncs: first call "
                             f"{first_syncs}, replay {replay_syncs}")
    wall, by_name = _device_time(torch, lambda: step(ids, labels).item())
    groups = _group_times(by_name)
    busy_us = sum(by_name.values())
    fpt = _moe_flops_per_token(cfg, S)
    tokens_per_s = B * S * MOE_TRAIN_STEPS / sum(walls)
    e2e = dict(tokens_per_s=tokens_per_s,
               step_p50_ms=_pct(walls, 0.5) * 1e3,
               step_ms=[x * 1e3 for x in walls],
               host_issue_p50_ms=_pct(issues, 0.5) * 1e3,
               host_issue_ms=[x * 1e3 for x in issues],
               device_span_p50_ms=_pct(spans, 0.5),
               mfu=tokens_per_s * fpt / PEAK_FLOPS["bfloat16"],
               flops_per_token=fpt, max_memory_allocated_bytes=peak,
               first_call_s=first_s, capture_s=step.capture_s,
               graphs=len(step.captured_signatures),
               pool_bytes=step.graph_pool_bytes(), losses=losses,
               host_syncs_first_call=len(first_syncs),
               host_syncs_replay=len(replay_syncs),
               gate_generators=len(gens), launches=counts,
               launches_per_step=per_step[0], moe_paths=paths,
               profiled_wall_ms=wall * 1e3,
               profiled_device_ms=busy_us / 1e3 if by_name else None,
               busy_share=busy_us / 1e6 / wall if by_name else None,
               device_ms_by_group={g: us / 1e3 for g, us in sorted(
                   groups.items(), key=lambda kv: -kv[1])})
    del step, model, loss
    torch.cuda.empty_cache()
    # the same weights under the eager switch: does random routing draw
    # the same numbers captured and eager?
    model = _moe_model(torch, 0)
    step = _moe_train_step(torch, model)
    with train_step._eager_step():
        eager = [step(ids, labels).item() for _ in range(5)]
    del step, model
    torch.cuda.empty_cache()
    e2e.update(eager_losses_routing_on=eager,
               captured_equals_eager_routing_on=losses[:5] == eager)
    a = res.get("training_moe_bf16", {})
    _log(f"training_moe (d) ParallelTrainStep captured, bf16 O1, random "
         f"routing on ({paths}): first call (eager step + capture) "
         f"{first_s * 1e3:.1f} ms, capture {e2e['capture_s'] * 1e3:.1f} ms, "
         f"graphs {e2e['graphs']}, pool {e2e['pool_bytes']} bytes, host "
         f"syncs in the first call {len(first_syncs)}, in a replay "
         f"{len(replay_syncs)}; {MOE_TRAIN_STEPS} timed replays: "
         f"{tokens_per_s:.1f} tokens/s, step p50 {e2e['step_p50_ms']:.2f} ms "
         f"(steps {', '.join(f'{x:.2f}' for x in e2e['step_ms'])}), host "
         f"stage + launch p50 {e2e['host_issue_p50_ms']:.3f} ms against the "
         f"device's span between events p50 {e2e['device_span_p50_ms']:.2f} "
         f"ms, MFU {e2e['mfu']:.4f}, peak memory {peak} bytes; on "
         f"{res.get('nvidia_smi')}")
    _log(f"training_moe (a) eager in the same call: "
         f"{a.get('tokens_per_s', float('nan')):.1f} tokens/s, step p50 "
         f"{a.get('step_p50_ms', float('nan')):.2f} ms, host issue p50 "
         f"{a.get('host_issue_p50_ms', float('nan')):.2f} ms, device span "
         f"p50 {a.get('device_span_p50_ms', float('nan')):.2f} ms, busy "
         f"share {a.get('busy_share')}, MFU {a.get('mfu', float('nan')):.4f}"
         f", peak memory {a.get('max_memory_allocated_bytes')} bytes")
    _log(f"training_moe (d) losses (first call, warm-up replay, timed): "
         f"{', '.join(f'{x:.6f}' for x in losses)}; launches per replay "
         f"{per_step[0]}, want {want}; gate generators {len(gens)}, their "
         f"states move with every replay")
    _log(f"training_moe (d) random routing on, the first 5 steps captured "
         f"{losses[:5]} vs eager {eager}: "
         f"{'bit-equal' if losses[:5] == eager else 'not bit-equal'}")
    if by_name:
        _log(f"profile one captured training_moe step: wall {wall * 1e3:.2f} "
             f"ms, device busy {busy_us / 1e3:.2f} ms (share "
             f"{e2e['busy_share']:.3f}); " + ", ".join(
                 f"{g} {ms:.3f} ms"
                 for g, ms in e2e["device_ms_by_group"].items()))
        for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:12]:
            _log(f"  {us / 1e3:9.3f} ms  {name[:100]}")
    else:
        _log("profile one captured training_moe step: device time not "
             "measured (the profiler saw no CUDA activity)")
    res["training_moe_captured"] = e2e


def _moe_captured_checks(torch, np, res):
    """(d) checks: ParallelTrainStep captured against the same step under
    the eager switch, from the same weights, random routing off, on the
    gather path and with fused_dispatch=True: every loss and parameter bit
    for bit over MOE_GRAPH_STEPS steps, and the launches each replay
    counts (the fused run's are the MoE kernels' main-path launches)."""
    from paddle_tpu_torch.distributed.fleet import train_step
    out = {}
    for name, fused in (("gather", False), ("fused", True)):
        runs = {}
        for how in ("eager", "captured"):
            model = _moe_model(torch, 3, fused_dispatch=fused)
            _no_random_routing(model)
            cfg, L = model.config, model.config.num_hidden_layers
            ids, labels = _moe_np_batch(np, cfg)
            step = _moe_train_step(torch, model)
            losses, per_step = [], []
            with train_step._eager_step() if how == "eager" \
                    else contextlib.nullcontext():
                for i in range(MOE_GRAPH_STEPS):
                    if i == 1:
                        _zero_counts()
                    c0 = _counts()
                    losses.append(step(ids, labels).item())
                    per_step.append({k: v - c0[k]
                                     for k, v in _counts().items()})
            runs[how] = dict(losses=losses, per_step=per_step,
                             counts=_counts(), paths=_moe_paths(model),
                             params={n: p.detach().clone() for n, p in
                                     model.named_parameters()})
            del step, model
            torch.cuda.empty_cache()
        e, c = runs["eager"], runs["captured"]
        diff = max((v.float() - e["params"][k].float()).abs().max().item()
                   for k, v in c["params"].items())
        same = c["losses"] == e["losses"] and diff == 0.0
        n_moe = L // cfg.moe_every
        want = dict(flash=L, flash_bwd_dq=L, flash_bwd_dkv=L)
        if fused:
            want.update(moe_dispatch=n_moe, moe_combine=n_moe)
        for how, run in runs.items():
            for i, got in enumerate(run["per_step"]):
                _check_counts(f"training_moe (d) {name} {how} step {i}",
                              got, want)
        out[name] = dict(losses=c["losses"], eager_losses=e["losses"],
                         max_abs_param_diff=diff, equal_to_eager=same,
                         replay_launches=c["counts"],
                         launches_per_replay=c["per_step"][1],
                         moe_paths=c["paths"])
        _log(f"training_moe (d) {name}, bf16 O1, random routing off "
             f"({c['paths']}): captured vs eager over {MOE_GRAPH_STEPS} "
             f"steps: losses {c['losses']} vs {e['losses']}, parameters max "
             f"|diff| {diff:.3e}: {'bit-equal' if same else 'DIFFER'}; "
             f"launches per replay {c['per_step'][1]} (replays "
             f"{MOE_GRAPH_STEPS - 1}: {c['counts']})")
        del runs, e, c
        torch.cuda.empty_cache()
    res["training_moe_graph_check"] = out
    if not all(out[k]["equal_to_eager"] for k in out):
        raise AssertionError("captured ERNIE-MoE step differs from eager")


def _moe_scaler_check(torch, np, res):
    """(d) GradScaler under capture: a small f32 Linear whose loss is
    lin(x).sum() with x all ones, so every gradient is 3: finite at a
    scale of 2^126, inf at 2^127. The first call (eager, then the capture)
    at 2^126; then the scale is set to 2^127, and that replay must keep
    every parameter and accumulator bit for bit, set last_found_inf and
    halve the scale; the next replay must update."""
    from paddle_tpu_torch.amp import GradScaler
    from paddle_tpu_torch.distributed import ParallelTrainStep
    from paddle_tpu_torch.nn._torch_layers import Linear
    from paddle_tpu_torch.optimizer import AdamW
    lin = Linear(768, 768, generator=torch.Generator("cuda").manual_seed(0))
    opt = AdamW(1e-3, parameters=lin.named_parameters())
    scaler = GradScaler(init_loss_scaling=2.0 ** 126,
                        decr_every_n_nan_or_inf=1)
    step = ParallelTrainStep(lin, opt, lambda m, x: m(x).sum(),
                             scaler=scaler)
    x = np.ones((3, 768), np.float32)
    params = list(lin.parameters())
    tensors = lambda: params + opt._state_tensors(params)  # noqa: E731
    step(x)
    good = step.last_found_inf
    before = [t.detach().clone() for t in tensors()]
    scaler.set_init_loss_scaling(2.0 ** 127)
    step(x)
    kept = all(torch.equal(a, b) for a, b in zip(before, tensors()))
    out = dict(first_found_inf=good, overflow_found_inf=step.last_found_inf,
               kept=kept, scale_after_overflow=scaler._scale)
    step(x)
    out.update(next_found_inf=step.last_found_inf,
               moved=not torch.equal(before[0], lin.weight),
               scale_after_next=scaler._scale,
               graphs=len(step.captured_signatures))
    ok = (not out["first_found_inf"] and out["overflow_found_inf"] and kept
          and out["scale_after_overflow"] == 2.0 ** 126
          and not out["next_found_inf"] and out["moved"]
          and out["scale_after_next"] == 2.0 ** 126 and out["graphs"] == 1)
    _log(f"training_moe (d) GradScaler under capture (f32 Linear 768x768, "
         f"AdamW): {out} {'ok' if ok else 'FAIL'}")
    res["training_moe_scaler"] = out
    if not ok:
        raise AssertionError("GradScaler under capture did not skip the "
                             "overflowing replay")


def phase_training_moe(torch, np, res):
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.kernels import moe_dispatch as md
    _moe_train_main(torch, np, res)
    torch.cuda.empty_cache()
    _moe_fused_check(torch, np, res)
    torch.cuda.empty_cache()
    _moe_kernel_vs_plain(torch, np, res)
    torch.cuda.empty_cache()
    _moe_attention_timings(torch, fa, res)
    _moe_dispatch_timings(torch, md, res)
    torch.cuda.empty_cache()
    _moe_captured_main(torch, np, res)
    torch.cuda.empty_cache()
    _moe_captured_checks(torch, np, res)
    _moe_scaler_check(torch, np, res)


# ----------------------------------------------------------------- phase 16

def _bert_model(seed, **kw):
    """``BertForPretraining(BertModel(bert_base_config(**kw)))`` built from
    ``paddle_tpu_torch.nn`` on the card, its f32 weights drawn from the
    facade's generator after ``paddle.seed(seed)``, in training mode."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.models.bert import (BertForPretraining, BertModel,
                                              bert_base_config)
    paddle.seed(seed)
    return BertForPretraining(BertModel(bert_base_config(**kw))).train()


def _bert_np_batch(np, cfg, b=BERT_TRAIN_B, seed=0):
    """ids and labels in [0, V), as bench_bert draws them (numpy)."""
    rng = np.random.default_rng(seed)
    return tuple(rng.integers(0, cfg.vocab_size, (b, BERT_TRAIN_S))
                 .astype(np.int64) for _ in range(2))


def _bert_loss_bf16(model, ids, labels):
    """The loss_fn a user hands ParallelTrainStep: ``forward_with_mlm_loss``
    under ``auto_cast(bf16)`` (O1), on facade Tensors."""
    from paddle_tpu_torch.amp import auto_cast
    with auto_cast(dtype="bfloat16"):
        return model.forward_with_mlm_loss(ids, labels)


def _bert_train_step(model):
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.distributed import ParallelTrainStep
    return ParallelTrainStep(model, paddle.optimizer.AdamW(
        learning_rate=1e-4, parameters=model.parameters()), _bert_loss_bf16)


def _bert_flops_per_token(cfg, S):
    """model_flops_per_token of the port's GPT helper on BERT's fields:
    6 N (N the matmul weights, the tied head and the position table) + 12
    L H S for attention."""
    from paddle_tpu_torch.models.gpt import model_flops_per_token
    gptish = type("C", (), dict(
        hidden_size=cfg.hidden_size, num_layers=cfg.num_hidden_layers,
        vocab_size=cfg.vocab_size, intermediate_size=cfg.intermediate_size,
        max_position_embeddings=cfg.max_position_embeddings))
    return model_flops_per_token(gptish, S)


class _MaskProbe:
    """Forward post hooks on every ``nn.Dropout`` with p > 0: each output's
    count of kept (nonzero) elements into a device buffer, and the
    embeddings' mask itself, by in-place copies a captured graph records,
    so each replay leaves its own masks there."""

    def __init__(self, torch, model, shape):
        import paddle_tpu_torch as paddle
        drops = [m for m in model.sublayers()
                 if isinstance(m, paddle.nn.Dropout) and m.p > 0]
        dev = torch.device("cuda")
        self.kept = torch.zeros(len(drops), dtype=torch.int64, device=dev)
        self.numel = [0] * len(drops)
        self.mask = torch.zeros(shape, dtype=torch.bool, device=dev)
        self.p = drops[0].p
        for i, m in enumerate(drops):
            m.register_forward_post_hook(self._hook(torch, i, m is drops[0]))

    def _hook(self, torch, i, first):
        def hook(layer, inputs, out):
            v = out._value
            self.numel[i] = v.numel()
            with torch.no_grad():
                self.kept[i].copy_((v != 0).sum())
                if first:
                    self.mask.copy_(v != 0)
        return hook

    def read(self):
        """(kept share over every probed output, a copy of the mask)."""
        kept = self.kept.sum().item()
        return kept / sum(self.numel), self.mask.clone()


def _bert_timed(torch, step, ids, labels, n):
    """``n`` calls of ``step``, each between CUDA events: losses, walls,
    host issue times, device spans and each call's launches."""
    ev = lambda: torch.cuda.Event(enable_timing=True)    # noqa: E731
    losses, walls, issues, spans, per_step = [], [], [], [], []
    for _ in range(n):
        c0 = _counts()
        e0, e1 = ev(), ev()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        e0.record()
        loss = step(ids, labels)
        t1 = time.perf_counter()
        e1.record()
        e1.synchronize()
        walls.append(time.perf_counter() - t0)
        issues.append(t1 - t0)
        spans.append(e0.elapsed_time(e1))
        losses.append(float(loss))
        per_step.append({k: v - c0[k] for k, v in _counts().items()})
    return losses, walls, issues, spans, per_step


def _bert_profile(torch, fn):
    """One profiled call of ``fn``: its numbers, and each kernel's device
    microseconds by name."""
    wall, by_name = _device_time(torch, fn)
    groups = _group_times(by_name)
    busy_us = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    return dict(profiled_wall_ms=wall * 1e3,
                profiled_device_ms=busy_us / 1e3 if by_name else None,
                busy_share=busy_us / 1e6 / wall if by_name else None,
                device_ms_by_group={g: us / 1e3 for g, us in sorted(
                    groups.items(), key=lambda kv: -kv[1])},
                top_kernels_ms=[(name[:100], us / 1e3) for name, us in top]
                ), by_name


def _log_profile(label, e2e):
    if e2e["profiled_device_ms"] is None:
        _log(f"profile {label}: device time not measured (the profiler saw "
             f"no CUDA activity)")
        return
    _log(f"profile {label}: wall {e2e['profiled_wall_ms']:.2f} ms, device "
         f"busy {e2e['profiled_device_ms']:.2f} ms (share "
         f"{e2e['busy_share']:.3f}); " + ", ".join(
             f"{g} {ms:.3f} ms" for g, ms in e2e["device_ms_by_group"].items()))
    for name, ms in e2e["top_kernels_ms"]:
        _log(f"  {ms:9.3f} ms  {name}")


def _bert_captured_run(torch, np, res, label, **cfg_kw):
    """BERT-base through ParallelTrainStep, captured: the first call (the
    eager step on a side stream, then the capture) and one replay, then
    BERT_TRAIN_STEPS timed replays; syncs, launches, memory and one
    profiled replay. Returns the numbers, the step and the mask probe."""
    model = _bert_model(0, **cfg_kw)
    cfg = model.bert.config
    B, S = BERT_TRAIN_B, BERT_TRAIN_S
    ids, labels = _bert_np_batch(np, cfg)
    probe = _MaskProbe(torch, model, (B, S, cfg.hidden_size))
    step = _bert_train_step(model)
    n_params = sum(p.size for p in model.parameters())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    first = []
    t0 = time.perf_counter()
    first_syncs = _syncs_in(torch, lambda: first.append(step(ids, labels)))
    losses = [float(first[0])]
    first_s = time.perf_counter() - t0
    losses.append(float(step(ids, labels)))
    _zero_counts()
    timed, walls, issues, spans, per_step = _bert_timed(
        torch, step, ids, labels, BERT_TRAIN_STEPS)
    losses += timed
    counts = _counts()
    peak = torch.cuda.max_memory_allocated()
    if not all(math.isfinite(x) for x in timed) or timed[-1] >= timed[0]:
        raise AssertionError(f"training_bert {label} losses not finite or "
                             f"not falling: {losses}")
    replay_syncs = _syncs_in(torch, lambda: step(ids, labels))
    if first_syncs or replay_syncs:
        raise AssertionError(f"training_bert {label} host syncs: first call "
                             f"{first_syncs}, replay {replay_syncs}")
    fpt, n_mm = _bert_flops_per_token(cfg, S)
    tokens_per_s = B * S * BERT_TRAIN_STEPS / sum(walls)
    e2e = dict(tokens_per_s=tokens_per_s,
               step_p50_ms=_pct(walls, 0.5) * 1e3,
               step_ms=[x * 1e3 for x in walls],
               host_issue_p50_ms=_pct(issues, 0.5) * 1e3,
               host_issue_ms=[x * 1e3 for x in issues],
               device_span_p50_ms=_pct(spans, 0.5),
               mfu=tokens_per_s * fpt / PEAK_FLOPS["bfloat16"],
               flops_per_token=fpt, n_matmul_params=n_mm,
               n_params=n_params, max_memory_allocated_bytes=peak,
               first_call_s=first_s, capture_s=step.capture_s,
               graphs=len(step.captured_signatures),
               pool_bytes=step.graph_pool_bytes(), losses=losses,
               host_syncs_first_call=len(first_syncs),
               host_syncs_replay=len(replay_syncs), launches=counts,
               launches_per_step=per_step[0], per_step=per_step,
               config=dict(cfg.__dict__), batch=[B, S])
    e2e.update(_bert_profile(torch, lambda: float(step(ids, labels)))[0])
    _log(f"training_bert {label}: BertForPretraining(BertModel("
         f"bert_base_config({', '.join(f'{k}={v}' for k, v in cfg_kw.items())}"
         f"))): layers={cfg.num_hidden_layers} hidden={cfg.hidden_size} "
         f"heads={cfg.num_attention_heads} ffn={cfg.intermediate_size} "
         f"vocab={cfg.vocab_size} dropout hidden "
         f"{cfg.hidden_dropout_prob} / attention "
         f"{cfg.attention_probs_dropout_prob}, {n_params} f32 parameters, "
         f"B={B} S={S}, auto_cast bf16 (O1), AdamW lr=1e-4, "
         f"ParallelTrainStep captured: first call (eager step + capture) "
         f"{first_s * 1e3:.1f} ms, capture {step.capture_s * 1e3:.1f} ms, "
         f"graphs {e2e['graphs']}, pool {e2e['pool_bytes']} bytes, host "
         f"syncs in the first call {len(first_syncs)}, in a replay "
         f"{len(replay_syncs)}")
    _log(f"training_bert {label}: {BERT_TRAIN_STEPS} timed replays: "
         f"{tokens_per_s:.1f} tokens/s, step p50 {e2e['step_p50_ms']:.2f} ms "
         f"(steps {', '.join(f'{x:.2f}' for x in e2e['step_ms'])}), host "
         f"stage + launch p50 {e2e['host_issue_p50_ms']:.3f} ms against the "
         f"device's span between events p50 {e2e['device_span_p50_ms']:.2f} "
         f"ms, MFU {e2e['mfu']:.4f} ({fpt / 1e9:.4f} GFLOP/token: "
         f"model_flops_per_token, N = {n_mm}), peak memory {peak} bytes; "
         f"on {res.get('nvidia_smi')}")
    _log(f"training_bert {label} losses (first call, warm replay, timed): "
         f"{', '.join(f'{x:.6f}' for x in losses)}; launches per replay "
         f"{per_step[0]}")
    _log_profile(f"one captured training_bert {label} replay", e2e)
    return e2e, step, probe, (ids, labels)


def _bert_eager_run(torch, np, res):
    """The eager facade step in the same call: BERT-base at the published
    config, the dygraph loop a user writes (loss under auto_cast(bf16),
    backward, AdamW.step, clear_grad), 2 warm-up and 10 timed steps."""
    import paddle_tpu_torch as paddle
    model = _bert_model(0)
    cfg = model.bert.config
    opt = paddle.optimizer.AdamW(learning_rate=1e-4,
                                 parameters=model.parameters())
    ids, labels = (paddle.to_tensor(a) for a in _bert_np_batch(np, cfg))

    def step(i, y):
        loss = _bert_loss_bf16(model, i, y)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss.detach()
    for _ in range(BERT_TRAIN_WARMUP):
        step(ids, labels)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, walls, issues, spans, _ = _bert_timed(
        torch, step, ids, labels, BERT_TRAIN_STEPS)
    fpt, _ = _bert_flops_per_token(cfg, BERT_TRAIN_S)
    tokens_per_s = BERT_TRAIN_B * BERT_TRAIN_S * BERT_TRAIN_STEPS / sum(walls)
    out = dict(tokens_per_s=tokens_per_s,
               step_p50_ms=_pct(walls, 0.5) * 1e3,
               host_issue_p50_ms=_pct(issues, 0.5) * 1e3,
               device_span_p50_ms=_pct(spans, 0.5),
               mfu=tokens_per_s * fpt / PEAK_FLOPS["bfloat16"],
               max_memory_allocated_bytes=torch.cuda.max_memory_allocated(),
               losses=losses)
    out.update(_bert_profile(torch, lambda: float(step(ids, labels)))[0])
    _log(f"training_bert (a) the eager facade step in the same call: "
         f"{tokens_per_s:.1f} tokens/s, step p50 {out['step_p50_ms']:.2f} ms, "
         f"host issue p50 {out['host_issue_p50_ms']:.2f} ms, device span p50 "
         f"{out['device_span_p50_ms']:.2f} ms, MFU {out['mfu']:.4f}, peak "
         f"memory {out['max_memory_allocated_bytes']} bytes; losses "
         f"{', '.join(f'{x:.6f}' for x in losses)}")
    _log_profile("one eager training_bert step", out)
    if not all(math.isfinite(x) for x in losses) or losses[-1] >= losses[0]:
        raise AssertionError(f"training_bert eager losses not finite or not "
                             f"falling: {losses}")
    return out


def _bert_dropout_checks(torch, step, probe, ids, labels):
    """Two replays of the (a) graph: each one's kept share over every
    hidden dropout (25 outputs of [16, 512, 768]) within 3 sigma of
    1 - p, and the embeddings' masks of the two differ."""
    shares, masks = [], []
    for _ in range(2):
        step(ids, labels)
        torch.cuda.synchronize()
        share, mask = probe.read()
        shares.append(share)
        masks.append(mask)
    n = sum(probe.numel)
    sigma = math.sqrt(probe.p * (1 - probe.p) / n)
    differ = int((masks[0] != masks[1]).sum().item())
    ok = all(abs(s - (1 - probe.p)) <= 3 * sigma for s in shares) \
        and differ > 0
    out = dict(kept_share=shares, sigma=sigma, elements=n,
               mask_elements_differing=differ, ok=ok)
    _log(f"training_bert (a) dropout masks of two replays: kept shares "
         f"{shares[0]:.6f}, {shares[1]:.6f} over {n} elements each (want "
         f"{1 - probe.p} within 3 sigma = {3 * sigma:.2e}); the embeddings' "
         f"masks differ in {differ} of {masks[0].numel()} elements "
         f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("training_bert dropout masks wrong under replay")
    return out


def _bert_graph_check(torch, np):
    """(b) all dropout at 0: ParallelTrainStep captured against its eager
    switch from the same seed, BERT_GRAPH_STEPS steps, every loss and
    parameter bit for bit, and the flash launches of every step."""
    from paddle_tpu_torch.distributed.fleet import train_step
    runs = {}
    for how in ("eager", "captured"):
        model = _bert_model(3, hidden_dropout_prob=0.0,
                            attention_probs_dropout_prob=0.0)
        L = model.bert.config.num_hidden_layers
        ids, labels = _bert_np_batch(np, model.bert.config)
        step = _bert_train_step(model)
        losses, per_step = [], []
        with train_step._eager_step() if how == "eager" \
                else contextlib.nullcontext():
            for _ in range(BERT_GRAPH_STEPS):
                c0 = _counts()
                losses.append(float(step(ids, labels)))
                per_step.append({k: v - c0[k] for k, v in _counts().items()})
        runs[how] = dict(losses=losses, per_step=per_step, params={
            n: p._value.detach().clone()
            for n, p in model.named_parameters()})
        del step, model
        torch.cuda.empty_cache()
    e, c = runs["eager"], runs["captured"]
    diff = max((v.float() - e["params"][k].float()).abs().max().item()
               for k, v in c["params"].items())
    same = c["losses"] == e["losses"] and diff == 0.0
    want = dict(flash=L, flash_bwd_dq=L, flash_bwd_dkv=L)
    for how, run in runs.items():
        for i, got in enumerate(run["per_step"]):
            _check_counts(f"training_bert (b) {how} step {i}", got, want)
    _log(f"training_bert (b) all dropout 0, captured vs eager over "
         f"{BERT_GRAPH_STEPS} steps: losses {c['losses']} vs {e['losses']}, "
         f"parameters max |diff| {diff:.3e}: "
         f"{'bit-equal' if same else 'DIFFER'}; launches per step "
         f"{c['per_step'][0]}")
    if not same:
        raise AssertionError("captured BERT step differs from eager")
    return dict(losses=c["losses"], eager_losses=e["losses"],
                max_abs_param_diff=diff, equal_to_eager=same,
                launches_per_step=c["per_step"][0])


def _bert_kernel_vs_plain(torch, np):
    """(b) 2 layers at base widths, B = 2, S = 512, attention dropout 0 (the
    flash route), hidden dropout 0: the loss and every gradient with the
    kernels against the same model with every kernel on its plain version,
    f32 and bf16 under auto_cast, at the training_moe check's limits."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.amp import auto_cast
    runs, out = {}, {}
    for dt in ("float32", "bfloat16"):
        for which in ("kernel", "plain"):
            model = _bert_model(2, num_hidden_layers=2,
                                hidden_dropout_prob=0.0,
                                attention_probs_dropout_prob=0.0)
            ids, labels = (paddle.to_tensor(a) for a in _bert_np_batch(
                np, model.bert.config, MOE_KVP_B, 2))
            ctx = _plain_kernels if which == "plain" \
                else contextlib.nullcontext
            _zero_counts()
            with ctx():
                with auto_cast(enable=dt == "bfloat16", dtype="bfloat16"):
                    loss = model.forward_with_mlm_loss(ids, labels)
                loss.backward()
            want = {} if which == "plain" else dict(
                flash=2, flash_bwd_dq=2, flash_bwd_dkv=2)
            _check_counts(f"training_bert (b) {dt} {which}", _counts(), want)
            runs[dt, which] = (float(loss), {
                n: p.grad._value for n, p in model.named_parameters()
                if p.grad is not None})
            del model
        grad_tol, loss_tol = MOE_KVP_TOL[dt]
        (lk, gk), (lp, gp) = runs[dt, "kernel"], runs[dt, "plain"]
        errs = _leaf_rel_err(gk, gp)
        worst, where = errs[0]
        ok = abs(lk - lp) <= loss_tol and worst <= grad_tol
        out[dt] = dict(loss_kernel=lk, loss_plain=lp,
                       loss_abs_err=abs(lk - lp), grad_rel_err=worst,
                       worst_leaf=where, worst_leaves=errs[:4], ok=ok)
        _log(f"training_bert (b) 2 layers B={MOE_KVP_B} S={BERT_TRAIN_S} "
             f"{dt}, kernels vs plain versions: loss {lk:.6f} vs {lp:.6f} "
             f"(|diff| {abs(lk - lp):.3e}, tol {loss_tol:g}); gradients "
             f"max |a-b|/|b| {worst:.3e} ({where}; tol {grad_tol:g}; then "
             + ", ".join(f"{k} {e:.2e}" for e, k in errs[1:4])
             + f") {'ok' if ok else 'FAIL'}")
    if not all(out[dt]["ok"] for dt in ("float32", "bfloat16")):
        raise AssertionError("training_bert kernels disagree with their "
                             "plain versions")
    return out


def phase_training_bert(torch, np, res):
    # (a) BERT-base at its published config: attention dropout 0.1, so the
    # JAX gate's dense attention (no kernel launch), hidden dropout 0.1
    a, step, probe, (ids, labels) = _bert_captured_run(torch, np, res, "(a)")
    _check_counts("training_bert (a) replays", a["launches"], {})
    a["dropout"] = _bert_dropout_checks(torch, step, probe, ids, labels)
    del step, probe
    torch.cuda.empty_cache()
    a["eager"] = _bert_eager_run(torch, np, res)
    res["training_bert_captured"] = a
    torch.cuda.empty_cache()
    # (b) attention dropout 0: the flash route, rows 1-3 12/12/12 a replay
    b, step, probe, _ = _bert_captured_run(
        torch, np, res, "(b)", attention_probs_dropout_prob=0.0)
    L = b["config"]["num_hidden_layers"]
    want = dict(flash=L, flash_bwd_dq=L, flash_bwd_dkv=L)
    for i, got in enumerate(b["per_step"]):
        _check_counts(f"training_bert (b) replay {i}", got, want)
    del step, probe
    torch.cuda.empty_cache()
    _log(f"training_bert tokens/s: (a) dense attention with dropout "
         f"{a['tokens_per_s']:.1f} (eager {a['eager']['tokens_per_s']:.1f}), "
         f"(b) flash kernels {b['tokens_per_s']:.1f}")
    b["graph_check"] = _bert_graph_check(torch, np)
    torch.cuda.empty_cache()
    b["kernel_vs_plain"] = _bert_kernel_vs_plain(torch, np)
    res["training_bert_flash"] = b


# ----------------------------------------------------------------- phase 17

def _bert_static_build(seed, bf16=True, **cfg_kw):
    """bench_bert's build (bench.py:534-549) as it is, on the port:
    ``static.data`` ids and labels [B, S] int64, ``BertForPretraining(
    BertModel(bert_base_config(**cfg_kw)))`` (its weights from
    ``paddle.seed(seed)``), ``forward_with_mlm_loss`` and
    ``AdamW(1e-4).minimize(loss)``, under ``enable_static``, a
    ``program_guard`` and ``auto_cast(bf16)`` (off with ``bf16=False``).
    Static mode stays on, as ``_timed_static_train`` keeps it through its
    runs: the caller turns it off. Returns the program, the loss, the model
    and the embeddings' dropout output (a variable the program can
    fetch)."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import amp, optimizer, static
    from paddle_tpu_torch.models.bert import (BertForPretraining, BertModel,
                                              bert_base_config)
    cfg = bert_base_config(**cfg_kw)
    B, S = BERT_TRAIN_B, BERT_TRAIN_S
    paddle.seed(seed)
    static.enable_static()
    main = static.Program()
    seen = []
    with static.program_guard(main):
        with amp.auto_cast(enable=bf16, dtype="bfloat16"):
            ids = static.data("ids", [B, S], "int64")
            labels = static.data("labels", [B, S], "int64")
            model = BertForPretraining(BertModel(cfg))
            hook = model.bert.embeddings.dropout.register_forward_post_hook(
                lambda layer, inputs, out: seen.append(out))
            loss = model.forward_with_mlm_loss(ids, labels)
            hook.remove()
            opt = optimizer.AdamW(learning_rate=1e-4,
                                  parameters=model.parameters())
            opt.minimize(loss)
    return main, loss, model, seen[0]


def _static_runs(torch, exe, main, feed, loss, n):
    """``n`` runs of ``main`` with ``return_numpy=False``, each between CUDA
    events, then one sync (bench.py's timed loop): the losses, the wall of
    the whole loop, each run's host time (staging + launch), each run's
    device span and launches."""
    ev = lambda: torch.cuda.Event(enable_timing=True)    # noqa: E731
    outs, issues, events, per_run = [], [], [], []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        c0 = _counts()
        e0, e1 = ev(), ev()
        e0.record()
        t1 = time.perf_counter()
        outs.append(exe.run(main, feed=feed, fetch_list=[loss],
                            return_numpy=False)[0])
        issues.append(time.perf_counter() - t1)
        e1.record()
        events.append((e0, e1))
        per_run.append({k: v - c0[k] for k, v in _counts().items()})
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return ([float(o) for o in outs], wall, issues,
            [a.elapsed_time(b) for a, b in events], per_run)


def _bert_static_run(torch, np, res, label, **cfg_kw):
    """BERT-base on the static path: bench_bert's program, device-resident
    feeds, the first run (the eager step on a side stream, then the
    capture) and one more warm-up, BERT_TRAIN_STEPS timed runs with one
    sync, then the checks: finite falling losses, no host sync in the first
    run or a replay, one graph for the feed signature, a fetched Tensor
    kept after the next run; one profiled run. Static mode is on when it
    returns (the caller turns it off)."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import static
    t_build = time.perf_counter()
    main, loss, model, emb_drop = _bert_static_build(0, **cfg_kw)
    build_s = time.perf_counter() - t_build
    cfg = model.bert.config
    B, S = BERT_TRAIN_B, BERT_TRAIN_S
    ids, labels = (paddle.to_tensor(a) for a in _bert_np_batch(np, cfg))
    feed = {"ids": ids, "labels": labels}
    exe = static.Executor()
    n_params = sum(p.size for p in model.parameters())

    def run():
        return exe.run(main, feed=feed, fetch_list=[loss],
                       return_numpy=False)[0]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    first = []
    t0 = time.perf_counter()
    first_syncs = _syncs_in(torch, lambda: first.append(run()))
    losses = [float(first[0])]
    first_s = time.perf_counter() - t0
    for _ in range(BERT_TRAIN_WARMUP - 1):
        losses.append(float(run()))
    _zero_counts()
    timed, wall, issues, spans, per_run = _static_runs(
        torch, exe, main, feed, loss, BERT_TRAIN_STEPS)
    losses += timed
    counts = _counts()
    peak = torch.cuda.max_memory_allocated()
    if not all(math.isfinite(x) for x in timed) or timed[-1] >= timed[0]:
        raise AssertionError(f"training_bert_static {label} losses not "
                             f"finite or not falling: {losses}")
    replay_syncs = _syncs_in(torch, run)
    if first_syncs or replay_syncs:
        raise AssertionError(f"training_bert_static {label} host syncs: "
                             f"first run {first_syncs}, replay "
                             f"{replay_syncs}")
    graphs = exe.graphs(main)
    if len(graphs) != 1:
        raise AssertionError(f"training_bert_static {label}: {len(graphs)} "
                             f"graphs for one feed signature: {graphs}")
    r1 = run()
    v1 = float(r1)
    r2 = run()
    v2 = float(r2)
    kept = float(r1) == v1 and v2 != v1 and \
        r1._value.data_ptr() != r2._value.data_ptr()
    if not kept:
        raise AssertionError(f"training_bert_static {label}: the loss "
                             f"fetched at one run reads {float(r1)} after "
                             f"the next (it was {v1}; the next {v2})")
    # staging + launch alone: runs issued with the device idle (in the
    # timed loop a run's staging waits for the pinned buffer's last copy,
    # which sits behind the previous replay)
    idle = []
    for _ in range(5):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        run()
        idle.append(time.perf_counter() - t1)
    torch.cuda.synchronize()
    fpt, n_mm = _bert_flops_per_token(cfg, S)
    tokens_per_s = B * S * BERT_TRAIN_STEPS / wall
    e2e = dict(tokens_per_s=tokens_per_s,
               step_p50_ms=_pct(spans, 0.5),
               device_span_ms=spans,
               host_issue_p50_ms=_pct(idle, 0.5) * 1e3,
               host_issue_ms=[x * 1e3 for x in idle],
               host_in_loop_p50_ms=_pct(issues, 0.5) * 1e3,
               host_in_loop_ms=[x * 1e3 for x in issues],
               timed_wall_s=wall,
               mfu=tokens_per_s * fpt / PEAK_FLOPS["bfloat16"],
               flops_per_token=fpt, n_matmul_params=n_mm,
               n_params=n_params, max_memory_allocated_bytes=peak,
               build_s=build_s, n_nodes=len(main._nodes),
               first_call_s=first_s, capture_s=exe.capture_s,
               graphs=len(graphs), pool_bytes=exe.graph_pool_bytes(),
               losses=losses, host_syncs_first_call=len(first_syncs),
               host_syncs_replay=len(replay_syncs), launches=counts,
               launches_per_step=per_run[0], per_step=per_run,
               fetch_kept=dict(run1=v1, run1_after_run2=float(r1), run2=v2),
               config=dict(cfg.__dict__), batch=[B, S])
    e2e.update(_bert_profile(torch, lambda: float(run()))[0])
    kw_text = ", ".join(f"{k}={v}" for k, v in cfg_kw.items())
    _log(f"training_bert_static {label}: bench_bert's program (bench.py:534-"
         f"549) at bert_base_config({kw_text}): {len(main._nodes)} recorded "
         f"nodes (built in "
         f"{build_s:.2f} s), {n_params} f32 parameters, B={B} S={S}, "
         f"auto_cast bf16 at record time, AdamW(1e-4).minimize, "
         f"device-resident feeds; Executor: first run (eager step + capture)"
         f" {first_s * 1e3:.1f} ms, capture {exe.capture_s * 1e3:.1f} ms, "
         f"graphs {len(graphs)} for the feed signature, pool "
         f"{e2e['pool_bytes']} bytes, host syncs in the first run "
         f"{len(first_syncs)}, in a replay {len(replay_syncs)}; a fetched "
         f"loss kept after the next run ({v1:.6f}, then {v2:.6f})")
    _log(f"training_bert_static {label}: {BERT_TRAIN_STEPS} timed runs, one "
         f"sync: {tokens_per_s:.1f} tokens/s (wall {wall * 1e3:.2f} ms), "
         f"device span p50 {e2e['step_p50_ms']:.2f} ms (runs "
         f"{', '.join(f'{x:.2f}' for x in spans)}), host stage + launch p50 "
         f"{e2e['host_issue_p50_ms']:.3f} ms with the device idle (a run's "
         f"host time in the loop p50 {e2e['host_in_loop_p50_ms']:.2f} ms: "
         f"it waits behind the previous replay), MFU {e2e['mfu']:.4f} "
         f"({fpt / 1e9:.4f} GFLOP/token), peak memory {peak} bytes; on "
         f"{res.get('nvidia_smi')}")
    _log(f"training_bert_static {label} losses (first run, warm-up, timed): "
         f"{', '.join(f'{x:.6f}' for x in losses)}; launches per run "
         f"{per_run[0]}")
    _log_profile(f"one training_bert_static {label} run", e2e)
    return e2e, exe, main, loss, emb_drop, feed


def _bert_static_masks(torch, exe, main, loss, emb_drop, feed, p):
    """Three runs fetching the embeddings' dropout output too (a fetch list
    of its own: its first run captures a second graph): each run's kept
    share within 3 sigma of 1 - p, and the masks of the two replays
    differ."""
    shares, masks = [], []
    for _ in range(3):
        _, h = exe.run(main, feed=feed, fetch_list=[loss, emb_drop],
                       return_numpy=False)
        m = h._value != 0
        shares.append(m.float().mean().item())
        masks.append(m)
    n = masks[0].numel()
    sigma = math.sqrt(p * (1 - p) / n)
    differ = int((masks[1] != masks[2]).sum().item())
    ok = all(abs(s - (1 - p)) <= 3 * sigma for s in shares) and differ > 0
    _log(f"training_bert_static (a) the embeddings' dropout over three runs "
         f"(the first captures the fetch list's graph): kept shares "
         f"{', '.join(f'{s:.6f}' for s in shares)} of {n} elements (want "
         f"{1 - p} within 3 sigma = {3 * sigma:.2e}); the two replays' masks "
         f"differ in {differ} elements {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("training_bert_static dropout masks wrong "
                             "under replay")
    return dict(kept_share=shares, sigma=sigma, elements=n,
                mask_elements_differing=differ, graphs=len(exe.graphs(main)))


def _bert_static_vs_step(torch, np, dt, **cfg_kw):
    """Static = dygraph: from the same weights (``paddle.seed(5)``), batch
    and dropout draws (``paddle.seed(11)`` before the first step), at
    attention dropout 0, BERT_STATIC_RUNS runs of bench_bert's program
    against as many calls of ParallelTrainStep's captured step on the same
    model (the loss_fn under the same auto_cast): every loss and every
    parameter the program trains, bit for bit. The program's second run
    takes numpy feeds (staged through pinned memory), the others device
    tensors. The pooler, which the MLM loss does not read, is no parameter
    of the program (as in the JAX Executor); ParallelTrainStep's AdamW
    decays it."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import static
    from paddle_tpu_torch.distributed import ParallelTrainStep
    bf16 = dt == "bfloat16"
    cfg_kw = dict(cfg_kw, attention_probs_dropout_prob=0.0)
    model = _bert_model(5, **cfg_kw)
    cfg = model.bert.config
    ids_np, labels_np = _bert_np_batch(np, cfg)
    ids, labels = paddle.to_tensor(ids_np), paddle.to_tensor(labels_np)
    loss_fn = _bert_loss_bf16 if bf16 else \
        (lambda m, i, y: m.forward_with_mlm_loss(i, y))
    step = ParallelTrainStep(model, paddle.optimizer.AdamW(
        learning_rate=1e-4, parameters=model.parameters()), loss_fn)
    paddle.seed(11)
    _zero_counts()
    step_losses = [float(step(ids, labels)) for _ in range(BERT_STATIC_RUNS)]
    step_counts = _counts()
    step_params = {n: p._value.detach().clone()
                   for n, p in model.named_parameters()}
    del step, model
    torch.cuda.empty_cache()
    main, loss, smodel, _ = _bert_static_build(5, bf16=bf16, **cfg_kw)
    try:
        init = {n: p._value.detach().clone()
                for n, p in smodel.named_parameters()}
        exe = static.Executor()
        paddle.seed(11)
        _zero_counts()
        losses = []
        for i in range(BERT_STATIC_RUNS):
            feed = {"ids": ids_np, "labels": labels_np} if i == 1 \
                else {"ids": ids, "labels": labels}
            losses.append(float(exe.run(main, feed=feed, fetch_list=[loss],
                                        return_numpy=False)[0]))
        counts = _counts()
        graphs = len(exe.graphs(main))
    finally:
        static.disable_static()
    trained, untouched = {}, []
    for n, p in smodel.named_parameters():
        if torch.equal(p._value, init[n]):
            untouched.append(n)
        else:
            trained[n] = (p._value.float() - step_params[n].float()).abs() \
                .max().item()
    worst = max(trained.items(), key=lambda kv: kv[1])
    loss_diff = max(abs(a - b) for a, b in zip(losses, step_losses))
    same = losses == step_losses and worst[1] == 0.0 and graphs == 1
    L = cfg.num_hidden_layers
    want = dict(flash=L * BERT_STATIC_RUNS, flash_bwd_dq=L * BERT_STATIC_RUNS,
                flash_bwd_dkv=L * BERT_STATIC_RUNS)
    _check_counts(f"training_bert_static {dt} static runs", counts, want)
    _check_counts(f"training_bert_static {dt} ParallelTrainStep calls",
                  step_counts, want)
    _log(f"training_bert_static static = dygraph, {dt}, {L} layers, "
         f"attention dropout 0, hidden {cfg.hidden_dropout_prob}: "
         f"{BERT_STATIC_RUNS} runs (the second on numpy feeds) losses "
         f"{losses} vs ParallelTrainStep {step_losses} (max |diff| "
         f"{loss_diff:.3e}); {len(trained)} trained parameters max |diff| "
         f"{worst[1]:.3e} ({worst[0]}); untouched by the program: "
         f"{untouched}; graphs {graphs}: "
         f"{'bit-equal' if same else 'DIFFER'}")
    if not same:
        raise AssertionError(f"training_bert_static {dt}: the static program "
                             f"differs from ParallelTrainStep")
    return dict(losses=losses, step_losses=step_losses,
                max_abs_loss_diff=loss_diff, max_abs_param_diff=worst[1],
                worst_param=worst[0], n_trained=len(trained),
                untouched=untouched, graphs=graphs, launches=counts,
                equal=same)


def phase_training_bert_static(torch, np, res):
    from paddle_tpu_torch import static
    # (a) the published config: attention dropout 0.1, the dense attention,
    # no kernel launch
    try:
        a, exe, main, loss, emb_drop, feed = _bert_static_run(
            torch, np, res, "(a)")
        _check_counts("training_bert_static (a) timed runs", a["launches"],
                      {})
        a["dropout"] = _bert_static_masks(
            torch, exe, main, loss, emb_drop, feed,
            a["config"]["hidden_dropout_prob"])
    finally:
        static.disable_static()
    del exe, main, loss, emb_drop, feed
    torch.cuda.empty_cache()
    res["training_bert_static"] = a
    # (b) attention dropout 0: the flash route, rows 1-3 12/12/12 a run
    try:
        b, exe, main, loss, _, feed = _bert_static_run(
            torch, np, res, "(b)", attention_probs_dropout_prob=0.0)
    finally:
        static.disable_static()
    del exe, main, loss, feed
    torch.cuda.empty_cache()
    L = b["config"]["num_hidden_layers"]
    for i, got in enumerate(b["per_step"]):
        _check_counts(f"training_bert_static (b) run {i}", got,
                      dict(flash=L, flash_bwd_dq=L, flash_bwd_dkv=L))
    res["training_bert_static_flash"] = b
    dyn_a = res.get("training_bert_captured", {}).get("tokens_per_s")
    dyn_b = res.get("training_bert_flash", {}).get("tokens_per_s")
    _log(f"training_bert_static tokens/s: (a) {a['tokens_per_s']:.1f} "
         f"(training_bert's captured ParallelTrainStep in this call: "
         f"{dyn_a}), (b) {b['tokens_per_s']:.1f} (training_bert: {dyn_b})")
    b["static_vs_step"] = {}
    for dt, kw in (("float32", dict(num_hidden_layers=2)), ("bfloat16", {})):
        b["static_vs_step"][dt] = _bert_static_vs_step(torch, np, dt, **kw)
        torch.cuda.empty_cache()


# ----------------------------------------------------------------- phase 18

def _resnet_np_batch(np, b=None, hw=None, classes=None, seed=0):
    """img [b, 3, hw, hw] f32 and label [b] int64, as bench_resnet50 draws
    them (``default_rng(seed)``)."""
    rng = np.random.default_rng(seed)
    b, hw = b or RESNET_B, hw or RESNET_HW
    img = rng.standard_normal((b, 3, hw, hw)).astype(np.float32)
    label = rng.integers(0, classes or RESNET_CLASSES, b).astype(np.int64)
    return img, label


def _resnet_build(depth, classes):
    from paddle_tpu_torch.vision import models
    return getattr(models, f"resnet{depth}")(num_classes=classes)


def _resnet_momentum(params):
    import paddle_tpu_torch as paddle
    return paddle.optimizer.Momentum(learning_rate=0.1, momentum=0.9,
                                     parameters=params)


def _resnet_static_build(seed, depth=50, b=None, hw=None, classes=None,
                         bf16=True):
    """bench_resnet50's build (bench.py:495-504) as it is, on the port:
    ``static.data`` img [b, 3, hw, hw] f32 and label [b] int64,
    ``resnet{depth}`` (its weights from ``paddle.seed(seed)``),
    ``cross_entropy`` and ``Momentum(0.1, 0.9).minimize``, under
    ``enable_static``, a ``program_guard`` and ``auto_cast(bf16)`` (off
    with ``bf16=False``), as ``_timed_static_train`` (bench.py:451-457)
    wraps it. Static mode stays on: the caller turns it off. Returns the
    program, the loss and the model."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import amp, static
    b, hw = b or RESNET_B, hw or RESNET_HW
    classes = classes or RESNET_CLASSES
    paddle.seed(seed)
    static.enable_static()
    main = static.Program()
    with static.program_guard(main):
        with amp.auto_cast(enable=bf16, dtype="bfloat16"):
            img = static.data("img", [b, 3, hw, hw], "float32")
            label = static.data("label", [b], "int64")
            net = _resnet_build(depth, classes)
            loss = paddle.nn.functional.cross_entropy(net(img), label)
            _resnet_momentum(net.parameters()).minimize(loss)
    return main, loss, net


def _resnet_loss(bf16):
    """The loss_fn a user hands ParallelTrainStep: cross_entropy of the
    logits, under ``auto_cast(bf16)`` (O1) unless ``bf16`` is False."""
    def loss_fn(model, img, label):
        import paddle_tpu_torch as paddle
        with paddle.amp.auto_cast(enable=bf16, dtype="bfloat16"):
            return paddle.nn.functional.cross_entropy(model(img), label)
    return loss_fn


def _resnet_step(seed, depth=50, classes=None, bf16=True):
    """``resnet{depth}`` from ``paddle.seed(seed)`` on the card through
    ``ParallelTrainStep`` with ``Momentum(0.1, 0.9)``."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.distributed import ParallelTrainStep
    paddle.seed(seed)
    net = _resnet_build(depth, classes or RESNET_CLASSES)
    return net, ParallelTrainStep(net, _resnet_momentum(net.parameters()),
                                  _resnet_loss(bf16))


def _resnet_macs(torch, np, net, hw):
    """Multiply-adds of one image's forward through ``net``'s convolutions
    and fc, from the layers' own shapes (forward hooks over a B = 1 pass
    on the card; a convolution's output elements x in/groups x k x k)."""
    import paddle_tpu_torch as paddle
    macs = []

    def hook(layer, inputs, out):
        w = layer.weight.shape
        if isinstance(layer, paddle.nn.Linear):
            macs.append(math.prod(out.shape[:-1]) * w[0] * w[1])
        else:
            macs.append(math.prod(out.shape) * math.prod(w[1:]))
    hooks = [m.register_forward_post_hook(hook) for m in net.sublayers()
             if isinstance(m, (paddle.nn.Conv2D, paddle.nn.Linear))]
    was = net.training
    net.eval()
    with paddle.no_grad():
        net(paddle.to_tensor(np.zeros((1, 3, hw, hw), np.float32)))
    if was:
        net.train()
    for h in hooks:
        h.remove()
    return sum(macs), len(macs)


def _bn_buffers(net):
    """Every BN running statistic of ``net`` (two a BatchNorm)."""
    return [v for k, v in net.state_dict().items()
            if k.endswith(("._mean", "._variance"))]


def _bn_moves(torch, snaps):
    """How many of the snapshots' consecutive pairs change every BN
    buffer, of how many pairs (each snapshot a list of buffer copies)."""
    moved = [all(not torch.equal(a, b) for a, b in zip(s0, s1))
             for s0, s1 in zip(snaps, snaps[1:])]
    return sum(moved), len(moved)


def _resnet_group(name):
    """The kernel groups of a ResNet step: cuDNN's convolutions and its
    layout transposes, the fc's GEMM, casts, pools, and the BatchNorm's
    statistics (reductions) and apply (elementwise, with ReLU, the
    residual adds and the Momentum update)."""
    low = name.lower()
    if "nchwtonhwc" in low or "nhwctonchw" in low:
        return "NCHW<->NHWC transposes (cuDNN)"
    if any(s in low for s in ("fprop", "dgrad", "wgrad", "implicit_gemm",
                              "conv", "cudnn")):
        return "convolutions (cuDNN)"
    if any(s in low for s in ("gemm", "gemv", "nvjet", "cutlass", "xmma")):
        return "GEMM-named kernels (cuDNN's convolution engines, the fc)"
    if "direct_copy" in low:
        return "casts and copies"
    if "max_pool" in low:
        return "max pool"
    if "adaptive" in low or "avg_pool" in low:
        return "adaptive avg pool"
    if "reduce_kernel" in low:
        return "reductions (BN statistics, loss)"
    if "multi_tensor" in low or "elementwise" in low:
        return ("elementwise (BN apply, ReLU, residual adds, Momentum, "
                "loss)")
    if name.startswith(("Memcpy", "Memset")):
        return "memcpy/memset"
    return "other"


def _resnet_profile(torch, fn):
    """One profiled step (``_bert_profile``) with ResNet's kernel groups,
    and the three largest kernels of each group."""
    out, by_name = _bert_profile(torch, fn)
    groups, largest = {}, {}
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1]):
        g = _resnet_group(name)
        groups[g] = groups.get(g, 0.0) + us
        if len(largest.setdefault(g, [])) < 3:
            largest[g].append((name[:100], us / 1e3))
    out["device_ms_by_group"] = {g: us / 1e3 for g, us in sorted(
        groups.items(), key=lambda kv: -kv[1])}
    out["largest_by_group_ms"] = largest
    return out


def _resnet_mfu(imgs_per_s, macs):
    """MFU twice: at bench.py's 3 x 4.1e9 FLOP/img (4.1 G is ResNet-50's
    multiply-add count, so it is about half the work), and at 3 x 2 FLOP
    per multiply-add of the model's own convolutions and fc."""
    return dict(mfu_bench=imgs_per_s * RESNET_BENCH_FLOP_PER_IMG
                / PEAK_FLOPS["bfloat16"],
                mfu_counted=imgs_per_s * 6 * macs / PEAK_FLOPS["bfloat16"],
                flop_per_img_bench=RESNET_BENCH_FLOP_PER_IMG,
                flop_per_img_counted=6 * macs, macs_per_img=macs)


def _resnet_fetch_check(torch, main, loss, net, feed):
    """Two runs of ``main`` fetching [loss, conv1.weight, bn1._mean] on an
    Executor of their own (its first run is the eager step + capture, the
    second a replay): each fetch equals the value before its run, a copy
    that the next run leaves alone, while the run moved the parameter and
    the buffer."""
    from paddle_tpu_torch import static
    exe = static.Executor()
    w, m = net.conv1.weight, net.bn1._mean
    before, fetched = [], []
    for _ in range(2):
        # detached: a clone on the autograd graph would keep conv1.weight's
        # gradient accumulator (made on this stream) alive into the capture
        before.append((w._value.detach().clone(), m._value.clone()))
        _, fw, fm = exe.run(main, feed=feed, fetch_list=[loss, w, m],
                            return_numpy=False)
        fetched.append((fw._value, fm._value))
    torch.cuda.synchronize()
    ok = {}
    for i, ((w0, m0), (fw, fm)) in enumerate(zip(before, fetched)):
        ok[f"run{i + 1}_param_pre_update"] = torch.equal(fw, w0)
        ok[f"run{i + 1}_buffer_pre_update"] = torch.equal(fm, m0)
        ok[f"run{i + 1}_fresh_storage"] = (
            fw.data_ptr() != w._value.data_ptr()
            and fm.data_ptr() != m._value.data_ptr())
    ok["param_moved"] = not torch.equal(before[1][0], before[0][0]) and \
        not torch.equal(w._value, before[1][0])
    ok["buffer_moved"] = not torch.equal(before[1][1], before[0][1]) and \
        not torch.equal(m._value, before[1][1])
    ok["graphs"] = len(exe.graphs(main))
    _log(f"training_resnet50 (a) fetched conv1.weight and bn1._mean over a "
         f"first run and a replay: {ok}")
    if not all(v for k, v in ok.items() if k != "graphs") or \
            ok["graphs"] != 1:
        raise AssertionError(f"training_resnet50: a fetched parameter or "
                             f"buffer is not the value its run read: {ok}")
    del exe
    gc.collect()
    torch.cuda.empty_cache()
    return ok


def _resnet_measured(torch, net, run, timed):
    """What parts (a) and (b) measure alike. ``run()`` takes one step:
    the first call (the eager step + the capture) and RESNET_WARMUP - 1
    more, then ``timed(RESNET_STEPS)`` (losses, walls, host issue times,
    device spans and each step's launches), then one replay for its syncs;
    the BN statistics after every step. Returns the shared numbers, the
    timed walls and the host issue times."""
    bufs = _bn_buffers(net)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    snaps = [[b._value.clone() for b in bufs]]
    first = []
    t0 = time.perf_counter()
    first_syncs = _syncs_in(torch, lambda: first.append(run()))
    losses = [float(first[0])]
    first_s = time.perf_counter() - t0
    snaps.append([b._value.clone() for b in bufs])
    for _ in range(RESNET_WARMUP - 1):
        losses.append(float(run()))
        snaps.append([b._value.clone() for b in bufs])
    _zero_counts()
    timed_losses, walls, issues, spans, per_step = timed(RESNET_STEPS)
    losses += timed_losses
    counts = _counts()
    peak = torch.cuda.max_memory_allocated()
    replay_syncs = _syncs_in(torch, run)
    snaps.append([b._value.clone() for b in bufs])
    torch.cuda.synchronize()
    e2e = dict(imgs_per_s=RESNET_B * RESNET_STEPS / sum(walls),
               device_span_ms=spans,
               n_params=sum(p.size for p in net.parameters()),
               max_memory_allocated_bytes=peak, first_call_s=first_s,
               losses=losses, host_syncs_first_call=len(first_syncs),
               host_syncs_replay=len(replay_syncs), launches=counts,
               per_step=per_step, bn_buffers=len(bufs),
               bn_moved_every_step=_bn_moves(torch, snaps),
               batch=[RESNET_B, 3, RESNET_HW, RESNET_HW],
               classes=RESNET_CLASSES)
    return e2e, walls, issues


def _resnet_static_run(torch, np, res):
    """(a) bench_resnet50's static program at full size: the fetch check
    (an Executor of its own), then bench's loop on another (timed runs
    with one sync), the host's staging + launch alone, one profiled run,
    and the checks. Static mode is off when it returns, unless it
    raised."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import static
    t_build = time.perf_counter()
    main, loss, net = _resnet_static_build(0)
    build_s = time.perf_counter() - t_build
    img, label = (paddle.to_tensor(a) for a in _resnet_np_batch(np))
    feed = {"img": img, "label": label}
    fetch = _resnet_fetch_check(torch, main, loss, net, feed)
    exe = static.Executor()

    def run():
        return exe.run(main, feed=feed, fetch_list=[loss],
                       return_numpy=False)[0]

    def timed(n):
        losses, wall, issues, spans, per_run = _static_runs(
            torch, exe, main, feed, loss, n)
        return losses, [wall], issues, spans, per_run
    e2e, walls, issues = _resnet_measured(torch, net, run, timed)
    idle = []
    for _ in range(5):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        run()
        idle.append(time.perf_counter() - t1)
    torch.cuda.synchronize()
    e2e.update(step_p50_ms=_pct(e2e["device_span_ms"], 0.5),
               host_issue_p50_ms=_pct(idle, 0.5) * 1e3,
               host_issue_ms=[x * 1e3 for x in idle],
               host_in_loop_p50_ms=_pct(issues, 0.5) * 1e3,
               timed_wall_s=walls[0], build_s=build_s,
               n_nodes=len(main._nodes), capture_s=exe.capture_s,
               graphs=len(exe.graphs(main)),
               pool_bytes=exe.graph_pool_bytes(), fetch_check=fetch)
    e2e.update(_resnet_profile(torch, lambda: float(run())))
    # the layers' shapes from an eager pass (in static mode it would record)
    static.disable_static()
    macs, e2e["conv_fc_layers"] = _resnet_macs(torch, np, net, RESNET_HW)
    e2e.update(_resnet_mfu(e2e["imgs_per_s"], macs))
    _resnet_checks("(a)", e2e)
    _resnet_log("(a) bench_resnet50's static program (bench.py:495-504) "
                f"through static.Executor, {len(main._nodes)} recorded "
                f"nodes (built in {build_s:.2f} s)", e2e, res)
    return e2e


def _resnet_checks(label, e2e):
    moved, pairs = e2e["bn_moved_every_step"]
    if not all(math.isfinite(x) for x in e2e["losses"]):
        raise AssertionError(f"training_resnet50 {label} losses not finite: "
                             f"{e2e['losses']}")
    if e2e["host_syncs_first_call"] or e2e["host_syncs_replay"]:
        raise AssertionError(f"training_resnet50 {label} host syncs: first "
                             f"call {e2e['host_syncs_first_call']}, replay "
                             f"{e2e['host_syncs_replay']}")
    if e2e["graphs"] != 1:
        raise AssertionError(f"training_resnet50 {label}: {e2e['graphs']} "
                             f"graphs for one signature")
    if moved != pairs:
        raise AssertionError(f"training_resnet50 {label}: the BN running "
                             f"statistics changed in {moved} of {pairs} "
                             f"steps")
    _check_counts(f"training_resnet50 {label} timed steps", e2e["launches"],
                  {})


def _resnet_log(head, e2e, res):
    _log(f"training_resnet50 {head}: resnet50(num_classes="
         f"{e2e['classes']}), {e2e['n_params']} f32 parameters, "
         f"{e2e['bn_buffers']} BN buffers, batch {e2e['batch']}, auto_cast "
         f"bf16 (O1), Momentum(0.1, 0.9); first call (eager step + capture) "
         f"{e2e['first_call_s'] * 1e3:.1f} ms, capture "
         f"{e2e['capture_s'] * 1e3:.1f} ms, graphs {e2e['graphs']}, pool "
         f"{e2e['pool_bytes']} bytes, host syncs in the first call "
         f"{e2e['host_syncs_first_call']}, in a replay "
         f"{e2e['host_syncs_replay']}; BN statistics moved in "
         f"{e2e['bn_moved_every_step'][0]} of "
         f"{e2e['bn_moved_every_step'][1]} steps")
    _log(f"training_resnet50 {head}: {RESNET_STEPS} timed steps: "
         f"{e2e['imgs_per_s']:.1f} imgs/s, step p50 {e2e['step_p50_ms']:.2f} "
         f"ms (device span: {', '.join(f'{x:.2f}' for x in e2e['device_span_ms'])}), "
         f"host stage + launch p50 {e2e['host_issue_p50_ms']:.3f} ms, MFU "
         f"{e2e['mfu_bench']:.4f} at bench.py's 3 x 4.1e9 FLOP/img, "
         f"{e2e['mfu_counted']:.4f} at 3 x 2 x {e2e['macs_per_img']} "
         f"multiply-adds/img counted from the {e2e['conv_fc_layers']} conv "
         f"and fc layers' shapes, peak memory "
         f"{e2e['max_memory_allocated_bytes']} bytes; on "
         f"{res.get('nvidia_smi')}")
    _log(f"training_resnet50 {head} losses: "
         f"{', '.join(f'{x:.6f}' for x in e2e['losses'])}")
    _log_profile(f"one training_resnet50 {head.split(' ')[0]} step", e2e)
    for g, names in e2e.get("largest_by_group_ms", {}).items():
        _log(f"  largest of {g}: " + "; ".join(
            f"{name} {ms:.3f} ms" for name, ms in names))


def _resnet_step_run(torch, np, res):
    """(b) the same model from the same seed through ParallelTrainStep
    with auto_cast(bf16) and Momentum, captured: the first call and one
    replay, RESNET_STEPS timed replays, the checks."""
    import paddle_tpu_torch as paddle
    net, step = _resnet_step(0)
    img, label = (paddle.to_tensor(a) for a in _resnet_np_batch(np))
    e2e, walls, issues = _resnet_measured(
        torch, net, lambda: step(img, label),
        lambda n: _bert_timed(torch, step, img, label, n))
    macs, e2e["conv_fc_layers"] = _resnet_macs(torch, np, net, RESNET_HW)
    e2e.update(step_p50_ms=_pct(walls, 0.5) * 1e3,
               step_ms=[x * 1e3 for x in walls],
               device_span_p50_ms=_pct(e2e["device_span_ms"], 0.5),
               host_issue_p50_ms=_pct(issues, 0.5) * 1e3,
               host_issue_ms=[x * 1e3 for x in issues],
               capture_s=step.capture_s,
               graphs=len(step.captured_signatures),
               pool_bytes=step.graph_pool_bytes())
    e2e.update(_resnet_mfu(e2e["imgs_per_s"], macs))
    e2e.update(_resnet_profile(torch, lambda: float(step(img, label))))
    _resnet_checks("(b)", e2e)
    _resnet_log("(b) the dygraph model through ParallelTrainStep, captured",
                e2e, res)
    return e2e


def _resnet_static_vs_step(torch, np, dt, depth, b, hw, classes):
    """Static = dygraph: from the same weights (``paddle.seed(5)``) and
    batch, RESNET_EQUAL_STEPS runs of bench_resnet50's program (the second
    on numpy feeds) against as many calls of ParallelTrainStep's captured
    step (its loss_fn under the same auto_cast), with
    ``torch.backends.cudnn.deterministic`` on for both: every loss,
    parameter and BN buffer bit for bit."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import static
    bf16 = dt == "bfloat16"
    img_np, label_np = _resnet_np_batch(np, b, hw, classes, seed=3)
    img, label = paddle.to_tensor(img_np), paddle.to_tensor(label_np)
    was = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        net, step = _resnet_step(5, depth, classes, bf16)
        step_losses = [float(step(img, label))
                       for _ in range(RESNET_EQUAL_STEPS)]
        step_state = {k: v._value.detach().clone()
                      for k, v in net.state_dict().items()}
        del step, net
        gc.collect()
        torch.cuda.empty_cache()
        main, loss, snet = _resnet_static_build(5, depth, b, hw, classes,
                                                bf16)
        try:
            exe = static.Executor()
            losses = []
            for i in range(RESNET_EQUAL_STEPS):
                feed = {"img": img_np, "label": label_np} if i == 1 \
                    else {"img": img, "label": label}
                losses.append(float(exe.run(main, feed=feed,
                                            fetch_list=[loss],
                                            return_numpy=False)[0]))
            graphs = len(exe.graphs(main))
        finally:
            static.disable_static()
    finally:
        torch.backends.cudnn.deterministic = was
    diffs = {k: (v._value.float() - step_state[k].float()).abs().max().item()
             for k, v in snet.state_dict().items()}
    worst = max(diffs.items(), key=lambda kv: kv[1])
    same = losses == step_losses and worst[1] == 0.0 and graphs == 1
    _log(f"training_resnet50 static = dygraph, {dt}, resnet{depth}, B={b}, "
         f"3x{hw}x{hw}, {classes} classes, cudnn.deterministic: "
         f"{RESNET_EQUAL_STEPS} runs (the second on numpy feeds) losses "
         f"{losses} vs ParallelTrainStep {step_losses}; {len(diffs)} "
         f"parameters and BN buffers max |diff| {worst[1]:.3e} ({worst[0]}); "
         f"graphs {graphs}: {'bit-equal' if same else 'DIFFER'}")
    if not same:
        raise AssertionError(f"training_resnet50 {dt}: the static program "
                             f"differs from ParallelTrainStep")
    del exe, main, loss, snet
    gc.collect()
    torch.cuda.empty_cache()
    return dict(losses=losses, step_losses=step_losses,
                max_abs_diff=worst[1], worst=worst[0], n_state=len(diffs),
                graphs=graphs, equal=same,
                config=dict(depth=depth, batch=b, hw=hw, classes=classes))


def phase_training_resnet50(torch, np, res):
    from paddle_tpu_torch import static
    try:
        a = _resnet_static_run(torch, np, res)
    finally:
        static.disable_static()
    gc.collect()
    torch.cuda.empty_cache()
    res["training_resnet50_static"] = a
    b = _resnet_step_run(torch, np, res)
    gc.collect()
    torch.cuda.empty_cache()
    res["training_resnet50_step"] = b
    _log(f"training_resnet50 imgs/s: (a) static {a['imgs_per_s']:.1f}, (b) "
         f"ParallelTrainStep {b['imgs_per_s']:.1f}")
    a["static_vs_step"] = {
        "float32": _resnet_static_vs_step(torch, np, "float32", 18, 4, 64,
                                          RESNET_CLASSES),
        "bfloat16": _resnet_static_vs_step(torch, np, "bfloat16", 50,
                                           RESNET_B, RESNET_HW,
                                           RESNET_CLASSES)}


# --------------------------------------------------------------------- main

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json-out", help="also write every result here")
    ap.add_argument("--parent", help="a tree holding another "
                    "paddle_tpu_torch (e.g. the parent commit's, unpacked "
                    "with git archive): its MoE kernels are timed beside "
                    "this tree's")
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
              ("tensor_api", lambda: phase_tensor_api(torch, np, res)),
              ("flash", lambda: phase_flash(torch, res)),
              ("flash_bwd", lambda: phase_flash_bwd(torch, res)),
              ("paged", lambda: phase_paged(torch, res)),
              ("paged_prefill", lambda: phase_paged_prefill(torch, res)),
              ("int8", lambda: phase_int8(torch, res)),
              ("moe_dispatch", lambda: phase_moe_dispatch(torch, res,
                                                          args.parent)),
              ("serving", lambda: phase_serving(torch, np, res)),
              ("serving_prefix", lambda: phase_serving_prefix(torch, np, res)),
              ("serving_int8", lambda: phase_serving_int8(torch, np, res)),
              ("serving_moe", lambda: phase_serving_moe(torch, np, res)),
              ("checkpoint", lambda: phase_checkpoint(torch, np, res)),
              ("training", lambda: phase_training(torch, np, res)),
              ("training_moe", lambda: phase_training_moe(torch, np, res)),
              ("training_bert", lambda: phase_training_bert(torch, np, res)),
              ("training_bert_static",
               lambda: phase_training_bert_static(torch, np, res)),
              ("training_resnet50",
               lambda: phase_training_resnet50(torch, np, res))]
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
    # training_moe: the replays of ParallelTrainStep's graph, part (d): the
    # attention passes of the 10 timed replays (default gates, the gather
    # path), the MoE kernels of the fused run's replays
    for key in ("flash", "flash_bwd_dq", "flash_bwd_dkv"):
        res[key]["launches_by_path"]["training_moe"] = \
            res["training_moe_captured"]["launches"][key]
    for key in ("moe_dispatch", "moe_combine"):
        res[key]["launches_by_path"]["training_moe"] = \
            res["training_moe_graph_check"]["fused"]["replay_launches"][key]
    # training_bert: part (b)'s 10 timed replays (attention dropout 0, the
    # flash route); part (a) (the published config's attention dropout
    # 0.1) launches none of the kernels, which its check holds
    for key in ("flash", "flash_bwd_dq", "flash_bwd_dkv"):
        res[key]["launches_by_path"]["training_bert"] = \
            res["training_bert_flash"]["launches"][key]
    # training_bert_static: part (b)'s 10 timed runs of bench_bert's static
    # program (attention dropout 0); part (a) launches none, held
    for key in ("flash", "flash_bwd_dq", "flash_bwd_dkv"):
        res[key]["launches_by_path"]["training_bert_static"] = \
            res["training_bert_static_flash"]["launches"][key]
    # training_resnet50: the timed steps of both parts launch no kernel of
    # the table (convolutions and pools are cuDNN's and ATen's), held
    for key in ("flash", "flash_bwd_dq", "flash_bwd_dkv", "paged",
                "paged_prefill", "int8", "moe_dispatch", "moe_combine"):
        res[key]["launches_by_path"]["training_resnet50"] = sum(
            res[part]["launches"][key] for part in (
                "training_resnet50_static", "training_resnet50_step"))
    # checkpoint: the counted runs of the engines from_checkpoint built
    # (f32, captured), summed over the phase's GPT and MoE cases
    for key in ("flash", "paged", "int8", "moe_dispatch", "moe_combine"):
        n = sum(case["launches"][key]
                for case in res["checkpoint"].values())
        if n:
            res[key]["launches_by_path"]["checkpoint"] = n
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
