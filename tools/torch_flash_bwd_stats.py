"""Errors and times of the port's bf16 flash backward on the card, over seeds
and source variants.

    python3 tools/torch_flash_bwd_stats.py [--shape gpt|ernie_moe] [--seeds 6]
        [--parent CSRC_DIR] [--only NAME ...] [--json-out PATH]

At one training shape (``gpt``: B = 12, S = 1024, 8 heads of 128, causal,
the q/k/v views of one fused QKV projection; ``ernie_moe``: B = 16, S =
512, 12 heads of 64, non-causal, separate q/k/v), for each seed: the
largest elementwise error |g - r| / (|r| + rms(r)) and the rms error of
dq, dk and dv against the plain backward (``chip_smoke.py``'s measures and
limits), where the worst element sits, whether the kernel's Delta equals
the plain version's bit for bit, then the dQ and dK/dV kernels' times
(CUDA events, the stream held) beside SDPA's flash backward op on the
same shape. It does so for the tree's own sources ("this"), for each
variant of source in ``VARIANTS`` (text replaced in a copy of ``csrc``)
and, with ``--parent``, for another source directory (for instance a
parent commit's ``paddle_tpu_torch/csrc``, unpacked with ``git
archive``). Each source set is built as ``kernels/_build.py`` builds the
tree's, into ``build/flash_bwd_stats/<name>``. Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import math
import re
import shutil
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

# text replacements, (source file, old, new): in the wgmma dK/dV pass, S^T
# and dP^T summed by the tensor cores 1 or 4 16-deep steps at a time
# between f32 additions, or chained over all of D (the pass sums 2 at a
# time); no in-order recompute at all in that pass ("no_tie_guard"); in
# every pass, no in-order recompute near a tie of dS (P's kept:
# "no_ds_guard"), or one at another margin around dS's ties
# ("ds_margin_16", "ds_margin_64"). In the mma.sync kernels (the dQ
# pass), S and dP chained in the tensor cores' accumulators.
WG, TC = "flash_attention_bwd_wg.cu", "flash_attention_bwd_tc.cuh"
VARIANTS = {
    "sdp_steps_1": [(WG, "constexpr int kSdPSteps = 2;",
                     "constexpr int kSdPSteps = 1;")],
    "sdp_steps_4": [(WG, "constexpr int kSdPSteps = 2;",
                     "constexpr int kSdPSteps = 4;")],
    "sdp_chained": [(WG, "constexpr int kSdPSteps = 2;",
                     "constexpr int kSdPSteps = 8;")],
    "no_tie_guard": [(WG, "if (__any_sync(0xffffffffu, tie < 2 * "
                      "tc::kTieMargin ||", "if (false && (tie < 2 * "
                      "tc::kTieMargin ||"),
                     (WG, "tie_ds < 2 * tc::kDsTieMargin)) {",
                      "tie_ds < 2 * tc::kDsTieMargin))) {")],
    "no_ds_guard": [("tensor_core.cuh",
                     "constexpr uint32_t kDsTieMargin = 32;",
                     "constexpr uint32_t kDsTieMargin = 0;")],
    "ds_margin_16": [("tensor_core.cuh",
                      "constexpr uint32_t kDsTieMargin = 32;",
                      "constexpr uint32_t kDsTieMargin = 16;")],
    "ds_margin_64": [("tensor_core.cuh",
                      "constexpr uint32_t kDsTieMargin = 32;",
                      "constexpr uint32_t kDsTieMargin = 64;")],
    "tc_chained_s_dp": [(TC, "tc::mma_rn(s[", "tc::mma_bf16(s["),
                        (TC, "tc::mma_rn(dp[", "tc::mma_bf16(dp[")],
}
# (B, S, N, D, causal, q/k/v as views of one fused projection)
SHAPES = {"gpt": (cs.TRAIN_B, cs.TRAIN_S, 8, 128, True, True),
          "ernie_moe": (*cs.MOE_ATTN_SHAPE, False, False)}


def _inputs(torch, fa, seed, shape):
    b, s, n, d, causal, fused = shape
    gen = torch.Generator(device="cuda").manual_seed(seed)
    randn = lambda *sh: torch.randn(*sh, device="cuda",  # noqa: E731
                                    generator=gen).to(torch.bfloat16)
    if fused:
        q, k, v = randn(b, s, 3, n, d).unbind(2)
    else:
        q, k, v = (randn(b, s, n, d) for _ in range(3))
    do = randn(b, s, n, d)
    o, lse = fa.flash_attention_fwd(q, k, v, causal)
    refs = fa.flash_attention_bwd_reference(q, k, v, o, lse, do, causal)
    return (q, k, v, o, lse, do), refs


def _sdpa_bwd_ms(torch, shape, args):
    """SDPA's flash backward op on [B, N, S, D] copies of the same inputs,
    from its own forward's saved outputs, with the stream held."""
    causal = shape[4]
    q, k, v, _, _, do = args
    qt, kt, vt, dot = (x.transpose(1, 2).contiguous() for x in (q, k, v, do))
    aten = torch.ops.aten
    with torch.no_grad():
        saved = aten._scaled_dot_product_flash_attention(qt, kt, vt, 0.0,
                                                         causal)
        o_s, lse_s, cum_q, cum_k, max_q, max_k, ph_seed, ph_off = saved[:8]
        return cs._time_held_ms(
            torch, lambda: aten._scaled_dot_product_flash_attention_backward(
                dot, qt, kt, vt, o_s, lse_s, cum_q, cum_k, max_q, max_k, 0.0,
                causal, ph_seed, ph_off), 20)


def _where(g, r):
    """(row, head, |ref| / rms(ref)) of the worst elementwise error."""
    r = r.float()
    rms = r.square().mean().sqrt()
    el = (g.float() - r).abs() / (r.abs() + rms)
    i = int(el.argmax())
    _, row, head, _ = (int(x) for x in np.unravel_index(i, tuple(r.shape)))
    return row, head, float(r.flatten()[i].abs() / rms)


def _load_older(_build):
    """Load the library built from another tree's sources (``--parent``)
    as the wrappers' library, with this tree's C signatures set for the
    three flash entries this tool launches; the other tree may lack this
    tree's newer entries."""
    lib = ctypes.CDLL(str(_build.library_path()))
    for entry in ("ptt_flash_attention_fwd", "ptt_flash_attention_bwd_dq",
                  "ptt_flash_attention_bwd_dkv"):
        fn = getattr(lib, entry)
        fn.argtypes = _build._SIGNATURES[entry]
        fn.restype = ctypes.c_int
    lib.ptt_error_string.argtypes = [ctypes.c_int]
    lib.ptt_error_string.restype = ctypes.c_char_p
    _build._lib = lib


def _measure(torch, fa, _build, name, src, inputs, shape):
    _build._CSRC = Path(src).resolve()
    _build._BUILD_DIR = ROOT / "build" / "flash_bwd_stats" / name
    _build._lib = None
    _build.build(force=True)
    if name == "parent":
        _load_older(_build)
    D, causal = shape[3], shape[4]
    ptxas = {k: v for k, v in cs._ptxas_kernels(
        _build.build_log["ptxas"]).items()
        if re.search(rf"flash_bwd_d\w*kernelILi{D}E(Lb1E)?E", k)}
    elem_tol, rms_tol = cs.GRAD_TOL["flash_bwd", "bfloat16"]
    seeds = []
    for seed, (args, refs) in enumerate(inputs):
        got = fa.flash_attention_bwd(*args, causal)
        row = {}
        for gname, g, r in zip(("dq", "dk", "dv"), got, refs):
            _, elem, rms, _ = cs._grad_err(g, r)
            row[gname] = dict(elementwise=elem, rms=rms,
                              ok=elem <= elem_tol and rms <= rms_tol,
                              worst_at=_where(g, r))
        q, k, v, o, lse, do = args
        _, delta = fa._launch_dq(q, k, v, o, lse, do, causal,
                                 1.0 / math.sqrt(D), 0)
        row["delta_bit_equal"] = bool(torch.equal(
            delta, (do.float() * o.float()).sum(-1).transpose(1, 2)))
        seeds.append(row)
        cs._log(f"  {name} seed {seed}: " + "; ".join(
            f"{k} el {v['elementwise']:.3e} rms {v['rms']:.3e}"
            + ("" if v["ok"] else " (over: row {}, head {}, |ref|/rms "
               "{:.2f})".format(*v["worst_at"]))
            for k, v in row.items() if k != "delta_bit_equal")
            + f"; Delta bit-equal {row['delta_bit_equal']}")
    (q, k, v, o, lse, do) = inputs[0][0]
    scale = 1.0 / math.sqrt(D)
    _, delta = fa._launch_dq(q, k, v, o, lse, do, causal, scale, 0)
    dq_ms = cs._time_held_ms(torch, lambda: fa._launch_dq(
        q, k, v, o, lse, do, causal, scale, 0), 20)
    dkv_ms = cs._time_held_ms(torch, lambda: fa._launch_dkv(
        q, k, v, do, lse, delta, causal, scale, 0), 20)
    mma_ms = None
    if name != "parent":
        with fa._mma_sync_route():   # the mma.sync dK/dV kernel, same call
            mma_ms = cs._time_held_ms(torch, lambda: fa._launch_dkv(
                q, k, v, do, lse, delta, causal, scale, 0), 20)
    over = {g: sum(not s[g]["ok"] for s in seeds) for g in ("dq", "dk", "dv")}
    delta_equal = sum(s["delta_bit_equal"] for s in seeds)
    cs._log(f"{name}: dq {dq_ms:.4f} ms, dkv {dkv_ms:.4f} ms"
            + ("" if mma_ms is None else f" (mma.sync dkv {mma_ms:.4f} ms)")
            + "; seeds over a "
            f"limit (of {len(seeds)}): {over}; Delta bit-equal on "
            f"{delta_equal}; max rms " + ", ".join(
                f"{g} {max(s[g]['rms'] for s in seeds):.3e}"
                for g in ("dq", "dk", "dv"))
            + f"; ptxas (D = {D}): " + ", ".join(
                f"{k[:40]} {v[0]} regs, spills "
                f"{v[1]}/{v[2]} B" for k, v in sorted(ptxas.items())))
    return dict(seeds=seeds, dq_ms=dq_ms, dkv_ms=dkv_ms,
                dkv_mma_sync_ms=mma_ms, over=over, delta_equal=delta_equal,
                ptxas={k: list(v) for k, v in ptxas.items()})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shape", choices=sorted(SHAPES), default="gpt")
    ap.add_argument("--seeds", type=int, default=6)
    ap.add_argument("--parent", help="another csrc directory to measure")
    ap.add_argument("--only", nargs="*", help="the variants to measure "
                    "(default: all)")
    ap.add_argument("--json-out")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("torch_flash_bwd_stats: CUDA is not available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.kernels import flash_attention as fa
    cs._log(f"nvidia-smi: {cs._nvidia_smi()}")
    own = _build._CSRC
    shape = SHAPES[args.shape]
    inputs = [_inputs(torch, fa, seed, shape) for seed in range(args.seeds)]
    out = {"shape": [args.shape, *shape],
           "this": _measure(torch, fa, _build, "this", own, inputs, shape)}
    out["sdpa_bwd_ms"] = _sdpa_bwd_ms(torch, shape, inputs[0][0])
    cs._log(f"{args.shape} {shape}: SDPA's flash backward op "
            f"{out['sdpa_bwd_ms']:.4f} ms (held)")
    for name, subs in VARIANTS.items():
        if args.only is not None and name not in args.only:
            continue
        src = ROOT / "build" / "flash_bwd_stats" / f"{name}_src"
        shutil.rmtree(src, ignore_errors=True)
        shutil.copytree(own, src)
        for file, old, new in subs:
            path = src / file
            text = path.read_text()
            if old not in text:
                raise ValueError(f"variant {name}: {old!r} not in {file}")
            path.write_text(text.replace(old, new))
        out[name] = _measure(torch, fa, _build, name, src, inputs, shape)
    if args.parent:
        out["parent"] = _measure(torch, fa, _build, "parent", args.parent,
                                 inputs, shape)
    if args.json_out:
        Path(args.json_out).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
