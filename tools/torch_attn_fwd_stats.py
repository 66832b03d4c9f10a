"""Errors and times of the port's bf16 attention forward kernels on the card,
over seeds and source variants.

    python3 tools/torch_attn_fwd_stats.py [--seeds 6] [--parent CSRC_DIR]
        [--only NAME ...] [--json-out PATH]

For each seed: the flash forward at S = 1024 (B = 1, 8 heads of 128,
causal) against its plain version (``chip_smoke.py``'s largest error, bias
and LSE error, and whether they are within its limits), and the chunk
prefill at its serving shape (C = 256, 8 heads of 128, page 64, offset 768)
against its two plain versions (the share of max |ref| and the rms share,
``PREFILL_TOL``). Then the times (CUDA events, the stream held while the
host enqueues): the flash forward at the serving shape and at the training
shape (B = 12 on the views of one fused QKV tensor), the chunk prefill at
its serving shape over 24 layers' pools. It does so for the tree's own
sources ("this"; with the mma.sync forward's times beside the wgmma
one's), for each source variant in ``VARIANTS`` (text replaced in a copy
of ``csrc``) and, with ``--parent``, for another
source directory (for instance a parent commit's ``paddle_tpu_torch/csrc``,
unpacked with ``git archive``). Each source set is built as
``kernels/_build.py`` builds the tree's, into
``build/attn_fwd_stats/<name>``. Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

# text replacements, (source file, old, new)
TC, WG = "attention_fwd_tc.cuh", "flash_attention_fwd_wg.cu"
VARIANTS = {
    # the chunk prefill through the mma.sync flash forward's block (4 warps
    # of 16 rows each, S on the tensor cores) instead of its own (S on the
    # CUDA cores in the plain version's order, 4 warps sharing 16 rows)
    "prefill_on_flash": [
        (TC, "  attend_split<D, FULL>(p, kv);", "  attend<D, FULL>(p, kv);"),
        (TC, "__launch_bounds__(32 * kSplitWarps)", "__launch_bounds__(128)"),
        (TC, "return start(paged_prefill_tc_kernel<D, FULL>, "
         "split_smem_bytes<D>(), 16,\n               32 * kSplitWarps,",
         "return start("
         "paged_prefill_tc_kernel<D, FULL>, flash_smem_bytes<D>(), 64,\n"
         "               32 * kFlashWarps,")],
    # the chunk prefill's 16-row groups shared by 4 warps (16 positions of
    # S and a quarter of the head dims each) instead of 8
    "split_4_warps": [(TC, "constexpr int kSplitWarps = 8;",
                       "constexpr int kSplitWarps = 4;")],
    # the wgmma flash forward with one consumer warpgroup (64 query rows a
    # block) at every shape, or two (128 rows) at every shape, instead of
    # choosing from the blocks the shape gives
    "fwd_64_rows": [(WG, "const bool two = fwd_warpgroups(B, Nq, Sq, "
                     "hop::sm_count()) == 2;", "const bool two = false;")],
    "fwd_128_rows": [(WG, "const bool two = fwd_warpgroups(B, Nq, Sq, "
                      "hop::sm_count()) == 2;", "const bool two = true;")],
    # the wgmma flash forward with a ring of two K/V stages instead of 3
    "fwd_2_stages": [(WG, "constexpr int kStages = 3;",
                      "constexpr int kStages = 2;")],
    # a bound, not a kernel: the wgmma flash forward without its softmax
    # (P = S, wrong results), to show what the softmax costs
    "fwd_no_softmax": [(WG, "  softmax(s, 0, corr);",
                        "  corr[0] = corr[1] = 1.f;"),
                       (WG, "    softmax(s, j, corr);",
                        "    corr[0] = corr[1] = 1.f;")],
}
PREFILL = dict(B=1, C=256, nh=8, d=128, ps=64, pps=16, off=768)


def _inputs(torch, seed):
    gen = torch.Generator(device="cuda").manual_seed(2000 + seed)
    q, k, v = (torch.randn(1, 1024, 8, 128, device="cuda", generator=gen)
               .to(torch.bfloat16) for _ in range(3))
    p = PREFILL
    pre = cs._prefill_case(torch, gen, "bfloat16", p["B"], p["C"], p["nh"],
                           p["d"], p["ps"], p["pps"])
    return (q, k, v), pre


def _errors(torch, fa, pa, inputs, prefill=True):
    rows = []
    for (q, k, v), (pq, kp, vp, pt) in inputs:
        o, lse = fa.flash_attention_fwd(q, k, v, True)
        o_ref, lse_ref = fa.flash_attention_reference(q, k, v, True)
        err, bias, ok = cs._check("flash", o, o_ref, "bfloat16")
        lse_err = (lse - lse_ref).abs().max().item()
        row = dict(flash=dict(max_abs_err=err, bias=bias, lse_err=lse_err,
                              ok=ok and lse_err <= 1e-3))
        if prefill:
            pre, _, pok = cs._prefill_errors(torch, pa, "bfloat16", pq, kp,
                                             vp, pt, PREFILL["off"])
            row["prefill"] = dict(pre, ok=pok)
        rows.append(row)
    return rows


def _offset_by_value(src):
    """Whether the chunk prefill's C entry in the sources ``src`` takes its
    offset as an int (older trees) rather than a device pointer, which
    this tree's wrapper passes: such a tree's chunk prefill is not
    measured."""
    text = (Path(src) / "paged_attention_prefill.cu").read_text()
    return "const void* q_offset" not in text


def _times(torch, fa, pa, mma_sync, prefill=True):
    out = {}
    gen = torch.Generator(device="cuda").manual_seed(7)
    q, k, v = (torch.randn(1, 1024, 8, 128, device="cuda", generator=gen)
               .to(torch.bfloat16) for _ in range(3))
    out["flash_serving_ms"] = cs._time_held_ms(
        torch, lambda: fa.flash_attention_fwd(q, k, v, True), 50)
    qkv = torch.randn(cs.TRAIN_B, cs.TRAIN_S, 3, 8, 128, device="cuda",
                      generator=gen).to(torch.bfloat16)
    tq, tk, tv = qkv.unbind(2)
    out["flash_training_ms"] = cs._time_held_ms(
        torch, lambda: fa.flash_attention_fwd(tq, tk, tv, True), 20)
    if mma_sync:
        with fa._mma_sync_route():   # the mma.sync forward, same call
            out["flash_serving_mma_sync_ms"] = cs._time_held_ms(
                torch, lambda: fa.flash_attention_fwd(q, k, v, True), 50)
            out["flash_training_mma_sync_ms"] = cs._time_held_ms(
                torch, lambda: fa.flash_attention_fwd(tq, tk, tv, True), 20)
    del qkv, tq, tk, tv
    if not prefill:
        return out
    p = PREFILL
    pools = [cs._prefill_case(torch, gen, "bfloat16", p["B"], p["C"],
                              p["nh"], p["d"], p["ps"], p["pps"])
             for _ in range(24)]
    step = [0]

    off = torch.full((1,), p["off"], dtype=torch.int32, device="cuda")

    def run():
        i = step[0] % len(pools)
        step[0] += 1
        _, kp, vp, _ = pools[i]
        return pa.ragged_prefill_attention(pools[0][0], kp, vp, pools[0][3],
                                           off)
    out["prefill_serving_ms"] = cs._time_held_ms(torch, run, 100)
    return out


def _short(mangled):
    """A kernel's name and mangled template arguments, from its mangled
    name (``_ZN<len><name>...I<args>EE...``)."""
    pos, name = mangled.find("_ZN") + 3, mangled
    while pos < len(mangled) and mangled[pos].isdigit():
        m = re.match(r"\d+", mangled[pos:])
        n = int(m.group())
        name = mangled[pos + m.end():pos + m.end() + n]
        pos += m.end() + n
    args = re.match(r"I(\w+?)EE", mangled[pos:])
    return f"{name}<{args.group(1)}>" if args else name


def _load_older(_build, entries):
    """Load the library built from another tree's sources (``--parent``)
    as the wrappers' library, with the C signatures of the ``entries``
    this tool launches set as this tree's; the other tree may lack this
    tree's newer entries."""
    lib = ctypes.CDLL(str(_build.library_path()))
    for entry in entries:
        fn = getattr(lib, entry)
        fn.argtypes = _build._SIGNATURES[entry]
        fn.restype = ctypes.c_int
    lib.ptt_error_string.argtypes = [ctypes.c_int]
    lib.ptt_error_string.restype = ctypes.c_char_p
    _build._lib = lib


def _measure(torch, fa, pa, _build, name, src, inputs):
    _build._CSRC = Path(src).resolve()
    _build._BUILD_DIR = ROOT / "build" / "attn_fwd_stats" / name
    _build._lib = None
    _build.build(force=True)
    prefill = not _offset_by_value(src)
    if name == "parent":
        _load_older(_build, ("ptt_flash_attention_fwd",)
                    + (("ptt_paged_attention_prefill",) if prefill else ()))
        if not prefill:
            cs._log("parent: its chunk prefill takes the offset by value, "
                    "so it is not measured")
    ptxas = {k: list(v) for k, v in cs._ptxas_kernels(
        _build.build_log["ptxas"]).items()
        if re.search(r"(flash_fwd|paged_prefill)\w*kernelI(13__nv_bfloat16)?"
                     r"Li128E(Lb1E|Li[12]E)", k)}
    rows = _errors(torch, fa, pa, inputs, prefill)
    times = _times(torch, fa, pa, mma_sync=name != "parent", prefill=prefill)
    over = {kind: sum(not r[kind]["ok"] for r in rows)
            for kind in ("flash", "prefill") if kind in rows[0]}
    cs._log(f"{name}: " + ", ".join(f"{k} {v:.4f}" for k, v in times.items())
            + f"; seeds over a limit (of {len(rows)}): {over}; flash max "
            f"err {max(r['flash']['max_abs_err'] for r in rows):.3e}, "
            f"bias up to {max(abs(r['flash']['bias']) for r in rows):.2e}; "
            + ("prefill tiled rms "
               + "/".join(f"{r['prefill']['tiled']['rms']:.2e}" for r in rows)
               + ", share up to "
               f"{max(r['prefill']['tiled']['share'] for r in rows):.2e}; "
               if prefill else "")
            + "ptxas (D = 128, full): " + "; ".join(
                f"{_short(k)} {v[0]} regs, spills {v[1]}/{v[2]} B"
                for k, v in sorted(ptxas.items())))
    return dict(seeds=rows, times=times, over=over, ptxas_d128=ptxas)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, default=6)
    ap.add_argument("--parent", help="another csrc directory to measure")
    ap.add_argument("--only", nargs="*", help="the variants to measure "
                    "(default: all)")
    ap.add_argument("--json-out")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("torch_attn_fwd_stats: CUDA is not available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.kernels import paged_attention as pa
    cs._log(f"nvidia-smi: {cs._nvidia_smi()}")
    own = _build._CSRC
    inputs = [_inputs(torch, seed) for seed in range(args.seeds)]
    out = {"this": _measure(torch, fa, pa, _build, "this", own, inputs)}
    for name, subs in VARIANTS.items():
        if args.only is not None and name not in args.only:
            continue
        src = ROOT / "build" / "attn_fwd_stats" / f"{name}_src"
        shutil.rmtree(src, ignore_errors=True)
        shutil.copytree(own, src)
        for file, old, new in subs:
            path = src / file
            text = path.read_text()
            if old not in text:
                raise ValueError(f"variant {name}: {old!r} not in {file}")
            path.write_text(text.replace(old, new))
        out[name] = _measure(torch, fa, pa, _build, name, src, inputs)
    if args.parent:
        out["parent"] = _measure(torch, fa, pa, _build, "parent",
                                 args.parent, inputs)
    if args.json_out:
        Path(args.json_out).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
