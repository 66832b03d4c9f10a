"""Times of the port's MoE dispatch and combine kernels on the card, over
source variants and another tree.

    python3 tools/torch_moe_stats.py [--parent ROOT] [--only NAME ...]
        [--json-out PATH]

bf16 at ERNIE-MoE base width (M = 768, E = 8, top-2, C = S), the stream held
(``chip_smoke._time_held_ms``): the dispatch on each of its routes at every
S of ``SWEEP_S`` for this tree's sources ("this") and, on the one-launch
route, for each source variant in ``VARIANTS`` (text replaced in a copy of
``paddle_tpu_torch``; the three passes too where the variant changes
them); with ``--parent``, another tree's dispatch (for
instance a parent commit's ``paddle_tpu_torch`` unpacked with ``git
archive`` under ROOT), timed in turns with this tree's. Then each kernel's
own device time under the profiler at S = 8 and 512, the one-launch
kernel's phases in SM clock cycles (the "timed" variant, which records
``clock64()`` in block 0 and returns the readings through ``me``), and the
combine beside ``F.embedding_bag`` and the other tree's. Each source set
builds only ``common.cu`` and ``moe_dispatch.cu``, into
``build/moe_<name>`` (``chip_smoke._load_moe_tree``). Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import re
import shutil
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

CU = "moe_dispatch.cu"
# text replacements in csrc/moe_dispatch.cu, (file, old, new): the one-launch
# kernel with gate_w read from device memory instead of its staged copy;
# with each lane on a block of M / 32 consecutive m (rows of gate_w 384
# bytes apart, a bank conflict on every staged read; M % 32 == 0); the
# three-pass gate kernel with the bias and the gate value through the
# helpers the one-launch kernel uses; and "timed"
_STAGE = ("  return 4 * one_launch_stage_at(S, E, K) + bytes <= kStaticSmem "
          "? bytes : 0;")
_LOOP = ("    for (int m = lane; m < M; m += 32)\n"
         "      gate_fma<W, EP, STAGE>(to_float<T>(xr[m]), m, gws, gw, E, "
         "acc);")
VARIANTS = {
    "no_stage": [(CU, _STAGE, "  return 0 * bytes;")],
    "lanes_on_m_blocks": [
        (CU, _LOOP,
         "    for (int j = 0; j < M / 32; ++j) {\n"
         "      const int m = lane * (M / 32) + j;\n"
         "      gate_fma<W, EP, STAGE>(to_float<T>(xr[m]), m, gws, gw, E, "
         "acc);\n    }")],
    "gate_helpers": [
        (CU, "      if (lane == 0)\n        lg[t * E + e] =\n            a + "
             "(b_bf16 ? to_float<__nv_bfloat16>(\n                         "
             "static_cast<const __nv_bfloat16*>(gb)[e])\n                "
             "        : static_cast<const float*>(gb)[e]);",
         "      if (lane == 0) lg[t * E + e] = a + gate_bias(gb, b_bf16, e);"),
        (CU, "        float v;\n        if (kind == kNaive) v = l[e];\n"
             "        else if (kind == kSwitch) v = p[e];\n"
             "        else if (kind == kGShard) v = p[e] / (denom + 1e-9f);\n"
             "        else v = p[e] / fmaxf(denom, 1e-9f);\n"
             "        val[(long long)s * K + k] = v;",
         "        val[(long long)s * K + k] = gate_value(kind, l[e], p[e], "
         "denom);")],
    "timed": [
        (CU, "  const bool lead = blockIdx.x == 0;     // writes the small "
             "outputs\n",
         "  const bool lead = blockIdx.x == 0;     // writes the small "
         "outputs\n  long long tk[7];\n  tk[0] = clock64();\n"),
        (CU, "    __syncthreads();\n  }\n\n  // 1-2: route every token",
         "    __syncthreads();\n  }\n  tk[1] = clock64();\n\n"
         "  // 1-2: route every token"),
        (CU, "    float l = 0.f;                      // lane e: expert e's "
             "logit",
         "    tk[2] = clock64();\n    float l = 0.f;"),
        (CU, "    if (lane < K) {\n      ch[t * K + lane] = my_e;",
         "    tk[3] = clock64();\n    if (lane < K) {\n"
         "      ch[t * K + lane] = my_e;"),
        (CU, "  // 3: slots, one warp", "  tk[4] = clock64();\n"
                                       "  // 3: slots, one warp"),
        (CU, "  // 4: this block's share of the rows, a warp each",
         "  tk[5] = clock64();\n  // 4: the rows"),
        (CU, "      zero_row(dst, M, vec, lane);\n  }\n}\n",
         "      zero_row(dst, M, vec, lane);\n  }\n  tk[6] = clock64();\n"
         "  if (lead && threadIdx.x == 0)\n"
         "    for (int i = 1; i < 7; ++i) me[i] = (float)(tk[i] - tk[0]);\n"
         "}\n")],
}
PHASES = ("staged", "gate", "softmax and top-k", "first barrier",
          "slots and second barrier", "rows")
SWEEP_S = (1, 2, 4, 8, 16, 32, 64, 96, 128, 192, 256, 512)
COMBINE_S = (1, 8, 512)
M, E, K = cs.MOE_M, cs.MOE_E, 2


def _kernel_us(torch, fn, calls=20):
    """Mean device microseconds of each MoE kernel ``fn`` launches."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    for _ in range(4):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        runs = {}
        for e in prof.events():
            m = re.search(r"moe_\w+_kernel", e.name)
            if e.device_type == DeviceType.CUDA and m:
                runs.setdefault(m.group(0), []).append(
                    e.time_range.elapsed_us())
        if runs:
            return {k: sum(v) / len(v) for k, v in runs.items()}
    return {}


def _variant_tree(name, subs):
    dst = ROOT / "build" / f"moe_{name}_src"
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(ROOT / "paddle_tpu_torch", dst / "paddle_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for file, old, new in subs:
        path = dst / "paddle_tpu_torch" / "csrc" / file
        text = path.read_text()
        if old not in text:
            raise ValueError(f"variant {name}: {old!r} not in {file}")
        path.write_text(text.replace(old, new))
    return dst


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="another tree holding paddle_tpu_torch")
    ap.add_argument("--only", nargs="*", help="the variants to build "
                    "(default: all)")
    ap.add_argument("--json-out")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("torch_moe_stats: CUDA is not available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    cs._log(f"nvidia-smi: {cs._nvidia_smi()}")
    clocks = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    cs._log(f"SM clock now, max: {clocks.strip()}")
    specs = [("this", ROOT)]
    if args.parent:
        specs.append(("parent", args.parent))
    specs += [(name, _variant_tree(name, subs))
              for name, subs in VARIANTS.items()
              if args.only is None or name in args.only]
    with ThreadPoolExecutor(len(specs)) as ex:     # the builds in parallel
        futures = {name: ex.submit(cs._load_moe_tree, root, name)
                   for name, root in specs}
    trees = {name: f.result() for name, f in futures.items()}
    gen = torch.Generator(device="cuda").manual_seed(8)
    out = dict(dispatch={}, kernels={}, phases={}, combine={})
    for S in SWEEP_S:
        x, gw, gb = cs._moe_inputs(torch, gen, "bfloat16", S)
        kw = dict(num_expert=E, capacity=S, top_k=K)
        runs = {}
        for name, md in trees.items():
            if name == "parent":
                runs[name] = lambda md=md: md.fused_moe_dispatch(x, gw, gb,
                                                                 **kw)
                continue
            for route in md.DISPATCH_ROUTES:
                if route == "three_pass" and name not in (
                        "this", "gate_helpers"):
                    continue
                if route == "one_launch" and not md._one_launch_fits(S, E, K):
                    continue

                def run(md=md, route=route):
                    with md._dispatch_route(route):
                        return md.fused_moe_dispatch(x, gw, gb, **kw)
                runs[f"{name}/{route}"] = run
        order = list(runs)
        t = {k: [] for k in order}
        with torch.no_grad():
            for k in order + order[::-1]:
                t[k].append(cs._time_held_ms(torch, runs[k], 100))
        out["dispatch"][S] = t
        cs._log(f"dispatch S={S}: " + ", ".join(
            f"{k} {sum(v) / 2:.4f} ms" for k, v in t.items()))
        if S in (8, 512):
            with torch.no_grad():
                out["kernels"][S] = {k: _kernel_us(torch, fn)
                                     for k, fn in runs.items()
                                     if k.startswith(("this", "parent",
                                                      "gate_helpers"))}
            cs._log(f"  kernels at S={S} (us): " + json.dumps(
                {k: {n: round(us, 3) for n, us in v.items()}
                 for k, v in out["kernels"][S].items()}))
        if "timed" in trees and S in (1, 8, 64):
            md = trees["timed"]
            reads = []
            with torch.no_grad(), md._dispatch_route("one_launch"):
                for _ in range(20):
                    reads.append(md.fused_moe_dispatch(x, gw, gb, **kw)[3]
                                 [1:7].tolist())
            cum = [statistics.median(r[i] for r in reads[5:])
                   for i in range(6)]
            steps = [b - a for a, b in zip([0.0] + cum[:-1], cum)]
            out["phases"][S] = dict(zip(PHASES, steps))
            cs._log(f"  one-launch phases at S={S}, SM cycles of block 0: "
                    + ", ".join(f"{p} {c:.0f}" for p, c in zip(PHASES,
                                                               steps)))
    for S in COMBINE_S:
        x, gw, gb = cs._moe_inputs(torch, gen, "bfloat16", S)
        with torch.no_grad():
            md = trees["this"]
            _, comb, val, _, _ = md.fused_moe_dispatch(
                x, gw, gb, num_expert=E, capacity=S, top_k=K)
            eo = torch.randn(E * S, M, device="cuda", generator=gen).to(
                torch.bfloat16)
            eo_pad = torch.cat([eo, eo.new_zeros(1, M)])
            val_dt = val.to(eo.dtype)
            runs = {n: (lambda md=t: md.fused_moe_combine(eo, val, comb))
                    for n, t in trees.items() if n in ("this", "parent")}
            runs["embedding_bag"] = lambda: torch.nn.functional.embedding_bag(
                comb, eo_pad, per_sample_weights=val_dt, mode="sum",
                padding_idx=E * S)
            order = list(runs)
            t = {k: [] for k in order}
            for k in order + order[::-1]:
                t[k].append(cs._time_held_ms(torch, runs[k], 100))
        out["combine"][S] = t
        cs._log(f"combine S={S}: " + ", ".join(
            f"{k} {sum(v) / 2:.4f} ms" for k, v in t.items()))
    if args.json_out:
        Path(args.json_out).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
