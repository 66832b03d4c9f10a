"""Times of the port's int8 dequant-matmul and paged decode kernels on the
card, for this tree's sources, source variants and another tree's.

    python3 tools/torch_decode_int8_stats.py [--parent CSRC_DIR]
        [--only NAME ...] [--rounds 2] [--json-out PATH]

The int8 kernel at the five GPT-345M weight shapes (wqkv, wo, w1, w2 in
"kn" and the logits in "nk") at M = 1, 2, 4 and 8 and the "kn" shapes at
M = 256, each beside cuBLAS bf16 on a weight dequantized ahead of time;
the paged decode at ``chip_smoke.py``'s bucket-8 shape (8 heads of 128,
page 64, 4002 live tokens), at buckets 1, 2 and 4 (its first sequences)
and at the MoE path's shape (12 heads of 64) beside
SDPA over the K/V gathered dense. bf16, CUDA events with the stream held
by a device sleep, weights and pages cycled over more than the L2 holds.

Source sets: this tree's ``paddle_tpu_torch/csrc`` ("this"), each variant
in ``VARIANTS`` (text replaced in a copy of a source), each wrapper setting
in ``PY_VARIANTS`` (this tree's library) and, with
``--parent``, another directory holding the sources of the kernels'
previous design (their C entries with the split-K workspace and tickets,
for instance ``paddle_tpu_torch/csrc`` of the commit before this design,
unpacked with ``git archive``). Each set is built as ``kernels/_build.py``
builds the tree's, into ``build/decode_int8_stats/<name>``; all are loaded
at once and timed in turns (parent, this, variants, then again in the
reverse order), so every set meets the others on one card; each time is
the lower of its rounds. Each set's outputs are first held against the
plain versions with ``chip_smoke.py``'s limits. Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import math
import shutil
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

# text replacements: source file -> [(old, new), ...]
VARIANTS = {
    # the "nk" lanes load 4 chunks at once instead of 2
    "int8_nk_u4": {"int8_matmul.cu": [
        ("  constexpr int U = 2;                 // chunks a lane loads at once",
         "  constexpr int U = 4;                 // chunks a lane loads at once")]},
    # the decode's lanes take twice the rows a step (32 at d = 128, bf16)
    "decode_u_double": {"paged_attention_decode.cuh": [
        ("static constexpr int U0 = 8 / G < 16 / RPI ? 8 / G : 16 / RPI;",
         "static constexpr int U0 = 16 / G < 32 / RPI ? 16 / G : 32 / RPI;")]},
}
# wrapper settings timed with this tree's library: name -> (module under
# paddle_tpu_torch.kernels, attribute, value)
PY_VARIANTS = {
    # the decode's split aimed at 4 blocks an SM instead of 2
    "decode_4_blocks_an_sm": ("paged_attention", "_BLOCKS_PER_SM", 4),
}
INT8_M = (1, 2, 4, 8)
BUCKET8_LENS = [970, 545, 734, 266, 897, 162, 428, 0]
PAGED = dict(**{f"bucket{B}": dict(B=B, nh=8, nkv=8, d=128, ps=64, pps=16,
                                   lens=BUCKET8_LENS[:B]) for B in (1, 2, 4, 8)},
             moe=dict(B=8, nh=12, nkv=12, d=64, ps=64, pps=8,
                      lens=[n + cs.MAX_NEW for n in cs.MOE_PROMPT_LENS[:7]]
                      + [0]))
N_LAYERS = 8


def _parent_int8(torch, lib, x, w, s, layout):
    """One call of the previous design's C entry: its split of K across
    blocks for "kn" (chunks of 256 to 4096 rows while the tiles are fewer
    than 132), an f32 workspace and zeroed tickets."""
    M, K = x.shape
    N = w.shape[1] if layout == "kn" else w.shape[0]
    split = 1
    if layout == "kn":
        tiles = math.ceil(M / 8) * math.ceil(N / 128)
        split = 1 if tiles >= 132 else math.ceil(K / 256)
        split = max(split, math.ceil(K / 4096))
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    ws = ctr = None
    if split > 1:
        ws = torch.empty(split * math.ceil(M / 8) * 8 * N,
                         dtype=torch.float32, device=x.device)
        ctr = _parent_int8.tickets
    vec = int(w.data_ptr() % 16 == 0 and (N if layout == "kn" else K) % 16
              == 0)
    err = lib.ptt_int8_matmul(
        x.data_ptr(), w.data_ptr(), s.data_ptr(), out.data_ptr(),
        None if ws is None else ws.data_ptr(),
        None if ctr is None else ctr.data_ptr(),
        1 if x.dtype == torch.bfloat16 else 0, 0 if layout == "kn" else 1,
        M, N, K, x.stride(0), split, vec,
        torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"parent int8_matmul: CUDA error {err}")
    return out


def _parent_paged(torch, lib, q, kp, vp, pt, sl):
    B, nh, d = q.shape
    _, ps, nkv, _ = kp.shape
    out = torch.empty_like(q)
    err = lib.ptt_paged_attention_decode(
        q.data_ptr(), kp.data_ptr(), vp.data_ptr(), pt.data_ptr(),
        sl.data_ptr(), out.data_ptr(), 1 if q.dtype == torch.bfloat16 else 0,
        B, nh, nkv, d, ps, pt.shape[1], q.stride(0), q.stride(1),
        d ** -0.5, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"parent paged_attention_decode: CUDA error {err}")
    return out


def _load_parent(path):
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib = ctypes.CDLL(str(path))
    lib.ptt_int8_matmul.argtypes = [P] * 6 + [I] * 8 + [P]
    lib.ptt_paged_attention_decode.argtypes = [P] * 6 + [I] * 9 + [F, P]
    lib.ptt_int8_matmul.restype = lib.ptt_paged_attention_decode.restype = I
    return lib


def _build_set(_build, name, src):
    _build._CSRC = Path(src).resolve()
    _build._BUILD_DIR = ROOT / "build" / "decode_int8_stats" / name
    _build._lib = None
    path = _build.build(force=True)
    regs = {k: list(v) for k, v in cs._ptxas_kernels(
        _build.build_log["ptxas"]).items()
        if any(p in k for p in ("int8_mm", "paged_decode"))}
    return path, regs


def _inputs(torch):
    gen = torch.Generator(device="cuda").manual_seed(9)
    int8 = {}
    for name, K, N, layout in cs.INT8_SHAPES:
        n_copy = max(2, math.ceil(150e6 / (K * N)))
        ws = [cs._int8_weight(torch, gen, K, N, layout) for _ in range(n_copy)]
        dq = [(w.to(torch.bfloat16) if layout == "kn"
               else w.t().to(torch.bfloat16).contiguous()) for w, _ in ws]
        xs = {M: torch.randn(M, K, device="cuda", generator=gen).to(
            torch.bfloat16) for M in INT8_M + ((256,) if layout == "kn"
                                               else ())}
        int8[name] = dict(ws=ws, dq=dq, xs=xs, layout=layout, K=K, N=N)
    paged = {}
    for name, p in PAGED.items():
        pt = cs._page_table(torch, gen, p["B"], p["pps"])
        npg = p["B"] * p["pps"] + 1
        shape = (N_LAYERS, npg, p["ps"], p["nkv"], p["d"])
        kp = torch.randn(*shape, device="cuda", generator=gen).to(
            torch.bfloat16)
        vp = torch.randn(*shape, device="cuda", generator=gen).to(
            torch.bfloat16)
        q = torch.randn(p["B"], p["nh"], p["d"], device="cuda",
                        generator=gen).to(torch.bfloat16)
        sl = torch.tensor(p["lens"], dtype=torch.int32, device="cuda")
        paged[name] = dict(q=q, kp=kp, vp=vp, pt=pt, sl=sl)
    return int8, paged


def _fns(torch, im, pa, kind, lib):
    """(int8 call, paged call) for one source set."""
    if kind == "parent":
        return (lambda x, w, s, layout: _parent_int8(torch, lib, x, w, s,
                                                     layout),
                lambda q, kp, vp, pt, sl: _parent_paged(torch, lib, q, kp,
                                                        vp, pt, sl))
    import importlib
    from paddle_tpu_torch.kernels import _build
    mod, attr, value = PY_VARIANTS.get(kind, ("_build", "_lib", lib))
    mod = importlib.import_module(f"paddle_tpu_torch.kernels.{mod}")

    def with_lib(fn):
        def run(*a):
            _build._lib = lib
            old = getattr(mod, attr)
            setattr(mod, attr, value)
            try:
                return fn(*a)
            finally:
                setattr(mod, attr, old)
        return run
    return (with_lib(lambda x, w, s, layout: im.int8_matmul(
        x, w, s, layout=layout)), with_lib(pa.paged_attention_decode))


def _check(torch, im, pa, fns, int8, paged):
    """Each set's outputs against the plain versions (chip_smoke's limits);
    raises on a disagreement."""
    mm, dec = fns
    for name, c in int8.items():
        for M, x in c["xs"].items():
            w, s = c["ws"][0]
            ref = im.int8_matmul_reference(x, w, s, c["layout"])
            _, _, ok = cs._check("int8", mm(x, w, s, c["layout"]), ref,
                                 "bfloat16",
                                 max(1.0, ref.float().abs().max().item()))
            if not ok:
                raise AssertionError(f"int8 {name} M={M} disagrees")
    for name, c in paged.items():
        args = (c["q"], c["kp"][0], c["vp"][0], c["pt"], c["sl"])
        live = c["sl"] > 0
        _, _, ok = cs._check("paged", dec(*args)[live],
                             pa.paged_attention_reference(*args)[live],
                             "bfloat16")
        if not ok:
            raise AssertionError(f"paged {name} disagrees")


def _cycle(n, fn):
    step = [0]

    def run():
        i = step[0] % n
        step[0] += 1
        return fn(i)
    return run


def _times(torch, fns, int8, paged):
    mm, dec = fns
    out = {}
    for name, c in int8.items():
        n = len(c["ws"])
        for M, x in c["xs"].items():
            out[f"int8 {name} M={M}"] = cs._time_held_ms(torch, _cycle(
                n, lambda i: mm(x, c["ws"][i][0], c["ws"][i][1],
                                c["layout"])), 100)
    for name, c in paged.items():
        out[f"paged {name}"] = cs._time_held_ms(torch, _cycle(
            N_LAYERS, lambda i: dec(c["q"], c["kp"][i], c["vp"][i], c["pt"],
                                    c["sl"])), 200)
    return out


def _library(torch, int8, paged):
    """The yardsticks: cuBLAS on the dequantized weight, SDPA over the
    gathered K/V with a length mask."""
    out = {}
    for name, c in int8.items():
        n = len(c["dq"])
        for M, x in c["xs"].items():
            out[f"int8 {name} M={M}"] = cs._time_held_ms(torch, _cycle(
                n, lambda i: torch.matmul(x, c["dq"][i])), 100)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for name, c in paged.items():
        q, pt, sl = c["q"], c["pt"], c["sl"]
        B, nh, d = q.shape
        _, _, ps, nkv, _ = c["kp"].shape
        t = pt.shape[1] * ps
        dense = [tuple(x[i][pt.long()].reshape(B, t, nkv, d).transpose(1, 2)
                       .contiguous() for x in (c["kp"], c["vp"]))
                 for i in range(N_LAYERS)]
        keep = (torch.arange(t, device="cuda")[None, :]
                < sl.clamp_min(1).long()[:, None])[:, None, None, :]
        out[f"paged {name}"] = cs._time_held_ms(torch, _cycle(
            N_LAYERS, lambda i: sdpa(q[:, :, None], dense[i][0], dense[i][1],
                                     attn_mask=keep)), 200)
        del dense
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="the previous design's csrc directory")
    ap.add_argument("--only", nargs="*", help="the variants to measure "
                    "(default: all)")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--json-out")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("torch_decode_int8_stats: CUDA is not available",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.kernels import int8_matmul as im
    from paddle_tpu_torch.kernels import paged_attention as pa
    smi = cs._nvidia_smi()
    cs._log(f"nvidia-smi: {smi}")
    own = _build._CSRC
    sets = {"this": own}
    for name, files in VARIANTS.items():
        if args.only is not None and name not in args.only:
            continue
        src = ROOT / "build" / "decode_int8_stats" / f"{name}_src"
        shutil.rmtree(src, ignore_errors=True)
        shutil.copytree(own, src)
        for fname, subs in files.items():
            text = (src / fname).read_text()
            for old, new in subs:
                if old not in text:
                    raise ValueError(f"variant {name}: {old!r} not in {fname}")
                text = text.replace(old, new)
            (src / fname).write_text(text)
        sets[name] = src
    if args.parent:
        sets["parent"] = Path(args.parent)
    libs, regs = {}, {}
    for name, src in sets.items():
        path, regs[name] = _build_set(_build, name, src)
        if name == "parent":
            libs[name] = _load_parent(path)
        else:
            _build._lib = None
            libs[name] = _build.load_library()
        cs._log(f"{name}: built {path}")
    _build._CSRC = own
    for name in PY_VARIANTS:
        if args.only is None or name in args.only:
            libs[name] = libs["this"]
    int8, paged = _inputs(torch)
    _parent_int8.tickets = torch.zeros(4096, dtype=torch.int32,
                                       device="cuda")
    fns = {name: _fns(torch, im, pa, name, lib) for name, lib in libs.items()}
    for name, f in fns.items():
        _check(torch, im, pa, f, int8, paged)
        cs._log(f"{name}: outputs within chip_smoke's limits")
    order = sorted(fns, key=lambda n: (n != "parent", n != "this", n))
    times = {name: [] for name in fns}
    for r in range(args.rounds):
        for name in (order if r % 2 == 0 else order[::-1]):
            times[name].append(_times(torch, fns[name], int8, paged))
    lib_ms = _library(torch, int8, paged)
    best = {name: {k: min(t[k] for t in rounds) for k in rounds[0]}
            for name, rounds in times.items()}
    for key in lib_ms:
        cs._log(f"{key}: " + ", ".join(f"{n} {best[n][key]:.4f}"
                                       for n in order)
                + f" ms; library {lib_ms[key]:.4f} ms")
    for n in order:
        total = sum(best[n][f"int8 {s[0]} M=8"] for s in cs.INT8_SHAPES)
        cs._log(f"{n}: int8 five shapes at M = 8 {total:.4f} ms (library "
                f"{sum(lib_ms[f'int8 {s[0]} M=8'] for s in cs.INT8_SHAPES):.4f})")
    if args.json_out:
        Path(args.json_out).write_text(json.dumps(dict(
            nvidia_smi=smi, times=best, rounds=times, library=lib_ms,
            ptxas=regs), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
