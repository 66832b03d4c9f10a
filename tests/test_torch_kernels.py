"""The port's attention kernels against the JAX package.

On the CPU the port's wrappers run their plain PyTorch versions; these are
held against the JAX Pallas kernels run in interpret mode, on the same
numpy inputs. The CUDA kernels themselves are held against the plain
versions by ``tests/test_torch_gpu.py`` on the card.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.kernels import flash_attention as jfa
from paddle_tpu.kernels import int8_matmul as jim
from paddle_tpu.kernels import paged_attention as jpa
from paddle_tpu_torch.kernels import _build
from paddle_tpu_torch.kernels import flash_attention as tfa
from paddle_tpu_torch.kernels import int8_matmul as tim
from paddle_tpu_torch.kernels import paged_attention as tpa

TOL = dict(rtol=2e-5, atol=2e-5)


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


# ------------------------------------------------------------ paged decode

def _paged_case(name):
    """(q, k_pages, v_pages, page_table, seq_lens, live rows) as numpy."""
    if name == "ragged_idle":
        B, nh, nkv, d, npg, ps = 4, 4, 4, 16, 13, 8
        pt = np.array([[1, 2, 3, 4], [5, 0, 0, 0], [6, 7, 0, 0],
                       [0, 0, 0, 0]], np.int32)
        sl = np.array([29, 3, 16, 0], np.int32)
    elif name == "gqa":
        B, nh, nkv, d, npg, ps = 3, 8, 2, 32, 9, 4
        pt = np.array([[1, 2, 3], [4, 5, 0], [6, 7, 8]], np.int32)
        sl = np.array([11, 5, 12], np.int32)
    else:  # one sequence over shuffled pages
        B, nh, nkv, d, npg, ps = 1, 2, 1, 8, 6, 4
        pt = np.array([[2, 4, 1]], np.int32)
        sl = np.array([11], np.int32)
    q = _rand((B, nh, d), 1)
    kp = _rand((npg, ps, nkv, d), 2)
    vp = _rand((npg, ps, nkv, d), 3)
    return q, kp, vp, pt, sl, np.flatnonzero(sl > 0)


@pytest.mark.parametrize("case", ["ragged_idle", "gqa", "shuffled_pages"])
def test_paged_reference_matches_jax_kernel(case):
    q, kp, vp, pt, sl, live = _paged_case(case)
    ref = jpa.paged_attention_decode(*(jnp.asarray(a)
                                       for a in (q, kp, vp, pt, sl)))
    out = tpa.paged_attention_decode(*(torch.from_numpy(a)
                                       for a in (q, kp, vp, pt, sl)))
    out = out.numpy()
    np.testing.assert_allclose(out[live], np.asarray(ref)[live], **TOL)
    assert np.isfinite(out).all()


def test_paged_reference_matches_jax_reference():
    q, kp, vp, pt, sl, _ = _paged_case("gqa")
    ref = jpa.paged_attention_reference(*(jnp.asarray(a)
                                          for a in (q, kp, vp, pt, sl)))
    out = tpa.paged_attention_reference(*(torch.from_numpy(a)
                                          for a in (q, kp, vp, pt, sl)))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_paged_rejects_bad_heads_and_devices():
    q, kp, vp, pt, sl, _ = _paged_case("gqa")
    t = [torch.from_numpy(a) for a in (q, kp, vp, pt, sl)]
    with pytest.raises(ValueError):
        tpa.paged_attention_decode(t[0][:, :3], *t[1:])   # 3 % 2 heads
    meta = [x.to("meta") for x in t]
    with pytest.raises(ValueError):
        tpa.paged_attention_decode(*meta)


# --------------------------------------------------------- flash forward

FLASH_CASES = {
    # name: (B, Sq, Sk, N, Nkv, D, causal, q_offset)
    "causal_d64": (2, 128, 128, 2, 2, 64, True, None),
    "causal_d128": (1, 128, 128, 2, 2, 128, True, None),
    "causal_ragged": (1, 100, 100, 2, 2, 64, True, None),
    "causal_offset": (1, 64, 160, 2, 2, 64, True, 96),
    "gqa_causal": (1, 128, 128, 4, 2, 64, True, None),
    "cross_ragged": (1, 70, 130, 2, 1, 128, False, None),
}


def _flash_inputs(case):
    B, Sq, Sk, N, Nkv, D, causal, off = FLASH_CASES[case]
    return (_rand((B, Sq, N, D), 10), _rand((B, Sk, Nkv, D), 11),
            _rand((B, Sk, Nkv, D), 12), causal, off)


@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_reference_matches_jax_kernel(case):
    q, k, v, causal, off = _flash_inputs(case)
    ref = jfa.flash_attention_bshd(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), causal=causal,
                                   q_offset=off)
    out = tfa.flash_attention_bshd(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(v), causal=causal,
                                   q_offset=off)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("d,g,causal", [(64, 1, True), (128, 2, True),
                                        (64, 1, False)])
def test_flash_lse_matches_jax_fwd(d, g, causal):
    """The kernel's second output, the f32 log-sum-exp, against JAX
    ``_fwd`` (head-major [BN, S, D] at a block-multiple length)."""
    bn, s = 4, 256
    q = _rand((bn, s, d), 20)
    k = _rand((bn // g, s, d), 21)
    v = _rand((bn // g, s, d), 22)
    scale = 1.0 / math.sqrt(d)
    o_j, lse_j = jfa._fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          causal, scale, g)
    as4 = lambda a: torch.from_numpy(a).transpose(0, 1).unsqueeze(0)
    o_t, lse_t = tfa.flash_attention_fwd(as4(q), as4(k), as4(v), causal,
                                         scale)
    np.testing.assert_allclose(lse_t[0].numpy(), np.asarray(lse_j)[..., 0],
                               **TOL)
    np.testing.assert_allclose(o_t[0].transpose(0, 1).numpy(),
                               np.asarray(o_j), **TOL)


def test_flash_head_major_matches_bshd():
    q, k, v, causal, off = _flash_inputs("gqa_causal")
    ref = tfa.flash_attention_bshd(*(torch.from_numpy(a) for a in (q, k, v)),
                                   causal=True)
    to3 = lambda a: torch.from_numpy(a)[0].transpose(0, 1).contiguous()
    out = tfa.flash_attention(to3(q), to3(k), to3(v), causal=True)
    np.testing.assert_allclose(out.transpose(0, 1).numpy(), ref[0].numpy(),
                               rtol=0, atol=0)


def test_flash_argument_checks_match_jax():
    q, k, v, _, _ = _flash_inputs("causal_offset")
    t = [torch.from_numpy(a) for a in (q, k, v)]
    for fn, arrs in ((tfa.flash_attention_bshd, t),
                     (jfa.flash_attention_bshd,
                      [jnp.asarray(a) for a in (q, k, v)])):
        with pytest.raises(ValueError):
            fn(*arrs, causal=True)                 # Sk != Sq, no offset
        with pytest.raises(ValueError):
            fn(*arrs, causal=False, q_offset=0)    # offset needs causal
        with pytest.raises(ValueError):
            fn(*arrs, causal=True, q_offset=100)   # past the key horizon


def test_supported_gate():
    assert tfa.supported((2, 256, 4, 64))
    assert tfa.supported((1, 1024, 8, 128))
    assert tfa.supported((2, 100, 4, 64), (2, 100, 2, 64), (2, 100, 2, 64),
                         causal=True)
    assert not tfa.supported((2, 32, 4, 64))       # below the profit line
    assert tfa.supported((2, 256, 4, 96))          # any head dim <= 128
    assert not tfa.supported((2, 256, 4, 160))     # past 128
    assert not tfa.supported((2, 256, 64))         # wrong rank
    assert not tfa.supported((1, 64, 4, 64), (1, 128, 4, 64), causal=True)
    assert tfa.supported((1, 64, 4, 64), (1, 128, 4, 64), causal=True,
                         q_offset=64)


def test_ctypes_signatures_match_c_entries():
    """Every bound C entry exists in csrc/ with as many parameters as its
    ctypes argtypes, pointers where the binding passes pointers."""
    import re
    src = "".join(p.read_text() for p in _build._sources())
    for name, argtypes in _build._SIGNATURES.items():
        m = re.search(r'extern "C" int ' + name + r"\(([^)]*)\)", src)
        assert m, name
        params = [p.strip() for p in m.group(1).split(",")]
        assert len(params) == len(argtypes), name
        for p, a in zip(params, argtypes):
            assert ("*" in p) == (a is _build._P), (name, p)


@pytest.mark.parametrize("tool,source", [
    ("torch_flash_bwd_stats", "flash_attention_bwd_tc.cuh"),
    ("torch_flash_bwd_stats", "flash_attention_bwd_wg.cu"),
    ("torch_attn_fwd_stats", "attention_fwd_tc.cuh"),
    ("torch_attn_fwd_stats", "flash_attention_fwd_wg.cu")])
def test_stats_tool_variants_apply_to_the_sources(tool, source):
    """Every source variant of the card's statistics tools replaces text
    that the kernel source it names holds, so each tool builds the variant
    it names (the tools run only on the card); each source listed here has
    variants."""
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "tools" / f"{tool}.py"
    spec = importlib.util.spec_from_file_location(tool, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    text = (_build._CSRC / source).read_text()
    assert mod.VARIANTS
    varied = 0
    for name, subs in mod.VARIANTS.items():
        variant = text
        for file, old, new in subs:
            assert (_build._CSRC / file).exists(), (name, file)
            if file != source:
                continue
            assert old in variant, (name, old)
            variant = variant.replace(old, new)
        if any(file == source for file, _, _ in subs):
            assert variant != text, name
            varied += 1
    assert varied, source


def _fused_views(B, S, N, Nkv, D, dtype=torch.bfloat16, offset=0):
    """q, k, v as slices of one [B, S, N + 2 Nkv, D + offset] tensor (their
    columns from ``offset``), and a contiguous output gradient."""
    qkv = torch.zeros(B, S, N + 2 * Nkv, D + offset, dtype=dtype)
    q, k, v = qkv[..., offset:].split([N, Nkv, Nkv], dim=2)
    return q, k, v, torch.zeros(B, S, N, D, dtype=dtype)


ROUTE_CASES = {
    # name: (views, forward route, dK/dV route)
    "training_fused_qkv": (lambda: (*torch.zeros(
        12, 1024, 3, 8, 128, dtype=torch.bfloat16).unbind(2),
        torch.zeros(12, 1024, 8, 128, dtype=torch.bfloat16)),
        "wgmma", "wgmma"),
    "serving_contiguous": (lambda: tuple(torch.zeros(
        1, 1024, 8, 128, dtype=torch.bfloat16) for _ in range(4)),
        "wgmma", "wgmma"),
    "gqa_masked_d80": (lambda: _fused_views(2, 300, 4, 2, 80),
                       "wgmma", "wgmma"),
    "masked_d40": (lambda: _fused_views(2, 300, 4, 2, 40), "wgmma", "wgmma"),
    # a head stride of 100 elements (200 bytes): no tensor map
    "unaligned_d100": (lambda: _fused_views(1, 64, 2, 2, 100),
                       "mma_sync", "mma_sync"),
    # views starting one element into their rows: base not 16-byte aligned
    "unaligned_base": (lambda: _fused_views(1, 64, 2, 2, 64, offset=1),
                       "mma_sync", "mma_sync"),
    # q, k, v aligned, the output gradient not: the forward keeps wgmma
    "unaligned_do": (lambda: (*_fused_views(1, 64, 2, 2, 64)[:3],
                              torch.zeros(1, 64, 2, 65,
                                          dtype=torch.bfloat16)[..., 1:]),
                     "wgmma", "mma_sync"),
    "float32": (lambda: _fused_views(1, 64, 2, 2, 64, torch.float32),
                "cuda_core", "cuda_core"),
}


@pytest.mark.parametrize("case", sorted(ROUTE_CASES))
def test_attention_route_from_shapes_and_strides(case):
    """The C launches' rule, mirrored in ``kernel_route``: bf16 views that
    TMA can describe (16-byte aligned base, strides multiples of 16 bytes)
    take the wgmma kernels, other bf16 views the mma.sync ones, f32 the
    CUDA-core ones; decided from the views alone."""
    make, fwd, dkv = ROUTE_CASES[case]
    q, k, v, do = make()
    assert tfa.kernel_route(q, k, v) == fwd
    assert tfa.kernel_route(q, k, v, do) == dkv


@pytest.mark.parametrize("b,n,sq,rows", [
    (12, 8, 1024, 128),     # the training shape: 768 blocks of 128 rows
    (1, 8, 1024, 64),       # the serving shape: 64 such blocks < 132 SMs
    (2, 8, 1024, 64),       # 128 blocks of 128 rows still < 132
    (3, 8, 1024, 128),      # 192
    (1, 8, 233, 64),
    (1, 32, 1024, 128)])
def test_fwd_query_tile_fills_the_card(b, n, sq, rows):
    """The wgmma forward's query rows a block: 128 (two consumer
    warpgroups) where those blocks fill the H100's 132 SMs, else 64."""
    assert tfa.fwd_query_rows(b, n, sq) == rows
    assert tfa.fwd_query_rows(b, n, sq, num_sms=10 ** 6) == 64


# -------------------------------------------------------- flash backward

# bf16: P and dS are rounded to bf16 before their products, in both
# packages; where the two sums that feed a rounding point differ in order,
# it can land on the other side of a tie and move a gradient element by
# about one bf16 spacing of one term (<= 2^-8 relative). The largest such
# move seen on these inputs is 2e-3 at |grad| <= 5.
BWD_TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
           "bfloat16": dict(rtol=0, atol=8e-3)}


def _jax_vjp(q, k, v, do, causal, off, dtype):
    jd = getattr(jnp, dtype)
    f = lambda q_, k_, v_: jfa.flash_attention_bshd(q_, k_, v_, causal=causal,
                                                    q_offset=off)
    _, vjp = jax.vjp(f, *(jnp.asarray(a).astype(jd) for a in (q, k, v)))
    return [np.asarray(g.astype(jnp.float32))
            for g in vjp(jnp.asarray(do).astype(jd))]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_bwd_matches_jax_vjp(case, dtype):
    """The plain backward, and the autograd Function that runs it on the
    CPU, against ``jax.vjp`` of the JAX flash kernel (interpret mode)."""
    q, k, v, causal, off = _flash_inputs(case)
    do = _rand(q.shape, 13)
    ref = _jax_vjp(q, k, v, do, causal, off, dtype)
    td = getattr(torch, dtype)
    tq, tk, tv, tdo = (torch.from_numpy(a).to(td) for a in (q, k, v, do))
    o, lse = tfa.flash_attention_fwd(tq, tk, tv, causal, q_offset=off)
    plain = tfa.flash_attention_bwd(tq, tk, tv, o, lse, tdo, causal,
                                    q_offset=off)
    leaves = [t.requires_grad_() for t in (tq, tk, tv)]
    out = tfa.flash_attention_bshd(*leaves, causal=causal, q_offset=off)
    auto = torch.autograd.grad(out, leaves, tdo)
    for name, p, a, r in zip("qkv", plain, auto, ref):
        assert p.dtype == td, name
        torch.testing.assert_close(a, p, rtol=0, atol=0)
        np.testing.assert_allclose(p.float().numpy(), r, **BWD_TOL[dtype],
                                   err_msg=f"d{name}")


def test_flash_head_major_is_differentiable():
    q, k, v, _, _ = _flash_inputs("gqa_causal")
    do = torch.from_numpy(_rand(q.shape, 14))
    t4 = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    ref = torch.autograd.grad(tfa.flash_attention_bshd(*t4, causal=True),
                              t4, do)
    t3 = [torch.from_numpy(a)[0].transpose(0, 1).contiguous()
          .requires_grad_() for a in (q, k, v)]
    out = tfa.flash_attention(*t3, causal=True)
    got = torch.autograd.grad(out, t3, do[0].transpose(0, 1))
    for g, r in zip(got, ref):
        torch.testing.assert_close(g.transpose(0, 1), r[0], rtol=0, atol=0)


def test_flash_bwd_refuses_mixed_devices():
    q, k, v, causal, off = _flash_inputs("causal_d64")
    t = [torch.from_numpy(a) for a in (q, k, v)]
    o, lse = tfa.flash_attention_fwd(*t, causal=True)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        tfa.flash_attention_bwd(*t, o, lse.to("meta"), o, causal=True)


# ---------------------------------------------------------- chunk prefill

def _prefill_case(seed=20):
    """Two sequences of a 4-head pool (d = 16, page 8); the second maps the
    first's two leading pages (a shared prefix) and then its own."""
    B, C, nh, d, ps, pps = 2, 16, 4, 16, 8, 6
    npg = B * pps + 1
    pt = np.arange(1, npg, dtype=np.int32).reshape(B, pps)
    pt[1, :2] = pt[0, :2]
    return (_rand((B, C, nh, d), seed), _rand((npg, ps, nh, d), seed + 1),
            _rand((npg, ps, nh, d), seed + 2), pt)


@pytest.mark.parametrize("q_offset", [0, 5, 16, 27, 32])
def test_prefill_plain_matches_jax(q_offset):
    """The port's chunk prefill on the CPU (its plain version, the XLA
    path) against the JAX Pallas kernel in interpret mode and the JAX XLA
    path, f32, at offsets 0, mid-page, page-aligned and late (the last
    pages of the table skipped by the kernel)."""
    arrays = _prefill_case()
    kern = jpa.ragged_prefill_attention(*map(jnp.asarray, arrays), q_offset,
                                        interpret=True)
    xla = jpa.paged_prefill_attention(*map(jnp.asarray, arrays), q_offset)
    t = [torch.from_numpy(a) for a in arrays]
    out = tpa.ragged_prefill_attention(*t, q_offset).numpy()
    np.testing.assert_allclose(out, np.asarray(kern), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(out, np.asarray(xla), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        tpa.paged_prefill_attention(*t, q_offset, scale=0.3).numpy(),
        np.asarray(jpa.paged_prefill_attention(
            *map(jnp.asarray, arrays), q_offset, scale=0.3)),
        rtol=1e-5, atol=1e-5)


def test_prefill_plain_bf16_matches_jax_xla():
    """bf16: the port's plain version against the JAX XLA path in bf16.
    Both round the scores, the softmax output and P.V to bf16 at the same
    points (they agree bit for bit here); the limit is one bf16 spacing
    at the outputs' magnitude (|out| < 2, spacing 2^-7), for sums taken
    in another order."""
    arrays = _prefill_case(seed=30)
    q, kp, vp, pt = arrays
    jx = [jnp.asarray(a).astype(jnp.bfloat16) for a in (q, kp, vp)]
    xla = jpa.paged_prefill_attention(*jx, jnp.asarray(pt), 19)
    t = [torch.from_numpy(a).to(torch.bfloat16) for a in (q, kp, vp)]
    out = tpa.ragged_prefill_attention(*t, torch.from_numpy(pt), 19)
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(xla, np.float32), rtol=0,
                               atol=2 ** -7)


def _rms(a):
    return float(np.sqrt(np.mean(np.square(a, dtype=np.float64))))


@pytest.mark.parametrize("q_offset", [0, 5, 16, 27, 32])
def test_prefill_tiled_reference_matches_jax_kernel(q_offset):
    """The plain version with the kernel's rounding points (positions in
    blocks of a page, f32 online softmax, P rounded to bf16 before P.V)
    against the JAX Pallas kernel in interpret mode: f32 at 1e-5; bf16
    with rms(out - ref) / rms(ref) <= 2e-4 and the largest error at most
    one bf16 spacing of the largest output (2^-7 of max |ref|), for sums
    in another order (they agree bit for bit here). The control, the same
    without the rounding of P, must exceed that rms limit (it reads
    1.4e-3 to 2.1e-3 here), or the limit could not see P's rounding."""
    arrays = _prefill_case()
    ps = arrays[1].shape[1]
    kern = jpa.ragged_prefill_attention(*map(jnp.asarray, arrays), q_offset,
                                        interpret=True)
    t = [torch.from_numpy(a) for a in arrays]
    np.testing.assert_allclose(
        tpa.ragged_prefill_reference(*t, q_offset, block=ps).numpy(),
        np.asarray(kern), rtol=1e-5, atol=1e-5)
    jb = [jnp.asarray(a).astype(jnp.bfloat16) for a in arrays[:3]]
    want = np.asarray(jpa.ragged_prefill_attention(
        *jb, jnp.asarray(arrays[3]), q_offset, interpret=True), np.float32)
    tb = [torch.from_numpy(a).to(torch.bfloat16) for a in arrays[:3]]
    got = tpa.ragged_prefill_reference(*tb, t[3], q_offset, block=ps)
    ctl = tpa.ragged_prefill_reference(*tb, t[3], q_offset, block=ps,
                                       round_p=False)
    assert got.dtype == torch.bfloat16
    err = got.float().numpy() - want
    assert _rms(err) <= 2e-4 * _rms(want)
    assert np.abs(err).max() <= 2 ** -7 * np.abs(want).max()
    assert _rms(ctl.float().numpy() - want) > 2e-4 * _rms(want)


# ------------------------------------------------------------ int8 matmul

@pytest.mark.parametrize("M,K,N", [(1, 64, 96), (3, 100, 77), (8, 48, 130),
                                   (37, 16, 5)])
@pytest.mark.parametrize("layout", ["kn", "nk"])
def test_int8_plain_matches_jax_kernel(M, K, N, layout):
    """The port's int8 matmul on the CPU (its plain version) against the
    JAX Pallas kernel in interpret mode, both weight layouts (the JAX
    kernel takes [K, N]; the "nk" weight is its transpose), odd shapes."""
    rng = np.random.default_rng(M * K + N)
    x = _rand((M, K), 40)
    w = rng.integers(-128, 128, (K, N)).astype(np.int8)
    s = rng.uniform(1e-3, 2e-2, N).astype(np.float32)
    ref = np.asarray(jim.int8_matmul(jnp.asarray(x), jnp.asarray(w),
                                     jnp.asarray(s), interpret=True))
    tw = torch.from_numpy(w if layout == "kn" else np.ascontiguousarray(w.T))
    out = tim.int8_matmul(torch.from_numpy(x), tw, torch.from_numpy(s),
                          layout=layout).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)
    # bf16 x: the f32 sum times the f32 scale, rounded once (a sum in
    # another order may round the other way: one bf16 spacing)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    bf = tim.int8_matmul(xb, tw, torch.from_numpy(s), layout=layout)
    want = torch.from_numpy(xb.float().numpy() @ w.astype(np.float32) * s)
    assert bf.dtype == torch.bfloat16
    torch.testing.assert_close(bf.float(), want, rtol=2 ** -8, atol=1e-6)
