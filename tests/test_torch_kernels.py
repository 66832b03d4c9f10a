"""The port's attention kernels against the JAX package.

On the CPU the port's wrappers run their plain PyTorch versions; these are
held against the JAX Pallas kernels run in interpret mode, on the same
numpy inputs. The CUDA kernels themselves are held against the plain
versions by ``tests/test_torch_gpu.py`` on the card.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.kernels import flash_attention as jfa
from paddle_tpu.kernels import paged_attention as jpa
from paddle_tpu_torch.kernels import _build
from paddle_tpu_torch.kernels import flash_attention as tfa
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
    assert not tfa.supported((2, 256, 4, 96))      # head dim the kernel lacks
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
