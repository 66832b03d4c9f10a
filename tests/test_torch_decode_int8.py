"""The split paged decode and the one-pass int8 matmul, held on the CPU.

``paged_decode_split_reference`` is the decode kernel's plain version in
its own form (the walk split over blocks, each warp's online softmax with
P rounded against its own running max, the fixed-order merges); here it is
held against the JAX Pallas kernel in interpret mode and against the plain
version on the same numpy inputs. The wrapper's split of the page walk is
held to depend on the shapes alone and to fill the card at every decode
bucket, and the int8 module to keep nothing between calls. The CUDA kernels
themselves are held against these plain versions by
``tests/test_torch_gpu.py`` on the card.
"""
import importlib.util
import inspect
import math
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.kernels import paged_attention as jpa
from paddle_tpu_torch.kernels import _build
from paddle_tpu_torch.kernels import int8_matmul as tim
from paddle_tpu_torch.kernels import paged_attention as tpa

ROOT = Path(__file__).resolve().parents[1]

# f32: sums in another order (the kernel form merges states, the JAX kernel
# walks one page at a time), a few ulps of outputs of size ~1
F32_TOL = dict(rtol=2e-5, atol=2e-5)


def _bf16_atol(ref):
    """bf16: both round P to bf16 against different running maxes (a page
    in the JAX kernel, a 16-position step here), so a rounding of P may
    differ, and each rounds its output once: two bf16 spacings (2^-7) of
    the largest |output|."""
    return 2 ** -7 * max(1.0, float(np.abs(ref).max()))


def _case(name, seed=0):
    """(q, k_pages, v_pages, page_table, seq_lens) as numpy f32."""
    rng = np.random.default_rng(seed)
    if name == "ragged_idle":
        B, nh, nkv, d, ps, pps, lens = 4, 4, 4, 16, 8, 4, [29, 3, 16, 0]
    elif name == "gqa":
        B, nh, nkv, d, ps, pps, lens = 3, 8, 2, 32, 4, 3, [11, 5, 12]
    elif name == "gqa12_past_table":
        B, nh, nkv, d, ps, pps, lens = 2, 24, 2, 16, 8, 3, [30, 50]
    else:  # long: many steps and splits
        B, nh, nkv, d, ps, pps, lens = 2, 2, 1, 64, 16, 8, [128, 77]
    npg = B * pps + 1
    pt = rng.permutation(np.arange(1, npg)).reshape(B, pps).astype(np.int32)
    return (rng.standard_normal((B, nh, d)).astype(np.float32),
            rng.standard_normal((npg, ps, nkv, d)).astype(np.float32),
            rng.standard_normal((npg, ps, nkv, d)).astype(np.float32),
            pt, np.array(lens, np.int32))


CASES = ["ragged_idle", "gqa", "gqa12_past_table", "long"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n_split", [1, 2, 3])
@pytest.mark.parametrize("case", CASES)
def test_split_reference_matches_jax_kernel(case, n_split, dtype):
    q, kp, vp, pt, sl = _case(case)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    ref = jpa.paged_attention_decode(
        *(jnp.asarray(a).astype(jd) for a in (q, kp, vp)), jnp.asarray(pt),
        jnp.asarray(sl))
    ref = np.asarray(ref.astype(jnp.float32))
    out = tpa.paged_decode_split_reference(
        *(torch.from_numpy(a).to(td) for a in (q, kp, vp)),
        torch.from_numpy(pt), torch.from_numpy(sl), n_split=n_split)
    out = out.float().numpy()
    live = sl > 0
    assert np.isfinite(out).all()
    if dtype == "float32":
        np.testing.assert_allclose(out[live], ref[live], **F32_TOL)
    else:
        np.testing.assert_allclose(out[live], ref[live], rtol=0,
                                   atol=_bf16_atol(ref[live]))


@pytest.mark.parametrize("case", CASES)
def test_split_reference_matches_plain_at_every_split(case):
    q, kp, vp, pt, sl = (torch.from_numpy(a) for a in _case(case, 1))
    ref = tpa.paged_attention_reference(q, kp, vp, pt, sl)
    live = sl > 0
    for n_split in range(1, pt.shape[1] + 1):
        out = tpa.paged_decode_split_reference(q, kp, vp, pt, sl,
                                               n_split=n_split)
        np.testing.assert_allclose(out[live].numpy(), ref[live].numpy(),
                                   **F32_TOL)
        assert torch.equal(out[~live], torch.zeros_like(out[~live]))


def test_split_reference_rounds_p_per_warp_state():
    """bf16: rounding P is visible (the form with P kept in f32 is another
    function), and the warps' grouping is part of the form: a step of 1
    position rounds against other maxes than the kernel's step."""
    q, kp, vp, pt, sl = (torch.from_numpy(a).bfloat16() if a.dtype ==
                         np.float32 else torch.from_numpy(a)
                         for a in _case("long", 2))
    kernel_form = tpa.paged_decode_split_reference(q, kp, vp, pt, sl,
                                                   n_split=2).float()
    plain = tpa.paged_attention_reference(q.float(), kp.float(), vp.float(),
                                          pt, sl)
    other_steps = tpa.paged_decode_split_reference(q, kp, vp, pt, sl,
                                                   n_split=2, step=1).float()
    assert not torch.equal(kernel_form, plain.bfloat16().float())
    assert not torch.equal(kernel_form, other_steps)
    assert (kernel_form - plain).abs().max() < _bf16_atol(plain.numpy())


@pytest.mark.parametrize("itemsize,d,g,step", [
    (2, 128, 1, 16), (2, 64, 1, 16), (2, 16, 1, 16), (2, 128, 8, 2),
    (2, 100, 2, 8), (4, 128, 1, 8), (4, 64, 12, 2), (4, 16, 1, 16)])
def test_decode_step_mirrors_the_kernels_walk(itemsize, d, g, step):
    """16-byte loads, d / vec lanes a row, at most 16 rows a step and
    8 / G load instructions a lane, as ``Walk`` in the kernel source."""
    assert tpa._decode_step(itemsize, d, g) == step
    src = (_build._CSRC / "paged_attention_decode.cuh").read_text()
    assert "U0 = 8 / G < 16 / RPI ? 8 / G : 16 / RPI" in src
    assert "kMaxSplit = 8;" in src and tpa._MAX_SPLIT == 8


def test_decode_split_depends_only_on_host_shapes():
    params = list(inspect.signature(tpa._decode_split).parameters)
    assert params == ["B", "nkv", "g", "pps", "sms"]
    # and it reads nothing else: no tensor, no global state
    assert set(tpa._decode_split.__code__.co_names) <= {
        "min", "max", "_head_instance", "_BLOCKS_PER_SM", "_MAX_SPLIT"}


@pytest.mark.parametrize("sms", [132, 114, 108])
@pytest.mark.parametrize("nkv,g,pps", [(8, 1, 16), (12, 1, 8), (8, 1, 15),
                                       (2, 4, 16), (1, 12, 32)],
                         ids=["gpt345m", "ernie_moe", "shared_prefix",
                              "gqa4", "gqa12"])
@pytest.mark.parametrize("B", [1, 2, 4, 8])
def test_decode_split_fills_the_card_at_every_bucket(B, nkv, g, pps, sms):
    """At least two blocks an SM where the table's pages and a cluster of
    8 allow, every split a whole number of pages and none of them past the
    table."""
    n = tpa._decode_split(B, nkv, g, pps, sms)
    units = B * nkv * math.ceil(g / tpa._head_instance(g))
    per = math.ceil(pps / n)
    assert 1 <= n <= min(pps, 8) and per * (n - 1) < pps
    assert units * n >= min(2 * sms, units * min(pps, 8))


def test_decode_shared_memory_is_the_warps_states():
    # no page staged: the page size does not enter
    assert tpa._smem_bytes(1, 128, 16) == tpa._smem_bytes(1, 128, 128) \
        == 4 * (4 + 1) * (128 + 2)
    assert tpa._smem_bytes(12, 128, 64) == tpa._smem_bytes(8, 128, 64)


def test_int8_module_keeps_no_state_between_calls():
    """No tickets, no split-K workspace, no per-stream buffers: the module
    holds constants and its launch counter only, the launch allocates the
    output alone, and the C entry takes no workspace."""
    def state():
        return {k for k, v in vars(tim).items()
                if not k.startswith("__") and k != "annotations"
                and not inspect.ismodule(v) and not callable(v)}
    assert state() == {"_DTYPE_CODES", "_LAYOUTS", "launches"}
    assert "ksplit" not in inspect.signature(tim._launch).parameters
    body = inspect.getsource(tim._launch)
    assert body.count("torch.empty") == 1 and "torch.zeros" not in body
    sig = _build._SIGNATURES["ptt_int8_matmul"]
    assert sig.count(_build._P) == 5          # x, w, scale, out, stream
    x = torch.randn(3, 40)
    w = torch.randint(-128, 128, (40, 24), dtype=torch.int8)
    s = torch.rand(24)
    tim.int8_matmul(x, w, s)
    assert state() == {"_DTYPE_CODES", "_LAYOUTS", "launches"}


@pytest.mark.parametrize("source", ["int8_matmul.cu",
                                    "paged_attention_decode.cuh"])
def test_kernels_use_no_atomics(source):
    text = (_build._CSRC / source).read_text()
    assert not re.search(r"\batomic\w*\s*\(", text)


def test_decode_int8_stats_variants_apply_to_the_sources():
    """Every source variant of the card's timing tool replaces text that
    its kernel source holds once (the tool runs only on the card)."""
    path = ROOT / "tools" / "torch_decode_int8_stats.py"
    spec = importlib.util.spec_from_file_location("decode_int8_stats", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.VARIANTS
    for name, files in mod.VARIANTS.items():
        for fname, subs in files.items():
            text = (_build._CSRC / fname).read_text()
            for old, new in subs:
                assert text.count(old) == 1, (name, old)
                text = text.replace(old, new)
