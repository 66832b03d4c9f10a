"""Faults once found in the port against the reference, held on the CPU.

1. Head dims: the attention kernels take every head dim 0 < d <= 128, as
   the JAX kernels do (the card tests in ``tests/test_torch_gpu.py`` run
   them at d = 16, 32, 48, 64 and 128); here the instance rule, the
   kernels' shared-memory budget at every instance and the flash gate.
2. ``decode_step_fn`` casts the embedding sum to the compute dtype, as the
   JAX step does: with bf16 weights and an f32 compute dtype the step runs
   in f32 on both sides.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import gpt as jgpt
from paddle_tpu.serving import engine as jengine
from paddle_tpu_torch.kernels import _build
from paddle_tpu_torch.kernels import flash_attention as tfa
from paddle_tpu_torch.kernels import paged_attention as tpa
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.serving import decode_step_fn


def test_every_head_dim_up_to_128_has_an_instance():
    for d in range(1, 129):
        D = _build.instance_head_dim(d)
        assert D in _build.HEAD_DIM_INSTANCES and d <= D and (D == 16 or D < 2 * d)
    for d in (0, 129, 256):
        with pytest.raises(ValueError, match="head dim"):
            _build.instance_head_dim(d)
    for d in (16, 32, 48, 64, 96, 128):
        assert tgpt.flash_attention_gate(512, d, None, "cuda")
        assert tgpt.flash_attention_gate(512, d, True, "cpu")
        assert tfa.supported((1, 512, 4, d))
    assert not tfa.supported((1, 512, 4, 0))


@pytest.mark.parametrize("D", _build.HEAD_DIM_INSTANCES)
def test_decode_shared_memory_fits_at_every_instance(D):
    """The paged decode block's shared memory at the engines' shapes (one
    query head per KV head; GQA up to 8; pages of 16 to 128 positions)."""
    for g in (1, 2, 8):
        for ps in (16, 64, 128):
            assert tpa._smem_bytes(g, D, ps) <= tpa._MAX_SMEM


def test_decode_step_casts_the_embedding_to_the_compute_dtype():
    paddle.seed(1)
    cfg = jgpt.gpt_tiny_config()
    st = jgpt.stack_gpt_weights(jgpt.GPTForPretraining(jgpt.GPTModel(cfg)))
    params = {"blocks": {k: np.asarray(v) for k, v in st["blocks"].items()},
              **{k: np.asarray(st[k]) for k in ("wte", "wpe", "lnf_w",
                                                "lnf_b")}}
    rng = np.random.default_rng(1)
    L, P, ps, nh, d = cfg.num_layers, 12, 8, cfg.num_heads, cfg.head_dim
    kp = rng.standard_normal((L, P, ps, nh, d)).astype(np.float32)
    vp = rng.standard_normal((L, P, ps, nh, d)).astype(np.float32)
    pt = np.array([[1, 2, 3, 0], [4, 0, 0, 0], [5, 6, 0, 0], [0, 0, 0, 0]],
                  np.int32)
    lens = np.array([19, 8, 9, 0], np.int32)
    pos = np.maximum(lens - 1, 0).astype(np.int32)
    toks = rng.integers(0, cfg.vocab_size, (4,)).astype(np.int32)
    kw = dict(eps=cfg.layer_norm_epsilon, temperature=0.0, top_k=0)
    # bf16 weights, f32 compute: without the cast the port's step would run
    # in bf16 (pages off by ~4e-3), the JAX step runs in f32
    jparams = jax.tree_util.tree_map(
        lambda a: jnp.asarray(a).astype(jnp.bfloat16), params)
    jk, jv, jt = jengine.decode_step_fn(
        jparams, jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(toks),
        jnp.asarray(pos), jnp.asarray(pt), jnp.asarray(lens),
        jax.random.key(0), use_kernel=True, compute_dtype="float32", **kw)
    tparams = {"blocks": {k: torch.tensor(v).bfloat16()
                          for k, v in params["blocks"].items()},
               **{k: torch.tensor(params[k]).bfloat16()
                  for k in ("wte", "wpe", "lnf_w", "lnf_b")}}
    tk, tv = torch.tensor(kp), torch.tensor(vp)
    tt = decode_step_fn(tparams, tk, tv, torch.tensor(toks),
                        torch.tensor(pos), torch.tensor(pt),
                        torch.tensor(lens), None,
                        compute_dtype=torch.float32, **kw)
    live = slice(1, None)   # page 0 (the sink) takes the idle slot's writes
    np.testing.assert_allclose(tk.numpy()[:, live], np.asarray(jk)[:, live],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tv.numpy()[:, live], np.asarray(jv)[:, live],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(tt.numpy()[:3], np.asarray(jt)[:3])
