"""The port's GPT model against the JAX package's, on the same weights.

The JAX ``GPTForPretraining`` is built at the tiny config, its
``state_dict`` crosses to the port as numpy through
``gpt_state_dict_from_numpy``, and both compute in f32 on the CPU.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import gpt as jgpt
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.models.convert import gpt_state_dict_from_numpy

TOL = dict(rtol=1e-4, atol=1e-4)


def _jax_model(seed=0, **cfg_kw):
    paddle.seed(seed)
    model = jgpt.GPTForPretraining(jgpt.GPTModel(
        jgpt.gpt_tiny_config(**cfg_kw)))
    state = {k: np.asarray(v._value) for k, v in model.state_dict().items()}
    return model, state


def _port_model(state, **cfg_kw):
    model = tgpt.GPTForPretraining(tgpt.GPTModel(
        tgpt.gpt_tiny_config(**cfg_kw), device="cpu"))
    model.load_state_dict(gpt_state_dict_from_numpy(state), strict=True)
    return model


def _block_params(state, layer=0):
    pre = f"gpt.layers.{layer}."
    return {k[len(pre):]: v for k, v in state.items() if k.startswith(pre)}


@pytest.mark.parametrize("S", [16, 64])
def test_gpt_block_dense_matches_jax(S):
    _, state = _jax_model()
    p = _block_params(state, 1)
    x = np.random.default_rng(0).standard_normal((2, S, 64)).astype(
        np.float32)
    ref = jgpt.gpt_block({k: jnp.asarray(v) for k, v in p.items()},
                         jnp.asarray(x), 1e-5)
    out, k, v = tgpt.gpt_block({k: torch.tensor(v) for k, v in p.items()},
                               torch.from_numpy(x), 1e-5, return_kv=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    _, k_ref, v_ref = jgpt.gpt_block(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x), 1e-5,
        return_kv=True)
    np.testing.assert_allclose(k.numpy(), np.asarray(k_ref), **TOL)
    np.testing.assert_allclose(v.numpy(), np.asarray(v_ref), **TOL)


@pytest.mark.parametrize("S", [64, 100])
def test_gpt_block_flash_plain_matches_jax_flash(S):
    """``use_flash=True``: the port's plain flash version on the CPU
    against the JAX Pallas flash kernel (interpret mode)."""
    _, state = _jax_model(seed=1)
    p = _block_params(state, 2)
    x = np.random.default_rng(1).standard_normal((1, S, 64)).astype(
        np.float32)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: torch.tensor(v) for k, v in p.items()}
    ref = jgpt.gpt_block(jp, jnp.asarray(x), 1e-5, use_flash=True)
    out = tgpt.gpt_block(tp, torch.from_numpy(x), 1e-5, use_flash=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    dense = tgpt.gpt_block(tp, torch.from_numpy(x), 1e-5)
    np.testing.assert_allclose(out.numpy(), dense.numpy(), **TOL)


def test_gpt_forward_matches_jax():
    jmodel, state = _jax_model(seed=2)
    tmodel = _port_model(state)
    ids = np.random.default_rng(2).integers(0, 256, (2, 24)).astype(np.int32)
    ref = np.asarray(jmodel(paddle.to_tensor(ids))._value)
    with torch.no_grad():
        out = tmodel(torch.from_numpy(ids)).numpy()
    assert out.shape == (2, 24, 256)
    np.testing.assert_allclose(out, ref, **TOL)
    np.testing.assert_array_equal(out.argmax(-1), ref.argmax(-1))


def test_stack_gpt_weights_matches_jax():
    jmodel, state = _jax_model(seed=3)
    tmodel = _port_model(state)
    jst = jgpt.stack_gpt_weights(jmodel)
    tst = tgpt.stack_gpt_weights(tmodel)
    assert set(tst["blocks"]) == set(jst["blocks"])
    for k, v in jst["blocks"].items():
        np.testing.assert_array_equal(tst["blocks"][k].numpy(), np.asarray(v))
    for k in ("wte", "wpe", "lnf_w", "lnf_b"):
        np.testing.assert_array_equal(tst[k].numpy(), np.asarray(jst[k]))


def test_convert_rejects_mismatched_state():
    _, state = _jax_model()
    bad = dict(state)
    del bad["gpt.layers.3.b2"]
    with pytest.raises(ValueError, match="missing"):
        gpt_state_dict_from_numpy(bad)
    bad = dict(state, **{"gpt.extra": np.zeros(3, np.float32)})
    with pytest.raises(ValueError, match="unexpected"):
        gpt_state_dict_from_numpy(bad)
    bad = dict(state)
    bad["gpt.layers.1.wo"] = np.zeros((4, 16, 65), np.float32)
    with pytest.raises(ValueError, match="shape"):
        gpt_state_dict_from_numpy(bad)
    out = gpt_state_dict_from_numpy(state, dtype=torch.bfloat16)
    assert out["gpt.layers.0.wqkv"].dtype == torch.bfloat16
    assert tuple(out["gpt.layers.0.wqkv"].shape) == (64, 3, 4, 16)


def test_configs_match_jax():
    for name in ("gpt_tiny_config", "gpt_345m_config", "gpt_1p3b_config",
                 "gpt_13b_config"):
        j = getattr(jgpt, name)(num_heads=8)
        t = getattr(tgpt, name)(num_heads=8)
        for f in ("vocab_size", "hidden_size", "num_layers", "num_heads",
                  "intermediate_size", "max_position_embeddings",
                  "layer_norm_epsilon", "initializer_range", "head_dim"):
            assert getattr(t, f) == getattr(j, f), (name, f)


def test_seeded_init_scheme():
    cfg = tgpt.gpt_tiny_config(num_layers=2, hidden_size=256)
    a = tgpt.GPTModel(cfg, seed=7, device="cpu")
    b = tgpt.GPTModel(cfg, seed=7, device="cpu")
    c = tgpt.GPTModel(cfg, seed=8, device="cpu")
    for (n, pa), pb in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(pa, pb), n
    assert not torch.equal(a.layers[0].wqkv, c.layers[0].wqkv)
    layer = a.layers[1]
    std, res = 0.02, 0.02 / math.sqrt(2.0 * cfg.num_layers)
    assert abs(layer.wqkv.std().item() - std) < 0.1 * std
    assert abs(layer.w2.std().item() - res) < 0.1 * res
    assert torch.equal(layer.ln1_w, torch.ones(256))
    assert torch.equal(layer.bqkv, torch.zeros(3, 4, 64))
    tiny = tgpt.GPTModel(tgpt.gpt_tiny_config(), device="cpu")
    names = {n for n, _ in tgpt.GPTForPretraining(tiny).named_parameters()}
    _, state = _jax_model()
    assert names == set(state)


def test_sample_logits_greedy_ties_and_sampling():
    logits = np.array([[0.5, 2.0, 2.0, -1.0], [3.0, 3.0, 3.0, 3.0]],
                      np.float32)
    ref = np.asarray(jgpt.sample_logits(jnp.asarray(logits), None))
    out = tgpt.sample_logits(torch.from_numpy(logits))
    np.testing.assert_array_equal(out.numpy(), ref)
    g1, g2 = (torch.Generator().manual_seed(3) for _ in range(2))
    x = torch.randn(5, 50, generator=torch.Generator().manual_seed(0))
    s1 = tgpt.sample_logits(x, g1, temperature=0.8, top_k=4)
    s2 = tgpt.sample_logits(x, g2, temperature=0.8, top_k=4)
    assert torch.equal(s1, s2)
    top4 = torch.topk(x, 4, -1).indices
    assert all(s1[i] in top4[i] for i in range(5))


def test_flash_gate():
    assert tgpt.flash_attention_gate(64, 128, None, "cuda")
    assert tgpt.flash_attention_gate(1024, 64, None, "cuda")
    assert not tgpt.flash_attention_gate(32, 128, None, "cuda")
    assert not tgpt.flash_attention_gate(256, 96, None, "cuda")
    assert not tgpt.flash_attention_gate(1024, 128, None, "cpu")
    assert tgpt.flash_attention_gate(64, 16, True, "cpu")
    assert not tgpt.flash_attention_gate(512, 128, False, "cuda")


def test_model_without_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        tgpt.GPTModel(tgpt.gpt_tiny_config())
