"""Carry a JAX GPT or ERNIE-MoE ``state_dict`` across to the port.

The JAX package's ``GPTForPretraining(GPTModel(cfg)).state_dict()`` or
``ErnieMoeForPretraining(ErnieMoeModel(cfg)).state_dict()``, with each value
taken to numpy, becomes the port's ``state_dict``: the names and layouts are
the same on both sides, so the conversion is a checked copy.
"""
from __future__ import annotations

import re

import numpy as np
import torch

from .gpt import GPTConfig, block_shapes

__all__ = ["gpt_state_dict_from_numpy", "ernie_moe_state_dict_from_numpy"]

_LAYER = re.compile(r"^gpt\.layers\.(\d+)\.(\w+)$")
_ERNIE_LAYER = re.compile(r"^ernie\.layers\.(\d+)\.(inner|attn|moe|ln)")


def _expected_shapes(cfg: GPTConfig) -> dict:
    shapes = {
        "gpt.embeddings.word_embeddings": (cfg.vocab_size, cfg.hidden_size),
        "gpt.embeddings.position_embeddings": (cfg.max_position_embeddings,
                                               cfg.hidden_size),
        "gpt.lnf_w": (cfg.hidden_size,),
        "gpt.lnf_b": (cfg.hidden_size,),
    }
    for i in range(cfg.num_layers):
        for name, shape in block_shapes(cfg).items():
            shapes[f"gpt.layers.{i}.{name}"] = shape
    return shapes


def gpt_state_dict_from_numpy(jax_state: dict,
                              dtype=torch.float32) -> dict:
    """``{name: np.ndarray}`` from the JAX ``GPTForPretraining`` →
    ``{name: torch.Tensor}`` (CPU, ``dtype``) for the port's
    ``GPTForPretraining.load_state_dict(..., strict=True)``.

    The configuration is read off the arrays; every name and shape is then
    checked against it, and a missing, unexpected or misshapen entry
    raises ``ValueError``."""
    try:
        V, H = np.shape(jax_state["gpt.embeddings.word_embeddings"])
        P = np.shape(jax_state["gpt.embeddings.position_embeddings"])[0]
        _, _, nh, _ = np.shape(jax_state["gpt.layers.0.wqkv"])
        Fm = np.shape(jax_state["gpt.layers.0.w1"])[1]
    except (KeyError, ValueError) as e:
        raise ValueError(f"not a GPTForPretraining state dict: {e}") from e
    layers = {int(m.group(1)) for m in map(_LAYER.match, jax_state) if m}
    cfg = GPTConfig(vocab_size=V, hidden_size=H, num_layers=len(layers),
                    num_heads=nh, intermediate_size=Fm,
                    max_position_embeddings=P)
    expected = _expected_shapes(cfg)
    missing = sorted(set(expected) - set(jax_state))
    unexpected = sorted(set(jax_state) - set(expected))
    if missing or unexpected:
        raise ValueError(f"state dict names differ: missing {missing}, "
                         f"unexpected {unexpected}")
    out = {}
    for name, shape in expected.items():
        arr = np.asarray(jax_state[name])
        if arr.shape != shape:
            raise ValueError(f"{name}: shape {arr.shape}, expected {shape}")
        out[name] = torch.tensor(arr, dtype=torch.float32).to(dtype)
    return out


def _linear(prefix, n_in, n_out):
    return {f"{prefix}.weight": (n_in, n_out), f"{prefix}.bias": (n_out,)}


def _norm(prefix, n):
    return {f"{prefix}.weight": (n,), f"{prefix}.bias": (n,)}


def _ernie_expected_shapes(V, H, P, T, Fm, E, kinds) -> dict:
    """Every name and shape of the JAX ``ErnieMoeForPretraining`` state dict
    (the tied word embedding appears once, as ``decoder_weight``)."""
    shapes = {"decoder_weight": (V, H), "decoder_bias": (V,),
              "ernie.embeddings.position_embeddings.weight": (P, H),
              "ernie.embeddings.token_type_embeddings.weight": (T, H)}
    shapes.update(_norm("ernie.embeddings.layer_norm", H))
    for i, kind in enumerate(kinds):
        pre = f"ernie.layers.{i}"
        attn = f"{pre}.attn" if kind == "moe" else f"{pre}.inner.self_attn"
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            shapes.update(_linear(f"{attn}.{proj}", H, H))
        if kind == "moe":
            shapes.update(_norm(f"{pre}.ln1", H))
            shapes.update(_norm(f"{pre}.ln2", H))
            shapes.update(_linear(f"{pre}.moe.gate.gate", H, E))
            for e in range(E):
                shapes.update(_linear(f"{pre}.moe.experts.{e}.htoh4", H, Fm))
                shapes.update(_linear(f"{pre}.moe.experts.{e}.h4toh", Fm, H))
        else:
            shapes.update(_linear(f"{pre}.inner.linear1", H, Fm))
            shapes.update(_linear(f"{pre}.inner.linear2", Fm, H))
            shapes.update(_norm(f"{pre}.inner.norm1", H))
            shapes.update(_norm(f"{pre}.inner.norm2", H))
    shapes.update(_linear("transform", H, H))
    shapes.update(_norm("layer_norm", H))
    return shapes


def ernie_moe_state_dict_from_numpy(jax_state: dict,
                                    dtype=torch.float32) -> dict:
    """``{name: np.ndarray}`` from the JAX ``ErnieMoeForPretraining`` →
    ``{name: torch.Tensor}`` (CPU, ``dtype``) for the port's
    ``ErnieMoeForPretraining.load_state_dict(..., strict=True)``.

    The sizes and each layer's kind (dense or MoE) are read off the arrays;
    every name and shape is then checked against them, and a missing,
    unexpected or misshapen entry raises ``ValueError``. The JAX dict holds
    the tied word embedding once, as ``decoder_weight``; the port's holds
    it under both of its names."""
    try:
        V, H = np.shape(jax_state["decoder_weight"])
        P = np.shape(jax_state[
            "ernie.embeddings.position_embeddings.weight"])[0]
        T = np.shape(jax_state[
            "ernie.embeddings.token_type_embeddings.weight"])[0]
    except (KeyError, ValueError) as e:
        raise ValueError(f"not an ErnieMoeForPretraining state dict: "
                         f"{e}") from e
    layers = {}
    for name in jax_state:
        m = _ERNIE_LAYER.match(name)
        if m:
            kind = "dense" if m.group(2) == "inner" else "moe"
            if layers.setdefault(int(m.group(1)), kind) != kind:
                raise ValueError(f"layer {m.group(1)} mixes dense and MoE "
                                 f"entries")
    kinds = [layers[i] for i in sorted(layers)]
    if sorted(layers) != list(range(len(layers))):
        raise ValueError(f"layer indices {sorted(layers)} are not 0..n-1")
    Fm = E = 0
    for i, kind in enumerate(kinds):
        pre = f"ernie.layers.{i}"
        if kind == "moe":
            gw = jax_state.get(f"{pre}.moe.gate.gate.weight")
            w1 = jax_state.get(f"{pre}.moe.experts.0.htoh4.weight")
            if gw is not None and w1 is not None:
                E, Fm = np.shape(gw)[1], np.shape(w1)[1]
                break
        else:
            w1 = jax_state.get(f"{pre}.inner.linear1.weight")
            if w1 is not None:
                Fm = np.shape(w1)[1]
    expected = _ernie_expected_shapes(V, H, P, T, Fm, E, kinds)
    missing = sorted(set(expected) - set(jax_state))
    unexpected = sorted(set(jax_state) - set(expected))
    if missing or unexpected:
        raise ValueError(f"state dict names differ: missing {missing}, "
                         f"unexpected {unexpected}")
    out = {}
    for name, shape in expected.items():
        arr = np.asarray(jax_state[name])
        if arr.shape != shape:
            raise ValueError(f"{name}: shape {arr.shape}, expected {shape}")
        out[name] = torch.tensor(arr, dtype=torch.float32).to(dtype)
    out["ernie.embeddings.word_embeddings.weight"] = out["decoder_weight"]
    return out
