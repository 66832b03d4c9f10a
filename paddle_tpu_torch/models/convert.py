"""Carry a JAX GPT ``state_dict`` across to the port.

The JAX package's ``GPTForPretraining(GPTModel(cfg)).state_dict()``, with
each value taken to numpy, becomes the port's ``state_dict``: the names and
layouts are the same on both sides, so the conversion is a checked copy.
"""
from __future__ import annotations

import re

import numpy as np
import torch

from .gpt import GPTConfig, block_shapes

__all__ = ["gpt_state_dict_from_numpy"]

_LAYER = re.compile(r"^gpt\.layers\.(\d+)\.(\w+)$")


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
