"""Seeded random generators (counterpart of ``paddle_tpu/framework/random.py``).

The JAX package threads ``jax.random`` keys; the port hands an explicit
``torch.Generator`` to everything that draws random numbers, so nothing on
the serving path reads or advances PyTorch's global RNG. The two
frameworks give different numbers from one seed: tests make their inputs
with numpy and hand them to both.
"""
from __future__ import annotations

import torch

from ..device import resolve_device

__all__ = ["make_generator"]


def make_generator(seed: int, device=None) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` (CUDA unless ``"cpu"`` is asked
    for), seeded with ``seed``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    return gen
