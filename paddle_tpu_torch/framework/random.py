"""Seeded random generators (counterpart of ``paddle_tpu/framework/random.py``).

The JAX package threads ``jax.random`` keys; the port draws from explicit
``torch.Generator``s, so nothing reads or advances PyTorch's global RNG.
Model and engine code builds its own with :func:`make_generator`. The
facade's random ops draw from one generator per device, made at first use
from the seed :func:`seed` set (:func:`generator`); ``rng_guard`` swaps in
another for a region. The two frameworks give different numbers from one
seed: tests make their inputs with numpy and hand them to both, and hold
random ops to shape, dtype, moments and repeatability.
"""
from __future__ import annotations

import contextlib

import torch

from ..device import resolve_device

__all__ = ["make_generator", "seed", "get_rng_state", "set_rng_state",
           "rng_guard", "generator"]

_DEFAULT_SEED = 34342423252

_seed = _DEFAULT_SEED
_generators: dict = {}     # torch.device -> the facade's torch.Generator
_guards: list = []         # innermost rng_guard's generator last


def make_generator(seed: int, device=None) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` (CUDA unless ``"cpu"`` is asked
    for), seeded with ``seed``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    return gen


def generator(device: torch.device) -> torch.Generator:
    """The generator the facade's random ops on ``device`` draw from: the
    innermost ``rng_guard``'s when one is active on that device type, else
    the device's own, made from the current seed at first use. None for
    the ``meta`` device: a static program records its ops on meta tensors
    (shapes only), and a draw there takes no number from any generator."""
    dev = torch.device(device)
    if dev.type == "meta":
        return None
    if dev.type == "cuda" and dev.index is None:
        dev = resolve_device(dev)
    for gen in reversed(_guards):
        if gen.device.type == dev.type:
            return gen
    gen = _generators.get(dev)
    if gen is None:
        gen = _generators[dev] = torch.Generator(device=dev)
        gen.manual_seed(_seed)
    return gen


def seed(s: int):
    """``paddle.seed``: reseeds every device's generator (lazily: no
    device is touched here)."""
    global _seed
    _seed = int(s)
    _generators.clear()
    return _seed


def _current_device():
    from .place import to_torch_device
    return to_torch_device()


def get_rng_state(device=None) -> torch.Tensor:
    """The state of the current place's generator (or ``device``'s)."""
    dev = torch.device(device) if device is not None else _current_device()
    return generator(dev).get_state()


def set_rng_state(state, device=None):
    dev = torch.device(device) if device is not None else _current_device()
    generator(dev).set_state(state)


@contextlib.contextmanager
def rng_guard(seed_or_state, device=None):
    """Draw from a generator of its own inside the region: seeded with an
    int, or set to a state from :func:`get_rng_state`. The ambient
    generators neither advance nor are read inside."""
    dev = torch.device(device) if device is not None else _current_device()
    gen = torch.Generator(device=dev)
    if isinstance(seed_or_state, torch.Tensor):
        gen.set_state(seed_or_state)
    else:
        gen.manual_seed(int(seed_or_state))
    _guards.append(gen)
    try:
        yield gen
    finally:
        _guards.remove(gen)
