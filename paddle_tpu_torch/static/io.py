"""Static-graph save/load (counterpart of ``paddle_tpu/static/io.py``):
``save`` and ``load`` of a program's parameters through
:mod:`paddle_tpu_torch.framework.io`.

``save_inference_model`` and ``load_inference_model`` are not ported: the
JAX package writes StableHLO; their counterpart (a ``.pt2`` through
``torch.export``) belongs with ``jit/save_load.py``.
"""
from __future__ import annotations

import numpy as np
import torch

from ..framework import io as fio
from ..framework.tensor import Tensor, _numpy_to_torch
from .executor import _collect_graph

__all__ = ["save", "load"]

_JIT_ITEM = ("ROADMAP.md Queue 1 item 10: the inference model goes with "
             "jit/save_load.py, as a .pt2 through torch.export")


def _program_params(program):
    """Every Parameter the program's nodes read, in the order first met."""
    return _collect_graph(list(program._feeds.values())
                          + [t for n in program._nodes for t in n.args
                             if isinstance(t, Tensor)])[1]


def save(program, path_prefix, protocol=4):
    """Write every parameter the program reads to
    ``path_prefix.pdparams``, keyed by name."""
    state = {p.name or f"param_{i}": p
             for i, p in enumerate(_program_params(program))}
    fio.save(state, path_prefix + ".pdparams", protocol=protocol)


def load(program, path_prefix, executor=None, var_list=None):
    """Set the program's parameters from ``path_prefix.pdparams``, in
    place (a captured graph keeps reading them)."""
    set_params(program, fio.load(path_prefix + ".pdparams"))


def set_params(program, state):
    """Copy ``state[name]`` (Tensors, torch tensors or arrays) into the
    program's parameters of that name, in place."""
    for i, p in enumerate(_program_params(program)):
        key = p.name or f"param_{i}"
        if key in state:
            v = state[key]
            if isinstance(v, Tensor):
                v = v._value
            elif not isinstance(v, torch.Tensor):
                v = _numpy_to_torch(np.asarray(v))
            with torch.no_grad():
                p._value.copy_(v.to(p._value.device, p._value.dtype))


def save_inference_model(path_prefix, feed_vars, fetch_vars, executor=None,
                         program=None, **kwargs):
    raise NotImplementedError(f"save_inference_model is not ported "
                              f"({_JIT_ITEM})")


def load_inference_model(path_prefix, executor=None, **kwargs):
    raise NotImplementedError(f"load_inference_model is not ported "
                              f"({_JIT_ITEM})")
