"""MoE layer (counterpart of
``paddle_tpu/incubate/distributed/models/moe/moe_layer.py``) at one
expert-parallel rank.

GShard's static-capacity dispatch: the gate picks each token's top-k
experts, :func:`~paddle_tpu_torch.kernels.moe_dispatch.dispatch_indices`
gives every choice a slot of its expert (all first choices before any
second; a choice past the capacity is dropped), the expert inputs
``[E, C, M]`` are gathered, the experts run as two batched products, and
the weighted combine brings the outputs back to token order. With
``fused_dispatch=True`` the gate, the slots and the scatter are the fused
dispatch kernel and the combine the fused combine kernel
(:mod:`paddle_tpu_torch.kernels.moe_dispatch`), as in the JAX layer.

Eval only: training (the aux loss, random routing) and the ``ep`` axis
are not ported and raise ``NotImplementedError``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .....kernels.moe_dispatch import (dispatch_indices, fused_moe_combine,
                                       fused_moe_dispatch,
                                       reference_moe_combine)
from .....nn import Linear
from .gate import _TRAINING_ITEM, BaseGate, GShardGate

__all__ = ["ExpertLayer", "MoELayer"]


class ExpertLayer(nn.Module):
    """The FFN expert: ``h4toh(act(htoh4(x)))``, two paddle ``Linear``s."""

    def __init__(self, d_model, d_hidden, act="gelu", *,
                 generator: torch.Generator, std=None):
        super().__init__()
        if act != "gelu":
            raise NotImplementedError(f"expert activation {act!r}: only "
                                      f"'gelu' is ported")
        self.htoh4 = Linear(d_model, d_hidden, generator=generator, std=std)
        self.h4toh = Linear(d_hidden, d_model, generator=generator, std=std)
        self.act = act

    def forward(self, x):
        return self.h4toh(F.gelu(self.htoh4(x)))


def _gather_dispatch(x, slot_token):
    """``x [S, M]`` → expert inputs ``[E*C, M]``; empty slots read a zero
    row."""
    xp = torch.cat([x, x.new_zeros(1, x.shape[-1])], 0)
    return xp[slot_token.long()]


class MoELayer(nn.Module):
    """Mixture-of-experts layer. ``experts``: a list of :class:`ExpertLayer`
    (the global list; ep = 1); ``gate``: ``{"type": "gshard", "top_k": 2}``
    or a :class:`GShardGate`; ``capacity_factor``: expert slots =
    ``int(cf * top_k * S / E)`` clamped to ``[1, S]`` (the gate's eval
    factor when None); ``fused_dispatch``: the fused CUDA kernels in place of
    the gather path."""

    def __init__(self, d_model, experts, gate=None, capacity_factor=None,
                 fused_dispatch=False, *, generator: torch.Generator = None,
                 std=None):
        super().__init__()
        self.d_model = d_model
        self.fused_dispatch = bool(fused_dispatch)
        self.experts = nn.ModuleList(experts)
        self.num_expert = len(self.experts)
        self.capacity_factor = capacity_factor
        if gate is None:
            gate = {}
        if isinstance(gate, dict):
            gate_type = gate.get("type", "gshard")
            if gate_type != "gshard":
                raise NotImplementedError(
                    f"gate type {gate_type!r}: only 'gshard' is ported")
            gate = GShardGate(d_model, self.num_expert, 1,
                              topk=gate.get("top_k", 2), generator=generator,
                              std=std)
        assert isinstance(gate, BaseGate), "gate must be dict or BaseGate"
        self.gate = gate
        self.top_k = getattr(gate, "top_k", 2)

    def _capacity(self, n_tokens):
        cf = self.capacity_factor
        if cf is None:
            cap = getattr(self.gate, "capacity", (1.2, 2.4))
            cf = cap[0] if self.training else cap[1]
        c = int(cf * self.top_k * n_tokens / self.num_expert)
        return max(1, min(n_tokens, c))

    def forward(self, inp):
        if self.training:
            raise NotImplementedError(
                f"MoELayer in training mode is not ported yet "
                f"({_TRAINING_ITEM})")
        orig_shape = inp.shape
        x = inp.reshape(-1, self.d_model)
        S = x.shape[0]
        E, C = self.num_expert, self._capacity(S)
        if self.fused_dispatch:
            expert_in, comb_idx, val, _, _ = fused_moe_dispatch(
                x, self.gate.gate.weight, self.gate.gate.bias, num_expert=E,
                capacity=C, top_k=self.top_k, gate_kind="gshard")
            expert_out = self._experts_stacked(expert_in)
            y = fused_moe_combine(expert_out.reshape(E * C, self.d_model),
                                  val, comb_idx)
            return y.reshape(orig_shape)
        val, idx = self.gate(x)
        slot_token, comb_idx = dispatch_indices(idx, num_expert=E,
                                                capacity=C)
        expert_in = _gather_dispatch(x, slot_token).reshape(E, C,
                                                            self.d_model)
        expert_out = self._experts_stacked(expert_in)
        y = reference_moe_combine(expert_out.reshape(E * C, self.d_model),
                                  val, comb_idx)
        return y.reshape(orig_shape)

    def _experts_stacked(self, expert_in):
        """The batched expert FFN: two ``[E, ., .]`` products."""
        w1 = torch.stack([e.htoh4.weight for e in self.experts])
        b1 = torch.stack([e.htoh4.bias for e in self.experts])
        w2 = torch.stack([e.h4toh.weight for e in self.experts])
        b2 = torch.stack([e.h4toh.bias for e in self.experts])
        h = F.gelu(torch.bmm(expert_in, w1) + b1[:, None, :])
        return torch.bmm(h, w2) + b2[:, None, :]
