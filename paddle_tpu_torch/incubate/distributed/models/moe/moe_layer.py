"""MoE layer (counterpart of
``paddle_tpu/incubate/distributed/models/moe/moe_layer.py``) at one
expert-parallel rank.

GShard's static-capacity dispatch: the gate picks each token's top-k
experts, :func:`~paddle_tpu_torch.kernels.moe_dispatch.dispatch_indices`
gives every choice a slot of its expert (all first choices before any
second; a choice past the capacity is dropped), the expert inputs
``[E, C, M]`` are gathered, the experts run as two batched products (or
one by one where they differ), and the weighted combine brings the
outputs back to token order. With ``fused_dispatch=True`` the gate, the
slots and the scatter are the fused dispatch kernel and the combine the
fused combine kernel (:mod:`paddle_tpu_torch.kernels.moe_dispatch`), as
in the JAX layer, for every gate whose current behaviour the kernel can
replicate: a gate that draws random numbers in training (GShard's random
routing, Switch's jitter) takes the gather path (:meth:`MoELayer.
_fused_gate_kind`, the JAX rule, read from the configuration alone).

Training and eval both run; the ``ep`` axis (a ``moe_group`` of more
than one rank) is not ported and raises ``NotImplementedError``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from .....amp import amp_cast
from .....amp.auto_cast import _entered, current_amp_state
from .....kernels.moe_dispatch import (dispatch_indices, fused_moe_combine,
                                       fused_moe_dispatch,
                                       reference_moe_combine)
from .....nn._torch_layers import Linear
from .gate import BaseGate, GShardGate, NaiveGate, SwitchGate

__all__ = ["ExpertLayer", "MoELayer"]

_EP_ITEM = ("ROADMAP.md, Queue 1, items 1 and 7 (the ep axis: "
            "ep_moe_ffn and its all_to_all)")


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


def _group_size(group):
    """Ranks of a ``moe_group``: its ``nranks`` (paddle's groups) or
    ``size()`` (a ``torch.distributed`` process group); None is one."""
    if group is None:
        return 1
    n = getattr(group, "nranks", None)
    return int(n if n is not None else group.size())


def _remat(fn, *args):
    """``fn(*args)`` under ``torch.utils.checkpoint`` (the JAX layer's
    ``jax.checkpoint``); the recompute casts under the ``auto_cast`` state
    the forward saw."""
    state = current_amp_state()

    def run(*a):
        with _entered(state):
            return fn(*a)
    return checkpoint(run, *args, use_reentrant=False)


class MoELayer(nn.Module):
    """Mixture-of-experts layer. ``experts``: a list of expert modules (the
    global list; ep = 1); ``gate``: ``{"type": "gshard" | "switch" |
    "naive", "top_k": k}`` or a :class:`BaseGate`; ``capacity_factor``:
    expert slots = ``int(cf * top_k * S / E)`` clamped to ``[1, S]`` (the
    gate's train or eval factor when None); ``recompute_interval > 0``
    recomputes the experts in the backward when training;
    ``fused_dispatch``: the fused CUDA kernels in place of the gather path;
    ``seed``: the seed of a gate built from a dict, for the random numbers
    it draws in training."""

    def __init__(self, d_model, experts, gate=None, moe_group=None,
                 mp_group=None, recompute_interval=0, recompute_ctx=None,
                 capacity_factor=None, fused_dispatch=False, *,
                 generator: torch.Generator = None, std=None, seed=None):
        super().__init__()
        if _group_size(moe_group) > 1:
            raise NotImplementedError(
                f"MoELayer over a moe_group of {_group_size(moe_group)} "
                f"ranks is not ported ({_EP_ITEM})")
        self.d_model = d_model
        self.fused_dispatch = bool(fused_dispatch)
        self.experts = nn.ModuleList(experts)
        self.num_expert = len(self.experts)
        self.moe_group = moe_group
        self.recompute_interval = recompute_interval
        self.capacity_factor = capacity_factor
        if gate is None:
            gate = {}
        if isinstance(gate, dict):
            gate_type = gate.get("type", "gshard")
            kw = dict(generator=generator, std=std, seed=seed)
            if gate_type == "naive":
                gate = NaiveGate(d_model, self.num_expert, 1,
                                 topk=gate.get("top_k", 2), generator=generator,
                                 std=std)
            elif gate_type == "gshard":
                gate = GShardGate(d_model, self.num_expert, 1,
                                  topk=gate.get("top_k", 2), **kw)
            elif gate_type == "switch":
                gate = SwitchGate(d_model, self.num_expert, 1,
                                  topk=gate.get("top_k", 1), **kw)
            else:
                raise AssertionError(f"unknown gate type {gate_type}")
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

    def _homogeneous_ffn(self):
        if not all(isinstance(e, ExpertLayer) for e in self.experts):
            return False
        e0 = self.experts[0]
        return all(e.act == e0.act and
                   e.htoh4.weight.shape == e0.htoh4.weight.shape
                   for e in self.experts)

    def _fused_gate_kind(self):
        """The fused kernel's ``gate_kind`` for this layer's gate, or None
        where the kernel cannot replicate the gate's current behaviour (it
        draws random numbers in training: GShard's random routing, Switch's
        jitter) and the layer takes the gather path."""
        if isinstance(self.gate, GShardGate):
            if self.training and self.gate.random_routing:
                return None
            return "gshard"
        if isinstance(self.gate, SwitchGate):
            if self.training and self.gate.switch_eps:
                return None
            return "switch"
        if isinstance(self.gate, NaiveGate):
            return "naive"
        return None

    def forward(self, inp):
        orig_shape = inp.shape
        x = inp.reshape(-1, self.d_model)
        S = x.shape[0]
        E, C = self.num_expert, self._capacity(S)
        kind = self._fused_gate_kind() if self.fused_dispatch else None
        if kind is not None:
            return self._forward_fused(x, E, C, kind).reshape(orig_shape)
        val, idx = self.gate(x)
        val = val.reshape(S, self.top_k)
        idx = idx.reshape(S, self.top_k)
        slot_token, comb_idx = dispatch_indices(idx, num_expert=E,
                                                capacity=C)
        expert_in = _gather_dispatch(x, slot_token).reshape(E, C,
                                                            self.d_model)
        expert_out = self._run_experts(expert_in, E)
        y = reference_moe_combine(expert_out.reshape(E * C, self.d_model),
                                  val, comb_idx)
        return y.reshape(orig_shape)

    def _forward_fused(self, x, E, C, kind):
        """The fused dispatch (gate, slots and scatter in one C call) and
        the fused combine; the aux loss comes from the kernel's ``me`` and
        ``ce``, the formula of ``gate._load_balance_loss``."""
        expert_in, comb_idx, val, me, ce = fused_moe_dispatch(
            x, self.gate.gate.weight, self.gate.gate.bias, num_expert=E,
            capacity=C, top_k=self.top_k, gate_kind=kind)
        if not isinstance(self.gate, NaiveGate):
            self.gate.set_loss((me * ce).sum() * float(E) if self.training
                               else None)
        expert_out = self._run_experts(expert_in, E)
        return fused_moe_combine(expert_out.reshape(E * C, self.d_model),
                                 val, comb_idx)

    def _run_experts(self, expert_in, E):
        """The experts on ``[E, C, M]``: the batched products where every
        expert is an :class:`ExpertLayer` of one shape, else each expert on
        its own rows; recomputed in the backward when training with
        ``recompute_interval > 0``."""
        remat = self.recompute_interval > 0 and self.training
        if self._homogeneous_ffn():
            args = (expert_in, *(torch.stack([getattr(getattr(e, lin), p)
                                              for e in self.experts])
                                 for lin in ("htoh4", "h4toh")
                                 for p in ("weight", "bias")))
            return _remat(_stacked_ffn, *args) if remat \
                else _stacked_ffn(*args)
        outs = [_remat(self.experts[e], expert_in[e]) if remat
                else self.experts[e](expert_in[e]) for e in range(E)]
        return torch.stack(outs, 0)


def _stacked_ffn(xin, w1, b1, w2, b2):
    """The batched expert FFN: two ``[E, ., .]`` products (paddle's
    "einsum", white list under ``auto_cast``), each bias added after it in
    the promoted dtype, as the JAX layer adds them."""
    a, w = amp_cast("einsum", xin, w1)
    h = F.gelu(torch.bmm(a, w) + b1[:, None, :])
    a, w = amp_cast("einsum", h, w2)
    return torch.bmm(a, w) + b2[:, None, :]
