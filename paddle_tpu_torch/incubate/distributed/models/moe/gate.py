"""MoE gates (counterpart of
``paddle_tpu/incubate/distributed/models/moe/gate.py``).

``gate(x) -> (top_k_val, top_k_idx)`` over tokens ``x [S, d_model]``; in
training the GShard and Switch gates stash their load-balance aux loss
with ``set_loss`` (read with ``get_loss``), in eval they clear it.

A gate that draws random numbers in training (GShard's random routing of
the second choice, Switch's multiplicative jitter) draws them from its
own ``torch.Generator`` (``rng``, made on the device of its weights,
seeded with ``seed``) and moves them to its logits' device: nothing reads
or advances PyTorch's global RNG. The two
frameworks draw different numbers, so those draws are held to statistics,
not to the JAX package's values.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .....amp import amp_cast
from .....kernels.moe_dispatch import _top_k
from .....nn._torch_layers import Linear

__all__ = ["BaseGate", "NaiveGate", "GShardGate", "SwitchGate"]


class BaseGate(nn.Module):
    def __init__(self, num_expert, world_size):
        super().__init__()
        self.world_size = world_size
        self.num_expert = num_expert
        self.tot_expert = world_size * num_expert
        self.loss = None

    def forward(self, x):
        raise NotImplementedError("Base gate cannot be directly used for fwd")

    def set_loss(self, loss):
        self.loss = loss

    def get_loss(self, clear=True):
        loss = self.loss
        if clear:
            self.loss = None
        return loss

    @property
    def has_loss(self):
        return self.loss is not None


def _rng(generator, seed):
    """The gate's own generator on ``generator``'s device: seeded with
    ``seed``, or with the weight generator's seed + 1 when None (the weight
    generator itself is not advanced)."""
    g = torch.Generator(device=generator.device)
    g.manual_seed(int(generator.initial_seed() + 1 if seed is None
                      else seed))
    return g


def _softmax(logits):
    """The gate's softmax: paddle's "softmax" is on the black list, so
    under ``auto_cast`` its bf16 logits go in as f32."""
    return torch.softmax(amp_cast("softmax", logits)[0], -1)


class NaiveGate(BaseGate):
    """Linear top-k gate over the raw logits; no capacity rule, no aux
    loss."""

    def __init__(self, d_model, num_expert, world_size, topk=2, *,
                 generator: torch.Generator, std=None):
        super().__init__(num_expert, world_size)
        self.gate = Linear(d_model, self.tot_expert, generator=generator,
                           std=std)
        self.top_k = topk

    def forward(self, inp, return_all_scores=False):
        gate = self.gate(inp)
        val, idx = _top_k(gate, self.top_k)
        if return_all_scores:
            return val, idx, gate
        return val, idx


def _load_balance_loss(probs, top1_idx, num_expert):
    """GShard/Switch aux loss: ``E * sum_e mean_s(probs_e) * frac_s(e)``;
    ``probs [S, E]``, ``top1_idx [S]`` the hard assignment."""
    me = probs.mean(0)
    ce = F.one_hot(top1_idx.long(), num_expert).to(probs.dtype).mean(0)
    return (me * ce).sum() * float(num_expert)


class GShardGate(BaseGate):
    """Top-2 gate with weights normalised to sum to one. ``gate`` is the
    ``[d_model, tot_expert]``
    :class:`~paddle_tpu_torch.nn._torch_layers.Linear`; ``capacity`` the
    (train, eval) capacity factors ``MoELayer`` consults. In training with
    ``random_routing`` the second choice is kept where ``2 * p2 > u``,
    ``u`` uniform from ``rng`` (else its weight is 0; its slot stays held,
    as in the JAX gate)."""

    def __init__(self, d_model, num_expert, world_size, topk=2,
                 capacity=(1.2, 2.4), random_routing=True, group=None, *,
                 generator: torch.Generator, std=None, seed=None):
        assert topk == 2, "topk should be 2 in gshard"
        super().__init__(num_expert, world_size)
        self.gate = Linear(d_model, self.tot_expert, generator=generator,
                           std=std)
        self.top_k = topk
        self.capacity = capacity
        self.random_routing = random_routing
        self.rng = _rng(generator, seed)

    def forward(self, x):
        probs = _softmax(self.gate(x))
        topk_val, topk_idx = _top_k(probs, self.top_k)
        topk_val = topk_val / (topk_val.sum(-1, keepdim=True) + 1e-9)
        if self.random_routing and self.training:
            u = torch.rand(topk_val.shape[0], generator=self.rng,
                           device=self.rng.device).to(topk_val)
            keep = (2.0 * topk_val[:, 1] > u).to(topk_val.dtype)
            topk_val = torch.stack([topk_val[:, 0], topk_val[:, 1] * keep],
                                   -1)
        self.set_loss(_load_balance_loss(probs, topk_idx[:, 0],
                                         self.tot_expert)
                      if self.training else None)
        return topk_val, topk_idx


class SwitchGate(BaseGate):
    """Top-1 gate with the aux loss; in training the logits get Switch's
    multiplicative jitter ``1 + (u - 0.5) * 2 * switch_eps``, ``u`` uniform
    from ``rng``."""

    def __init__(self, d_model, num_expert, world_size, topk=1,
                 switch_eps=0.1, capacity=(1.2, 2.4), group=None, *,
                 generator: torch.Generator, std=None, seed=None):
        assert topk == 1, "topk should be 1 in switch"
        super().__init__(num_expert, world_size)
        self.gate = Linear(d_model, self.tot_expert, generator=generator,
                           std=std)
        self.top_k = topk
        self.switch_eps = switch_eps
        self.capacity = capacity
        self.rng = _rng(generator, seed)

    def forward(self, x):
        logits = self.gate(x)
        if self.training and self.switch_eps:
            noise = torch.rand(logits.shape, generator=self.rng,
                               device=self.rng.device).to(logits)
            logits = logits * (1.0 + (noise - 0.5) * 2.0 * self.switch_eps)
        probs = _softmax(logits)
        topk_val, topk_idx = _top_k(probs, 1)
        self.set_loss(_load_balance_loss(probs, topk_idx[:, 0],
                                         self.tot_expert)
                      if self.training else None)
        return topk_val, topk_idx
