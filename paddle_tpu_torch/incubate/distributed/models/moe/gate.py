"""MoE gates (counterpart of
``paddle_tpu/incubate/distributed/models/moe/gate.py``).

``gate(x) -> (top_k_val, top_k_idx)`` over tokens ``x [S, d_model]``. The
port has the GShard gate in eval: top-2 over the softmax probabilities,
normalised to sum to one. Its training-mode behaviour (random routing of
the second choice and the load-balance aux loss) belongs to the MoE
training slice and raises ``NotImplementedError``.
"""
from __future__ import annotations

import torch
from torch import nn

from .....kernels.moe_dispatch import _top_k
from .....nn import Linear

__all__ = ["BaseGate", "GShardGate"]

_TRAINING_ITEM = ("ROADMAP.md, Queue 1, item 1 (MoE: the MLM and aux "
                  "losses, gates that draw randomness)")


class BaseGate(nn.Module):
    def __init__(self, num_expert, world_size):
        super().__init__()
        self.world_size = world_size
        self.num_expert = num_expert
        self.tot_expert = world_size * num_expert

    def forward(self, x):
        raise NotImplementedError("Base gate cannot be directly used for fwd")


class GShardGate(BaseGate):
    """Top-2 gate with normalised weights. ``gate`` is the ``[d_model,
    tot_expert]`` :class:`~paddle_tpu_torch.nn.Linear`; ``capacity`` the
    (train, eval) capacity factors ``MoELayer`` consults."""

    def __init__(self, d_model, num_expert, world_size, topk=2,
                 capacity=(1.2, 2.4), *, generator: torch.Generator,
                 std=None):
        assert topk == 2, "topk should be 2 in gshard"
        super().__init__(num_expert, world_size)
        self.gate = Linear(d_model, self.tot_expert, generator=generator,
                           std=std)
        self.top_k = topk
        self.capacity = capacity

    def forward(self, x):
        if self.training:
            raise NotImplementedError(
                f"GShardGate in training mode (random routing, aux loss) is "
                f"not ported yet ({_TRAINING_ITEM})")
        probs = torch.softmax(self.gate(x), -1)
        topk_val, topk_idx = _top_k(probs, self.top_k)
        topk_val = topk_val / (topk_val.sum(-1, keepdim=True) + 1e-9)
        return topk_val, topk_idx
