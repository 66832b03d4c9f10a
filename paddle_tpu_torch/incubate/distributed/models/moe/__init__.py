"""Mixture of experts (counterpart of
``paddle_tpu/incubate/distributed/models/moe``): the naive, GShard and
Switch gates, ``MoELayer`` at one expert-parallel rank (ep = 1) in training
and eval, with the gather path and the fused CUDA dispatch and combine
(:mod:`paddle_tpu_torch.kernels.moe_dispatch`), and the MoE-aware global
norm clip."""
from .gate import BaseGate, GShardGate, NaiveGate, SwitchGate  # noqa: F401
from .grad_clip import ClipGradForMOEByGlobalNorm  # noqa: F401
from .moe_layer import ExpertLayer, MoELayer  # noqa: F401
