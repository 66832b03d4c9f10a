"""Mixture of experts (counterpart of
``paddle_tpu/incubate/distributed/models/moe``): the GShard gate and
``MoELayer`` at one expert-parallel rank (ep = 1), with the gather path and
the fused CUDA dispatch and combine
(:mod:`paddle_tpu_torch.kernels.moe_dispatch`)."""
from .gate import BaseGate, GShardGate  # noqa: F401
from .moe_layer import ExpertLayer, MoELayer  # noqa: F401
