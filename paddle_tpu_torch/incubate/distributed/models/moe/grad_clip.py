"""Global-norm gradient clipping aware of expert-parallel parameters
(counterpart of ``paddle_tpu/incubate/distributed/models/moe/grad_clip.py``).

At one expert-parallel rank every expert's gradient is local, so the
expert partial norm that paddle all-reduces over the ``moe_group`` is
already part of the plain global norm: the clip is
:class:`~paddle_tpu_torch.nn.clip.ClipGradByGlobalNorm`. A ``moe_group`` of
more than one rank is the ep axis, which is not ported.
"""
from __future__ import annotations

from .....nn.clip import ClipGradByGlobalNorm
from .moe_layer import _EP_ITEM, _group_size

__all__ = ["ClipGradForMOEByGlobalNorm"]


class ClipGradForMOEByGlobalNorm(ClipGradByGlobalNorm):
    def __init__(self, clip_norm, is_expert_param_func=None, moe_group=None,
                 group_name="default_moe_group"):
        super().__init__(clip_norm, group_name)
        if _group_size(moe_group) > 1:
            raise NotImplementedError(
                f"ClipGradForMOEByGlobalNorm over a moe_group of "
                f"{_group_size(moe_group)} ranks is not ported ({_EP_ITEM})")
        self.is_expert_param_func = is_expert_param_func
        self.moe_group = moe_group
