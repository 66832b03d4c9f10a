"""Layers with paddle's conventions (counterpart of ``paddle_tpu/nn``),
only those the ported models need so far: :class:`Linear` with its
``[in, out]`` weight and :class:`LayerNorm` with paddle's numerics, the
attention functional (:mod:`.functional`) and the gradient clips
(:mod:`.clip`)."""
from . import clip, functional  # noqa: F401
from .clip import (ClipGradByGlobalNorm, ClipGradByNorm,  # noqa: F401
                   ClipGradByValue)
from .layer import LayerNorm, Linear, layer_norm  # noqa: F401

__all__ = ["Linear", "LayerNorm", "layer_norm", "ClipGradByValue",
           "ClipGradByNorm", "ClipGradByGlobalNorm"]
