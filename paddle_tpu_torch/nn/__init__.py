"""Layers with paddle's conventions (counterpart of ``paddle_tpu/nn``),
only those the ported models need so far: :class:`Linear` with its
``[in, out]`` weight and :class:`LayerNorm` with paddle's numerics."""
from .layer import LayerNorm, Linear, layer_norm  # noqa: F401

__all__ = ["Linear", "LayerNorm", "layer_norm"]
