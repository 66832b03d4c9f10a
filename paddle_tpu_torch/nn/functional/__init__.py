"""Functionals (counterpart of ``paddle_tpu/nn/functional``): attention so
far."""
from .attention import scaled_dot_product_attention  # noqa: F401

__all__ = ["scaled_dot_product_attention"]
