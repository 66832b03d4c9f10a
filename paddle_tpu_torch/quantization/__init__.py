"""Weight-only int8 quantization (counterpart of ``paddle_tpu/quantization``;
only the serving engine's stacked-weight scheme is ported)."""
