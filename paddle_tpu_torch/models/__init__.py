"""GPT model family (counterpart of ``paddle_tpu/models``)."""
