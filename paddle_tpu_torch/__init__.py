"""paddle_tpu_torch: the PyTorch/CUDA port of ``paddle_tpu`` for one NVIDIA H100.

The JAX package ``paddle_tpu`` stays the reference; this package keeps its
module names and public names so each counterpart is easy to find. It
imports ``torch`` and never ``jax``, and nothing from ``paddle_tpu``.

Importing it has no global side effects: no device is touched, no kernel
is built (the CUDA kernels compile at their first launch, see
:mod:`paddle_tpu_torch.kernels._build`), and no RNG state is seeded.

Ported so far, GPT serving and training, ERNIE-MoE serving and
pretraining (``ROADMAP.md`` lists the rest):

- :mod:`.models.gpt` — the GPT model family as ``nn.Module``s and the
  training step (one CUDA graph per batch shape on the card);
- :mod:`.models.ernie`, :mod:`.incubate.distributed.models.moe` — the
  ERNIE-MoE model, its gates and ``MoELayer``, in training and eval;
- :mod:`.optimizer` — ``SGD``, ``Momentum``, ``Adam``, ``AdamW`` and the
  learning-rate schedulers; :mod:`.nn.clip` — the gradient clips;
- :mod:`.amp` — paddle's O1 ``auto_cast``;
- :mod:`.kernels.flash_attention` — FlashAttention-2 forward and
  backward (CUDA);
- :mod:`.kernels.paged_attention` — paged-attention decode and ragged
  chunk prefill (CUDA);
- :mod:`.kernels.int8_matmul` — weight-only int8 dequant-matmul (CUDA);
- :mod:`.quantization.export` — int8 quantization of the stacked weights;
- :mod:`.serving` — ``PagePool``, ``PrefixCache``, ``ServingEngine`` and
  ``ContinuousBatchingScheduler``.

Entry points run on CUDA unless the caller passes ``device="cpu"``
(:func:`.device.resolve_device`).
"""
from .device import resolve_device  # noqa: F401

__version__ = "0.1.0"
