"""paddle_tpu_torch: the PyTorch/CUDA port of ``paddle_tpu`` for one NVIDIA H100.

The JAX package ``paddle_tpu`` stays the reference; this package keeps its
module names and public names so each counterpart is easy to find. It
imports ``torch`` and never ``jax``, and nothing from ``paddle_tpu``.

Importing it has no global side effects: no device is touched, no kernel
is built (the CUDA kernels compile at their first launch, see
:mod:`paddle_tpu_torch.kernels._build`), and no RNG state is seeded.

Ported so far, the GPT serving main path (``ROADMAP.md`` lists the rest):

- :mod:`.models.gpt` — the GPT model family as ``nn.Module``s;
- :mod:`.kernels.flash_attention` — FlashAttention-2 forward (CUDA);
- :mod:`.kernels.paged_attention` — ragged paged-attention decode (CUDA);
- :mod:`.serving` — ``PagePool``, ``ServingEngine`` and
  ``ContinuousBatchingScheduler``.

Entry points run on CUDA unless the caller passes ``device="cpu"``
(:func:`.device.resolve_device`).
"""
from .device import resolve_device  # noqa: F401

__version__ = "0.1.0"
