"""Paged-KV serving engine (counterpart of ``paddle_tpu/serving``).

- :mod:`.kv_pool` — ``PagePool``: the KV cache as fixed-size pages with
  per-sequence page tables, a free list and page refcounts; page 0 is the
  sink for padding writes.
- :mod:`paddle_tpu_torch.kernels.paged_attention` — the CUDA ragged
  paged-attention decode kernel.
- :mod:`.engine` — ``ServingEngine``: stacked weights, bucketed prefill
  (FlashAttention kernel) and bucketed decode over the pool.
- :mod:`.scheduler` — ``ContinuousBatchingScheduler``: evict finished /
  admit queued (full-completion page reservation) / one bucketed decode
  step, every tick.
"""
from .engine import (EngineShapeError, ServingEngine, decode_step_fn,  # noqa: F401
                     default_prefill_buckets, prefill_fn)
from .kv_pool import PagePool, PagePoolError, PagePoolOOM  # noqa: F401
from .scheduler import ContinuousBatchingScheduler, Request  # noqa: F401

__all__ = ["ServingEngine", "EngineShapeError", "decode_step_fn",
           "prefill_fn", "default_prefill_buckets", "PagePool",
           "PagePoolError", "PagePoolOOM", "ContinuousBatchingScheduler",
           "Request"]
