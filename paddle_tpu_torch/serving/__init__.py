"""Paged-KV serving engine (counterpart of ``paddle_tpu/serving``).

- :mod:`.kv_pool` — ``PagePool``: the KV cache as fixed-size pages with
  per-sequence page tables, a free list and page refcounts; page 0 is the
  sink for padding writes.
- :mod:`.prefix_cache` — ``PrefixCache``: a page-granular token trie that
  shares cached prompt pages between sequences.
- :mod:`paddle_tpu_torch.kernels.paged_attention` — the CUDA paged decode
  and ragged chunk-prefill kernels.
- :mod:`.engine` — ``ServingEngine``: stacked (optionally int8) weights,
  bucketed or chunked prefill and bucketed decode over the pool.
- :mod:`.scheduler` — ``ContinuousBatchingScheduler``: evict finished /
  admit queued (full-completion page reservation) / prefill chunks / one
  bucketed decode step, every tick.
"""
from .engine import (EngineShapeError, ServingEngine,  # noqa: F401
                     chunk_prefill_fn, decode_step_fn,
                     default_prefill_buckets, prefill_fn)
from .kv_pool import PagePool, PagePoolError, PagePoolOOM  # noqa: F401
from .prefix_cache import PrefixCache, make_shared_prefix_workload  # noqa: F401
from .scheduler import ContinuousBatchingScheduler, Request  # noqa: F401

__all__ = ["ServingEngine", "EngineShapeError", "decode_step_fn",
           "prefill_fn", "chunk_prefill_fn", "default_prefill_buckets",
           "PagePool", "PagePoolError", "PagePoolOOM", "PrefixCache",
           "make_shared_prefix_workload", "ContinuousBatchingScheduler",
           "Request"]
