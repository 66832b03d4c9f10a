"""Block KV-cache pool: fixed-size pages + per-sequence page tables
(counterpart of ``paddle_tpu/serving/kv_pool.py``).

The pool owns two device tensors, ``k_pages``/``v_pages`` ``[num_layers,
num_pages, page_size, num_kv_heads, head_dim]``, and the host bookkeeping
that maps sequences onto them: a free list, one page table per live
sequence, and a reference count per page. Live memory tracks actual
tokens (rounded up to the page), not ``max_position_embeddings``.

Page 0 is the reserved **sink** page: padding page-table entries and
padded prefill rows point into it, so every gather/scatter index the
engine computes is in bounds however ragged the batch. It is never
allocated and never read unmasked.

Pages are **refcounted** so the prefix cache (:mod:`.prefix_cache`) can
map one physical page into many sequences' page tables and into its own
trie: a page returns to the free list when its last reference drops.
Writers stay safe through the copy-on-write barrier in :meth:`extend`:
a sequence never grows into a page another holder references (the engine
copies a shared boundary page at admission, so a correctly driven pool
never trips it).

Unlike the JAX pool, whose arrays are updated functionally and rebound,
the engine updates these tensors in place.
"""
from __future__ import annotations

import functools
import math
import threading

import numpy as np
import torch

from ..device import resolve_device

__all__ = ["PagePool", "PagePoolError", "PagePoolOOM"]


def _locked(fn):
    """Run a bookkeeping method under the pool's RLock (the scheduler and
    callers on other threads mutate one pool; free -> decref nests)."""
    @functools.wraps(fn)
    def wrapper(self, *args, **kwargs):
        with self._mu:
            return fn(self, *args, **kwargs)
    return wrapper


class PagePoolError(RuntimeError):
    """Bookkeeping misuse: unknown/duplicate sequence, bad token count."""


class PagePoolOOM(PagePoolError):
    """Not enough free pages to satisfy an allocation."""


class PagePool:
    SINK = 0  # reserved padding/garbage page, never allocated

    def __init__(self, num_pages, page_size, num_layers, num_kv_heads,
                 head_dim, dtype=torch.float32, max_seq_len=None,
                 device=None):
        if num_pages < 2:
            raise ValueError("need at least 2 pages (one is the sink)")
        if page_size < 1:
            raise ValueError(f"page_size {page_size} must be >= 1")
        self.num_pages = int(num_pages)
        self.page_size = int(page_size)
        self.num_layers = int(num_layers)
        self.num_kv_heads = int(num_kv_heads)
        self.head_dim = int(head_dim)
        self.max_seq_len = int(max_seq_len) if max_seq_len \
            else (num_pages - 1) * page_size
        # every decode step carries the same page-table width
        self.max_pages_per_seq = max(
            1, math.ceil(self.max_seq_len / self.page_size))
        shape = (self.num_layers, self.num_pages, self.page_size,
                 self.num_kv_heads, self.head_dim)
        dev = resolve_device(device)
        self.k_pages = torch.zeros(shape, dtype=dtype, device=dev)
        self.v_pages = torch.zeros(shape, dtype=dtype, device=dev)
        self._mu = threading.RLock()
        # LIFO free list, deterministic: lowest page ids hand out first
        self._free = list(range(self.num_pages - 1, 0, -1))
        self._tables: dict = {}   # seq_id -> [page, ...]
        self._lens: dict = {}     # seq_id -> true token count
        self._refs: dict = {}     # page -> reference count (seqs + cache)
        # prefix-cache accounting: the cache reports into its pool, so one
        # stats() snapshot carries occupancy and reuse
        self._prefix_lookups = 0
        self._prefix_hits = 0
        self._tokens_reused = 0

    # ------------------------------------------------------------ sizing
    def pages_needed(self, n_tokens: int) -> int:
        return max(1, math.ceil(int(n_tokens) / self.page_size))

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def pages_in_use(self) -> int:
        return (self.num_pages - 1) - len(self._free)

    @property
    @_locked
    def live_tokens(self) -> int:
        return sum(self._lens.values())

    @property
    def live_sequences(self) -> int:
        return len(self._tables)

    @property
    @_locked
    def pages_shared(self) -> int:
        """Pages mapped by more than one holder (sequences and/or the
        prefix-cache trie)."""
        return sum(1 for c in self._refs.values() if c > 1)

    @_locked
    def note_prefix_lookup(self, tokens_reused: int):
        """Prefix-cache reuse accounting, called on every admission match
        attempt: a lookup that reuses > 0 tokens is a hit."""
        self._prefix_lookups += 1
        if tokens_reused > 0:
            self._prefix_hits += 1
            self._tokens_reused += int(tokens_reused)

    @_locked
    def stats(self) -> dict:
        """Occupancy, fragmentation and sharing: ``utilization`` is the
        share of allocated page slots physically holding a token, so
        ``internal_fragmentation`` is the share wasted on partly filled
        trailing pages (only a trailing page can be partial, and partial
        pages are never shared, so the waste sums per sequence).
        ``pages_shared``, ``tokens_reused`` and ``prefix_hit_rate`` report
        prefix-cache reuse (zero without a cache)."""
        cap = self.pages_in_use * self.page_size
        waste = sum((self.page_size - n % self.page_size) % self.page_size
                    for n in self._lens.values())
        util = ((cap - waste) / cap) if cap else 1.0
        return {
            "num_pages": self.num_pages,
            "page_size": self.page_size,
            "pages_in_use": self.pages_in_use,
            "free_pages": self.free_pages,
            "live_sequences": self.live_sequences,
            "live_tokens": self.live_tokens,
            "capacity_tokens": (self.num_pages - 1) * self.page_size,
            "utilization": round(util, 4),
            "internal_fragmentation": round(1.0 - util, 4),
            "pool_bytes": 2 * self.k_pages.numel()
            * self.k_pages.element_size(),
            "pages_shared": self.pages_shared,
            "tokens_reused": self._tokens_reused,
            "prefix_lookups": self._prefix_lookups,
            "prefix_hits": self._prefix_hits,
            "prefix_hit_rate": round(
                self._prefix_hits / self._prefix_lookups, 4)
            if self._prefix_lookups else 0.0,
        }

    # ------------------------------------------------------- bookkeeping
    def _require(self, seq_id):
        if seq_id not in self._tables:
            raise PagePoolError(
                f"unknown or already-freed sequence {seq_id!r} "
                f"({self.live_sequences} live)")

    @_locked
    def incref(self, pages):
        """Add one reference per page; validates every page before
        touching any count."""
        pages = list(pages)
        for p in pages:
            if p == self.SINK or not (0 < p < self.num_pages):
                raise PagePoolError(f"cannot reference page {p}")
            if p not in self._refs:
                raise PagePoolError(f"page {p} is not allocated")
        for p in pages:
            self._refs[p] += 1

    @_locked
    def decref(self, pages):
        """Drop one reference per page; pages reaching zero return to the
        free list (lowest ids reused first)."""
        freed = []
        for p in pages:
            c = self._refs.get(p, 0)
            if c < 1:
                raise PagePoolError(f"page {p} is not referenced")
            if c == 1:
                del self._refs[p]
                freed.append(p)
            else:
                self._refs[p] = c - 1
        self._free.extend(sorted(freed, reverse=True))
        return freed

    @_locked
    def page_ref(self, page: int) -> int:
        return self._refs.get(page, 0)

    @_locked
    def _take_page(self) -> int:
        """Pop one free page at refcount 1, owned by the caller (the
        engine's copy-on-write boundary page, before a table exists)."""
        if not self._free:
            raise PagePoolOOM("no free pages for a copy-on-write page")
        p = self._free.pop()
        self._refs[p] = 1
        return p

    def alloc(self, seq_id, n_tokens: int):
        """Register a new sequence holding ``n_tokens`` and hand it pages.
        Returns its page table."""
        return self.alloc_prefixed(seq_id, n_tokens, (), 0)

    @_locked
    def alloc_prefixed(self, seq_id, n_tokens: int, prefix_pages,
                       prefix_len: int):
        """Register a new sequence whose first ``prefix_len`` tokens already
        live in ``prefix_pages`` (cached pages the caller mapped; this takes
        one reference on each); only the pages for the tokens past the
        prefix come from the free list. Returns the full page table."""
        if seq_id in self._tables:
            raise PagePoolError(f"sequence {seq_id!r} already allocated")
        n_tokens = int(n_tokens)
        prefix_len = int(prefix_len)
        prefix_pages = list(prefix_pages)
        if n_tokens < 1:
            raise PagePoolError(f"n_tokens {n_tokens} must be >= 1")
        if n_tokens > self.max_seq_len:
            raise PagePoolError(f"n_tokens {n_tokens} exceeds max_seq_len "
                                f"{self.max_seq_len}")
        if prefix_len > n_tokens:
            raise PagePoolError(f"prefix_len {prefix_len} exceeds n_tokens "
                                f"{n_tokens}")
        if prefix_pages and not prefix_len:
            raise PagePoolError("prefix pages without a prefix length")
        if prefix_len and len(prefix_pages) != math.ceil(
                prefix_len / self.page_size):
            raise PagePoolError(
                f"prefix of {prefix_len} tokens needs "
                f"{math.ceil(prefix_len / self.page_size)} pages, got "
                f"{len(prefix_pages)}")
        need = self.pages_needed(n_tokens) - len(prefix_pages)
        if need > len(self._free):
            raise PagePoolOOM(f"need {need} pages for {n_tokens} tokens "
                              f"({prefix_len} cached), {len(self._free)} "
                              f"free")
        self.incref(prefix_pages)
        fresh = []
        for _ in range(max(need, 0)):
            p = self._free.pop()
            self._refs[p] = 1
            fresh.append(p)
        self._tables[seq_id] = prefix_pages + fresh
        self._lens[seq_id] = n_tokens
        return list(self._tables[seq_id])

    @_locked
    def extend(self, seq_id, n_new: int = 1) -> int:
        """Grow a sequence by ``n_new`` tokens, allocating pages as the
        length crosses page boundaries. Returns the new length. The pages
        the new tokens land in must be held by this sequence alone (the
        copy-on-write barrier: a write into a shared page would corrupt
        the other holders). It runs before any allocation, so a refused
        extend leaves the pool as it was."""
        self._require(seq_id)
        new_len = self._lens[seq_id] + int(n_new)
        if new_len > self.max_seq_len:
            raise PagePoolError(f"sequence {seq_id!r} would exceed "
                                f"max_seq_len {self.max_seq_len}")
        table = self._tables[seq_id]
        need = self.pages_needed(new_len) - len(table)
        if need > len(self._free):
            raise PagePoolOOM(f"sequence {seq_id!r} needs {need} more "
                              f"page(s), {len(self._free)} free")
        first = self._lens[seq_id] // self.page_size
        last = (new_len - 1) // self.page_size
        for idx in range(first, min(last, len(table) - 1) + 1):
            p = table[idx]
            if self._refs.get(p, 0) != 1:
                raise PagePoolError(
                    f"sequence {seq_id!r} would write shared page {p} "
                    f"(refcount {self._refs.get(p, 0)}): copy-on-write the "
                    f"boundary page before extending")
        for _ in range(need):
            p = self._free.pop()
            self._refs[p] = 1
            table.append(p)
        self._lens[seq_id] = new_len
        return new_len

    @_locked
    def free(self, seq_id):
        """Drop the sequence's reference on its pages."""
        self._require(seq_id)
        pages = self._tables.pop(seq_id)
        del self._lens[seq_id]
        self.decref(pages)

    @_locked
    def seq_len(self, seq_id) -> int:
        self._require(seq_id)
        return self._lens[seq_id]

    @_locked
    def table(self, seq_id) -> list:
        self._require(seq_id)
        return list(self._tables[seq_id])

    # ---------------------------------------------- device-facing arrays
    @_locked
    def table_array(self, seq_ids) -> np.ndarray:
        """Dense int32 page-table batch ``[B, max_pages_per_seq]`` for the
        decode kernel; missing/short entries point at the sink."""
        out = np.full((len(seq_ids), self.max_pages_per_seq), self.SINK,
                      dtype=np.int32)
        for i, sid in enumerate(seq_ids):
            pages = self._tables.get(sid)
            if pages:
                out[i, :len(pages)] = pages
        return out

    @_locked
    def lens_array(self, seq_ids) -> np.ndarray:
        """True lengths ``[B]`` int32 (0 for idle/unknown slots)."""
        return np.asarray([self._lens.get(sid, 0) for sid in seq_ids],
                          dtype=np.int32)

    def prefill_rows(self, seq_id, bucket_len: int) -> np.ndarray:
        """Destination rows ``[bucket_len]`` int32 into the flattened
        ``[num_pages * page_size]`` page-row view for a prefill scatter:
        token ``t`` lands in its page's slot; padded positions (``t >=
        seq_len``) land in the sink page."""
        return self.chunk_rows(seq_id, 0, bucket_len)

    @_locked
    def chunk_rows(self, seq_id, start: int, bucket_len: int) -> np.ndarray:
        """Destination rows for a prefill chunk: positions ``[start, start +
        bucket_len)`` of the sequence map to their page slots; positions at
        or past its length land in the sink page."""
        self._require(seq_id)
        ps = self.page_size
        pages = self._tables[seq_id]
        n = self._lens[seq_id]
        t = int(start) + np.arange(int(bucket_len))
        page = np.full(t.shape, self.SINK, dtype=np.int64)
        live = t < n
        page[live] = np.asarray(pages, dtype=np.int64)[t[live] // ps]
        return (page * ps + t % ps).astype(np.int32)

    @_locked
    def token_rows(self, seq_id, start: int, stop: int) -> np.ndarray:
        """Flattened page rows of token positions ``[start, stop)`` of a
        live sequence, without padding: every row is a real token's slot."""
        self._require(seq_id)
        start, stop = int(start), int(stop)
        if not 0 <= start <= stop <= self._lens[seq_id]:
            raise PagePoolError(
                f"token range [{start}, {stop}) outside sequence "
                f"{seq_id!r} length {self._lens[seq_id]}")
        t = np.arange(start, stop)
        pages = np.asarray(self._tables[seq_id], dtype=np.int64)
        return (pages[t // self.page_size] * self.page_size
                + t % self.page_size).astype(np.int32)
