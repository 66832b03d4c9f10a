"""Radix-style prefix cache over the KV page pool (counterpart of
``paddle_tpu/serving/prefix_cache.py``).

A token trie at page granularity whose nodes each own one *full* KV page
(``page_size`` tokens) through the pool's refcounts. At admission the
engine asks for the longest cached prefix of the new prompt; matched pages
map straight into the new sequence's page table (one reference each, no
device work), and only the rest of the prompt is prefilled.

Sharing rules (kept here and by the pool's write barrier):

- Only **full** pages enter the trie. A full page never changes, since
  decode writes land at positions at or past the sequence length, in later
  pages. A partial trailing page stays private to its sequence.
- A match may end **mid-page**: the engine copies the cached page into a
  fresh private page (copy-on-write) and the suffix prefill overwrites the
  rows from the divergence on. A token's K/V depends only on the tokens
  before it, so the copied rows are valid as they are.
- A node is **pinned** (``ref > 0``) while a live sequence maps it.
  Eviction is LRU over unpinned leaves; evicting a node drops the trie's
  page reference, and the page returns to the free list when no sequence
  still maps it. :meth:`PrefixCache.reclaim` is the scheduler's pressure
  valve at admission.

Pages enter the trie when their content exists: at prefill completion (the
prompt's full pages) and at release (the full pages of prompt and
generated tokens, less the final sampled token, whose K/V never entered
the pool).

``make_shared_prefix_workload`` makes the shared-prefix traffic of the
tests and of ``chip_smoke.py``.
"""
from __future__ import annotations

import heapq
import itertools

import numpy as np

from .kv_pool import PagePool, PagePoolError

__all__ = ["PrefixCache", "make_shared_prefix_workload"]


class _Node:
    __slots__ = ("tokens", "page", "children", "parent", "ref",
                 "last_used")

    def __init__(self, tokens, page, parent):
        self.tokens = tokens          # tuple[int], len == page_size
        self.page = page              # pool page id (trie holds one ref)
        self.children = {}            # tokens tuple -> _Node
        self.parent = parent
        self.ref = 0                  # live sequences mapping this node
        self.last_used = 0


class PrefixCache:
    """Token trie over ``pool``'s pages. One instance per engine; all
    methods are host-side dict/list ops (the only device work a hit
    triggers is the engine's COW page copy)."""

    def __init__(self, pool: PagePool):
        self.pool = pool
        self.page_size = pool.page_size
        self._root = _Node((), None, None)
        self._clock = itertools.count(1)
        self._nodes = 0
        self._pins: dict = {}         # seq_id -> [node, ...]
        self.evictions = 0

    # reuse counters live in ONE place — the pool (so pool.stats() and
    # cache.stats() can never disagree); these are read-only views
    @property
    def lookups(self) -> int:
        return self.pool._prefix_lookups

    @property
    def hits(self) -> int:
        return self.pool._prefix_hits

    @property
    def tokens_reused(self) -> int:
        return self.pool._tokens_reused

    # ------------------------------------------------------------ match
    def match(self, prompt) -> tuple:
        """Longest cached prefix of ``prompt``, capped at
        ``len(prompt) - 1`` so at least one token remains to prefill
        (the last position's logits seed the first output token).

        Returns ``(nodes, boundary, cached_len)`` where ``nodes`` are
        the fully matched trie nodes (one full page each) and
        ``boundary`` is ``(node, n_rows)`` when the walk ends part-way
        into a cached page (→ COW), else ``None``. No refcounts move —
        :meth:`map_into` commits the match."""
        toks = [int(t) for t in np.asarray(prompt).reshape(-1)]
        cap = len(toks) - 1
        ps = self.page_size
        node, pos, nodes = self._root, 0, []
        while cap - pos >= ps:
            child = node.children.get(tuple(toks[pos:pos + ps]))
            if child is None:
                break
            nodes.append(child)
            node, pos = child, pos + ps
        boundary = None
        limit = min(ps, cap - pos)
        if limit > 0:
            best, best_j = None, 0
            for child in node.children.values():
                j = 0
                for a, b in zip(child.tokens, toks[pos:pos + limit]):
                    if a != b:
                        break
                    j += 1
                if j > best_j:
                    best, best_j = child, j
            if best is not None:
                boundary = (best, best_j)
                pos += best_j
        return nodes, boundary, pos

    def map_into(self, seq_id, nodes, boundary=None):
        """Commit a match for ``seq_id``: pin the nodes (and the
        boundary node — pinning blocks eviction, so the pages survive
        until ``pool.alloc_prefixed`` takes the sequence's reference
        and the engine's COW copy lands), stamp LRU clocks, and record
        reuse stats. Returns the shared full pages in prefix order
        (refcounts move in ``alloc_prefixed``, not here)."""
        pages = [n.page for n in nodes]
        now = next(self._clock)
        pinned = list(nodes)
        if boundary is not None:
            pinned.append(boundary[0])
        for n in pinned:
            n.ref += 1
            while n is not None and n.tokens:
                n.last_used = now
                n = n.parent
        self._pins.setdefault(seq_id, []).extend(pinned)
        reused = len(pages) * self.page_size + \
            (boundary[1] if boundary is not None else 0)
        self.pool.note_prefix_lookup(reused)
        return pages

    def release(self, seq_id):
        """Unpin the nodes a finished/failed sequence was mapping (the
        pool refs drop separately via ``pool.free``)."""
        for n in self._pins.pop(seq_id, ()):
            n.ref = max(n.ref - 1, 0)

    # ----------------------------------------------------------- insert
    def insert(self, token_ids, pages):
        """Insert the full pages of a sequence (``token_ids`` covered by
        ``pages``, K/V already written) into the trie. Existing nodes
        are descended (first writer wins — duplicates stay private to
        their sequence); each NEW node takes one pool reference on the
        sequence's page. Returns the number of new nodes."""
        toks = [int(t) for t in np.asarray(token_ids).reshape(-1)]
        ps = self.page_size
        n_full = len(toks) // ps
        node, added = self._root, 0
        now = next(self._clock)
        for i in range(n_full):
            chunk = tuple(toks[i * ps:(i + 1) * ps])
            child = node.children.get(chunk)
            if child is None:
                page = pages[i]
                if self.pool.page_ref(page) < 1:
                    raise PagePoolError(
                        f"cannot cache unallocated page {page}")
                self.pool.incref([page])
                child = _Node(chunk, page, node)
                node.children[chunk] = child
                self._nodes += 1
                added += 1
            child.last_used = now
            node = child
        return added

    # --------------------------------------------------------- eviction
    def _leaves(self):
        out, stack = [], [self._root]
        while stack:
            n = stack.pop()
            if n.tokens and not n.children:
                out.append(n)
            stack.extend(n.children.values())
        return out

    def evictable_pages(self) -> int:
        """Pages :meth:`reclaim` could return to the free list right
        now: pages of unpinned nodes (transitively — a pinned node pins
        its ancestors) whose only remaining reference is the trie's."""
        acc: list = []

        def walk(n):
            pinned = n.ref > 0
            for c in n.children.values():
                pinned = walk(c) or pinned
            if n.tokens and not pinned:
                acc.append(n)
            return pinned

        walk(self._root)
        return sum(1 for n in acc if self.pool.page_ref(n.page) == 1)

    def reclaim(self, n_pages: int) -> int:
        """Evict LRU unpinned leaves until ``n_pages`` pages actually
        returned to the free list (a node whose page a live sequence
        still maps frees nothing) or nothing evictable remains.
        Returns the number of pages freed. One trie walk per call:
        evicting a leaf can only expose its parent, so the candidate
        set is maintained incrementally — admission-tick reclaim under
        sustained pressure stays O(nodes + evictions·log), not
        O(evictions · nodes)."""
        freed = 0
        heap = [(n.last_used, id(n), n) for n in self._leaves()]
        heapq.heapify(heap)
        while freed < n_pages and heap:
            _, _, victim = heapq.heappop(heap)
            if victim.children or victim.ref > 0 \
                    or victim.tokens not in victim.parent.children:
                continue  # stale entry (grew children / pinned / gone)
            parent = victim.parent
            freed += len(self._evict(victim))
            if parent.tokens and not parent.children:
                heapq.heappush(heap, (parent.last_used, id(parent),
                                      parent))
        return freed

    def _evict(self, node):
        node.parent.children.pop(node.tokens, None)
        self._nodes -= 1
        self.evictions += 1
        return self.pool.decref([node.page])

    def clear(self):
        """Drop every unpinned node (full reset under memory pressure)."""
        self.reclaim(self._nodes * 2 + 1)

    # ------------------------------------------------------------ stats
    def stats(self) -> dict:
        return {
            "nodes": self._nodes,
            "lookups": self.lookups,
            "hits": self.hits,
            "hit_rate": round(self.hits / self.lookups, 4)
            if self.lookups else 0.0,
            "tokens_reused": self.tokens_reused,
            "evictions": self.evictions,
            "evictable_pages": self.evictable_pages(),
        }


# ---------------------------------------------------------------------------
# shared-prefix workload generator (tests and chip_smoke.py)
# ---------------------------------------------------------------------------

def make_shared_prefix_workload(vocab_size, n_requests, prefix_len,
                                suffix_len, n_prefixes=1, seed=0,
                                divergence_offsets=()):
    """Prompts modelling real shared-prefix traffic: ``n_prefixes``
    distinct system prompts of ``prefix_len`` tokens, each request =
    one shared prefix + a private random suffix of ``suffix_len``.
    ``divergence_offsets`` plants requests whose prompt diverges from
    their prefix ``offset`` tokens EARLY (i.e. shares ``prefix_len -
    offset`` tokens) — mid-page offsets exercise the COW boundary.
    Returns a list of int32 prompt arrays."""
    rng = np.random.default_rng(seed)
    prefixes = [rng.integers(0, vocab_size, (prefix_len,)).astype(np.int32)
                for _ in range(n_prefixes)]
    prompts = []
    for i in range(n_requests):
        pre = prefixes[i % n_prefixes].copy()
        suffix = rng.integers(0, vocab_size,
                              (suffix_len,)).astype(np.int32)
        if i < len(divergence_offsets) and divergence_offsets[i]:
            off = int(divergence_offsets[i])
            # diverge inside the prefix: flip the token at -off
            pre[prefix_len - off] = (pre[prefix_len - off] + 1) % vocab_size
        prompts.append(np.concatenate([pre, suffix]))
    return prompts
