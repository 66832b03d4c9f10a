"""What the port's CUDA graphs share: launch accounting over replays, the
garbage collector held off during a capture, flat input buffers and a
pool's size. The serving engines' bucket programs
(:mod:`paddle_tpu_torch.serving.graphs`) and the GPT training step
(:class:`paddle_tpu_torch.models.gpt.GPTHybridTrainStep`) capture with
these.

Launch accounting: the kernel wrappers count their launches in Python, and
a replay runs no Python. So each graph records, at capture, what the
counters of ``paddle_tpu_torch.kernels`` moved by (:func:`counted`, which
sets them back: a capture launches nothing), and adds that to the same
counters on every replay (:func:`add_counts`).
"""
from __future__ import annotations

import contextlib
import gc
import math

import torch

from ..kernels import flash_attention, int8_matmul, moe_dispatch, \
    paged_attention

__all__ = ["read_counts", "add_counts", "counted", "no_gc", "unpack",
           "pool_bytes"]

_KERNEL_MODULES = (flash_attention, paged_attention, int8_matmul,
                   moe_dispatch)


def read_counts() -> dict:
    """Every kernel wrapper's launch counter (``*launches`` of the modules
    of ``paddle_tpu_torch.kernels``), by ``(module, name)``."""
    return {(m.__name__, k): v for m in _KERNEL_MODULES
            for k, v in vars(m).items()
            if k.endswith("launches") and isinstance(v, int)}


def add_counts(delta):
    """Add ``delta`` (as :func:`counted` returns it) to the counters."""
    mods = {m.__name__: m for m in _KERNEL_MODULES}
    for (mod, name), n in delta.items():
        setattr(mods[mod], name, getattr(mods[mod], name) + n)


def counted(fn):
    """Run ``fn()``; return its result and what it moved the launch
    counters by (only the counters that moved), with the counters set back
    to where they were."""
    before = read_counts()
    out = fn()
    moved = {k: v - before[k] for k, v in read_counts().items()
             if v != before[k]}
    add_counts({k: -v for k, v in moved.items()})
    return out, moved


@contextlib.contextmanager
def no_gc():
    """The cyclic garbage collector off: a collection inside a capture may
    destroy another graph (or free pinned memory or an event), which
    invalidates the capture. ``torch.cuda.graph`` still collects (by an
    explicit call) just before it begins."""
    was = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if was:
            gc.enable()


def unpack(flat, shapes):
    """Views of a flat tensor, one for each shape, in order."""
    views, at = [], 0
    for shape in shapes:
        n = math.prod(shape)
        views.append(flat[at:at + n].view(shape))
        at += n
    if at != flat.numel():
        raise ValueError(f"{flat.numel()} values for shapes {shapes}")
    return tuple(views)


def pool_bytes(pool):
    """Device bytes a graph memory pool holds (segments of the caching
    allocator in that pool), or None where the allocator's snapshot does
    not name pools."""
    segs = torch.cuda.memory_snapshot()
    if segs and "segment_pool_id" not in segs[0]:
        return None
    pool = tuple(pool)
    return sum(s["total_size"] for s in segs
               if tuple(s["segment_pool_id"]) == pool)
