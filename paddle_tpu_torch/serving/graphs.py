"""CUDA graphs of the serving engines' step programs: the port's form of the
JAX engines' ahead-of-time bucket closure (``aot=True``,
``compile_buckets``).

The JAX engine compiles one executable per decode bucket and per prefill
bucket (or one chunk program) before it serves, so no request mix ever
compiles. Here each of those programs is captured once as a CUDA graph and
replayed, so a step costs one graph launch of host time instead of one
Python call per kernel and per op.

A program's int32 inputs (tokens, positions, page table, lengths; or ids,
true length and rows; or the chunk's ids, offset, length, table and rows)
travel as one flat buffer: :meth:`StepGraph.stage` writes them into a
pinned host buffer and one non-blocking copy moves them into the graph's
static device buffer, whose views the captured program reads. Everything
else the program touches keeps its address for the engine's life: the
weights and the page pool (updated in place).

An engine's graphs share one memory pool. That is safe because the engines
read every graph's output to the host (``.tolist()``, ``int(tok[0])``)
before another graph replays, so no two graphs' intermediates are live at
once.

Launch accounting: the kernel wrappers count their launches in Python, and
a replay runs no Python. So each graph records, at capture, what the
counters of ``paddle_tpu_torch.kernels`` moved by, restores them (warm-up
and capture count nothing), and adds that to the same counters on every
replay (:func:`counted`, :class:`StepGraph`).
"""
from __future__ import annotations

import contextlib
import gc
import math

import torch

from ..kernels import flash_attention, int8_matmul, moe_dispatch, \
    paged_attention

__all__ = ["BucketGraphs", "StepGraph", "read_counts", "counted",
           "unpack"]

_KERNEL_MODULES = (flash_attention, paged_attention, int8_matmul,
                   moe_dispatch)


def read_counts() -> dict:
    """Every kernel wrapper's launch counter (``*launches`` of the modules
    of ``paddle_tpu_torch.kernels``), by ``(module, name)``."""
    return {(m.__name__, k): v for m in _KERNEL_MODULES
            for k, v in vars(m).items()
            if k.endswith("launches") and isinstance(v, int)}


def _add_counts(delta):
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
    _add_counts({k: -v for k, v in moved.items()})
    return out, moved


@contextlib.contextmanager
def _no_gc():
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


class StepGraph:
    """One captured program: its graph, its static inputs (views of
    ``static``), their pinned host staging buffer, its output and the
    launches one replay stands for."""

    def __init__(self, graph, static, host, inputs, out, counts,
                 copied=None):
        self.graph, self.static, self.host = graph, static, host
        self.inputs, self.out, self.counts = inputs, out, counts
        self._host_np = host.numpy()
        self._copied = copied        # an event after the last copy out

    def stage(self, flat):
        """Write one step's inputs (a flat int32 array) into the static
        buffer; returns the static inputs. The host buffer is rewritten
        only once the previous copy out of it has landed."""
        if self._copied is not None:
            self._copied.synchronize()
        self._host_np[:] = flat
        self.static.copy_(self.host, non_blocking=True)
        if self._copied is not None:
            self._copied.record()
        return self.inputs

    def replay(self):
        """Launch the graph on the current stream and count its kernels'
        launches; returns the static output (overwritten by the next
        replay)."""
        self.graph.replay()
        _add_counts(self.counts)
        return self.out


class BucketGraphs:
    """One engine's captured programs, keyed as the engine keys them, all
    in one memory pool. ``generator`` (when the engine samples) is
    registered with every graph, so that each replay draws from it as the
    eager step would."""

    def __init__(self, device, generator=None):
        self.device = device
        self.generator = generator
        self.pool = torch.cuda.graph_pool_handle()
        self._graphs: dict = {}

    def __contains__(self, key):
        return key in self._graphs

    def __len__(self):
        return len(self._graphs)

    def get(self, key):
        return self._graphs.get(key)

    def capture(self, key, shapes, fn):
        """Capture ``fn(*inputs)`` (its inputs int32 tensors of
        ``shapes``) as the program ``key``: one warm-up call on a side
        stream, then the capture into the shared pool. Raises if the
        capture fails; the launch counters are left as they were."""
        dev = self.device
        n = sum(math.prod(s) for s in shapes)
        static = torch.zeros(n, dtype=torch.int32, device=dev)
        inputs = unpack(static, shapes)
        stream = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(stream)
        with torch.no_grad(), torch.cuda.stream(side):
            counted(lambda: fn(*inputs))
        stream.wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        if self.generator is not None:
            graph.register_generator_state(self.generator)

        def capture():
            with torch.no_grad(), _no_gc(), \
                    torch.cuda.graph(graph, pool=self.pool):
                return fn(*inputs)
        out, counts = counted(capture)
        host = torch.zeros(n, dtype=torch.int32, pin_memory=True)
        self._graphs[key] = StepGraph(graph, static, host, inputs, out,
                                      counts, torch.cuda.Event())
        return self._graphs[key]

    def pool_bytes(self):
        """Device bytes the graphs' shared pool holds (segments of the
        caching allocator in that pool), or None where the allocator's
        snapshot does not name pools."""
        segs = torch.cuda.memory_snapshot()
        if segs and "segment_pool_id" not in segs[0]:
            return None
        pool = tuple(self.pool)
        return sum(s["total_size"] for s in segs
                   if tuple(s["segment_pool_id"]) == pool)
