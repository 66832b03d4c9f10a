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

Launch accounting: each graph records, at capture, what the kernels'
launch counters moved by and adds that on every replay (``counted`` and
the other helpers it shares with the training step's graph are in
:mod:`paddle_tpu_torch.framework.graphs`, re-exported here).
"""
from __future__ import annotations

import math

import torch

from ..framework.graphs import (add_counts, counted, no_gc,  # noqa: F401
                                pool_bytes, read_counts, unpack)

__all__ = ["BucketGraphs", "StepGraph", "read_counts", "counted",
           "unpack"]


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
        add_counts(self.counts)
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
            with torch.no_grad(), no_gc(), \
                    torch.cuda.graph(graph, pool=self.pool):
                return fn(*inputs)
        out, counts = counted(capture)
        host = torch.zeros(n, dtype=torch.int32, pin_memory=True)
        self._graphs[key] = StepGraph(graph, static, host, inputs, out,
                                      counts, torch.cuda.Event())
        return self._graphs[key]

    def pool_bytes(self):
        """Device bytes the graphs' shared pool holds, or None where the
        allocator's snapshot does not name pools."""
        return pool_bytes(self.pool)
