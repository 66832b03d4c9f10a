"""What the port's CUDA graphs share: launch accounting over replays, the
garbage collector held off during a capture, flat input buffers, a
training step's inputs staged through pinned memory, host syncs made
errors, and a pool's size. The serving engines' bucket programs
(:mod:`paddle_tpu_torch.serving.graphs`) and the training steps
(:class:`paddle_tpu_torch.models.gpt.GPTHybridTrainStep`,
:class:`paddle_tpu_torch.distributed.fleet.ParallelTrainStep`) and the
static :class:`paddle_tpu_torch.static.Executor` capture with these; the
last two share :class:`CapturedSteps`.

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
import time
import warnings

import numpy as np
import torch

from ..kernels import flash_attention, int8_matmul, moe_dispatch, \
    paged_attention

__all__ = ["read_counts", "add_counts", "counted", "no_gc", "unpack",
           "pool_bytes", "sync_is_error", "StagedInputs", "eager_step",
           "capturing_on", "CapturedSteps"]

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


# set only inside eager_step()
_EAGER_ON_CUDA = False


@contextlib.contextmanager
def eager_step():
    """Every training step (``GPTHybridTrainStep``, ``ParallelTrainStep``)
    called inside runs eagerly on CUDA too: the yardstick the captured
    steps are held against by ``chip_smoke.py`` and the card tests. No call
    of the program enters it."""
    global _EAGER_ON_CUDA
    was, _EAGER_ON_CUDA = _EAGER_ON_CUDA, True
    try:
        yield
    finally:
        _EAGER_ON_CUDA = was


def capturing_on(device):
    """Does a training step on ``device`` capture and replay a graph (CUDA,
    outside :func:`eager_step`)?"""
    return device.type == "cuda" and not _EAGER_ON_CUDA


@contextlib.contextmanager
def sync_is_error():
    """A CUDA call that waits for the device raises inside: it would fail
    a capture, and here it fails with the op's name."""
    was = torch.cuda.get_sync_debug_mode()
    with warnings.catch_warnings():     # "a prototype feature"
        warnings.simplefilter("ignore", UserWarning)
        torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(was)


class StagedInputs:
    """A graph's static inputs in one device buffer: a tensor of each
    ``(shape, dtype)`` of ``specs`` (:attr:`tensors`), then ``n_scalars``
    0-d f32 tensors (:attr:`scalars`). :meth:`stage` writes a call's values
    into a pinned host buffer of the same layout and moves it with one
    non-blocking copy (as the serving engines' ``StepGraph.stage`` does);
    values given as CUDA tensors are copied in on the device after it."""

    def __init__(self, specs, n_scalars, device):
        offsets, at = [], 0
        for shape, dtype in specs:          # each tensor 16-byte aligned
            offsets.append(at)
            at += -(-math.prod(shape) * dtype.itemsize // 16) * 16
        self.static = torch.empty(at + 4 * n_scalars, dtype=torch.uint8,
                                  device=device)
        self.host = torch.empty(at + 4 * n_scalars, dtype=torch.uint8,
                                pin_memory=True)

        def views(buf):
            return [buf[o:o + math.prod(shape) * dtype.itemsize].view(
                dtype).view(shape) for o, (shape, dtype) in zip(offsets,
                                                                specs)]
        self.tensors = views(self.static)
        self._host_tensors = views(self.host)
        self.scalars = self.static[at:].view(torch.float32).unbind()
        self._host_scalars = self.host[at:].numpy().view(np.float32)
        self._copied = torch.cuda.Event()     # after the last copy out

    def stage(self, values, scalars):
        """Write one call's values (numpy arrays or tensors of the specs'
        shapes) and scalars; the host buffer is rewritten only once the
        previous copy out of it has landed."""
        self._copied.synchronize()     # returns at once before a record
        on_device = []
        for value, view, host in zip(values, self.tensors,
                                     self._host_tensors):
            if isinstance(value, torch.Tensor) and value.is_cuda:
                on_device.append((view, value))
            else:
                host.copy_(torch.as_tensor(value))
        self._host_scalars[:] = scalars
        self.static.copy_(self.host, non_blocking=True)
        self._copied.record()
        for view, value in on_device:
            view.copy_(value, non_blocking=True)


class _StepGraph:
    """One input signature's captured step: the graph, its staged inputs,
    its outputs (overwritten by every replay) and the launches a replay
    stands for."""

    def __init__(self, graph, inputs, outputs, counts):
        self.graph, self.inputs = graph, inputs
        self.outputs, self.counts = outputs, counts


class CapturedSteps:
    """A step function on ``device`` captured as one CUDA graph per input
    signature and replayed (what ``ParallelTrainStep`` and the static
    ``Executor`` run on the card).

    ``step(tensors, *scalars)`` takes the inputs as device tensors and the
    scalars as 0-d f32 device tensors, and returns a tuple of tensors (or
    None). :meth:`__call__` with a signature it has not seen runs the step
    eagerly on a side stream, where a host sync raises (it primes the
    allocator, cuBLAS and the kernel library, and counts its launches as
    any call does), then captures it in the one memory pool, with every
    generator given registered, so each replay draws new numbers as an
    eager call would: the capture records the same work and runs none of
    it, so the state moves by one call. Later calls stage the inputs and
    scalars through one pinned buffer (:class:`StagedInputs`) and replay.
    A capture that fails raises; nothing falls back. The outputs returned
    are copies that no later call overwrites."""

    def __init__(self, device):
        self.device = device
        self._graphs = {}             # signature -> _StepGraph
        self._pool = None
        self.capture_s = 0.0          # wall time of the captures

    @staticmethod
    def signature(values):
        """The signature of inputs (each tensor's or array's shape and
        dtype)."""
        return tuple((tuple(v.shape), v.dtype) for v in values)

    def __call__(self, step, values, scalars, generators=()):
        key = self.signature(values)
        graph = self._graphs.get(key)
        if graph is None:
            return self._capture(key, step, values, scalars, generators)
        graph.inputs.stage(values, scalars)
        graph.graph.replay()
        add_counts(graph.counts)
        return tuple(None if o is None else o.clone() for o in graph.outputs)

    def _capture(self, key, step, values, scalars, generators):
        dev = self.device
        inputs = StagedInputs(key, len(scalars), dev)
        inputs.stage(values, scalars)
        args = (inputs.tensors, *inputs.scalars)
        stream = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(stream)
        with torch.cuda.stream(side), sync_is_error():
            outs = step(*args)
        stream.wait_stream(side)
        for t in outs:
            if t is not None:
                t.record_stream(stream)
        t0 = time.perf_counter()
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        for gen in generators:
            graph.register_generator_state(gen)

        def capture():
            with no_gc(), torch.cuda.graph(graph, pool=self._pool):
                return step(*args)
        graph_outs, counts = counted(capture)
        self._graphs[key] = _StepGraph(graph, inputs, graph_outs, counts)
        self.capture_s += time.perf_counter() - t0
        return outs

    @property
    def signatures(self):
        """The input signatures that have a captured graph."""
        return list(self._graphs)

    def pool_bytes(self):
        """Device bytes the graphs' pool holds (0 with none captured; None
        where the allocator does not name pools)."""
        return 0 if self._pool is None else pool_bytes(self._pool)
