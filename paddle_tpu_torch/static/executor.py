"""The static-graph Executor (counterpart of ``paddle_tpu/static/executor.py``).

``Executor.run`` closes a Program's lazy DAG into one step function of the
feeds per (program, feed signature, fetch list), the JAX Executor's jit
cache key. The step evaluates the nodes the fetches (and the buffer
updates, and the loss of a recorded ``minimize``) need, in the order they
were recorded, each as eager ``apply`` runs it; with a ``minimize`` it then
takes ``torch.autograd.grad`` of the loss over the trainable parameters and
runs the optimizer's update (:meth:`Optimizer._apply`, lr a 0-d f32 device
tensor read from the host each run), and last it copies the buffer updates
(BN running statistics) into their buffers in place.

On CUDA the step is captured as one CUDA graph per feed signature and
replayed (:class:`paddle_tpu_torch.framework.graphs.CapturedSteps`, as
``ParallelTrainStep`` does): the first run of a signature runs eagerly on a
side stream, where a host sync raises, then the capture; later runs stage
the feeds (numpy arrays through one pinned buffer, device tensors copied on
the device) and lr, and replay. The facade's generator of the device is
registered with each graph, so dropout draws new masks every run. A capture
that fails raises; nothing falls back. A fetch is the value the run read
(a fetched parameter or buffer is copied inside the step, before the
update writes it in place) and a copy that no later run overwrites. On the
CPU, and on CUDA inside
:func:`paddle_tpu_torch.framework.graphs.eager_step` (the yardstick the
card checks hold the graphs against), the step runs eagerly.
"""
from __future__ import annotations

import numpy as np
import torch

from ..framework import random as random_mod
from ..framework.graphs import CapturedSteps, capturing_on
from ..framework.place import to_torch_device
from ..framework.tensor import (LazyTensor, Parameter, Tensor,
                                _numpy_to_torch)
from ..optimizer.optimizer import _trainable
from .program import Program, default_main_program, default_startup_program

__all__ = ["Executor", "global_scope"]


class _Scope:
    def __init__(self):
        self.vars = {}

    def var(self, name):
        return self.vars.setdefault(name, None)

    def find_var(self, name):
        return self.vars.get(name)


_global_scope = _Scope()


def global_scope():
    return _global_scope


def _collect_graph(fetch_vars):
    """The nodes ``fetch_vars`` depend on, in the order they were recorded,
    and the ``Parameter``s they read (in the order first met)."""
    nodes, params, seen_n, seen_p = [], [], set(), set()
    todo = [t for t in reversed(list(fetch_vars)) if isinstance(t, Tensor)]
    while todo:
        t = todo.pop()
        if not isinstance(t, LazyTensor):
            if isinstance(t, Parameter) and id(t) not in seen_p:
                seen_p.add(id(t))
                params.append(t)
            continue
        node = t._lazy[0]
        if node == "feed" or id(node) in seen_n:
            continue
        seen_n.add(id(node))
        nodes.append(node)
        todo.extend(a for a in reversed(node.args) if isinstance(a, Tensor))
    nodes.sort(key=lambda n: n.seq)
    return nodes, params


def _eval_graph(fetch_vars, feed_vals, param_map=None, nodes=None,
                differentiated=()):
    """The values of ``fetch_vars``: ``feed_vals`` maps feed names to
    tensors, ``param_map`` ids of concrete Tensors to values that replace
    theirs (every other concrete Tensor reads its ``_value`` now). The
    nodes run in the order they were recorded (``nodes``, when given, is
    :func:`_collect_graph`'s list), so random ops draw as the eager ops
    did. Reads of the Tensors in ``differentiated`` (what
    ``static.gradients`` differentiates by) are never detached."""
    keep = {id(t) for t in differentiated}
    param_map = param_map or {}
    if nodes is None:
        nodes = _collect_graph(fetch_vars)[0]
    # a node's outputs are dropped after their last reader has run (unless
    # fetched), as eager code drops its temporaries
    last = {id(t._lazy[0]): len(nodes) for t in fetch_vars
            if isinstance(t, LazyTensor)}
    for i, node in enumerate(nodes):
        for a in node.args:
            if isinstance(a, LazyTensor) and last.get(id(a._lazy[0]),
                                                      -1) < len(nodes):
                last[id(a._lazy[0])] = i
    memo = {}

    def value(t):
        if not isinstance(t, Tensor):
            return t
        if not isinstance(t, LazyTensor):
            return param_map.get(id(t), t._value)
        src, idx = t._lazy
        if src == "feed":
            if idx not in feed_vals:
                raise KeyError(f"feed {idx!r} is missing: the program reads "
                               f"it")
            return feed_vals[idx]
        return memo[id(src)][idx]

    for i, node in enumerate(nodes):
        detach = [d and id(a) not in keep
                  for a, d in zip(node.args, node.detach)] if keep else None
        memo[id(node)] = node.run([value(a) for a in node.args], detach)
        for a in node.args:
            if isinstance(a, LazyTensor) and last.get(id(a._lazy[0])) == i:
                memo.pop(id(a._lazy[0]), None)
    return [value(t) for t in fetch_vars]


class _Entry:
    """A (program, feed signature, fetch list)'s closed step: the nodes it
    evaluates, the trainable parameters, the optimizer, the buffer
    targets, and on CUDA its captured graphs."""

    def __init__(self, program, feed_names, fetch_list, device):
        self.program = program      # held: the cache is keyed by its id
        self.feed_names = feed_names
        bupds = program._buffer_updates
        self.targets = [t for t, _ in bupds]
        upd_exprs = [v for _, v in bupds]
        opt = program._optimize_ops[-1] if program._optimize_ops else None
        self.optimizer = opt[0] if opt else None
        self.roots = list(fetch_list) + upd_exprs + ([opt[1]] if opt else [])
        self.nodes, params = _collect_graph(self.roots)
        self.read = params          # every Parameter the step reads
        self.n_fetch = len(fetch_list)
        target_ids = {id(t) for t in self.targets}
        self.params = []
        if self.optimizer is not None:
            held = self.optimizer._adopt_parameters(
                [p for p in params if id(p) not in target_ids])
            self.params = [p for p in held if _trainable(p)]
            self.optimizer._init_state(self.params)
        self.steps = CapturedSteps(device) if device.type == "cuda" else None

    def _snapshot(self, fetched):
        """The fetched values, each that shares storage with a concrete
        Tensor of the program (a parameter, a buffer, a fetched non-lazy
        Tensor, or a view of one) copied: the run's updates write those
        in place, and the JAX Executor returns what the run read."""
        concrete = [t for t in self.roots[:self.n_fetch]
                    if isinstance(t, Tensor) and not isinstance(t,
                                                                LazyTensor)]
        held = {t._value.untyped_storage().data_ptr()
                for t in self.read + self.targets + concrete}
        return [o.detach().clone() if isinstance(o, torch.Tensor)
                and o.untyped_storage().data_ptr() in held else o
                for o in fetched]

    def step(self, feeds, *scalars):
        """Evaluate, differentiate and update on device tensors; returns
        the fetched values (what a graph captures), as the run read them:
        a fetched parameter or buffer is copied before the update."""
        fv = dict(zip(self.feed_names, feeds))
        with torch.set_grad_enabled(self.optimizer is not None):
            outs = _eval_graph(self.roots, fv, nodes=self.nodes)
            if self.optimizer is not None:
                loss = outs[-1]
                grads = torch.autograd.grad(
                    loss if loss.dim() == 0 else loss.sum(),
                    [p._value for p in self.params], materialize_grads=True)
        with torch.no_grad():
            fetched = self._snapshot(outs[:self.n_fetch])
            if self.optimizer is not None:
                self.optimizer._apply(list(zip(self.params, grads)),
                                      scalars[0])
            for t, v in zip(self.targets,
                            outs[self.n_fetch:self.n_fetch + len(
                                self.targets)]):
                t._value.copy_(v)
        return tuple(o.detach() if isinstance(o, torch.Tensor) else o
                     for o in fetched)


def _feed_value(v, placeholder, device):
    """A feed (numpy array, facade or torch tensor) as a tensor of its
    placeholder's dtype: a CUDA tensor stays on the card (it is copied in
    on the device), host data stays on the host until it is staged."""
    if isinstance(v, Tensor):
        v = v._value.detach()
    elif not isinstance(v, torch.Tensor):
        v = _numpy_to_torch(np.asarray(v))
    dt = placeholder._value.dtype if placeholder is not None else v.dtype
    if v.dtype != dt:
        v = v.to(dt)
    if device.type == "cpu" and v.device != device:
        v = v.to(device)
    return v


class Executor:
    """``paddle.static.Executor``: runs a Program on ``place`` (the card
    unless the CPU is asked for, by ``place`` or ``set_device("cpu")``)."""

    def __init__(self, place=None):
        self.place = place
        self._cache = {}

    def _device(self):
        return to_torch_device(self.place)

    def run(self, program=None, feed=None, fetch_list=None, scope=None,
            return_numpy=True, use_prune=False):
        """Run ``program`` (the default main program) on ``feed`` ({name:
        value}) and return the values of ``fetch_list``: numpy arrays, or
        facade Tensors with ``return_numpy=False``. A program with a
        ``minimize`` also updates its parameters; the buffer updates are
        written back after the run. The startup program returns ``[]``
        (parameters are initialised when their layers are built)."""
        program = program or default_main_program()
        # CompiledProgram (static/parity.py): unwrap to the Program
        program = getattr(program, "program", program)
        feed = feed or {}
        fetch_list = list(fetch_list or [])
        if program is default_startup_program() or (
                not program._nodes and not fetch_list):
            return []
        if not isinstance(program, Program):
            raise TypeError(f"Executor.run takes a Program, got "
                            f"{type(program).__name__}")
        dev = self._device()
        names = sorted(feed)
        vals = [_feed_value(feed[n], program._feeds.get(n), dev)
                for n in names]
        key = (id(program), tuple(names),
               CapturedSteps.signature(vals), tuple(id(t) for t in
                                                    fetch_list),
               len(program._optimize_ops), len(program._nodes),
               len(program._buffer_updates))
        entry = self._cache.get(key)
        if entry is None:
            entry = self._cache[key] = _Entry(program, names, fetch_list,
                                              dev)
        lr = ()
        if entry.optimizer is not None:
            lr = (float(entry.optimizer.get_lr()),)
        if capturing_on(dev):
            outs = entry.steps(entry.step, vals, lr,
                               generators=[random_mod.generator(dev)])
        else:
            scalars = [torch.full((), v, dtype=torch.float32, device=dev)
                       for v in lr]
            outs = entry.step([v.to(dev) for v in vals], *scalars)
        if entry.optimizer is not None:
            entry.optimizer._global_step += 1
        if return_numpy:
            return [Tensor._wrap(o, True).numpy() for o in outs]
        return [Tensor._wrap(o, True) for o in outs]

    def graphs(self, program=None):
        """The feed signatures that have a captured graph, over every
        fetch list of ``program`` (all programs for None)."""
        return [sig for key, e in self._cache.items()
                if e.steps is not None and (program is None
                                            or key[0] == id(program))
                for sig in e.steps.signatures]

    def graph_pool_bytes(self):
        """Device bytes the Executor's graphs' pools hold."""
        return sum(e.steps.pool_bytes() or 0 for e in self._cache.values()
                   if e.steps is not None)

    @property
    def capture_s(self):
        """Wall time of the Executor's captures."""
        return sum(e.steps.capture_s for e in self._cache.values()
                   if e.steps is not None)

    def train_from_dataset(self, program=None, dataset=None, scope=None,
                           thread=0, debug=False, fetch_list=None,
                           fetch_info=None, print_period=100):
        """One pass over ``dataset`` (an iterable of ``{name: array}``
        batches), running the program on each batch; ``fetch_list``
        values are printed every ``print_period`` batches, labelled by
        ``fetch_info``."""
        if dataset is None:
            raise ValueError("train_from_dataset needs a dataset")
        fetch_list = list(fetch_list or [])
        names = list(fetch_info or [t.name or f"fetch{i}"
                                    for i, t in enumerate(fetch_list)])
        var_names = {name for name, _, _ in
                     getattr(dataset, "use_var", [])} or None
        for step, batch in enumerate(dataset):
            feed = {k: v for k, v in batch.items()
                    if var_names is None or k in var_names
                    or (k.endswith(".lod") and k[:-4] in var_names)}
            outs = self.run(program, feed=feed, fetch_list=fetch_list)
            if (debug or fetch_list) and (step + 1) % print_period == 0:
                msg = ", ".join(f"{n}={np.asarray(o).mean():.6f}"
                                for n, o in zip(names, outs))
                print(f"[train_from_dataset] step {step + 1}: {msg}")
        return None

    def infer_from_dataset(self, program=None, dataset=None, scope=None,
                           thread=0, debug=False, fetch_list=None,
                           fetch_info=None, print_period=100):
        """Inference pass over a dataset (a program without a ``minimize``
        changes nothing)."""
        return self.train_from_dataset(program, dataset, scope, thread,
                                       debug, fetch_list, fetch_info,
                                       print_period)
