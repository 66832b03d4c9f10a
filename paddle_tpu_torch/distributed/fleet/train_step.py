"""``ParallelTrainStep`` at one device (counterpart of
``paddle_tpu/distributed/fleet/train_step.py``).

The JAX step is one compiled function of (parameters, optimizer state,
batch, lr, loss scale): the loss, its gradients by ``value_and_grad``,
dynamic loss scaling and the optimizer's update, under one ``jax.jit``
per batch signature. Here the same step runs on the model's own
parameters, updated in place:

1. ``loss = loss_fn(model, *batch)`` (a 0-d tensor; ``auto_cast`` goes
   inside ``loss_fn``);
2. ``torch.autograd.grad`` over the model's trainable parameters (an
   unused parameter gets a zero gradient, as ``value_and_grad`` gives
   it);
3. with a ``GradScaler``: the loss multiplied by the scale before the
   gradients, the gradients multiplied by 1 / scale, ``found_inf`` over
   all of them, and on overflow every parameter and accumulator kept as
   it was (``torch.where``), as the JAX ``_pure_step`` does;
4. the optimizer's update (:meth:`~paddle_tpu_torch.optimizer.Optimizer.
   _apply`) with lr as a 0-d f32 device tensor.

On CUDA the step is captured: the first call with a batch signature (each
input's shape and dtype; ``jax.jit`` compiles per signature) runs the step
eagerly on a side stream, where a host sync raises, and then captures it
as one CUDA graph in the step's one memory pool; later calls stage the
batch, lr and the scale through one pinned buffer with one non-blocking
copy and replay the graph. Every ``torch.Generator`` that a module of the
model holds (the MoE gates' ``rng``), and the facade's generator of the
device (what dropout and the facade's random ops draw from), is registered
with each graph, so a replay draws new numbers as an eager step would
(``paddle.seed`` after the first call leaves the graphs on the generator
they captured). A capture that fails raises; nothing falls back. On the
CPU the step runs eagerly.

The model is a ``torch.nn.Module`` (``loss_fn`` gets torch tensors and
returns one) or a facade :class:`paddle_tpu_torch.nn.Layer`: then
``loss_fn(model, *batch)`` gets the batch as facade Tensors and returns a
facade Tensor, as the JAX step's does, the gradients are taken on the
parameters' torch leaves, which the update writes in place, and the step
returns a facade Tensor.

At one device there is nothing to shard or donate: ``zero_stage``,
``batch_spec`` and ``data_axes`` (the ZeRO and batch shardings over the
mesh) and ``donate`` (the parameters are updated in place anyway) are
accepted and stored. ``accumulate_steps`` is stored and unused, as in the
JAX step. An ``hcg`` or ``mesh`` with a degree above 1 raises
``NotImplementedError``, as do ``validate=True`` and the checkpoint
manager, whose modules are not ported. The JAX step's telemetry hooks
are not ported either.
"""
from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from ...framework import random as random_mod
from ...framework.graphs import CapturedSteps, capturing_on, eager_step
from ...framework.tensor import Tensor
from ...nn.layer.layers import Layer
from ...optimizer.lr import LRScheduler
from ...optimizer.optimizer import _leaf, _trainable

__all__ = ["ParallelTrainStep"]

DATA_AXES = ("dp", "sharding")
_HYBRID_ITEM = "ROADMAP.md Queue 1, 'Hybrid parallel'"
_ANALYSIS_ITEM = ("ROADMAP.md Queue 1, 'Analysis, planner and auto-fusion "
                  "over torch.fx graphs'")
_HOST_ITEM = "ROADMAP.md Queue 1, 'Host-side systems'"

# the training steps' eager switch (framework.graphs.eager_step): the
# yardstick chip_smoke.py and the card tests hold the captured step against
_eager_step = eager_step


def _degrees(hcg, mesh):
    """The parallel degrees an ``hcg`` (its ``get_*_parallel_world_size``)
    or a ``mesh`` (its ``shape``: axis -> size, or sizes) names."""
    out = {axis: getattr(hcg, f"get_{axis}_parallel_world_size",
                         lambda: 1)()
           for axis in ("data", "model", "pipe", "sharding", "sep")}
    shape = getattr(mesh, "shape", None)
    if isinstance(shape, Mapping):
        out.update(shape)
    elif shape is not None:
        out.update(enumerate(tuple(shape)))
    return out


def _generators(model):
    """Every CUDA ``torch.Generator`` a module (or layer) of ``model``
    holds."""
    found = {}
    mods = model.sublayers(include_self=True) if isinstance(model, Layer) \
        else model.modules()
    for m in mods:
        for v in vars(m).values():
            if isinstance(v, torch.Generator) and v.device.type == "cuda":
                found[id(v)] = v
    return list(found.values())


def _batch_value(b):
    """A batch input (numpy array, torch or facade tensor) as a torch
    tensor."""
    if isinstance(b, Tensor):
        return b._value.detach()
    if isinstance(b, torch.Tensor):
        return b
    return torch.as_tensor(np.asarray(b))


def _detached(v):
    """A state value (a facade Tensor or a torch tensor) as a copy."""
    return _leaf(v).detach().clone()


class ParallelTrainStep:
    """Build once per (model, optimizer, loss_fn); call with batches."""

    def __init__(self, model, optimizer, loss_fn, hcg=None, zero_stage=1,
                 batch_spec=None, accumulate_steps=1, data_axes=DATA_AXES,
                 scaler=None, validate=False, donate=True, mesh=None):
        for axis, degree in _degrees(hcg, mesh).items():
            if degree > 1:
                raise NotImplementedError(
                    f"{axis} degree {degree}: the port trains on one "
                    f"device ({_HYBRID_ITEM})")
        if validate:
            raise NotImplementedError(
                f"validate=True is not ported ({_ANALYSIS_ITEM})")
        self.model = model
        self.optimizer = optimizer
        self.loss_fn = loss_fn
        self.hcg, self.mesh = hcg, mesh
        self.zero_stage = zero_stage
        self.batch_spec = batch_spec
        self.accumulate_steps = accumulate_steps
        self.data_axes = tuple(data_axes)
        self.donate = bool(donate)
        self.scaler = scaler if (scaler is not None and
                                 scaler.is_enable()) else None
        self.last_found_inf = False
        self.flops_per_token = None
        self._step_count = 0
        self._layer = isinstance(model, Layer)
        # the model's trainable parameters, in the optimizer's order
        trainable = {id(p): p for p in model.parameters() if _trainable(p)}
        if optimizer._parameter_list is None:
            raise ValueError("the optimizer was created without parameters")
        self._params = [p for p in optimizer._parameter_list
                        if id(p) in trainable]
        missing = set(trainable) - {id(p) for p in self._params}
        if missing:
            names = [n for n, p in model.named_parameters()
                     if id(p) in missing]
            raise ValueError(f"trainable parameters the optimizer does not "
                             f"hold: {names}")
        self._device = _leaf(self._params[0]).device
        optimizer._init_state(self._params)
        self._steps = CapturedSteps(self._device)
        self._generators = _generators(model)

    # ------------------------------------------------------- checkpointing
    def sync_optimizer_state(self):
        """The JAX step carries the accumulators through its jit and copies
        them back here; this one updates the optimizer's accumulators in
        place, so they are always current."""

    def train_state_dict(self):
        """Flat state as the JAX step's ``pack_training_state`` lays it
        out: ``model/<key>`` (the model's ``state_dict``),
        ``optacc/<accumulator>/<parameter's qualified name>``,
        ``opt/global_step``, ``opt/LR_Scheduler``, ``train/step_count`` and
        ``train/loss_scale``; the tensors are copies (a snapshot)."""
        state = {f"model/{k}": _detached(v)
                 for k, v in self.model.state_dict().items()}
        names = {id(p): n for n, p in self.model.named_parameters()}
        opt = self.optimizer
        for acc, by_id in opt._accumulators.items():
            for pid, t in by_id.items():
                if pid in names:
                    state[f"optacc/{acc}/{names[pid]}"] = _detached(t)
        state["opt/global_step"] = int(opt._global_step)
        if isinstance(opt._learning_rate, LRScheduler):
            state["opt/LR_Scheduler"] = opt._learning_rate.state_dict()
        state["train/step_count"] = int(self._step_count)
        if self.scaler is not None:
            state["train/loss_scale"] = float(self.scaler._scale)
        return state

    def set_train_state(self, state):
        """Restore a :meth:`train_state_dict` snapshot (values may be numpy
        arrays). Parameters and accumulators are written in place, so the
        captured graphs stay valid."""
        model_state = {k[len("model/"):]: torch.as_tensor(v)
                       for k, v in state.items() if k.startswith("model/")}
        if model_state and self._layer:
            self.model.set_state_dict(model_state)
        elif model_state:
            self.model.load_state_dict(model_state, strict=False)
        params = dict(self.model.named_parameters())
        opt = self.optimizer
        translated = {}
        for k, v in state.items():
            if k.startswith("optacc/"):
                _, acc, name = k.split("/", 2)
                if name in params:
                    translated[f"{opt._name(params[name])}_{acc}"] = v
        if "opt/global_step" in state:
            translated["global_step"] = state["opt/global_step"]
        if "opt/LR_Scheduler" in state:
            translated["LR_Scheduler"] = state["opt/LR_Scheduler"]
        if translated:
            opt.set_state_dict(translated)
        self._step_count = int(state.get("train/step_count", 0))
        if self.scaler is not None and "train/loss_scale" in state:
            self.scaler._scale = float(state["train/loss_scale"])

    def attach_checkpoint_manager(self, manager):
        raise NotImplementedError(
            f"the checkpoint manager (distributed/checkpoint) is not ported "
            f"({_HOST_ITEM})")

    def resume_from_checkpoint(self, manager=None, reshard_to=None):
        raise NotImplementedError(
            f"the checkpoint manager (distributed/checkpoint) is not ported "
            f"({_HOST_ITEM})")

    @property
    def step_count(self):
        return self._step_count

    # ------------------------------------------------------------------
    def _pure_step(self, batch, lr, scale):
        """Loss, gradients, loss scaling and the update on device tensors;
        returns the loss before the update and ``found_inf`` (None without
        a scaler). What a graph captures."""
        params = self._params
        leaves = [_leaf(p) for p in params]
        with torch.enable_grad():
            if self._layer:
                loss = self.loss_fn(self.model, *(
                    Tensor._wrap(b, True) for b in batch))._value
            else:
                loss = self.loss_fn(self.model, *batch)
            target = loss if self.scaler is None else \
                loss * scale.to(loss.dtype)
            grads = torch.autograd.grad(target, leaves,
                                        materialize_grads=True)
        found_inf = None
        with torch.no_grad():
            if self.scaler is not None:
                inv = 1.0 / scale
                grads = [g * inv.to(g.dtype) for g in grads]
                found_inf = torch.stack([torch.isfinite(g).all()
                                         for g in grads]).logical_not().any()
                kept = leaves + self.optimizer._state_tensors(params)
                before = [t.clone() for t in kept]
            self.optimizer._apply(list(zip(params, grads)), lr)
            if found_inf is not None:
                # overflow: every parameter and accumulator as it was
                for t, old in zip(kept, before):
                    t.copy_(torch.where(found_inf, old, t))
        return loss.detach(), found_inf

    def __call__(self, *batch):
        """One step on ``batch`` (numpy arrays, torch or facade tensors);
        returns the loss before the update as a 0-d tensor (a facade
        Tensor for a Layer) that no later call overwrites."""
        batch = [_batch_value(b) for b in batch]
        lr = float(self.optimizer.get_lr())
        scale = self.scaler._scale if self.scaler is not None else 1.0
        if capturing_on(self._device):
            loss, found_inf = self._captured(batch, lr, scale)
        else:
            dev = self._device
            tensors = [b.to(dev) for b in batch]
            scalars = [torch.full((), v, dtype=torch.float32, device=dev)
                       for v in (lr, scale)]
            loss, found_inf = self._pure_step(tensors, *scalars)
        self._step_count += 1
        self.optimizer._global_step += 1
        if self.scaler is not None:
            # the step's found_inf into the scaler's bookkeeping (grow or
            # shrink the scale, count the skip): one read on the host
            self.last_found_inf = bool(found_inf)
            self.scaler._found_inf = self.last_found_inf
            self.scaler.update()
        return Tensor._wrap(loss, True) if self._layer else loss

    train_batch = __call__

    def _captured(self, batch, lr, scale):
        gens = self._generators + [random_mod.generator(self._device)]
        return self._steps(self._pure_step, batch, (lr, scale), gens)

    @property
    def captured_signatures(self):
        """The batch signatures that have a captured graph."""
        return self._steps.signatures

    @property
    def capture_s(self):
        """Wall time of the captures."""
        return self._steps.capture_s

    def graph_pool_bytes(self):
        """Device bytes the step's graphs' pool holds (0 with none
        captured; None where the allocator does not name pools)."""
        return self._steps.pool_bytes()
