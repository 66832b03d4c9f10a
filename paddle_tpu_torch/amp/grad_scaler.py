"""Dynamic loss scaling (counterpart of ``paddle_tpu/amp/grad_scaler.py``).

``GradScaler`` multiplies the loss by the scale before the backward,
divides the gradients by it before the update (``unscale_``), skips the
update of a step whose gradients hold an inf or a nan, and grows or
shrinks the scale after each step (``update``): halved (``decr_ratio``)
after ``decr_every_n_nan_or_inf`` bad steps in a row, doubled
(``incr_ratio``) after ``incr_every_n_steps`` good ones. The scale is a
host float, as in the JAX package. Each optimizer moves through INIT,
UNSCALED and STEPPED between two ``update()`` calls, which guards the
``unscale_`` - clip - ``step`` pattern against unscaling twice.

In the dygraph steps (``unscale_``, ``step``) the host reads whether a
gradient is finite: one wait on the device a step. A captured training
step (:class:`paddle_tpu_torch.distributed.fleet.ParallelTrainStep`)
scales, unscales and checks on the device instead, and reads the flag
once after the step.
"""
from __future__ import annotations

import torch

__all__ = ["GradScaler", "AmpScaler"]


class GradScaler:
    def __init__(self, enable=True, init_loss_scaling=2.0 ** 15,
                 incr_ratio=2.0, decr_ratio=0.5, incr_every_n_steps=1000,
                 decr_every_n_nan_or_inf=2, use_dynamic_loss_scaling=True):
        self._enable = enable
        self._scale = float(init_loss_scaling)
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._incr_every = incr_every_n_steps
        self._decr_every = decr_every_n_nan_or_inf
        self._dynamic = use_dynamic_loss_scaling
        self._good_steps = 0
        self._bad_steps = 0
        self._found_inf = False
        # per optimizer: ("INIT" | "UNSCALED" | "STEPPED", found an inf)
        self._opt_states = {}

    def scale(self, loss):
        if not self._enable:
            return loss
        return loss * self._scale

    @torch.no_grad()
    def unscale_(self, optimizer):
        """Divide the gradients of ``optimizer``'s parameters by the scale,
        in place, and note whether any of them is not finite."""
        if not self._enable:
            return
        state, _ = self._opt_states.get(id(optimizer), ("INIT", False))
        if state == "UNSCALED":
            raise RuntimeError(
                "unscale_() has already been called on this optimizer since "
                "the last update().")
        if state == "STEPPED":
            raise RuntimeError("unscale_() is being called after step().")
        inv = 1.0 / self._scale
        grads = [p.grad for p in optimizer._parameter_list or ()
                 if p.grad is not None]
        for g in grads:
            g.mul_(inv)
        found = bool(grads) and bool(torch.stack(
            [torch.isfinite(g).all() for g in grads]).logical_not().any())
        # the scaler's flag is the OR over its optimizers, for update()
        self._found_inf = self._found_inf or found
        self._opt_states[id(optimizer)] = ("UNSCALED", found)

    def step(self, optimizer):
        if not self._enable:
            optimizer.step()
            return
        state, found = self._opt_states.get(id(optimizer), ("INIT", False))
        if state == "STEPPED":
            raise RuntimeError(
                "step() has already been called since the last update().")
        if state != "UNSCALED":
            self.unscale_(optimizer)
            state, found = self._opt_states[id(optimizer)]
        if not found:
            optimizer.step()
        self._opt_states[id(optimizer)] = ("STEPPED", found)

    def update(self):
        self._opt_states.clear()
        if not self._enable or not self._dynamic:
            self._found_inf = False
            return
        if self._found_inf:
            self._bad_steps += 1
            self._good_steps = 0
            if self._bad_steps >= self._decr_every:
                self._scale = max(self._scale * self._decr_ratio, 1.0)
                self._bad_steps = 0
        else:
            self._good_steps += 1
            self._bad_steps = 0
            if self._good_steps >= self._incr_every:
                self._scale *= self._incr_ratio
                self._good_steps = 0
        self._found_inf = False

    def minimize(self, optimizer, scaled_loss):
        scaled_loss.backward()
        self.step(optimizer)
        self.update()

    def is_enable(self):
        return self._enable

    def is_use_dynamic_loss_scaling(self):
        return self._dynamic

    def get_loss_scaling(self):
        """The scale as a 0-d f32 tensor (on the host)."""
        return torch.tensor(self._scale, dtype=torch.float32)

    def set_init_loss_scaling(self, v):
        self._scale = float(v)

    def state_dict(self):
        return {"scale": self._scale, "incr_ratio": self._incr_ratio,
                "decr_ratio": self._decr_ratio, "good_steps": self._good_steps,
                "bad_steps": self._bad_steps}

    def load_state_dict(self, state):
        self._scale = state.get("scale", self._scale)
        self._good_steps = state.get("good_steps", 0)
        self._bad_steps = state.get("bad_steps", 0)


AmpScaler = GradScaler
