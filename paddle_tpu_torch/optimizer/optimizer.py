"""Optimizer base and the first-order optimizers (counterpart of
``paddle_tpu/optimizer/optimizer.py``): ``SGD``, ``Momentum``, ``Adam`` and
``AdamW``, with paddle's regularizers (``L1Decay``, ``L2Decay``),
per-parameter ``regularizer`` and ``optimize_attr``, ``grad_clip``, a float
or an :class:`~paddle_tpu_torch.optimizer.lr.LRScheduler` as the learning
rate, and ``state_dict``/``set_state_dict``.

The updates are the JAX package's expressions, written with torch ops over
each parameter in turn under ``torch.no_grad`` and stored in place; Adam
keeps its moments and beta powers in f32 for bf16/f16 parameters, as the
JAX one does.

One update, two callers. :meth:`Optimizer._apply` updates given
(parameter, gradient) pairs with the learning rate as a 0-d f32 tensor on
the parameters' device: the counterpart of the JAX ``_jit_apply``, which
the compiled training steps run with a traced f32 ``lr``. ``step()`` runs
it with ``get_lr()`` put on the device; a captured training step
(:class:`paddle_tpu_torch.distributed.fleet.ParallelTrainStep`) records
it, reading lr from device memory on every replay. Every product of lr
(``optimize_attr["learning_rate"]``, ``lr_ratio``, AdamW's ``1 - lr *
coeff``) is taken on the device in f32, as under the JAX step's jit.
:meth:`Optimizer._init_state` makes the accumulators ahead of a capture.

Parameters. ``parameters`` may be a module, ``(name, tensor)`` pairs
(``module.named_parameters()``), bare tensors, or the facade's: a
:class:`paddle_tpu_torch.nn.Layer` or a list of its parameters
(``layer.parameters()``). A facade parameter is updated through its torch
leaf ``_value`` (in place, so it stays the same leaf), and reads
``stop_gradient``/``trainable``, ``regularizer``, ``optimize_attr`` and
``need_clip`` as paddle's do. The names: a facade parameter's ``name``
(``linear_0.w_0``, as paddle and the JAX package name it); otherwise the
qualified names of ``named_parameters()``, or the index in the list for
bare tensors. ``AdamW``'s ``apply_decay_param_fun`` is called with that
name; with bare torch tensors it raises. The names also key
``state_dict`` (``"{name}_{accumulator}"``).
"""
from __future__ import annotations

import torch
from torch import nn

from ..framework.tensor import Tensor
from .lr import LRScheduler

__all__ = ["L1Decay", "L2Decay", "Optimizer", "SGD", "Momentum", "Adam",
           "AdamW"]


class L2Decay:
    def __init__(self, coeff=0.0):
        self.coeff = coeff


class L1Decay:
    def __init__(self, coeff=0.0):
        self.coeff = coeff


def _named(parameters):
    """``(names, params, named)`` from a module, a facade ``Layer``,
    ``(name, tensor)`` pairs or tensors; ``named`` says whether the names
    are names (not indices)."""
    if parameters is None:
        return None, None, False
    if isinstance(parameters, nn.Module):
        parameters = parameters.named_parameters()
    elif hasattr(parameters, "named_sublayers"):        # a facade Layer
        parameters = parameters.parameters()
    items = list(parameters)
    if items and isinstance(items[0], tuple):
        return [n for n, _ in items], [p for _, p in items], True
    if items and all(isinstance(p, Tensor) and p.name for p in items):
        return [p.name for p in items], items, True
    return [str(i) for i in range(len(items))], items, False


def _leaf(p) -> torch.Tensor:
    """The torch tensor the update writes: a facade parameter's leaf."""
    return p._value if isinstance(p, Tensor) else p


def _trainable(p) -> bool:
    if isinstance(p, Tensor):
        return not p.stop_gradient and getattr(p, "trainable", True)
    return p.requires_grad and getattr(p, "trainable", True)


class Optimizer:
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None):
        self._learning_rate = learning_rate
        self._names, self._parameter_list, self._named = _named(parameters)
        self._name_of = {id(p): n for n, p in zip(
            self._names or (), self._parameter_list or ())}
        self._grad_clip = grad_clip
        if isinstance(weight_decay, float):
            weight_decay = L2Decay(weight_decay)
        self._regularization = weight_decay
        self._accumulators: dict[str, dict[int, torch.Tensor]] = {}
        self._pending_state = None
        self._global_step = 0
        self._lr_products = {}      # within one _apply: see _scaled_lr

    # -- lr -----------------------------------------------------------------
    def get_lr(self) -> float:
        if isinstance(self._learning_rate, LRScheduler):
            return self._learning_rate()
        return self._learning_rate

    def set_lr(self, value):
        self._learning_rate = float(value)

    def _lr_tensor(self, device):
        """``get_lr()`` as a 0-d f32 tensor on ``device``, made by a fill
        kernel (nothing waits on a copy from the host)."""
        return torch.full((), self.get_lr(), dtype=torch.float32,
                          device=device)

    def _scaled_lr(self, lr, factor):
        """``lr * factor`` on the device, one product per distinct factor
        within an update (``lr`` is a tensor that lives through it)."""
        if factor == 1.0:
            return lr
        key = (id(lr), factor)
        if key not in self._lr_products:
            self._lr_products[key] = lr * factor
        return self._lr_products[key]

    # -- state --------------------------------------------------------------
    def _name(self, p):
        return self._name_of[id(p)]

    def _acc(self, name, p, init):
        """Accumulator ``name`` of ``p``: from a pending ``set_state_dict``
        if it holds one, else ``init()``."""
        d = self._accumulators.setdefault(name, {})
        if id(p) not in d:
            key = f"{self._name(p)}_{name}"
            pending = self._pending_state or {}
            if key in pending:
                v = init()
                v.copy_(torch.as_tensor(pending[key]))
                d[id(p)] = v
            else:
                d[id(p)] = init()
        return d[id(p)]

    def state_dict(self):
        state = {}
        for acc, d in self._accumulators.items():
            for n, p in zip(self._names or (), self._parameter_list or ()):
                if id(p) in d:
                    state[f"{n}_{acc}"] = d[id(p)]
        state["global_step"] = self._global_step
        if isinstance(self._learning_rate, LRScheduler):
            state["LR_Scheduler"] = self._learning_rate.state_dict()
        return state

    def set_state_dict(self, state):
        if "global_step" in state:
            gs = state["global_step"]
            self._global_step = int(gs.item() if hasattr(gs, "item") else gs)
        if "LR_Scheduler" in state and isinstance(self._learning_rate,
                                                  LRScheduler):
            self._learning_rate.set_state_dict(state["LR_Scheduler"])
        # accumulators made already take their value now, the others when
        # first made
        for acc, d in self._accumulators.items():
            for n, p in zip(self._names or (), self._parameter_list or ()):
                key = f"{n}_{acc}"
                if key in state and id(p) in d:
                    d[id(p)].copy_(torch.as_tensor(state[key]))
        self._pending_state = state

    # -- step ---------------------------------------------------------------
    def _collect_params_grads(self):
        if self._parameter_list is None:
            raise ValueError("optimizer created without parameters")
        return [(p, _leaf(p).grad) for p in self._parameter_list
                if _trainable(p) and _leaf(p).grad is not None]

    @torch.no_grad()
    def step(self):
        params_grads = self._collect_params_grads()
        if not params_grads:
            return
        self._global_step += 1
        self._apply(params_grads,
                    self._lr_tensor(_leaf(params_grads[0][0]).device))

    @torch.no_grad()
    def _apply(self, params_grads, lr):
        """One update of ``params_grads``, in place: each parameter's
        regularizer (else the optimizer's), then ``grad_clip`` over all of
        them, then each parameter's update at ``lr`` times its
        ``optimize_attr["learning_rate"]``. ``lr`` is a 0-d f32 tensor on
        the parameters' device. Accumulators are made on first use."""
        reg = []
        for p, g in params_grads:    # a parameter's regularizer wins
            r = getattr(p, "regularizer", None)
            if r is None:
                r = self._regularization
            if isinstance(r, L2Decay) and r.coeff:
                g = g + r.coeff * _leaf(p)
            elif isinstance(r, L1Decay) and r.coeff:
                g = g + r.coeff * torch.sign(_leaf(p))
            reg.append((p, g))
        params_grads = reg
        if self._grad_clip is not None:
            params_grads = self._grad_clip(params_grads)
        try:
            for p, g in params_grads:
                mult = getattr(p, "optimize_attr", {}).get("learning_rate",
                                                           1.0)
                self._update_param(p, g, self._scaled_lr(lr, mult))
        finally:
            self._lr_products = {}

    def _state(self, p):
        """``p``'s accumulators, made where missing (none here)."""
        return ()

    @torch.no_grad()
    def _init_state(self, params):
        """Make the accumulators of ``params`` now, so that a captured
        update finds them in place."""
        for p in params:
            self._state(p)

    def _state_tensors(self, params):
        """Every accumulator of ``params`` that exists, in a fixed order."""
        ids = [id(p) for p in params]
        return [d[i] for _, d in sorted(self._accumulators.items())
                for i in ids if i in d]

    def _update_param(self, p, g, lr):
        raise NotImplementedError

    def clear_grad(self, set_to_zero=False):
        for p in self._parameter_list or ():
            w = _leaf(p)
            if set_to_zero and w.grad is not None:
                w.grad.zero_()
            else:
                w.grad = None

    clear_gradients = clear_grad

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        """With a static program's loss (under ``enable_static``), record
        the update on the program: ``Executor.run`` then differentiates
        and updates in the step it runs. Otherwise (dygraph)
        ``loss.backward()``, then :meth:`step`."""
        from ..framework.tensor import LazyTensor
        if isinstance(loss, LazyTensor):
            from ..static.program import default_main_program
            default_main_program()._record_minimize(self, loss)
            return [], []
        loss.backward()
        self.step()
        return None, None

    def _adopt_parameters(self, params):
        """The parameters of ``params`` (a static program's, in the order
        it reads them) that this optimizer updates: all of them when it
        was made without a parameter list (it takes them, named by their
        ``name``), else those on its list."""
        if self._parameter_list is None:
            self._parameter_list = list(params)
            self._names = [p.name or f"param_{i}"
                           for i, p in enumerate(params)]
            self._named = all(p.name for p in params)
            self._name_of = {id(p): n for n, p in zip(self._names, params)}
            return list(params)
        return [p for p in params if id(p) in self._name_of]


class SGD(Optimizer):
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None,
                 multi_precision=False):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)

    def _update_param(self, p, g, lr):
        w = _leaf(p)
        w.copy_(w - lr * g.to(w.dtype))


class Momentum(Optimizer):
    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 multi_precision=False, rescale_grad=1.0, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._momentum = momentum
        self._use_nesterov = use_nesterov

    def _state(self, p):
        return self._acc("velocity", p, lambda: torch.zeros_like(_leaf(p)))

    def _update_param(self, p, g, lr):
        v = self._state(p)
        w = _leaf(p)
        v.copy_(self._momentum * v + g)
        if self._use_nesterov:
            w.copy_(w - lr * (g + self._momentum * v))
        else:
            w.copy_(w - lr * v)


class Adam(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=False,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _state(self, p):
        w = _leaf(p)
        dt = torch.float32 if w.dtype in (torch.float16, torch.bfloat16) \
            else w.dtype
        def zeros():
            return torch.zeros(w.shape, dtype=dt, device=w.device)

        def ones():
            return torch.ones((), dtype=dt, device=w.device)
        return tuple(self._acc(name, p, init) for name, init in (
            ("moment1", zeros), ("moment2", zeros), ("beta1_pow", ones),
            ("beta2_pow", ones)))

    def _update_param(self, p, g, lr):
        m, v, b1p, b2p = self._state(p)
        g = g.to(m.dtype)
        b1p.mul_(self._beta1)
        b2p.mul_(self._beta2)
        m.copy_(self._beta1 * m + (1 - self._beta1) * g)
        v.copy_(self._beta2 * v + (1 - self._beta2) * g.square())
        mhat = m / (1 - b1p)
        vhat = v / (1 - b2p)
        update = lr * mhat / (vhat.sqrt() + self._epsilon)
        w = _leaf(p)
        w.copy_(w - update.to(w.dtype))


class AdamW(Adam):
    """Adam with decoupled weight decay: ``p *= 1 - lr * coeff`` before the
    Adam update, for every parameter ``apply_decay_param_fun(name)``
    approves (all when it is None)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 lazy_mode=False, multi_precision=False, name=None):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         None, grad_clip, lazy_mode, multi_precision, name)
        if apply_decay_param_fun is not None and not self._named:
            raise ValueError(
                "apply_decay_param_fun needs parameter names: pass the "
                "module, its named_parameters() or facade parameters")
        self._coeff = weight_decay if isinstance(weight_decay, float) else \
            getattr(weight_decay, "coeff", 0.01)
        self._apply_decay_param_fun = apply_decay_param_fun
        self._lr_ratio = lr_ratio

    def _update_param(self, p, g, lr):
        if self._lr_ratio is not None:
            lr = self._scaled_lr(lr, self._lr_ratio(p))
        decay = self._coeff
        if self._apply_decay_param_fun is not None and \
                not self._apply_decay_param_fun(self._name(p)):
            decay = 0.0
        if decay:
            key = ("keep", id(lr), decay)
            if key not in self._lr_products:
                self._lr_products[key] = 1.0 - lr * decay
            _leaf(p).mul_(self._lr_products[key])
        super()._update_param(p, g, lr)
