"""Custom differentiable ops (counterpart of ``paddle_tpu/autograd/py_layer.py``).

A ``PyLayer`` subclass defines ``forward(ctx, *args)`` and
``backward(ctx, *grads)`` over facade Tensors; ``apply`` runs them as one
``torch.autograd.Function``, so a PyLayer interleaves with every other op
in torch's graph. ``backward`` returns one gradient per tensor input, or
one per differentiable input (a float tensor with ``stop_gradient=False``);
keyword arguments are not differentiated. Tensors saved with
``ctx.save_for_backward`` go through torch's saved-tensor mechanism, so
saving an output makes no reference cycle; under ``saved_tensors_hooks``
the packed objects are kept as the hooks return them.
"""
from __future__ import annotations

import torch

from ..framework.tensor import Tensor

__all__ = ["PyLayer", "PyLayerContext", "saved_tensors_hooks"]


def _differentiable(a) -> bool:
    return (isinstance(a, Tensor) and not a.stop_gradient
            and (a._value.is_floating_point() or a._value.is_complex()))


class PyLayerContext:
    """Carries state from ``forward`` to ``backward``."""

    def __init__(self):
        self.container = None
        self._non_differentiable = ()
        self._materialize_grads = True
        self._hooks_pair = None
        self._tctx = None           # torch's ctx, inside forward/backward
        self._saved = None          # (is_tensor, stop_gradient/obj) per item

    def save_for_backward(self, *tensors):
        hooks = _current_hooks()
        # the pair is taken now: backward usually runs after the context
        # has exited
        self._hooks_pair = hooks
        if hooks is not None:
            self.container = tuple(hooks[0](t) for t in tensors)
            return
        if self._tctx is None:
            self.container = tensors
            return
        self._saved = [(True, t.stop_gradient) if isinstance(t, Tensor)
                       else (False, t) for t in tensors]
        self._tctx.save_for_backward(
            *[t._value for t in tensors if isinstance(t, Tensor)])

    def saved_tensor(self):
        if self._hooks_pair is not None:
            return tuple(self._hooks_pair[1](t) for t in self.container)
        if self._saved is None:
            return self.container
        vals = iter(self._tctx.saved_tensors)
        return tuple(Tensor._wrap(next(vals).detach(), x) if is_t else x
                     for is_t, x in self._saved)

    def mark_non_differentiable(self, *tensors):
        self._non_differentiable = tensors

    def set_materialize_grads(self, value: bool):
        self._materialize_grads = bool(value)


class _Function(torch.autograd.Function):
    """One PyLayer call: ``forward(tctx, layer, ctx, spec, *values)``."""

    @staticmethod
    def forward(tctx, layer, ctx, spec, *vals):
        args_spec, kwargs = spec
        it = iter(vals)
        args = [Tensor._wrap(next(it), sg) if is_t else obj
                for is_t, sg, obj in args_spec]
        ctx._tctx = tctx
        try:
            outputs = layer.forward(ctx, *args, **kwargs)
        finally:
            ctx._tctx = None
        outs = _check_outputs(layer, outputs)
        tctx._pylayer_name = layer.__name__
        tctx.layer, tctx.pctx = layer, ctx
        tctx.multi = isinstance(outputs, (tuple, list))
        tctx.diff = [not sg for is_t, sg, _ in args_spec if is_t]
        tctx.set_materialize_grads(ctx._materialize_grads)
        nd = {id(t) for t in ctx._non_differentiable}
        values = tuple(o._value for o in outs)
        marked = [v for o, v in zip(outs, values) if id(o) in nd]
        if marked:
            tctx.mark_non_differentiable(*marked)
        return values if tctx.multi else values[0]

    @staticmethod
    def backward(tctx, *grads):
        layer, ctx = tctx.layer, tctx.pctx
        grad_ins = [None if g is None else Tensor._wrap(g, True)
                    for g in grads]
        ctx._tctx = tctx
        try:
            with torch.no_grad():
                gout = layer.backward(ctx, *grad_ins)
        finally:
            ctx._tctx = None
        gouts = tuple(gout) if isinstance(gout, (tuple, list)) else (gout,)
        diff = tctx.diff
        n_diff = sum(diff)
        if len(gouts) == len(diff):
            per = list(gouts)
        elif len(gouts) == n_diff:
            it = iter(gouts)
            per = [next(it) if d else None for d in diff]
        else:
            raise ValueError(
                f"{layer.__name__}.backward returned {len(gouts)} grads; "
                f"expected {len(diff)} (one per tensor input) or {n_diff} "
                f"(one per differentiable input)")
        vals = []
        for g, d in zip(per, diff):
            if g is None or not d:
                vals.append(None)
            else:
                vals.append(g._value if isinstance(g, Tensor)
                            else torch.as_tensor(g))
        return (None, None, None, *vals)


def _check_outputs(layer, outputs):
    outs = tuple(outputs) if isinstance(outputs, (tuple, list)) \
        else (outputs,)
    for o in outs:
        if not isinstance(o, Tensor):
            raise TypeError(f"{layer.__name__}.forward must return "
                            f"Tensor(s), got {type(o)}")
    return outs


class PyLayerMeta(type):
    def __init__(cls, name, bases, attrs):
        super().__init__(name, bases, attrs)
        if bases and "apply" in attrs:
            raise TypeError("apply() must not be overridden in a PyLayer")


class PyLayer(metaclass=PyLayerMeta):
    """Subclass with ``forward``/``backward`` staticmethods; call
    ``apply``."""

    @staticmethod
    def forward(ctx, *args, **kwargs):
        raise NotImplementedError

    @staticmethod
    def backward(ctx, *args):
        raise NotImplementedError

    @classmethod
    def apply(cls, *args, **kwargs):
        ctx = PyLayerContext()
        if not torch.is_grad_enabled() or not any(
                _differentiable(a) for a in args):
            with torch.no_grad():
                outputs = cls.forward(ctx, *args, **kwargs)
            _check_outputs(cls, outputs)
            return outputs
        args_spec, vals = [], []
        for a in args:
            if isinstance(a, Tensor):
                sg = not _differentiable(a)
                args_spec.append((True, sg, None))
                vals.append(a._value.detach() if sg else a._value)
            else:
                args_spec.append((False, None, a))
        out = _Function.apply(cls, ctx, (args_spec, kwargs), *vals)
        if isinstance(out, tuple):
            return tuple(Tensor._wrap(v) for v in out)
        return Tensor._wrap(out)


# -- saved_tensors_hooks ---------------------------------------------------

_hooks_stack = []


def _current_hooks():
    return _hooks_stack[-1] if _hooks_stack else None


class saved_tensors_hooks:
    """Intercepts PyLayer ``save_for_backward`` / ``saved_tensor`` with
    ``(pack, unpack)`` hooks, e.g. to move saved tensors to the host at
    save and back at use. Only PyLayer saves go through them; torch's own
    saved tensors have ``torch.autograd.graph.saved_tensors_hooks``."""

    def __init__(self, pack_hook, unpack_hook):
        self.pair = (pack_hook, unpack_hook)

    def __enter__(self):
        _hooks_stack.append(self.pair)
        return self

    def __exit__(self, *exc):
        _hooks_stack.pop()
        return False
