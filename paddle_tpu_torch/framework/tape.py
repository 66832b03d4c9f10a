"""Op dispatch and autograd of the facade (counterpart of
``paddle_tpu/framework/tape.py``).

The JAX package records one tape node per op holding its ``jax.vjp``
pullback and walks the tape itself. Here torch autograd records the graph;
this module keeps paddle's semantics on top of it:

- :func:`apply` runs one op: it detaches every input whose
  ``stop_gradient`` is True, casts by op name under an active
  ``amp.auto_cast`` (the O1 lists of :mod:`paddle_tpu_torch.amp`), runs
  the op on torch tensors, wraps what it returns, and runs the
  ``FLAGS_check_nan_inf`` scan.
- :func:`backward` seeds ones for a root that is not a scalar (torch
  would raise), and a second backward through a root without
  ``retain_graph`` raises ``RuntimeError`` even where torch saved nothing
  it could miss.
- :func:`grad` leaves every other leaf's ``.grad`` untouched, takes
  non-leaf inputs, ``create_graph`` and ``allow_unused``; like the JAX
  tape, ``create_graph`` refuses a graph that goes through a ``PyLayer``.
- grad mode is torch's (``no_grad``, ``enable_grad``,
  ``set_grad_enabled``, ``is_grad_enabled``).

Static capture (the JAX tape's ``_static_capture`` branch): under
``paddle_tpu_torch.static.enable_static()``, an op with a lazy input (a
``static.data`` placeholder or another recorded op's output), or one that
consumes a ``Parameter``, records a node into the current ``Program``
(:func:`paddle_tpu_torch.static.program.make_lazy_output`) instead of
running. The node fixes at record time what eager ``apply`` decides when
it runs: the ``auto_cast`` rule (:class:`AmpWrappedOp`, so a program built
under ``auto_cast`` and run outside it keeps its casts) and which inputs
``stop_gradient`` detaches. The analysis hook is not ported
(``ROADMAP.md``, Queue 1 item 11).
"""
from __future__ import annotations

import sys
import warnings
from typing import Callable

import torch

from ..amp.auto_cast import cast_by_rule, cast_rule
from . import flags as flags_mod

__all__ = ["apply", "backward", "grad", "no_grad", "enable_grad",
           "set_grad_enabled", "is_grad_enabled", "AmpWrappedOp"]


# ---------------------------------------------------------------------------
# grad mode
# ---------------------------------------------------------------------------

def is_grad_enabled() -> bool:
    return torch.is_grad_enabled()


def set_grad_enabled(mode: bool):
    """Set grad mode (also usable as a context manager)."""
    return torch.set_grad_enabled(bool(mode))


class no_grad(torch.no_grad):
    """``paddle.no_grad``: a context manager and a decorator."""


enable_grad = torch.enable_grad


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------

def _check_nan_inf(name, outs):
    """``FLAGS_check_nan_inf``: scan float outputs (one host sync per
    op; debug only)."""
    for i, v in enumerate(outs):
        if not isinstance(v, torch.Tensor) or not (
                v.is_floating_point() or v.is_complex()):
            continue
        bad = int(v.numel()) - int(torch.isfinite(v).sum())
        if bad:
            msg = (f"op '{name}' output {i} contains {bad} NaN/Inf values "
                   f"(shape {tuple(v.shape)}, dtype {v.dtype})")
            if flags_mod._FLAGS.get("FLAGS_check_nan_inf_level", 0) == 0:
                raise FloatingPointError(msg)
            warnings.warn(msg)


def _input_value(a, rule):
    v = a._value
    if a.stop_gradient and v.requires_grad:
        v = v.detach()
    if rule is not None:
        (v,) = cast_by_rule(rule, (v,))
    return v


class AmpWrappedOp:
    """An op with the ``auto_cast`` rule of its record time folded in:
    ``mode`` "white" casts float32 inputs to ``low``, "black" casts
    ``low`` inputs to float32, as :func:`apply` casts them when it runs
    the op. A plain object (fn, mode, low), not a closure, so that
    ``static.serde`` can write it."""

    def __init__(self, fn, mode, low):
        self.fn = fn
        self.mode = mode
        self.low = low
        self.__name__ = getattr(fn, "__name__", "op")

    def __call__(self, *vals, **kw):
        return self.fn(*cast_by_rule((self.mode, self.low), vals), **kw)


# static mode and lazy tensors exist only once this module is imported and
# has turned static mode on or made a placeholder (``_recording_possible``)
_PROGRAM_MODULE = __name__.rsplit(".", 2)[0] + ".static.program"


def _records(args):
    """The static program module when an op on ``args`` records into the
    current program (a lazy input, or under ``enable_static`` a
    ``Parameter`` input, which run eagerly would enter the program as a
    frozen constant), else None."""
    prog = sys.modules.get(_PROGRAM_MODULE)
    if prog is None or not prog._recording_possible:
        return None
    from .tensor import LazyTensor, Parameter
    if any(isinstance(a, LazyTensor) for a in args) or (
            prog.in_static_mode()
            and any(isinstance(a, Parameter) for a in args)):
        return prog
    return None


def _wrap_outputs(out, stop_gradient=None):
    from .tensor import Tensor
    if isinstance(out, (tuple, list)):
        return tuple(_wrap_outputs(o, stop_gradient) for o in out)
    if isinstance(out, torch.Tensor):
        return Tensor._wrap(out, stop_gradient)
    return out


def apply(fn: Callable, *args, op_name: str = None, has_aux: bool = False,
          **kwargs):
    """Run one op. ``fn(*values, **kwargs)`` is a torch function of the
    positional arguments with every :class:`Tensor` replaced by its
    ``torch.Tensor``; what it returns is wrapped back (a tuple stays a
    tuple). With ``has_aux``, ``fn`` returns ``(out, aux)`` and ``aux`` is
    not differentiated."""
    from .tensor import Tensor
    name = op_name or getattr(fn, "__name__", "op")
    rule = cast_rule(name)
    prog = _records(args)
    if prog is not None:
        if rule is not None:
            fn = AmpWrappedOp(fn, *rule)
        return prog.make_lazy_output(fn, args, kwargs, name,
                                     has_aux=has_aux)
    vals = [_input_value(a, rule) if isinstance(a, Tensor) else a
            for a in args]
    out = fn(*vals, **kwargs)
    if flags_mod._FLAGS.get("FLAGS_check_nan_inf", False):
        _check_nan_inf(name, out if isinstance(out, (tuple, list))
                       else (out,))
    if has_aux:
        main, aux = out
        aux = tuple(a.detach() for a in aux) \
            if isinstance(aux, (tuple, list)) else aux.detach()
        return _wrap_outputs(main), _wrap_outputs(aux, True)
    return _wrap_outputs(out)


# ---------------------------------------------------------------------------
# backward / grad
# ---------------------------------------------------------------------------

def _as_grad(g, v):
    from .tensor import Tensor
    if g is None:
        return torch.ones_like(v)
    gv = g._value if isinstance(g, Tensor) else torch.as_tensor(g)
    return gv.detach().to(v.device, v.dtype)


def _free(values):
    """Mark the roots' graphs as freed: a later backward through one of
    them raises, as the JAX tape's does."""
    for v in values:
        node = v.grad_fn
        if node is None:
            continue

        def freed(grad_outputs, _name=node.name()):
            raise RuntimeError(
                f"backward through op '{_name}' a second time, but the "
                "graph was freed. Pass retain_graph=True to backward().")

        node.register_prehook(freed)


def backward(tensors, grad_tensors=None, retain_graph: bool = False):
    """``paddle.autograd.backward``: accumulate into the ``.grad`` of every
    leaf with ``stop_gradient=False`` that ``tensors`` depend on. A missing
    gradient seeds ones, also for a root that is not a scalar."""
    from .tensor import Tensor
    if isinstance(tensors, Tensor):
        tensors = [tensors]
    if grad_tensors is None:
        grad_tensors = [None] * len(tensors)
    elif isinstance(grad_tensors, Tensor):
        grad_tensors = [grad_tensors]
    roots, seeds = [], []
    for t, g in zip(tensors, grad_tensors):
        v = t._value
        if not v.requires_grad:
            continue
        roots.append(v)
        seeds.append(_as_grad(g, v))
    if not roots:
        return
    torch.autograd.backward(roots, seeds, retain_graph=retain_graph)
    if not retain_graph:
        _free(roots)


def _pylayer_in_graph(roots):
    """The name of a ``PyLayer`` the graph of ``roots`` goes through, or
    None."""
    seen, todo = {}, [v.grad_fn for v in roots if v.grad_fn is not None]
    while todo:
        node = todo.pop()
        if id(node) in seen:
            continue
        seen[id(node)] = node       # held, so no id is reused
        name = getattr(node, "_pylayer_name", None)
        if name is not None:
            return name
        todo.extend(n for n, _ in node.next_functions if n is not None)
    return None


def grad(outputs, inputs, grad_outputs=None, retain_graph=None,
         create_graph=False, allow_unused=False):
    """``paddle.grad``: d(outputs)/d(inputs), touching no ``.grad``. With
    ``create_graph`` the results are differentiable (double backward)."""
    from .tensor import Tensor
    if isinstance(outputs, Tensor):
        outputs = [outputs]
    single = isinstance(inputs, Tensor)
    if single:
        inputs = [inputs]
    if grad_outputs is None:
        grad_outputs = [None] * len(outputs)
    elif isinstance(grad_outputs, Tensor):
        grad_outputs = [grad_outputs]
    if retain_graph is None:
        retain_graph = create_graph
    roots, seeds = [], []
    for t, g in zip(outputs, grad_outputs):
        v = t._value
        if v.requires_grad:
            roots.append(v)
            seeds.append(_as_grad(g, v))
    if create_graph:
        name = _pylayer_in_graph(roots)
        if name is not None:
            raise RuntimeError(
                f"create_graph is not supported through op '{name}': a "
                "PyLayer's backward is opaque to double backward.")
    wanted = [i for i, t in enumerate(inputs) if t._value.requires_grad]
    got = [None] * len(inputs)
    if roots and wanted:
        with torch.enable_grad() if create_graph else torch.no_grad():
            res = torch.autograd.grad(
                roots, [inputs[i]._value for i in wanted], seeds,
                retain_graph=retain_graph, create_graph=create_graph,
                allow_unused=True)
        for i, g in zip(wanted, res):
            got[i] = g
        if not retain_graph:
            _free(roots)
    results = []
    for g in got:
        if g is None:
            if not allow_unused:
                raise RuntimeError(
                    "one of the input tensors received no gradient; pass "
                    "allow_unused=True to return None for it")
            results.append(None)
        else:
            results.append(Tensor._wrap(g))
    return results[0] if single else results
