"""Op dispatch helpers shared by the op modules (counterpart of
``paddle_tpu/ops/_dispatch.py``): an op is a torch function routed through
:func:`~paddle_tpu_torch.framework.tape.apply` (differentiable) or around
it (integer and bool outputs)."""
from __future__ import annotations

import torch

from ..framework import tape as _tape
from ..framework.dtype import promote_types
from ..framework.place import to_torch_device
from ..framework.tensor import LazyTensor, Tensor

apply = _tape.apply


def unwrap(x):
    """A Tensor's value as a constant of the op (detached, as the JAX
    package closes over it); anything else as it is."""
    return x._value.detach() if isinstance(x, Tensor) else x


def wrap(v, stop_gradient=True):
    if isinstance(v, (tuple, list)):
        return tuple(Tensor._wrap(x, stop_gradient) for x in v)
    return Tensor._wrap(v, stop_gradient)


def apply_nondiff(fn, *args, **kwargs):
    """Run an op whose outputs are not differentiable (bool, int); with a
    lazy input it records into the static program, as in the JAX
    package."""
    if any(isinstance(a, LazyTensor) for a in args):
        from ..static.program import make_lazy_output
        return make_lazy_output(fn, args, kwargs,
                                getattr(fn, "__name__", "op"), nondiff=True)
    vals = [a._value.detach() if isinstance(a, Tensor) else a for a in args]
    with torch.no_grad():
        return wrap(fn(*vals, **kwargs))


def binop(fn, x, y, op_name=None):
    """Elementwise binary op on Tensor|scalar either side, with paddle's
    scalar rule (a python scalar adopts the tensor's dtype) and the JAX
    package's promotion of two tensors."""
    if not isinstance(x, Tensor):
        x = _scalar_like(x, y)
    if not isinstance(y, Tensor):
        y = _scalar_like(y, x)
    x, y = maybe_cast_pair(x, y)
    return apply(fn, x, y, op_name=op_name)


def _scalar_like(scalar, ref: Tensor) -> Tensor:
    """A python scalar as a tensor beside ``ref``: ``ref``'s dtype, but a
    float with an integer (or bool) tensor gives float32, a bool stays
    bool, and a complex with a real tensor gives complex."""
    rv = ref._value
    dt = rv.dtype
    # beside a static program's variable (a meta value): on the current
    # place, where the program runs
    dev = to_torch_device() if rv.is_meta else rv.device
    if isinstance(scalar, bool):
        return Tensor._wrap(torch.tensor(scalar, device=dev), True)
    if isinstance(scalar, float) and not (rv.is_floating_point()
                                          or rv.is_complex()) \
            and dt != torch.bool:
        dt = torch.float32
    if isinstance(scalar, complex) and not rv.is_complex():
        dt = torch.complex128
    return Tensor._wrap(torch.tensor(scalar, dtype=dt, device=dev),
                        True)


def maybe_cast_pair(x: Tensor, y: Tensor):
    """Promote a (Tensor, Tensor) pair to one dtype by the JAX package's
    rule (:func:`~paddle_tpu_torch.framework.dtype.promote_types`)."""
    if x._value.dtype == y._value.dtype:
        return x, y
    common = promote_types(x._value.dtype, y._value.dtype)
    from .manipulation import cast
    return cast(x, common), cast(y, common)
