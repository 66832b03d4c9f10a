"""Comparison, logical and bitwise ops, whose outputs are not
differentiated (counterpart of ``paddle_tpu/ops/logic.py``)."""
from __future__ import annotations

import torch

from ._dispatch import apply_nondiff, unwrap, wrap
from ..framework.dtype import promote_types
from ..framework.tensor import Tensor

__all__ = [
    "equal", "not_equal", "greater_than", "greater_equal", "less_than",
    "less_equal", "equal_all", "allclose", "isclose", "logical_and",
    "logical_or", "logical_not", "logical_xor", "bitwise_and", "bitwise_or",
    "bitwise_xor", "bitwise_not", "is_empty", "is_tensor",
]


def _pair(a, b):
    """Both operands as tensors on one device (a python scalar beside a
    tensor becomes a tensor)."""
    if not isinstance(a, torch.Tensor):
        a = torch.as_tensor(a, device=b.device)
    if not isinstance(b, torch.Tensor):
        b = torch.as_tensor(b, device=a.device)
    return a, b


def _bin(tfn):
    def op(x, y, name=None):
        return apply_nondiff(lambda a, b: tfn(*_pair(a, b)), x, y)
    op.__name__ = tfn.__name__
    return op


equal = _bin(torch.eq)
not_equal = _bin(torch.ne)
greater_than = _bin(torch.gt)
greater_equal = _bin(torch.ge)
less_than = _bin(torch.lt)
less_equal = _bin(torch.le)
logical_and = _bin(torch.logical_and)
logical_or = _bin(torch.logical_or)
logical_xor = _bin(torch.logical_xor)
bitwise_and = _bin(torch.bitwise_and)
bitwise_or = _bin(torch.bitwise_or)
bitwise_xor = _bin(torch.bitwise_xor)


def logical_not(x, name=None):
    return apply_nondiff(torch.logical_not, x)


def bitwise_not(x, name=None):
    return apply_nondiff(torch.bitwise_not, x)


def _common(a, b):
    a, b = _pair(unwrap(a), unwrap(b))
    a, b = a.detach(), b.detach()
    if a.dtype != b.dtype:
        td = promote_types(a.dtype, b.dtype)
        a, b = a.to(td), b.to(td)
    return a, b


def equal_all(x, y, name=None):
    a, b = _common(x, y)
    return wrap(torch.tensor(a.shape == b.shape and bool(torch.equal(a, b)),
                             device=a.device))


def allclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False, name=None):
    a, b = _common(x, y)
    return wrap(torch.tensor(torch.allclose(a, b, rtol=rtol, atol=atol,
                                            equal_nan=equal_nan),
                             device=a.device))


def isclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False, name=None):
    a, b = _common(x, y)
    return wrap(torch.isclose(a, b, rtol=rtol, atol=atol,
                              equal_nan=equal_nan))


def is_empty(x, name=None):
    v = unwrap(x)
    return wrap(torch.tensor(v.numel() == 0, device=v.device))


def is_tensor(x):
    return isinstance(x, Tensor)
