"""The ``paddle.*`` op surface over torch (counterpart of
``paddle_tpu/ops``).

Aggregates the op modules and attaches them to :class:`Tensor` as
operators and methods (:func:`monkey_patch_tensor`), so ``x.sum()``,
``x + y`` and ``x @ w`` go through the dispatch. ``ops/extras.py`` and
``ops/sequence.py`` of the JAX package are not ported (``ROADMAP.md``,
Queue 1 item 5).
"""
from __future__ import annotations

from .math import *  # noqa: F401,F403
from .manipulation import *  # noqa: F401,F403
from .creation import *  # noqa: F401,F403
from .linalg import *  # noqa: F401,F403
from .logic import *  # noqa: F401,F403
from .search import *  # noqa: F401,F403

from . import math as _math
from . import manipulation as _manip
from . import linalg as _linalg
from . import logic as _logic
from . import search as _search

from ..framework.tensor import Tensor as _Tensor


def _swap(fn):
    return lambda self, other, name=None: fn(other, self)


def _bool_or(logical, bitwise):
    return lambda s, o: logical(s, o) if s.dtype == "bool" else bitwise(s, o)


def monkey_patch_tensor():
    T = _Tensor
    # ---- operators ----
    T.__add__ = lambda s, o: _math.add(s, o)
    T.__radd__ = lambda s, o: _math.add(s, o)
    T.__sub__ = lambda s, o: _math.subtract(s, o)
    T.__rsub__ = _swap(_math.subtract)
    T.__mul__ = lambda s, o: _math.multiply(s, o)
    T.__rmul__ = lambda s, o: _math.multiply(s, o)
    T.__truediv__ = lambda s, o: _math.divide(s, o)
    T.__rtruediv__ = _swap(_math.divide)
    T.__floordiv__ = lambda s, o: _math.floor_divide(s, o)
    T.__rfloordiv__ = _swap(_math.floor_divide)
    T.__mod__ = lambda s, o: _math.remainder(s, o)
    T.__rmod__ = _swap(_math.remainder)
    T.__pow__ = lambda s, o: _math.pow(s, o)
    T.__rpow__ = _swap(_math.pow)
    T.__matmul__ = lambda s, o: _linalg.matmul(s, o)
    T.__rmatmul__ = _swap(_linalg.matmul)
    T.__neg__ = lambda s: _math.scale(s, -1.0)
    T.__abs__ = lambda s: _math.abs(s)
    T.__invert__ = lambda s: (_logic.logical_not(s) if s.dtype == "bool"
                              else _logic.bitwise_not(s))
    T.__eq__ = lambda s, o: _logic.equal(s, o)
    T.__ne__ = lambda s, o: _logic.not_equal(s, o)
    T.__lt__ = lambda s, o: _logic.less_than(s, o)
    T.__le__ = lambda s, o: _logic.less_equal(s, o)
    T.__gt__ = lambda s, o: _logic.greater_than(s, o)
    T.__ge__ = lambda s, o: _logic.greater_equal(s, o)
    T.__and__ = _bool_or(_logic.logical_and, _logic.bitwise_and)
    T.__or__ = _bool_or(_logic.logical_or, _logic.bitwise_or)
    T.__xor__ = _bool_or(_logic.logical_xor, _logic.bitwise_xor)

    # ---- named methods from the op modules ----
    for mod in (_math, _manip, _linalg, _logic, _search):
        for name in mod.__all__:
            if not hasattr(T, name):
                setattr(T, name, getattr(mod, name))

    # in-place variants: <op>_ rebinds the value (paddle's inplace API)
    def make_inplace(op):
        def fn(self, *a, **kw):
            return self._inplace_assign(op(self, *a, **kw))
        return fn

    for name in ("add", "subtract", "multiply", "divide", "clip", "scale",
                 "exp", "sqrt", "rsqrt", "floor", "ceil", "round",
                 "reciprocal", "tanh", "remainder"):
        setattr(T, name + "_", make_inplace(getattr(_math, name)))
    T.cast_ = make_inplace(_manip.cast)

    # aliases
    T.mm = _linalg.mm
    T.dim = lambda self: self.ndim


monkey_patch_tensor()
