"""Dtypes of the facade (counterpart of ``paddle_tpu/framework/dtype.py``).

``paddle.float32`` and the other constants are :class:`DType` singletons
over a ``torch.dtype``; :func:`to_torch_dtype` takes the place of the JAX
package's ``to_jax_dtype``. :func:`promote_types` is the JAX package's
promotion rule (JAX's type lattice, with 64-bit types on), which the op
dispatch uses where two tensors meet (``ops/_dispatch.py``); it differs
from ``torch.promote_types`` on a few pairs, and the facade follows JAX.

numpy has no bfloat16: :attr:`DType.np_dtype` of ``bfloat16`` is
``ml_dtypes.bfloat16`` where that package is installed, else ``None``.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["DType", "convert_dtype", "to_torch_dtype", "promote_types",
           "set_default_dtype", "get_default_dtype", "default_dtype",
           "bool_", "uint8", "int8", "int16", "int32", "int64", "float16",
           "bfloat16", "float32", "float64", "complex64", "complex128"]


def _bf16_numpy():
    try:
        import ml_dtypes
    except ImportError:
        return None
    return np.dtype(ml_dtypes.bfloat16)


class DType:
    """A facade dtype: one instance per name, equal to its name, its
    ``torch.dtype`` and its numpy dtype."""

    _registry: dict = {}

    def __new__(cls, name: str, torch_dtype=None):
        if name in cls._registry:
            return cls._registry[name]
        self = super().__new__(cls)
        self.name = name
        self.torch_dtype = torch_dtype
        cls._registry[name] = self
        return self

    # interned singletons: copying keeps identity
    def __deepcopy__(self, memo):
        return self

    def __copy__(self):
        return self

    def __reduce__(self):
        return (convert_dtype, (self.name,))

    def __repr__(self):
        return f"paddle_tpu_torch.{self.name}"

    def __hash__(self):
        return hash(self.name)

    def __eq__(self, other):
        if isinstance(other, DType):
            return self.name == other.name
        if isinstance(other, str):
            key = other.lower()
            return self.name == key or _STR_ALIASES.get(key) is self
        if isinstance(other, torch.dtype):
            return self.torch_dtype == other
        try:
            return self.np_dtype == np.dtype(other)
        except TypeError:
            return NotImplemented

    @property
    def np_dtype(self):
        if self.name == "bfloat16":
            return _bf16_numpy()
        return np.dtype(self.name if self.name != "bool" else np.bool_)

    @property
    def is_floating_point(self):
        return self.name in ("float16", "bfloat16", "float32", "float64")

    @property
    def is_complex(self):
        return self.name in ("complex64", "complex128")

    @property
    def is_integer(self):
        return self.name in ("int8", "int16", "int32", "int64", "uint8")

    @property
    def itemsize(self):
        return torch.empty((), dtype=self.torch_dtype).element_size()


bool_ = DType("bool", torch.bool)
uint8 = DType("uint8", torch.uint8)
int8 = DType("int8", torch.int8)
int16 = DType("int16", torch.int16)
int32 = DType("int32", torch.int32)
int64 = DType("int64", torch.int64)
float16 = DType("float16", torch.float16)
bfloat16 = DType("bfloat16", torch.bfloat16)
float32 = DType("float32", torch.float32)
float64 = DType("float64", torch.float64)
complex64 = DType("complex64", torch.complex64)
complex128 = DType("complex128", torch.complex128)

_STR_ALIASES = {
    "bool": bool_,
    "float": float32,
    "double": float64,
    "half": float16,
    "int": int32,
    "long": int64,
}

_TORCH_TO_DTYPE = {d.torch_dtype: d for d in DType._registry.values()}


def convert_dtype(dtype) -> DType:
    """Any dtype spec (DType, str, ``torch.dtype``, numpy dtype, python
    type) → a DType."""
    if dtype is None:
        return None
    if isinstance(dtype, DType):
        return dtype
    if isinstance(dtype, torch.dtype):
        if dtype in _TORCH_TO_DTYPE:
            return _TORCH_TO_DTYPE[dtype]
        raise ValueError(f"unsupported dtype: {dtype!r}")
    if isinstance(dtype, str):
        key = dtype.lower()
        if key in DType._registry:
            return DType._registry[key]
        if key in _STR_ALIASES:
            return _STR_ALIASES[key]
        raise ValueError(f"unsupported dtype string: {dtype!r}")
    if dtype is bool:
        return bool_
    if dtype is int:
        return int64
    if dtype is float:
        return float32
    if dtype is complex:
        return complex64
    npd = np.dtype(dtype)
    if npd.name in DType._registry:
        return DType._registry[npd.name]
    raise ValueError(f"unsupported dtype: {dtype!r}")


def to_torch_dtype(dtype):
    """DType (or anything :func:`convert_dtype` accepts) → ``torch.dtype``."""
    d = convert_dtype(dtype)
    return None if d is None else d.torch_dtype


# JAX's promotion lattice (jax._src.dtypes, x64 on) over the facade's
# dtypes; "i*", "f*" and "c*" are JAX's weak types, which stand between
# the strong ones
_LATTICE = {
    "bool": ["uint8", "int8"],
    "uint8": ["int16", "u16"], "u16": ["int32", "u32"],
    "u32": ["int64", "u64"], "u64": ["f*"],
    "int8": ["int16"], "int16": ["int32"], "int32": ["int64"],
    "int64": ["f*"],
    "f*": ["float16", "bfloat16", "c*"],
    "float16": ["float32"], "bfloat16": ["float32"],
    "float32": ["float64", "complex64"], "float64": ["complex128"],
    "c*": ["complex64"], "complex64": ["complex128"], "complex128": [],
}


def _upper_bounds(name):
    out, todo = {name}, [name]
    while todo:
        for nxt in _LATTICE[todo.pop()]:
            if nxt not in out:
                out.add(nxt)
                todo.append(nxt)
    return out


_UB = {n: _upper_bounds(n) for n in _LATTICE}


def promote_types(a, b) -> torch.dtype:
    """The dtype two tensors of dtypes ``a`` and ``b`` promote to, by the
    JAX package's rule (the least upper bound in JAX's lattice)."""
    na, nb = convert_dtype(a).name, convert_dtype(b).name
    common = _UB[na] & _UB[nb]
    best = [c for c in common if _UB[c] == common]
    return DType._registry[best[0]].torch_dtype


# default dtype (paddle.set_default_dtype / get_default_dtype)
_default_dtype = float32


def set_default_dtype(dtype):
    global _default_dtype
    d = convert_dtype(dtype)
    if not d.is_floating_point:
        raise TypeError(f"default dtype must be floating point, got {d}")
    _default_dtype = d


def get_default_dtype() -> str:
    return _default_dtype.name


def default_dtype() -> DType:
    return _default_dtype
