"""The facade's Tensor (counterpart of ``paddle_tpu/framework/tensor.py``).

A :class:`Tensor` is a plain Python object holding a ``torch.Tensor`` in
``_value``, not a ``torch.Tensor`` subclass: paddle's method names clash
with torch's and mean something else (``shape`` is a list,
``transpose(perm)``, ``sum(axis=, keepdim=)``, ``max`` gives values
only), and a subclass would hand them to every torch function that meets
it. Math methods and operators are attached by :mod:`paddle_tpu_torch.ops`;
this file holds the structural behaviour.

Autograd is torch's (:mod:`.tape`). A tensor with ``stop_gradient=False``
and no producer is a leaf whose ``_value`` requires grad, and ``.grad``
reads the leaf's ``_value.grad``. An op result's ``stop_gradient`` is
False exactly when torch records a gradient for it. Ops detach every input
whose ``stop_gradient`` is True, so setting it on a result cuts the graph
there, as in paddle. In-place ops (``x.add_(y)``, ``x[i] = v``) rebind
``_value`` to a new result (:meth:`Tensor._inplace_assign`), so autograd
never sees a tensor it saved change under it.
"""
from __future__ import annotations

import numpy as np
import torch

from . import dtype as dtype_mod
from . import place as place_mod
from . import tape as tape_mod

__all__ = ["Tensor", "Parameter", "LazyTensor", "to_tensor"]


def _numpy_to_torch(arr: np.ndarray) -> torch.Tensor:
    """A numpy array (bfloat16 from ``ml_dtypes`` too) → a CPU tensor."""
    if arr.dtype.name == "bfloat16":
        bits = np.ascontiguousarray(arr).view(np.int16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr, copy=True, order="C"))


def _as_value(data, dtype=None, place=None) -> torch.Tensor:
    """User data → a ``torch.Tensor`` on ``place`` (the current place for
    host data when ``place`` is None; a tensor keeps its device).
    Paddle's rule: python floats take the default dtype, python ints
    int64, numpy arrays keep their dtype."""
    td = dtype_mod.to_torch_dtype(dtype) if dtype is not None else None
    dev = place_mod.to_torch_device(place) if place is not None else None
    if isinstance(data, Tensor):
        v = data._value.detach()
    elif isinstance(data, torch.Tensor):
        v = data.detach()
    else:
        arr = np.asarray(data)
        if td is None and arr.dtype == np.float64 \
                and not isinstance(data, np.ndarray):
            td = dtype_mod.default_dtype().torch_dtype
        v = _numpy_to_torch(arr)
        if dev is None:
            dev = place_mod.to_torch_device()
    if dev is not None and v.device != dev:
        v = v.to(dev)
    if td is not None and v.dtype != td:
        v = v.to(td)
    return v


def _differentiable(v: torch.Tensor) -> bool:
    return v.is_floating_point() or v.is_complex()


class Tensor:
    """``paddle.Tensor`` over a ``torch.Tensor`` (see the module
    docstring)."""

    __slots__ = ("_value", "_stop_gradient", "name", "persistable",
                 "_is_param", "__weakref__")

    # let Tensor win against numpy in reflected ops
    __array_priority__ = 100

    def __init__(self, data, dtype=None, place=None,
                 stop_gradient: bool = True, name: str = None):
        self._value = _as_value(data, dtype, place)
        self._stop_gradient = True
        self.name = name
        self.persistable = False
        self._is_param = False
        self.stop_gradient = stop_gradient

    @classmethod
    def _wrap(cls, v: torch.Tensor, stop_gradient=None) -> "Tensor":
        """An op's result: ``stop_gradient`` follows whether torch records
        a gradient for ``v`` unless given."""
        t = object.__new__(Tensor)
        t._value = v
        t._stop_gradient = (not v.requires_grad if stop_gradient is None
                            else bool(stop_gradient))
        t.name = None
        t.persistable = False
        t._is_param = False
        return t

    # -- structural properties ---------------------------------------------
    @property
    def shape(self) -> list:
        return list(self._value.shape)

    @property
    def dtype(self) -> dtype_mod.DType:
        return dtype_mod.convert_dtype(self._value.dtype)

    @property
    def ndim(self) -> int:
        return self._value.ndim

    @property
    def size(self) -> int:
        return int(self._value.numel())

    @property
    def place(self):
        return place_mod.place_of(self._value.device)

    @property
    def is_leaf(self) -> bool:
        return self._value.grad_fn is None

    @property
    def stop_gradient(self) -> bool:
        return self._stop_gradient

    @stop_gradient.setter
    def stop_gradient(self, sg):
        sg = bool(sg)
        self._stop_gradient = sg
        v = self._value
        if v.grad_fn is not None or not _differentiable(v):
            return          # a result: ops detach it when sg is True
        if v.requires_grad == sg:
            self._rebind_leaf(v.detach(), requires_grad=not sg)

    def _rebind_leaf(self, new: torch.Tensor, requires_grad: bool):
        """Make ``new`` this tensor's leaf value, carrying ``.grad``."""
        old = self._value
        grad = old.grad if old.is_leaf else None
        if requires_grad and _differentiable(new):
            new.requires_grad_(True)
        if grad is not None and grad.shape == new.shape \
                and grad.dtype == new.dtype:
            new.grad = grad
        self._value = new

    @property
    def grad(self):
        v = self._value
        if not v.is_leaf or v.grad is None:
            return None
        return Tensor._wrap(v.grad, True)

    @grad.setter
    def grad(self, g):
        if g is None:
            self._value.grad = None
            return
        gv = g._value if isinstance(g, Tensor) else _as_value(g)
        self._value.grad = gv.to(self._value.device, self._value.dtype)

    # -- autograd -----------------------------------------------------------
    def backward(self, grad_tensor=None, retain_graph: bool = False):
        tape_mod.backward([self], [grad_tensor], retain_graph=retain_graph)

    def clear_grad(self):
        self._value.grad = None

    def clear_gradient(self, set_to_zero: bool = False):
        g = self._value.grad
        if set_to_zero and g is not None:
            self._value.grad = torch.zeros_like(g)
        else:
            self._value.grad = None

    def detach(self) -> "Tensor":
        t = Tensor._wrap(self._value.detach(), True)
        t.name = self.name
        return t

    def detach_(self):
        self._value = self._value.detach()
        self._stop_gradient = True
        return self

    def clone(self) -> "Tensor":
        from .. import ops
        return ops.assign(self)

    # -- host interop -------------------------------------------------------
    def numpy(self) -> np.ndarray:
        v = self._value.detach()
        if v.dtype == torch.bfloat16:
            npd = dtype_mod.bfloat16.np_dtype
            if npd is None:
                raise TypeError(
                    "numpy has no bfloat16 without the ml_dtypes package; "
                    "cast first, e.g. t.astype('float32').numpy()")
            return v.cpu().view(torch.int16).numpy().view(npd)
        return v.cpu().numpy()

    def __array__(self, dtype=None, copy=None):
        a = self.numpy()
        return a.astype(dtype) if dtype is not None else a

    def item(self, *idx):
        v = self._value if not idx else self._value[idx]
        return v.item()

    def tolist(self):
        return self._value.detach().cpu().tolist()

    def __float__(self):
        return float(self.item())

    def __int__(self):
        return int(self.item())

    def __bool__(self):
        if self.size != 1:
            raise ValueError("The truth value of a Tensor with more than "
                             "one element is ambiguous")
        return bool(self.item())

    def __len__(self):
        if self.ndim == 0:
            raise TypeError("len() of a 0-D tensor")
        return self._value.shape[0]

    def __repr__(self):
        grad_s = "" if self.stop_gradient else ", stop_gradient=False"
        data = self._value.detach().cpu()
        return (f"Tensor(shape={self.shape}, dtype={self.dtype.name}, "
                f"place={self.place}{grad_s},\n       {data.tolist()})")

    def __hash__(self):
        return id(self)

    # -- dtype / device movement -------------------------------------------
    def astype(self, dtype) -> "Tensor":
        from .. import ops
        return ops.cast(self, dtype)

    cast = astype

    def _moved(self, dev: torch.device) -> "Tensor":
        # a new leaf on ``dev`` with this tensor's stop_gradient, as the
        # JAX package's device_put gives
        return Tensor(self._value.detach().to(dev),
                      stop_gradient=self.stop_gradient)

    def cpu(self):
        return self._moved(torch.device("cpu"))

    def cuda(self, device_id=None, blocking=True):
        place = place_mod.CUDAPlace(device_id or 0)
        return self._moved(place_mod.to_torch_device(place))

    def pin_memory(self):
        return self.cpu()

    def to(self, *args, **kwargs):
        """``to(dtype)``, ``to(device)`` or both; a device is ``"cpu"``,
        ``"gpu[:i]"``/``"cuda[:i]"`` or a Place."""
        dtype = kwargs.get("dtype")
        device = kwargs.get("device")
        for a in args:
            if isinstance(a, place_mod.Place) or (
                    isinstance(a, str) and a.split(":")[0].lower()
                    in ("cpu", "gpu", "tpu", "cuda")):
                device = a
            else:
                dtype = a
        t = self
        if dtype is not None:
            t = t.astype(dtype)
        if device is not None:
            place = device if isinstance(device, place_mod.Place) \
                else _parse_place(device)
            t = t._moved(place_mod.to_torch_device(place))
        return t

    # -- in-place machinery -------------------------------------------------
    def _inplace_assign(self, new: "Tensor"):
        """Rebind this tensor's value to ``new``'s (in-place op
        semantics): it records ``new``'s producer, or stays a leaf."""
        sg = new.stop_gradient and self.stop_gradient
        v = new._value
        if v.grad_fn is not None:
            self._value = v
        else:
            self._rebind_leaf(v.detach(), requires_grad=not sg)
        self._stop_gradient = sg
        return self

    def set_value(self, value):
        v = _as_value(value, place=self.place)
        if tuple(v.shape) != tuple(self._value.shape):
            raise ValueError(f"set_value shape mismatch: {list(v.shape)} "
                             f"vs {self.shape}")
        v = v.to(self._value.dtype)
        if self._value.grad_fn is None:
            self._rebind_leaf(v, requires_grad=self._value.requires_grad)
        else:
            self._value = v
        return self

    def copy_(self, other, *a):
        return self.set_value(other)

    # -- indexing -----------------------------------------------------------
    def __getitem__(self, idx):
        idx = _normalize_index(idx, self._value)
        return tape_mod.apply(lambda v: v[idx], self, op_name="getitem")

    def __setitem__(self, idx, value):
        idx = _normalize_index(idx, self._value)

        def f(v, w):
            out = v.clone()
            w = torch.as_tensor(w, device=v.device)
            out[idx] = w.to(v.dtype)
            return out

        if not isinstance(value, Tensor):
            value = Tensor._wrap(torch.as_tensor(np.asarray(value)), True)
        self._inplace_assign(tape_mod.apply(f, self, value,
                                            op_name="setitem"))

    @property
    def T(self):
        from .. import ops
        return ops.transpose(self, list(range(self.ndim))[::-1])

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    # math dunders & named methods are attached by ops.monkey_patch_tensor()


def _parse_place(device: str):
    s = device.lower()
    if s == "cpu":
        return place_mod.CPUPlace()
    _, _, idx = s.partition(":")
    return place_mod.CUDAPlace(int(idx) if idx else 0)


def _index_part(i, v):
    if isinstance(i, Tensor):
        return i._value
    if isinstance(i, np.ndarray):
        return torch.as_tensor(i, device=v.device)
    if isinstance(i, list):
        return torch.as_tensor(np.asarray(i), device=v.device)
    return i


def _normalize_index(idx, v):
    """Unwrap Tensor/numpy indices; a slice with a negative step (which
    torch cannot take) becomes an index tensor."""
    parts = idx if isinstance(idx, tuple) else (idx,)
    out = []
    dim = 0
    for i in parts:
        if isinstance(i, slice) and i.step is not None and i.step < 0:
            n = v.shape[dim]
            out.append(torch.arange(*i.indices(n), device=v.device))
        else:
            out.append(_index_part(i, v))
        if i is not None and i is not Ellipsis:
            dim += 1
    return tuple(out) if isinstance(idx, tuple) else out[0]


class Parameter(Tensor):
    """Trainable tensor (``paddle.framework.Parameter``)."""

    __slots__ = ("trainable", "optimize_attr", "regularizer", "need_clip",
                 "is_distributed")

    def __init__(self, data, dtype=None, name=None, trainable: bool = True,
                 place=None):
        super().__init__(data, dtype=dtype, place=place,
                         stop_gradient=not trainable, name=name)
        self._is_param = True
        self.persistable = True
        self.trainable = trainable
        self.optimize_attr = {"learning_rate": 1.0}
        self.regularizer = None
        self.need_clip = True
        self.is_distributed = False


class LazyTensor(Tensor):
    """A static program's variable (the JAX package's placeholder ``Tensor``
    over a ``ShapeDtypeStruct``): a ``static.data`` feed or the output of a
    recorded op. ``_value`` is a ``meta`` tensor (shape and dtype, no
    storage) and ``_lazy`` says what it stands for: ``("feed", name)`` or
    ``(node, output index)``. ``shape``, ``dtype``, ``ndim`` and ``name``
    work; ops on it record (:func:`~paddle_tpu_torch.framework.tape.apply`);
    reading its value on the host raises, since it has none until
    ``Executor.run``."""

    __slots__ = ("_lazy",)

    @classmethod
    def _make(cls, value, lazy, name=None, stop_gradient=True):
        t = object.__new__(cls)
        t._value = value
        t._lazy = lazy
        t._stop_gradient = bool(stop_gradient)
        t.name = name
        t.persistable = False
        t._is_param = False
        return t

    def _no_value(self, what):
        label = self.name or "an op output"
        raise RuntimeError(
            f"{what} of a static program's variable ({label}, shape "
            f"{self.shape}): it has no value until Executor.run; fetch it "
            f"with fetch_list=[...]")

    @property
    def place(self):
        return place_mod._get_current_place()

    @property
    def is_leaf(self) -> bool:
        return self._lazy[0] == "feed"

    @property
    def stop_gradient(self) -> bool:
        return self._stop_gradient

    @stop_gradient.setter
    def stop_gradient(self, sg):
        # read when an op consumes the variable: it detaches it then
        self._stop_gradient = bool(sg)

    @property
    def grad(self):
        return None

    def backward(self, grad_tensor=None, retain_graph=False):
        raise RuntimeError("backward() of a static program's variable: use "
                           "optimizer.minimize(loss) or static.gradients")

    def numpy(self):
        self._no_value("numpy()")

    def __array__(self, dtype=None, copy=None):
        self._no_value("np.asarray()")

    def item(self, *idx):
        self._no_value("item()")

    def tolist(self):
        self._no_value("tolist()")

    def __float__(self):
        self._no_value("float()")

    def __int__(self):
        self._no_value("int()")

    def __bool__(self):
        self._no_value("bool()")

    def __repr__(self):
        return (f"Variable(name={self.name}, shape={self.shape}, "
                f"dtype={self.dtype.name}, stop_gradient="
                f"{self.stop_gradient})")

    def detach(self):
        out = tape_mod.apply(lambda v: v, self, op_name="detach")
        out.stop_gradient = True
        return out

    def set_value(self, value):
        self._no_value("set_value()")

    def _moved(self, dev):
        self._no_value("moving")

    def _inplace_assign(self, new):
        self._value, self._lazy = new._value, new._lazy
        self._stop_gradient = new.stop_gradient and self._stop_gradient
        return self


def to_tensor(data, dtype=None, place=None,
              stop_gradient: bool = True) -> Tensor:
    """``paddle.to_tensor``: on ``place``, else the current place (the card
    unless ``set_device("cpu")``)."""
    return Tensor(data, dtype=dtype, place=place,
                  stop_gradient=stop_gradient)
