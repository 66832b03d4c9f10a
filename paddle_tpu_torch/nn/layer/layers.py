"""``nn.Layer`` and ``ParamAttr`` (counterpart of
``paddle_tpu/nn/layer/layers.py``).

:class:`Layer` is a plain Python class, not a ``torch.nn.Module``, for the
reason the facade's ``Tensor`` is not a ``torch.Tensor`` subclass:
paddle's names mean other things than torch's (``parameters()`` is a
list, ``to(device, dtype, blocking)``, ``state_dict()`` holds facade
Tensors, ``apply``, ``full_name`` and hooks with paddle's signatures).
Its parameters are the facade's :class:`~paddle_tpu_torch.Parameter`\\s,
whose ``_value`` is the torch leaf autograd and the optimizers update, so
ops on them go through the facade's dispatch (``auto_cast``, the flags and
``stop_gradient`` hold as for any Tensor).

Parameters keep their leaf: :meth:`Layer.set_state_dict` copies into it,
so a tied parameter stays tied and a captured CUDA graph that reads it
(``ParallelTrainStep``) reads the new values. ``to``, ``astype`` and
friends make new leaves (another device or dtype), and drop gradients.
"""
from __future__ import annotations

import re
from collections import OrderedDict
from typing import Callable, Iterator

import numpy as np
import torch

from ...framework.dtype import convert_dtype, default_dtype
from ...framework.place import Place, to_torch_device
from ...framework.tensor import (Parameter, Tensor, _numpy_to_torch,
                                 _parse_place)
from .. import initializer as init_mod

__all__ = ["Layer", "ParamAttr"]


class ParamAttr:
    """``paddle.ParamAttr``."""

    def __init__(self, name=None, initializer=None, learning_rate=1.0,
                 regularizer=None, trainable=True, need_clip=True):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.need_clip = need_clip

    @staticmethod
    def _to_attr(attr):
        if attr is None:
            return ParamAttr()
        if isinstance(attr, ParamAttr):
            return attr
        if isinstance(attr, init_mod.Initializer):
            return ParamAttr(initializer=attr)
        if isinstance(attr, str):
            return ParamAttr(name=attr)
        if attr is False:
            return False
        raise TypeError(f"invalid ParamAttr {attr!r}")


_layer_name_counters: dict[str, int] = {}


def _unique_name(prefix: str) -> str:
    n = _layer_name_counters.get(prefix, 0)
    _layer_name_counters[prefix] = n + 1
    return f"{prefix}_{n}"


def _torch_value(v) -> torch.Tensor:
    """A state value (Tensor, torch tensor, numpy array incl. bfloat16,
    list) as a detached torch tensor."""
    if isinstance(v, Tensor):
        return v._value.detach()
    if isinstance(v, torch.Tensor):
        return v.detach()
    return _numpy_to_torch(np.asarray(v))


def _rebind(t: Tensor, new: torch.Tensor):
    """Make ``new`` the value of ``t`` (a parameter stays a trainable leaf
    as it was); its gradient is dropped."""
    t._value.grad = None
    if isinstance(t, Parameter) or t._value.requires_grad:
        t._rebind_leaf(new.detach(), requires_grad=not t.stop_gradient)
    else:
        t._value = new.detach()


class Layer:
    """``paddle.nn.Layer``: sublayer, parameter and buffer registries by
    attribute assignment, forward pre- and post-hooks, ``state_dict`` with
    structured names, ``train``/``eval``."""

    def __init__(self, name_scope=None, dtype=None):
        self.training = True
        self._dtype = convert_dtype(dtype) if dtype is not None \
            else default_dtype()
        self._parameters: OrderedDict[str, Parameter] = OrderedDict()
        self._sub_layers: OrderedDict[str, Layer] = OrderedDict()
        self._buffers: OrderedDict[str, Tensor] = OrderedDict()
        self._non_persistable_buffer_names: set[str] = set()
        self._forward_pre_hooks: OrderedDict[int, Callable] = OrderedDict()
        self._forward_post_hooks: OrderedDict[int, Callable] = OrderedDict()
        self._full_name = _unique_name(
            name_scope or re.sub(r"(?<!^)(?=[A-Z])", "_",
                                 type(self).__name__).lower())

    # ---- attribute routing ------------------------------------------------
    def __setattr__(self, name, value):
        params = self.__dict__.get("_parameters")
        layers = self.__dict__.get("_sub_layers")
        buffers = self.__dict__.get("_buffers")
        if isinstance(value, Parameter):
            if params is None:
                raise RuntimeError(
                    "call super().__init__() before assigning params")
            params[name] = value
            layers.pop(name, None)
            buffers.pop(name, None)
            self.__dict__.pop(name, None)
        elif isinstance(value, Layer):
            if layers is None:
                raise RuntimeError(
                    "call super().__init__() before assigning sublayers")
            layers[name] = value
            params.pop(name, None)
            self.__dict__.pop(name, None)
        elif buffers is not None and name in buffers:
            if value is None or isinstance(value, Tensor):
                buffers[name] = value
            else:
                buffers[name] = Tensor(value)
        else:
            object.__setattr__(self, name, value)

    def __getattr__(self, name):
        for registry in ("_parameters", "_sub_layers", "_buffers"):
            d = self.__dict__.get(registry)
            if d is not None and name in d:
                return d[name]
        raise AttributeError(
            f"'{type(self).__name__}' object has no attribute {name!r}")

    def __delattr__(self, name):
        for registry in ("_parameters", "_sub_layers", "_buffers"):
            d = self.__dict__.get(registry)
            if d is not None and name in d:
                del d[name]
                return
        object.__delattr__(self, name)

    def __dir__(self):
        extra = []
        for registry in ("_parameters", "_sub_layers", "_buffers"):
            d = self.__dict__.get(registry)
            if d:
                extra.extend(d.keys())
        return sorted(set(list(super().__dir__()) + extra))

    # ---- forward ----------------------------------------------------------
    def forward(self, *inputs, **kwargs):
        raise NotImplementedError

    def _call_with_hooks(self, forward, *inputs, **kwargs):
        """Pre hooks (each may replace the inputs), ``forward``, post hooks
        (each may replace the outputs)."""
        for hook in self._forward_pre_hooks.values():
            out = hook(self, inputs)
            if out is not None:
                inputs = out if isinstance(out, tuple) else (out,)
        outputs = forward(*inputs, **kwargs)
        for hook in self._forward_post_hooks.values():
            out = hook(self, inputs, outputs)
            if out is not None:
                outputs = out
        return outputs

    def __call__(self, *inputs, **kwargs):
        return self._call_with_hooks(self.forward, *inputs, **kwargs)

    def register_forward_pre_hook(self, hook):
        """``hook(layer, inputs)``; returns a handle with ``remove()``."""
        handle = HookRemoveHelper(self._forward_pre_hooks)
        self._forward_pre_hooks[handle.hook_id] = hook
        return handle

    def register_forward_post_hook(self, hook):
        """``hook(layer, inputs, outputs)``; returns a handle with
        ``remove()``."""
        handle = HookRemoveHelper(self._forward_post_hooks)
        self._forward_post_hooks[handle.hook_id] = hook
        return handle

    # ---- parameter creation -------------------------------------------------
    def create_parameter(self, shape, attr=None, dtype=None, is_bias=False,
                         default_initializer=None):
        """A Parameter of ``shape`` on the current place, drawn by the
        attr's initializer, else ``default_initializer``, else paddle's
        default (zeros for a bias, Xavier normal for a weight); ``attr``
        False gives None."""
        attr = ParamAttr._to_attr(attr)
        if attr is False:
            return None
        dtype = convert_dtype(dtype) if dtype is not None else self._dtype
        initializer = (attr.initializer or default_initializer
                       or (init_mod.Constant(0.0) if is_bias
                           else init_mod.XavierNormal()))
        p = Parameter(initializer(shape, dtype), name=attr.name,
                      trainable=attr.trainable)
        p.optimize_attr["learning_rate"] = attr.learning_rate
        p.regularizer = attr.regularizer
        p.need_clip = attr.need_clip
        if p.name is None:
            p.name = _unique_name(f"{self._full_name}.w" if not is_bias
                                  else f"{self._full_name}.b")
        return p

    def create_tensor(self, name=None, persistable=None, dtype=None):
        td = convert_dtype(dtype or self._dtype).torch_dtype
        t = Tensor(torch.zeros([], dtype=td, device=to_torch_device()))
        t.name = name
        return t

    def add_parameter(self, name, parameter):
        self._parameters[name] = parameter
        return parameter

    def add_sublayer(self, name, sublayer):
        self._sub_layers[str(name)] = sublayer
        return sublayer

    def register_buffer(self, name, tensor, persistable=True):
        self._buffers[name] = tensor
        if not persistable:
            self._non_persistable_buffer_names.add(name)
        return tensor

    # ---- traversal --------------------------------------------------------
    def parameters(self, include_sublayers=True) -> list:
        return [p for _, p in self.named_parameters(
            include_sublayers=include_sublayers)]

    def named_parameters(self, prefix="", include_sublayers=True):
        """``(structured name, Parameter)``, each parameter once: a tied
        parameter under the first name that reaches it."""
        seen = set()
        for name, layer in self._traverse(prefix, include_sublayers):
            for pname, p in layer._parameters.items():
                if p is not None and id(p) not in seen:
                    seen.add(id(p))
                    yield (f"{name}.{pname}" if name else pname), p

    def buffers(self, include_sublayers=True) -> list:
        return [b for _, b in self.named_buffers(
            include_sublayers=include_sublayers)]

    def named_buffers(self, prefix="", include_sublayers=True):
        seen = set()
        for name, layer in self._traverse(prefix, include_sublayers):
            for bname, b in layer._buffers.items():
                if b is not None and id(b) not in seen:
                    seen.add(id(b))
                    yield (f"{name}.{bname}" if name else bname), b

    def _traverse(self, prefix="", include_sublayers=True):
        yield prefix, self
        if include_sublayers:
            for lname, sub in self._sub_layers.items():
                if sub is None:
                    continue
                sub_prefix = f"{prefix}.{lname}" if prefix else lname
                yield from sub._traverse(sub_prefix, True)

    def children(self) -> Iterator["Layer"]:
        for _, layer in self.named_children():
            yield layer

    def named_children(self):
        for name, layer in self._sub_layers.items():
            if layer is not None:
                yield name, layer

    def sublayers(self, include_self=False) -> list:
        out = [layer for _, layer in self._traverse("", True)]
        return out if include_self else out[1:]

    def named_sublayers(self, prefix="", include_self=False):
        for name, layer in self._traverse(prefix, True):
            if include_self or layer is not self:
                yield name, layer

    def apply(self, fn):
        for layer in self.sublayers(include_self=True):
            fn(layer)
        return self

    # ---- modes ------------------------------------------------------------
    def train(self):
        for layer in self.sublayers(include_self=True):
            layer.training = True
        return self

    def eval(self):
        for layer in self.sublayers(include_self=True):
            layer.training = False
        return self

    # ---- state ------------------------------------------------------------
    def state_dict(self, destination=None, include_sublayers=True,
                   structured_name_prefix="", use_hook=True):
        """The parameters and persistable buffers (the Tensors themselves)
        by structured name."""
        dest = destination if destination is not None else OrderedDict()
        for name, p in self.named_parameters(structured_name_prefix,
                                             include_sublayers):
            dest[name] = p
        for name, layer in self._traverse(structured_name_prefix,
                                          include_sublayers):
            for bname, b in layer._buffers.items():
                if b is not None and \
                        bname not in layer._non_persistable_buffer_names:
                    dest[f"{name}.{bname}" if name else bname] = b
        return dest

    @torch.no_grad()
    def set_state_dict(self, state_dict, use_structured_name=True):
        """Copy each value (Tensor, torch tensor, numpy array incl.
        bfloat16) into the entry of that name, in place, cast to its dtype;
        with ``use_structured_name=False`` the keys are the parameters'
        ``name``\\s. A shape mismatch raises. Returns ``(missing,
        unexpected)`` keys."""
        own = self.state_dict()
        if not use_structured_name:
            own = OrderedDict((t.name, t) for t in own.values())
        unexpected = []
        for k, v in state_dict.items():
            if k not in own:
                unexpected.append(k)
                continue
            target = own[k]
            val = _torch_value(v)
            if tuple(val.shape) != tuple(target.shape):
                raise ValueError(f"shape mismatch for {k}: "
                                 f"{list(val.shape)} vs {target.shape}")
            target._value.copy_(val)
        missing = [k for k in own if k not in state_dict]
        return missing, unexpected

    load_dict = set_state_dict

    # ---- dtype / device movement -------------------------------------------
    def to(self, device=None, dtype=None, blocking=None):
        """Move every parameter and buffer to ``device`` (a Place,
        ``"cpu"``, ``"gpu[:i]"``) and cast the floating ones to ``dtype``;
        gradients are dropped."""
        if device is not None:
            place = device if isinstance(device, Place) \
                else _parse_place(str(device))
            dev = to_torch_device(place)
            for t in self._tensors():
                if t._value.device != dev:
                    _rebind(t, t._value.to(dev))
        if dtype is not None:
            self._cast_all(dtype)
        return self

    def astype(self, dtype):
        self._cast_all(dtype)
        return self

    def _tensors(self):
        return self.parameters() + [b for b in self.buffers()
                                    if b is not None]

    def _cast_all(self, dtype, floating_only=True):
        td = convert_dtype(dtype).torch_dtype
        for t in self._tensors():
            v = t._value
            if (not floating_only or v.is_floating_point()) \
                    and v.dtype != td:
                _rebind(t, v.to(td))

    def float(self):
        return self.astype("float32")

    def half(self):
        return self.astype("float16")

    def bfloat16(self):
        return self.astype("bfloat16")

    def full_name(self):
        return self._full_name

    def clear_gradients(self):
        for p in self.parameters():
            p.clear_grad()

    def __repr__(self):
        lines = []
        for name, sub in self._sub_layers.items():
            sub_repr = repr(sub).split("\n")
            lines.append(f"  ({name}): " + ("\n  ".join(sub_repr)))
        body = "" if not lines else "\n" + "\n".join(lines) + "\n"
        return f"{type(self).__name__}({self.extra_repr()}" + body + ")"

    def extra_repr(self):
        return ""


class HookRemoveHelper:
    _next_id = 0

    def __init__(self, hooks_dict):
        self._hooks = hooks_dict
        self.hook_id = HookRemoveHelper._next_id
        HookRemoveHelper._next_id += 1

    def remove(self):
        self._hooks.pop(self.hook_id, None)
