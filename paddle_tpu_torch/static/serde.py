"""Program serialization (counterpart of ``paddle_tpu/static/serde.py``).

The wire format is a structural encoding of the lazy DAG: per node (op fn,
kwargs, argument refs, what eager ``apply`` decides when it runs the op,
output avals as shapes and torch dtype names), feeds by name, parameters
by value. Op fns serialize by module reference where they resolve to
themselves, else by value (marshal'd code and pickled closure cells);
``AmpWrappedOp`` is written as (mode, low dtype, inner fn). A port file is
not a JAX program file: avals are torch shapes and dtypes.

.. warning:: **Trust boundary.** The format embeds Python callables
   (pickled references and marshal'd code objects) that are **executed**
   when the program is loaded and run: loading a program file is like
   importing a module. Only load programs you (or a party you trust)
   wrote. The outer envelope is parsed with a restricted unpickler that
   admits plain containers and numpy types only, so a malformed file
   cannot instantiate arbitrary classes at parse time; the op blobs inside
   it are unrestricted by design.
"""
from __future__ import annotations

import importlib
import io
import marshal
import pickle
import sys
import types

import numpy as np
import torch

from ..framework.tape import AmpWrappedOp
from ..framework.tensor import LazyTensor, Parameter, Tensor
from .program import LazyNode, Program, make_placeholder

__all__ = ["serialize_program", "deserialize_program", "save_program",
           "load_program", "program_to_string"]

_MAGIC = b"PTTPROG1"
_PYTAG = f"{sys.version_info.major}.{sys.version_info.minor}"


class _EnvelopeUnpickler(pickle.Unpickler):
    """Restricted unpickler for the outer payload envelope: containers,
    scalars, numpy arrays/dtypes and nested ``bytes`` blobs only."""

    _BUILTINS = {"complex", "set", "frozenset", "slice", "range",
                 "bytearray"}
    _NP_FUNCS = {"_reconstruct", "scalar", "_frombuffer"}

    def find_class(self, module, name):
        if module == "builtins" and name in self._BUILTINS:
            return super().find_class(module, name)
        if (module in ("numpy.core.multiarray", "numpy._core.multiarray",
                       "numpy.core.numeric", "numpy._core.numeric")
                and name in self._NP_FUNCS):
            return super().find_class(module, name)
        if module in ("numpy", "numpy.core", "numpy._core"):
            obj = super().find_class(module, name)
            if isinstance(obj, type):  # ndarray, dtype, scalar types
                return obj
        raise pickle.UnpicklingError(
            f"program envelope may not reference {module}.{name}; the file "
            f"is corrupt or was not produced by save_program")


def _loads_envelope(blob):
    return _EnvelopeUnpickler(io.BytesIO(blob)).load()


def _dtype_name(dt) -> str:
    return str(dt).replace("torch.", "")


def _torch_dtype(name):
    return getattr(torch, name)


def _serialize_fn(fn, op_name):
    """Op callables by reference when importable, else by value (code
    object + closure cells; the ops are mostly small closures)."""
    if isinstance(fn, AmpWrappedOp):
        return ("amp", fn.mode, _dtype_name(fn.low),
                _serialize_fn(fn.fn, op_name))
    try:
        blob = pickle.dumps(fn)
        pickle.loads(blob)
        return ("ref", blob)
    except Exception:
        pass
    mod, qn = getattr(fn, "__module__", None), getattr(fn, "__qualname__", "")
    if mod and qn and "<locals>" not in qn and "<lambda>" not in qn:
        try:
            obj = importlib.import_module(mod)
            for part in qn.split("."):
                obj = getattr(obj, part)
            # identity only: a bound method's qualname resolves to the
            # unbound function, which would drop `self` at load time
            if obj is fn:
                return ("named", mod, qn)
        except (ImportError, AttributeError):
            pass
    if not isinstance(fn, types.FunctionType):
        raise ValueError(
            f"op {op_name!r} captured a non-serializable callable "
            f"({type(fn).__name__}); this program cannot be written")
    try:
        cells = tuple(pickle.dumps(c.cell_contents)
                      for c in (fn.__closure__ or ()))
        return ("code", marshal.dumps(fn.__code__), fn.__module__,
                fn.__name__, pickle.dumps(fn.__defaults__),
                pickle.dumps(fn.__kwdefaults__), cells)
    except Exception as e:
        raise ValueError(
            f"op {op_name!r} captured a closure over non-serializable "
            f"state; this program cannot be written") from e


def _deserialize_fn(enc):
    if enc[0] == "amp":
        return AmpWrappedOp(_deserialize_fn(enc[3]), enc[1],
                            _torch_dtype(enc[2]))
    if enc[0] == "ref":
        return pickle.loads(enc[1])
    if enc[0] == "named":
        obj = importlib.import_module(enc[1])
        for part in enc[2].split("."):
            obj = getattr(obj, part)
        return obj
    _, code_blob, module, name, defaults, kwdefaults, cells = enc
    code = marshal.loads(code_blob)
    try:
        g = importlib.import_module(module).__dict__
    except ImportError:
        g = {"torch": torch, "np": np}
    closure = tuple(types.CellType(pickle.loads(c)) for c in cells)
    fn = types.FunctionType(code, g, name, pickle.loads(defaults),
                            closure or None)
    fn.__kwdefaults__ = pickle.loads(kwdefaults)
    return fn


def _host(v: torch.Tensor):
    """A tensor as (numpy array, torch dtype name); bf16 travels as f32,
    which holds every bf16 value exactly."""
    v = v.detach().cpu()
    name = _dtype_name(v.dtype)
    if v.dtype == torch.bfloat16:
        v = v.float()
    return v.numpy(), name


def _aval(t):
    v = t._value if isinstance(t, Tensor) else t
    return (tuple(v.shape), _dtype_name(v.dtype))


def _encode_arg(a, node_idx, param_idx, params):
    if isinstance(a, LazyTensor):
        if a._lazy[0] == "feed":
            return ("feed", a._lazy[1])
        return ("lazy", node_idx[id(a._lazy[0])], a._lazy[1])
    if isinstance(a, Parameter):
        if id(a) not in param_idx:
            param_idx[id(a)] = len(params)
            value, dt = _host(a._value)
            params.append({"name": a.name, "value": value, "dtype": dt,
                           "trainable": a.trainable})
        return ("param", param_idx[id(a)])
    if isinstance(a, Tensor):
        return ("tensor", *_host(a._value))
    return ("const", a)


def serialize_program(program: Program, fetch_vars=None) -> bytes:
    """Program (+ optional fetch tensors) -> bytes."""
    node_idx = {id(n): i for i, n in enumerate(program._nodes)}
    params, param_idx = [], {}
    nodes_enc = []
    for n in program._nodes:
        fn_blob = _serialize_fn(n.fn, n.name)
        try:
            # validate against the load-time envelope, so a program that
            # writes also loads
            _loads_envelope(pickle.dumps(n.kwargs, protocol=4))
        except Exception as e:
            raise ValueError(
                f"op {n.name!r} has kwargs outside the serializable "
                f"envelope (containers/scalars/numpy only)") from e
        nodes_enc.append({
            "name": n.name,
            "fn": fn_blob,
            "kwargs": n.kwargs,
            "args": [_encode_arg(a, node_idx, param_idx, params)
                     for a in n.args],
            "detach": list(n.detach),
            "has_aux": n.has_aux,
            "nondiff": n.nondiff,
            "treedef": n.treedef,
            "out_avals": [_aval(av) for av in n.out_avals],
        })
    feeds_enc = {name: _aval(t) for name, t in program._feeds.items()}
    fetches_enc = []
    for t in (fetch_vars or []):
        if not isinstance(t, LazyTensor) or t._lazy[0] == "feed":
            raise ValueError("fetch_vars must be graph outputs")
        fetches_enc.append((node_idx[id(t._lazy[0])], t._lazy[1]))
    payload = {"nodes": nodes_enc, "feeds": feeds_enc, "params": params,
               "fetches": fetches_enc, "random_seed": program.random_seed,
               "python": _PYTAG}
    blob = pickle.dumps(payload, protocol=4)
    try:
        _loads_envelope(blob)
    except pickle.UnpicklingError as e:
        raise ValueError(
            f"program contains a constant outside the serializable "
            f"envelope: {e}") from e
    return _MAGIC + blob


def deserialize_program(blob: bytes):
    """bytes -> (Program, feed_tensors{name: Tensor}, fetch_tensors[list]);
    the Program is self-contained: run it with ``Executor.run(program,
    feed=..., fetch_list=fetches)``. Parameters and constants land on the
    current place."""
    if not blob.startswith(_MAGIC):
        raise ValueError("not a serialized paddle_tpu_torch Program")
    payload = _loads_envelope(blob[len(_MAGIC):])

    def has_code(enc):
        return enc[0] == "code" or (enc[0] == "amp" and has_code(enc[3]))

    if payload["python"] != _PYTAG and any(
            has_code(ne["fn"]) for ne in payload["nodes"]):
        raise ValueError(
            f"program was serialized under python {payload['python']} with "
            f"by-value ops; load it under the same python minor version "
            f"(running {_PYTAG})")

    prog = Program()
    prog.random_seed = payload["random_seed"]
    feeds = {name: make_placeholder(sh, _torch_dtype(dt), ("feed", name),
                                    name)
             for name, (sh, dt) in payload["feeds"].items()}
    prog._feeds = dict(feeds)
    params = [Parameter(p["value"], dtype=p["dtype"], name=p["name"],
                        trainable=p["trainable"])
              for p in payload["params"]]

    outs_of = []
    for ne in payload["nodes"]:
        args = []
        for kind, *rest in ne["args"]:
            if kind == "feed":
                args.append(feeds[rest[0]])
            elif kind == "lazy":
                args.append(outs_of[rest[0]][rest[1]])
            elif kind == "param":
                args.append(params[rest[0]])
            elif kind == "tensor":
                args.append(Tensor(rest[0], dtype=rest[1]))
            else:
                args.append(rest[0])
        out_avals = [torch.empty(sh, dtype=_torch_dtype(dt), device="meta")
                     for sh, dt in ne["out_avals"]]
        node = LazyNode(_deserialize_fn(ne["fn"]), args, ne["kwargs"],
                        out_avals, ne["name"], ne["treedef"],
                        detach=ne["detach"], has_aux=ne["has_aux"],
                        nondiff=ne["nondiff"])
        prog._nodes.append(node)
        outs_of.append([make_placeholder(av, None, (node, i))
                        for i, av in enumerate(out_avals)])
    fetches = [outs_of[ni][oi] for ni, oi in payload["fetches"]]
    return prog, feeds, fetches


def save_program(program, path, fetch_vars=None):
    """Write the Program structure itself (the reference's .pdmodel
    ProgramDesc bytes). The file embeds Python code (see the module
    warning)."""
    with open(path, "wb") as f:
        f.write(serialize_program(program, fetch_vars))


def load_program(path):
    """Load a program written by :func:`save_program`.

    .. warning:: Runs embedded Python callables when the program is run
       (and unpickles them at load time): only load files you or a trusted
       party wrote."""
    with open(path, "rb") as f:
        return deserialize_program(f.read())


def program_to_string(program: Program) -> str:
    """ProgramDesc debug-string parity (``print(program)`` shows the ops
    and variables)."""
    lines = [f"Program(random_seed={program.random_seed})"]
    for name, t in program._feeds.items():
        sh, dt = _aval(t)
        lines.append(f"  feed {name}: {dt}{list(sh)}")
    node_idx = {id(n): i for i, n in enumerate(program._nodes)}
    for i, n in enumerate(program._nodes):
        parts = []
        for a in n.args:
            if isinstance(a, LazyTensor):
                lz = a._lazy
                parts.append(f"feed:{lz[1]}" if lz[0] == "feed"
                             else f"%{node_idx[id(lz[0])]}.{lz[1]}")
            elif isinstance(a, Tensor):
                parts.append(a.name or ("param" if isinstance(a, Parameter)
                                        else "tensor"))
            else:
                parts.append(repr(a))
        outs = ", ".join(f"{_dtype_name(av.dtype)}{list(av.shape)}"
                         for av in n.out_avals)
        lines.append(f"  %{i} = {n.name}({', '.join(parts)}) -> {outs}")
    return "\n".join(lines)
