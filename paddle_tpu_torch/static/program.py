"""Program: a lazy op DAG (counterpart of ``paddle_tpu/static/program.py``).

Under :func:`enable_static`, the facade's op dispatch
(:func:`paddle_tpu_torch.framework.tape.apply`) records an op with a lazy
input, or one consuming a ``Parameter``, as a :class:`LazyNode` of the
current program (:func:`make_lazy_output`). The node's outputs are
:class:`~paddle_tpu_torch.framework.tensor.LazyTensor` placeholders whose
shapes and dtypes come from running the op on ``meta`` tensors, where the
JAX package calls ``jax.eval_shape``: no storage, no arithmetic, no kernel
launch and no random draw.
"""
from __future__ import annotations

import contextlib
import itertools

import torch

from ..framework.dtype import to_torch_dtype
from ..framework.tensor import LazyTensor, Tensor

__all__ = ["Program", "LazyNode", "program_guard", "default_main_program",
           "default_startup_program", "enable_static", "disable_static",
           "in_static_mode", "static_build", "data", "name_scope",
           "make_placeholder", "make_lazy_output", "is_lazy",
           "record_buffer_update", "latest_buffer_value"]

_static_mode = False
# False until static mode is first turned on or a placeholder is made:
# until then no op can record, and the dispatch skips the check
_recording_possible = False


def enable_static():
    global _static_mode, _recording_possible
    _static_mode = _recording_possible = True


def disable_static():
    global _static_mode
    _static_mode = False


def in_static_mode() -> bool:
    return _static_mode


def static_build() -> bool:
    """True while ops record into the current Program."""
    return _static_mode


_order = itertools.count()      # LazyNode.seq: the order ops were recorded


def _flatten(out):
    """The tensors of a nested tuple/list output, and its structure."""
    if isinstance(out, (tuple, list)):
        leaves, defs = [], []
        for o in out:
            sub, d = _flatten(o)
            leaves += sub
            defs.append(d)
        return leaves, tuple(defs)
    return [out], None


def _unflatten(treedef, leaves):
    it = iter(leaves)

    def build(d):
        return next(it) if d is None else tuple(build(s) for s in d)
    return build(treedef)


def _floating(v) -> bool:
    return v.is_floating_point() or v.is_complex()


class LazyNode:
    """One recorded op: ``fn`` (with its ``auto_cast`` rule folded in, an
    ``AmpWrappedOp``), its arguments (lazy or concrete Tensors, and
    constants), ``kwargs``, the flat output avals (``meta`` tensors), and
    what eager ``apply`` decides when it runs the op: ``detach`` (per
    argument, its ``stop_gradient`` when recorded), ``has_aux`` (the aux
    outputs detached) and ``nondiff`` (an op outside autograd)."""

    __slots__ = ("fn", "args", "kwargs", "out_avals", "name", "n_outputs",
                 "treedef", "detach", "has_aux", "nondiff", "seq")

    def __init__(self, fn, args, kwargs, out_avals, name, treedef=None,
                 detach=None, has_aux=False, nondiff=False):
        self.fn = fn
        self.args = list(args)
        self.kwargs = kwargs
        self.out_avals = list(out_avals)
        self.name = name
        self.n_outputs = len(self.out_avals)
        self.treedef = treedef
        self.detach = list(detach) if detach is not None else [
            isinstance(a, Tensor) and a.stop_gradient for a in self.args]
        self.has_aux = has_aux
        self.nondiff = nondiff
        self.seq = next(_order)

    def run(self, vals, detach=None):
        """The op on its arguments' values, as eager ``apply`` runs it
        (``detach`` in place of the node's own flags); returns the flat
        outputs."""
        vals = [v.detach() if d and isinstance(v, torch.Tensor) else v
                for v, d in zip(vals, detach or self.detach)]
        if self.nondiff:
            with torch.no_grad():
                out = self.fn(*vals, **self.kwargs)
        else:
            out = self.fn(*vals, **self.kwargs)
        if self.has_aux:
            main, aux = out
            out = (main, tuple(a.detach() for a in aux)
                   if isinstance(aux, (tuple, list)) else aux.detach())
        return _flatten(out)[0]


def make_placeholder(shape, dtype, lazy, name=None, stop_gradient=True):
    """A :class:`LazyTensor` of ``shape`` and ``dtype`` (or, with ``dtype``
    None, the ``meta`` tensor ``shape``) standing for ``lazy``: one
    construction point for feeds, op outputs and loaded programs."""
    global _recording_possible
    _recording_possible = True
    value = shape if dtype is None else torch.empty(
        tuple(shape), dtype=to_torch_dtype(dtype), device="meta")
    return LazyTensor._make(value, lazy, name, stop_gradient)


def _meta(a):
    v = a._value
    return v if v.is_meta else torch.empty_like(v, device="meta")


def make_lazy_output(fn, args, kwargs, op_name, has_aux=False,
                     nondiff=False, out_avals=None):
    """Record ``fn(*args, **kwargs)`` into the current program and return
    placeholders shaped as its output (a tuple stays a tuple). The output
    avals come from running ``fn`` on ``meta`` tensors, unless given."""
    if out_avals is None:
        metas = [_meta(a) if isinstance(a, Tensor) else a for a in args]
        try:
            with torch.no_grad():
                out = fn(*metas, **kwargs)
        except (RuntimeError, NotImplementedError, TypeError) as e:
            raise RuntimeError(
                f"op {op_name!r} cannot be recorded into a static program "
                f"(its shapes come from a run on meta tensors, which "
                f"failed: {e})") from e
        leaves, treedef = _flatten(out)
        n_main = len(_flatten(out[0])[0]) if has_aux else len(leaves)
    else:
        leaves, treedef = list(out_avals), tuple(None for _ in out_avals)
        n_main = len(leaves)
    for v in leaves:
        if not isinstance(v, torch.Tensor):
            raise TypeError(f"op {op_name!r} returned a {type(v).__name__}, "
                            f"which a static program cannot hold")
    leaves = [v.detach() for v in leaves]
    node = LazyNode(fn, args, kwargs, leaves, op_name, treedef,
                    has_aux=has_aux, nondiff=nondiff)
    diff = not nondiff and torch.is_grad_enabled() and any(
        isinstance(a, Tensor) and not a.stop_gradient and _floating(a._value)
        for a in args)
    default_main_program()._nodes.append(node)
    outs = [make_placeholder(v, None, (node, i), stop_gradient=not (
        diff and i < n_main and _floating(v))) for i, v in enumerate(leaves)]
    return _unflatten(treedef, outs)


def is_lazy(t) -> bool:
    return isinstance(t, LazyTensor)


def record_buffer_update(target: Tensor, lazy_value: Tensor):
    """Register an in-program state write: after each Executor run,
    ``target``'s value becomes the evaluated ``lazy_value``, copied in
    place (inside a captured graph too), so updates compound across
    runs."""
    default_main_program()._buffer_updates.append((target, lazy_value))


def latest_buffer_value(target: Tensor):
    """The most recently recorded update value for ``target`` in the
    current program, or ``target`` itself: a buffer updated twice in one
    program (a BN layer applied to two inputs) chains off this, so the
    updates compound within a run, like the reference's sequential
    in-place batch_norm ops."""
    for t, v in reversed(default_main_program()._buffer_updates):
        if t is target:
            return v
    return target


class Program:
    """Recorded lazy DAG + feed/fetch bookkeeping (ProgramDesc parity
    shell)."""

    def __init__(self):
        self._nodes: list[LazyNode] = []
        self._feeds: dict[str, Tensor] = {}
        self._optimize_ops = []  # (optimizer, loss_tensor)
        # (target Tensor, lazy update value): in-program state writes the
        # Executor applies after each run (BN running mean/var)
        self._buffer_updates = []
        self.random_seed = 0

    def global_block(self):
        return self

    def clone(self, for_test=False):
        p = Program()
        p._nodes = list(self._nodes)
        p._feeds = dict(self._feeds)
        # eval clones never mutate state (the reference's
        # clone(for_test=True) strips the training-only in-place ops)
        p._buffer_updates = [] if for_test else list(self._buffer_updates)
        p.random_seed = self.random_seed
        return p

    def __repr__(self):
        return f"Program(nodes={len(self._nodes)}, feeds={list(self._feeds)})"

    # -- ProgramDesc parity: debug string + binary round trip ------------
    def to_string(self, throw_on_error=False, with_details=False):
        from .serde import program_to_string
        return program_to_string(self)

    __str__ = to_string

    def serialize_to_string(self, fetch_vars=None) -> bytes:
        from .serde import serialize_program
        return serialize_program(self, fetch_vars)

    @staticmethod
    def parse_from_string(binary: bytes) -> "Program":
        from .serde import deserialize_program
        prog, _, _ = deserialize_program(binary)
        return prog

    # set by Optimizer.minimize under static mode
    def _record_minimize(self, optimizer, loss):
        self._optimize_ops.append((optimizer, loss))


_default_main = Program()
_default_startup = Program()


def default_main_program() -> Program:
    return _default_main


def default_startup_program() -> Program:
    return _default_startup


@contextlib.contextmanager
def program_guard(main_program, startup_program=None):
    global _default_main, _default_startup
    saved = (_default_main, _default_startup)
    _default_main = main_program
    if startup_program is not None:
        _default_startup = startup_program
    try:
        yield
    finally:
        _default_main, _default_startup = saved


@contextlib.contextmanager
def name_scope(prefix=None):
    yield


def data(name, shape, dtype="float32", lod_level=0):
    """``paddle.static.data``: a named feed placeholder; a ``None`` or
    negative dim becomes 1 (the Executor runs each fed shape)."""
    shape = [1 if (s is None or s < 0) else int(s) for s in shape]
    t = make_placeholder(shape, dtype, ("feed", name), name)
    default_main_program()._feeds[name] = t
    return t
