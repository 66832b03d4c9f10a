"""The rest of ``paddle.static`` (counterpart of
``paddle_tpu/static/parity.py``).

The legacy multi-device machinery (``BuildStrategy``,
``ExecutionStrategy``, ``CompiledProgram``, ``ParallelExecutor``) stays an
accepted-config shell: the Executor's one CUDA graph per feed signature is
the build. The IPU names raise, as in the JAX package. Differentiation is
real: :func:`gradients` records one node whose evaluation re-runs the
sub-DAG of its targets and takes ``torch.autograd.grad`` over it, where
the JAX package runs ``jax.grad``.
"""
from __future__ import annotations

import contextlib
import os
import pickle

import numpy as np
import torch

from ..framework.place import CPUPlace, CUDAPlace
from ..framework.tape import apply
from ..framework.tensor import LazyTensor, Parameter, Tensor
from ..nn.layer.layers import ParamAttr as _ParamAttr
from . import executor as _executor
from .executor import _collect_graph, _eval_graph
from .io import _program_params, set_params
from .program import _meta, default_main_program, make_lazy_output
from .serde import _host

__all__ = [
    "Variable", "BuildStrategy", "ExecutionStrategy", "CompiledProgram",
    "ParallelExecutor", "IpuStrategy", "IpuCompiledProgram",
    "ipu_shard_guard", "set_ipu_shard", "ExponentialMovingAverage",
    "Print", "WeightNormParamAttr", "accuracy", "auc",
    "append_backward", "gradients", "cpu_places", "cuda_places",
    "npu_places", "xpu_places", "mlu_places", "create_global_var",
    "create_parameter", "ctr_metric_bundle", "device_guard",
    "exponential_decay", "load_from_file", "save_to_file",
    "load_program_state", "set_program_state", "normalize_program",
    "scope_guard", "serialize_persistables", "deserialize_persistables",
]

Variable = Tensor  # the reference's static Variable is the lazy Tensor


class _AttrBag:
    """Accept-anything config object (the reference's strategy protos)."""

    def __init__(self, **kw):
        self.__dict__.update(kw)

    def __setattr__(self, k, v):
        self.__dict__[k] = v

    def __getattr__(self, k):
        return self.__dict__.get(k)


class BuildStrategy(_AttrBag):
    """Graph-build knobs (reference build_strategy.h); recorded only: the
    Executor's capture is the build."""


class ExecutionStrategy(_AttrBag):
    """Executor knobs (num_threads etc.); recorded only."""


class CompiledProgram:
    """compiler.py CompiledProgram: wraps a Program and its strategies;
    the Executor's graph cache plays the role of the build."""

    def __init__(self, program, build_strategy=None):
        self.program = getattr(program, "program", program)
        self.build_strategy = build_strategy or BuildStrategy()
        self._places = None

    def with_data_parallel(self, loss_name=None, build_strategy=None,
                           exec_strategy=None, places=None):
        self.build_strategy = build_strategy or self.build_strategy
        self._places = places
        return self


class ParallelExecutor:
    """The legacy multi-device executor: an ``Executor`` over the (possibly
    compiled) main program."""

    def __init__(self, use_cuda=False, loss_name=None,
                 main_program=None, build_strategy=None,
                 exec_strategy=None, share_vars_from=None):
        self._exe = _executor.Executor()
        self._program = main_program or default_main_program()
        self.build_strategy = build_strategy

    def run(self, fetch_list=None, feed=None, return_numpy=True):
        return self._exe.run(self._program, feed=feed,
                             fetch_list=fetch_list,
                             return_numpy=return_numpy)


def _no_ipu(*a, **k):
    raise RuntimeError(
        "the IPU backend does not exist in the CUDA build; use the default "
        "path (remove IpuStrategy/IpuCompiledProgram usage)")


class IpuStrategy:
    __init__ = _no_ipu


class IpuCompiledProgram:
    __init__ = _no_ipu


def ipu_shard_guard(index=-1, stage=-1):
    _no_ipu()


def set_ipu_shard(call_func, index=-1, stage=-1):
    _no_ipu()


# ---------------------------------------------------------------------------
# differentiation (fluid/backward.py parity)
# ---------------------------------------------------------------------------

def _to_list(x):
    if x is None:
        return []
    return list(x) if isinstance(x, (list, tuple)) else [x]


def gradients(targets, inputs, target_gradients=None, no_grad_set=None):
    """Symbolic gradients of sum(targets) (each weighted by its entry of
    ``target_gradients``) with respect to ``inputs`` (fluid/backward.py
    :2147): one lazy Tensor per input. They evaluate by re-running the
    targets' sub-DAG under ``torch.autograd.grad`` when the Executor runs
    them. Inputs are ``static.data`` feeds or Parameters."""
    targets, inputs = _to_list(targets), _to_list(inputs)
    seeds = _to_list(target_gradients)
    specs = []
    for t in inputs:
        if isinstance(t, LazyTensor) and t._lazy[0] == "feed":
            specs.append(("feed", t._lazy[1]))
        elif isinstance(t, Parameter):
            specs.append(("param", id(t)))
        else:
            raise ValueError("gradients() inputs must be static.data feeds "
                             "or Parameters")
    nodes, params = _collect_graph(targets)
    feed_names = []
    for n in nodes:
        for a in n.args:
            if isinstance(a, LazyTensor) and a._lazy[0] == "feed" \
                    and a._lazy[1] not in feed_names:
                feed_names.append(a._lazy[1])
    for kind, key in specs:
        if kind == "feed" and key not in feed_names:
            feed_names.append(key)
    param_ids = [id(p) for p in params]
    for t, (kind, key) in zip(inputs, specs):
        if kind == "param" and key not in param_ids:
            params.append(t)
            param_ids.append(key)
    prog = default_main_program()
    feed_args = [prog._feeds[name] for name in feed_names]
    nf = len(feed_names)

    def grad_fn(*vals):
        fv = dict(zip(feed_names, vals[:nf]))
        pv = dict(zip(param_ids, vals[nf:]))
        with torch.enable_grad():
            wrt = []
            for kind, key in specs:
                src = fv if kind == "feed" else pv
                src[key] = src[key].detach().requires_grad_(True)
                wrt.append(src[key])
            outs = _eval_graph(targets, fv, pv, nodes=nodes,
                               differentiated=inputs)
            total = 0.0
            for i, o in enumerate(outs):
                seed = seeds[i] if i < len(seeds) else None
                if seed is None:
                    total = total + o.sum()
                else:
                    s = seed._value if isinstance(seed, Tensor) \
                        else torch.as_tensor(np.asarray(seed))
                    total = total + (o * s.to(o.device, o.dtype)).sum()
            got = torch.autograd.grad(total, wrt, allow_unused=True)
        return tuple(torch.zeros_like(w) if g is None else g.detach()
                     for w, g in zip(wrt, got))

    outs = make_lazy_output(grad_fn, feed_args + params, {}, "gradients",
                            out_avals=[_meta(t) for t in inputs])
    return list(outs)


def append_backward(loss, parameter_list=None, no_grad_set=None,
                    callbacks=None, checkpoints=None):
    """fluid/backward.py:1427: ``[(param, grad_var)]`` for every trainable
    parameter ``loss`` reads."""
    if parameter_list:
        params = list(parameter_list)
    else:
        params = [p for p in _collect_graph([loss])[1] if p.trainable]
    if not params:
        return []
    return list(zip(params, gradients([loss], params)))


# ---------------------------------------------------------------------------
# misc ops / helpers
# ---------------------------------------------------------------------------

def Print(input, first_n=-1, message=None, summarize=20,
          print_tensor_name=True, print_tensor_type=True,
          print_tensor_shape=True, print_tensor_layout=True,
          print_tensor_lod=True, print_phase="both"):
    """In-graph debug print (fluid/layers Print op): prints the value
    when the program runs and passes the tensor through. The print reads
    the value on the host, so on the card the Executor's capture refuses
    it (a host sync raises)."""
    tag = message or "Print"

    def f(v):
        if not v.is_meta:
            print(f"{tag}: {v}")
        return v

    return apply(f, input, op_name="print")


class WeightNormParamAttr(_ParamAttr):
    """ParamAttr carrying a weight-norm dim (reference
    WeightNormParamAttr)."""

    def __init__(self, dim=None, **kw):
        super().__init__(**kw)
        self.dim = dim


def accuracy(input, label, k=1, correct=None, total=None, name=None):
    """Top-k accuracy of the scores (fluid/layers accuracy)."""

    def f(pred, lab):
        topk = torch.argsort(-pred, dim=-1, stable=True)[..., :k]
        hit = (topk == lab.reshape(-1, 1)).any(-1)
        return hit.float().mean()

    return apply(f, input, label, op_name="accuracy")


def _auc_value(pred, lab, num_thresholds):
    p = pred[..., -1] if pred.ndim > 1 else pred
    lab_f = lab.reshape(-1).float()
    bins = (p.reshape(-1) * num_thresholds).to(torch.int32).clamp(
        0, num_thresholds).long()
    zeros = torch.zeros(num_thresholds + 1, device=p.device)
    pos = zeros.index_add(0, bins, lab_f)
    neg = zeros.index_add(0, bins, 1.0 - lab_f)
    # integrate from the high-score end (trapezoid on ranks)
    tp = pos.flip(0).cumsum(0)
    fp = neg.flip(0).cumsum(0)
    tot_pos, tot_neg = tp[-1], fp[-1]
    area = ((fp[1:] - fp[:-1]) * (tp[1:] + tp[:-1]) / 2.0).sum()
    denom = tot_pos * tot_neg
    return torch.where(denom > 0, area / denom.clamp_min(1e-30),
                       torch.zeros((), device=p.device))


def auc(input, label, curve="ROC", num_thresholds=4095, topk=1,
        slide_steps=1, ins_tag_weight=None):
    """Batch ROC AUC from thresholded TP/FP histograms (fluid/layers auc).
    Returns (auc_value, batch_auc_value, [stat_pos, stat_neg]) like the
    reference."""
    a = apply(lambda pred, lab: _auc_value(pred, lab, num_thresholds),
              input, label, op_name="auc")
    return a, a, [a, a]


def ctr_metric_bundle(input, label, ins_tag_weight=None):
    """CTR eval bundle (reference ctr_metric_bundle), condensed to what
    exists without parameter-server state: (auc, batch_auc, rmse)."""
    a, b, _ = auc(input, label)

    def f(pred, lab):
        p = pred[..., -1] if pred.ndim > 1 else pred
        err = p.reshape(-1) - lab.reshape(-1).float()
        return (err * err).mean().sqrt()

    return a, b, apply(f, input, label, op_name="ctr_rmse")


def cpu_places(device_count=None):
    n = device_count or int(os.environ.get("CPU_NUM", 1))
    return [CPUPlace() for _ in range(n)]


def cuda_places(device_ids=None):
    """The cards' places (every card for None)."""
    if device_ids is None:
        device_ids = range(torch.cuda.device_count())
    return [CUDAPlace(int(i)) for i in device_ids]


def npu_places(device_ids=None):
    return cuda_places(device_ids)


def xpu_places(device_ids=None):
    return cuda_places(device_ids)


def mlu_places(device_ids=None):
    return cuda_places(device_ids)


def create_global_var(shape, value, dtype, persistable=False,
                      force_cpu=False, name=None):
    """A constant-filled global variable (fluid/layers), on the current
    place."""
    p = Parameter(np.full(tuple(shape), value), dtype=dtype, name=name,
                  trainable=False)
    p.persistable = persistable
    return p


def create_parameter(shape, dtype, name=None, attr=None, is_bias=False,
                     default_initializer=None):
    """Standalone parameter factory (reference layers/create_parameter):
    ``default_initializer``, else zeros for a bias and Xavier normal for a
    weight."""
    from ..nn.initializer import Constant, XavierNormal
    init = default_initializer or (Constant(0.0) if is_bias
                                   else XavierNormal())
    return Parameter(init(list(shape), dtype), name=name)


@contextlib.contextmanager
def device_guard(device=None):
    """Op placement hint (framework.py device_guard); accepted, unused:
    the Executor runs the whole program on its place."""
    yield


@contextlib.contextmanager
def scope_guard(scope):
    """Swap the global scope (executor.py scope_guard)."""
    old = _executor._global_scope
    _executor._global_scope = scope
    try:
        yield
    finally:
        _executor._global_scope = old


def exponential_decay(learning_rate, decay_steps, decay_rate,
                      staircase=False):
    """Legacy lr helper -> the ExponentialDecay scheduler."""
    from ..optimizer.lr import ExponentialDecay
    sched = ExponentialDecay(learning_rate=learning_rate, gamma=decay_rate)
    sched._decay_steps = decay_steps
    sched._staircase = staircase
    return sched


def save_to_file(path, content):
    if not isinstance(content, bytes):
        raise TypeError("save_to_file expects bytes")
    with open(path, "wb") as f:
        f.write(content)


def load_from_file(path):
    with open(path, "rb") as f:
        return f.read()


def serialize_persistables(feed_vars, fetch_vars, executor=None):
    """The parameters ``fetch_vars`` read -> bytes (static/io.py
    serialize_persistables): ``{name: (array, dtype name)}`` pickled."""
    params = _collect_graph(_to_list(fetch_vars))[1]
    state = {p.name or f"param_{i}": _host(p._value)
             for i, p in enumerate(params)}
    return pickle.dumps(state, protocol=4)


def deserialize_persistables(program, data, executor=None):
    """Bytes from :func:`serialize_persistables` -> the program's
    parameters, in place; returns them by name."""
    state = pickle.loads(data)
    set_params(program, {k: torch.from_numpy(np.array(a)).to(
        getattr(torch, dt)) for k, (a, dt) in state.items()})
    return {p.name: p for p in _program_params(program) if p.name}


def load_program_state(model_path, var_list=None):
    """``model_path`` prefix -> {name: ndarray} (io.py
    load_program_state)."""
    from ..framework import io as fio
    state = fio.load(model_path + ".pdparams", return_numpy=True)
    return {k: np.asarray(v) for k, v in state.items()}


def set_program_state(program, state_dict):
    """Copy ``state_dict`` into the program's parameters, in place."""
    set_params(program, state_dict)


def normalize_program(program, feed_vars, fetch_vars):
    """Prune/normalize for serving (static/io.py normalize_program): checks
    and records the feeds and fetches; the Executor prunes to the fetches
    anyway, so the program returns unchanged."""
    for v in _to_list(feed_vars):
        if not (isinstance(v, LazyTensor) and v._lazy[0] == "feed"):
            raise ValueError("feed_vars must be static.data variables")
    program._normalized_fetches = _to_list(fetch_vars)
    return program


# ---------------------------------------------------------------------------
# ExponentialMovingAverage (fluid/optimizer.py:ExponentialMovingAverage)
# ---------------------------------------------------------------------------

class ExponentialMovingAverage:
    """Shadow-parameter EMA with apply/restore guards; the parameters are
    written in place (a captured graph keeps reading them)."""

    def __init__(self, decay=0.999, thres_steps=None, name=None,
                 parameter_list=None):
        self._decay = decay
        self._thres_steps = thres_steps
        self._params = list(parameter_list or [])
        self._shadow = {}
        self._backup = {}
        self._step = 0

    def _ensure_params(self):
        if not self._params:
            raise ValueError("pass parameter_list= (there is no global "
                             "parameter registry to scan)")

    @torch.no_grad()
    def update(self):
        self._ensure_params()
        self._step += 1
        # constant decay by default; the TF-style warmup ramp only when
        # thres_steps is asked for (reference semantics)
        d = self._decay if self._thres_steps is None else min(
            self._decay, (1 + self._step) / (10 + self._step))
        for p in self._params:
            v = p._value.detach()
            s = self._shadow.get(id(p))
            self._shadow[id(p)] = v.clone() if s is None \
                else d * s + (1 - d) * v

    @contextlib.contextmanager
    def apply(self, executor=None, need_restore=True):
        self._ensure_params()
        with torch.no_grad():
            for p in self._params:
                self._backup[id(p)] = p._value.detach().clone()
                if id(p) in self._shadow:
                    p._value.copy_(self._shadow[id(p)])
        try:
            yield
        finally:
            if need_restore:
                self.restore()

    @torch.no_grad()
    def restore(self, executor=None):
        for p in self._params:
            if id(p) in self._backup:
                p._value.copy_(self._backup.pop(id(p)))
