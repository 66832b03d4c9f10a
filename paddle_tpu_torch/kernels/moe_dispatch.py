"""Fused MoE dispatch and combine: hand-written CUDA kernels and their plain
versions.

Counterpart of ``paddle_tpu/kernels/moe_dispatch.py``. Two kernels of
``csrc/moe_dispatch.cu`` replace the two Pallas kernels there:

- ``_dispatch_kernel``: :func:`fused_moe_dispatch` — the top-k gate
  (f32 logits, f32 softmax, top-k with ties to the lowest index), GShard's
  priority-major capacity-clamped slots and the scatter of token rows into
  ``[E, C, M]``, in one C call: one launch at decode sizes, three passes
  above them (:func:`dispatch_route`);
- ``_combine_kernel``: :func:`fused_moe_combine` — the weighted gather-sum
  back to token order, with the Pallas kernel's rounding points.

Plain versions: :func:`reference_moe_dispatch` and
:func:`reference_moe_combine` (the JAX references, line by line), and
:func:`combine_kernel_reference`, the combine with the kernel's rounding
points (``val`` cast to the output dtype, each product and add rounded in k
order), which the JAX engine runs through the Pallas kernel.

Gate kinds (the combine weight of the k-th choice):

========= ===========================================================
kind      combine weight
========= ===========================================================
naive     the raw gate logit
switch    the softmax probability
gshard    probability / (sum of the top-k probabilities + 1e-9)
renorm    probability / max(sum of the top-k probabilities, 1e-9)
========= ===========================================================

Both ops are ``torch.autograd.Function``s whose backward recomputes through
the plain reference, as the JAX ``custom_vjp``s do.

Dispatch: CPU tensors take the plain version; CUDA tensors launch the
kernel or raise. ``dispatch_launches`` and ``combine_launches`` count
C calls (the three-pass dispatch is three kernels in one call). The f32
gate product of the plain version on the card needs
``torch.backends.cuda.matmul.allow_tf32`` False, PyTorch's default.
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from . import _build

__all__ = ["fused_moe_dispatch", "fused_moe_combine",
           "reference_moe_dispatch", "reference_moe_combine",
           "combine_kernel_reference", "dispatch_indices", "dispatch_route",
           "gate_logits", "near_ties", "GATE_KINDS", "DISPATCH_ROUTES"]

GATE_KINDS = ("naive", "switch", "gshard", "renorm")
_NEG_INF = -1e30
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_TOKENS_PER_BLOCK = 32       # the gate pass's block (csrc/moe_dispatch.cu)
_MAX_EXPERTS = 512          # the gate pass keeps 2 x 32 x E floats in shared memory
# the dispatch's routes, by their code in the C entry
DISPATCH_ROUTES = ("one_launch", "three_pass")
# The switch point: S up to this takes the one-launch route, where every
# block routes all S tokens itself, so its time grows with S. chip_smoke.py's
# route sweep (M = 768, E = 8, top-2, C = S, bf16; an H100 80GB HBM3 at
# 700 W): one launch 0.0442 ms against three passes 0.0466 at S = 128,
# 0.0467 against 0.0466 at S = 130 (PERF.md).
_ONE_LAUNCH_MAX_S = 128
_ONE_LAUNCH_MAX_E = 32       # one lane per expert
_ONE_LAUNCH_SMEM = 48 * 1024  # its shared memory, without an opt-in
_forced_route = None         # set only inside _dispatch_route

# kernel launches (C calls) since each counter was last set to 0
dispatch_launches = 0
combine_launches = 0


# ---------------------------------------------------------------- plain

def dispatch_indices(idx, *, num_expert, capacity):
    """GShard's priority-major, capacity-clamped slot rule. ``idx [S, k]``
    int expert choices (k in priority order). Returns ``slot_token
    [E*C]`` int32 (the token feeding each expert slot; ``S`` = empty, the
    zero pad row) and ``comb_idx [S, k]`` int32 (``expert*C + slot`` per
    choice; ``E*C`` = dropped). All first choices claim slots before any
    second choice; ties in token order."""
    S, k = idx.shape
    E, C = int(num_expert), int(capacity)
    e_f = idx.t().reshape(-1).long()                       # [k*S] priority-major
    oh = F.one_hot(e_f, E)                                 # [k*S, E]
    pos = torch.cumsum(oh, 0) - 1
    slot_f = pos.gather(1, e_f[:, None])[:, 0]
    within = slot_f < C
    token_f = torch.arange(S, device=idx.device).repeat(k)
    flat_ec = torch.where(within, e_f * C + slot_f,
                          torch.full_like(e_f, E * C))
    # every kept choice has a slot of its own; the dropped ones all land on
    # one extra slot, cut off (no mask indexing: nothing waits for the
    # device)
    slot_token = torch.full((E * C + 1,), S, dtype=torch.int32,
                            device=idx.device)
    slot_token.scatter_(0, flat_ec, token_f.to(torch.int32))
    return slot_token[:E * C], flat_ec.reshape(k, S).t().to(torch.int32)


def _top_k(scores, k):
    """Top-k by masked-argmax rounds, ties to the lowest index (as
    ``lax.top_k``; ``torch.argmax`` returns the first maximum). Returns
    ``(values, indices int64)``."""
    work = scores
    idxs = []
    for _ in range(int(k)):
        sel = torch.argmax(work, -1, keepdim=True)
        idxs.append(sel)
        work = work.scatter(-1, sel, _NEG_INF)
    idx = torch.cat(idxs, -1)
    return scores.gather(-1, idx), idx


def _gate_values(logits, probs, kind, top_k):
    """Top-k over the logits and the combine weights of one gate kind (the
    table in the module docstring). Returns ``(val f32 [S, k], idx int32
    [S, k])``."""
    lv, idx = _top_k(logits, top_k)
    pv = probs.gather(1, idx)
    if kind == "naive":
        val = lv.float()
    elif kind == "switch":
        val = pv
    elif kind == "gshard":
        val = pv / (pv.sum(-1, keepdim=True) + 1e-9)
    elif kind == "renorm":
        val = pv / pv.sum(-1, keepdim=True).clamp_min(1e-9)
    else:
        raise ValueError(f"gate_kind {kind!r} not in {GATE_KINDS}")
    return val, idx.to(torch.int32)


def gate_logits(x, gate_w, gate_b):
    """The f32 gate logits ``x @ gate_w + gate_b`` ``[S, E]``."""
    return x.float() @ gate_w.float() + gate_b.float()


def near_ties(logits, top_k, gap=1e-5):
    """``[S]`` bool: the tokens whose routing a rounding of the gate product
    can change, where the i-th and (i+1)-th largest logits, i <= top_k,
    lie within ``gap``. Elsewhere a kernel must pick exactly the plain
    version's experts, in the same order."""
    s = logits.float().sort(-1, descending=True).values[:, :top_k + 1]
    return (s[:, :-1] - s[:, 1:] < gap).any(-1)


def reference_moe_dispatch(x, gate_w, gate_b, *, num_expert, capacity,
                           top_k, gate_kind="gshard"):
    """Plain PyTorch version of :func:`fused_moe_dispatch` (the JAX
    reference): ``x [S, M]``, ``gate_w [M, E]``, ``gate_b [E]``. Returns
    ``(expert_in [E, C, M] in x's dtype, comb_idx [S, k] int32, val [S, k]
    f32, me [E] f32, ce [E] f32)``."""
    S, M = x.shape
    E, C = int(num_expert), int(capacity)
    logits = gate_logits(x, gate_w, gate_b)
    probs = torch.softmax(logits, -1)
    val, idx = _gate_values(logits, probs, gate_kind, top_k)
    slot_token, comb_idx = dispatch_indices(idx, num_expert=E, capacity=C)
    xp = torch.cat([x, x.new_zeros(1, M)], 0)
    expert_in = xp[slot_token.long()].reshape(E, C, M)
    me = probs.mean(0)
    ce = F.one_hot(idx[:, 0].long(), E).float().mean(0)
    return expert_in, comb_idx, val, me, ce


def reference_moe_combine(expert_out_flat, val, comb_idx):
    """Plain PyTorch version of :func:`fused_moe_combine` (the JAX
    reference): ``y[s] = sum_k val[s,k] * expert_out_flat[comb_idx[s,k]]``
    as one einsum in the rows' dtype, the ``E*C`` sentinel reading a zero
    pad row."""
    ep = torch.cat([expert_out_flat,
                    expert_out_flat.new_zeros(1, expert_out_flat.shape[-1])])
    g = ep[comb_idx.long()]                                  # [S, k, M]
    return torch.einsum("skm,sk->sm", g, val.to(g.dtype))


def combine_kernel_reference(expert_out_flat, val, comb_idx):
    """The combine with the Pallas kernel's rounding points (the form the
    JAX engine runs): ``y = 0``; for each k in order, where the index is not
    the sentinel, ``y = y + val[:, k].to(dtype) * row``, the product and the
    sum each rounded to the rows' dtype."""
    EC, M = expert_out_flat.shape
    dt = expert_out_flat.dtype
    y = expert_out_flat.new_zeros(comb_idx.shape[0], M)
    for k in range(comb_idx.shape[1]):
        c = comb_idx[:, k].long()
        keep = (c < EC)[:, None]
        row = expert_out_flat[c.clamp_max(EC - 1)]
        y = torch.where(keep, y + val[:, k].to(dt)[:, None] * row, y)
    return y


# --------------------------------------------------------------- kernels

def _vec_ok(*rows):
    """16-byte vector access: every ``(tensor, row stride)`` has a 16-byte
    aligned base and rows a multiple of 16 bytes apart, and its rows are."""
    for t, rs in rows:
        es = t.element_size()
        if t.data_ptr() % 16 or (rs * es) % 16 or (t.shape[-1] * es) % 16:
            return False
    return True


def _one_launch_fits(S, E, K):
    """The one-launch kernel's limits (``one_launch_fits`` in the source):
    a lane per expert, and its routing arrays (3SK + SE + 64 words, in
    16-byte units) within 48 KB of shared memory."""
    words = -(-(3 * S * K + S * E + 64) // 4) * 4
    return E <= _ONE_LAUNCH_MAX_E and 4 * words <= _ONE_LAUNCH_SMEM


def dispatch_route(S, E, K):
    """The route the dispatch kernel takes for ``S`` tokens, ``E`` experts
    and top-``K``, from the shapes alone: ``"one_launch"`` at decode sizes
    (``S <= _ONE_LAUNCH_MAX_S``, ``E <= 32``), else ``"three_pass"``;
    inside :func:`_dispatch_route`, the route it names."""
    if _forced_route is not None:
        return _forced_route
    if S <= _ONE_LAUNCH_MAX_S and _one_launch_fits(S, E, K):
        return "one_launch"
    return "three_pass"


@contextlib.contextmanager
def _dispatch_route(route):
    """Every dispatch launch inside takes ``route`` (the one-launch route
    raises where its limits are exceeded): how ``chip_smoke.py`` and the
    card tests time and check both routes at one shape. No launch of the
    program sets it."""
    global _forced_route
    if route not in DISPATCH_ROUTES:
        raise ValueError(f"route {route!r} not in {DISPATCH_ROUTES}")
    prev, _forced_route = _forced_route, route
    try:
        yield
    finally:
        _forced_route = prev


def _check_cuda(name, ts):
    dev = ts[0].device
    for t in ts:
        if t.device != dev:
            raise ValueError(f"{name}: operands on {t.device} and {dev}")


def _launch_dispatch(x, gate_w, gate_b, E, C, K, kind):
    """The dispatch kernel on CUDA tensors, on :func:`dispatch_route`'s
    route. Returns the five outputs and the kernel's chosen experts
    ``[S, k]`` int32."""
    global dispatch_launches
    _check_cuda("fused_moe_dispatch", (x, gate_w, gate_b))
    if x.dim() != 2 or gate_w.dim() != 2 or gate_b.dim() != 1:
        raise ValueError(f"x [S, M], gate_w [M, E], gate_b [E] expected, got "
                         f"{tuple(x.shape)}, {tuple(gate_w.shape)}, "
                         f"{tuple(gate_b.shape)}")
    S, M = x.shape
    if tuple(gate_w.shape) != (M, E) or tuple(gate_b.shape) != (E,):
        raise ValueError(f"gate_w {tuple(gate_w.shape)} / gate_b "
                         f"{tuple(gate_b.shape)} do not match M={M}, E={E}")
    if x.dtype not in _DTYPE_CODES or gate_w.dtype not in _DTYPE_CODES:
        raise TypeError(f"dispatch kernel takes float32 or bfloat16 x and "
                        f"gate_w, got {x.dtype}, {gate_w.dtype}")
    if gate_b.dtype not in _DTYPE_CODES:   # the kernel widens f32 or bf16
        gate_b = gate_b.float()             # as it is; others as JAX does
    if x.stride(1) != 1 or not (gate_w.is_contiguous()
                                and gate_b.is_contiguous()):
        raise ValueError("dispatch kernel needs x with unit stride along M "
                         "and contiguous gate_w and gate_b")
    if not 0 < E <= _MAX_EXPERTS or not 0 < K <= E or C < 1 or S < 1:
        raise ValueError(f"dispatch kernel takes 1 <= top_k <= num_expert <= "
                         f"{_MAX_EXPERTS}, capacity >= 1 and S >= 1, got "
                         f"E={E}, K={K}, C={C}, S={S}")
    if max(E * C, S) * max(M, x.stride(0)) >= 2 ** 62:
        raise ValueError("dispatch too large for the kernel's indexing")
    dev = x.device
    out = torch.empty((E * C, M), dtype=x.dtype, device=dev)
    comb = torch.empty((S, K), dtype=torch.int32, device=dev)
    val = torch.empty((S, K), dtype=torch.float32, device=dev)
    me = torch.empty((E,), dtype=torch.float32, device=dev)
    ce = torch.empty((E,), dtype=torch.float32, device=dev)
    idx = torch.empty((S, K), dtype=torch.int32, device=dev)
    route = dispatch_route(S, E, K)
    if route == "one_launch":
        if not _one_launch_fits(S, E, K):
            raise ValueError(f"the one-launch dispatch takes E <= "
                             f"{_ONE_LAUNCH_MAX_E} and its routing arrays "
                             f"within {_ONE_LAUNCH_SMEM} bytes, got S={S}, "
                             f"E={E}, K={K}")
        words, work_ptr = 0, None
    else:                   # the three passes' scratch (csrc, Work)
        nblk = -(-S // _TOKENS_PER_BLOCK)
        words = 2 * K * nblk * E + E
        words += words & 1
        words += 2 * nblk * E
        work = torch.empty((words,), dtype=torch.int32, device=dev)
        work_ptr = work.data_ptr()
    vec = _vec_ok((x, x.stride(0)), (out, M))
    with torch.cuda.device(dev):
        err = _build.load_library().ptt_moe_dispatch(
            x.data_ptr(), gate_w.data_ptr(), gate_b.data_ptr(),
            out.data_ptr(), comb.data_ptr(), val.data_ptr(), me.data_ptr(),
            ce.data_ptr(), idx.data_ptr(), work_ptr, words,
            _DTYPE_CODES[x.dtype], _DTYPE_CODES[gate_w.dtype],
            _DTYPE_CODES[gate_b.dtype], S, M, x.stride(0), E, K, C,
            GATE_KINDS.index(kind), int(vec), DISPATCH_ROUTES.index(route),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "fused_moe_dispatch")
    dispatch_launches += 1
    return (out.view(E, C, M), comb, val, me, ce), idx


def _dispatch(x, gate_w, gate_b, E, C, K, kind):
    ts = (x, gate_w, gate_b)
    if all(t.device.type == "cpu" for t in ts):
        return reference_moe_dispatch(x, gate_w, gate_b, num_expert=E,
                                      capacity=C, top_k=K, gate_kind=kind)
    if not all(t.is_cuda for t in ts):
        raise ValueError("fused_moe_dispatch runs on CUDA or CPU tensors, "
                         "got " + ", ".join(str(t.device) for t in ts))
    return _launch_dispatch(x, gate_w, gate_b, E, C, K, kind)[0]


def _launch_combine(expert_out_flat, val, comb_idx):
    global combine_launches
    _check_cuda("fused_moe_combine", (expert_out_flat, val, comb_idx))
    if expert_out_flat.dim() != 2 or val.dim() != 2 \
            or tuple(val.shape) != tuple(comb_idx.shape):
        raise ValueError(f"expert_out_flat [E*C, M], val and comb_idx [S, k] "
                         f"expected, got {tuple(expert_out_flat.shape)}, "
                         f"{tuple(val.shape)}, {tuple(comb_idx.shape)}")
    if expert_out_flat.dtype not in _DTYPE_CODES:
        raise TypeError(f"combine kernel takes float32 or bfloat16 rows, got "
                        f"{expert_out_flat.dtype}")
    eo = expert_out_flat.contiguous()
    val = val.float().contiguous()
    comb = comb_idx.to(torch.int32).contiguous()
    EC, M = eo.shape
    S, K = comb.shape
    if max(EC, S) * M >= 2 ** 62 or S < 1:
        raise ValueError(f"combine of S={S} rows of {M} not supported")
    y = torch.empty((S, M), dtype=eo.dtype, device=eo.device)
    vec = _vec_ok((eo, M), (y, M))
    with torch.cuda.device(eo.device):
        err = _build.load_library().ptt_moe_combine(
            eo.data_ptr(), val.data_ptr(), comb.data_ptr(), y.data_ptr(),
            _DTYPE_CODES[eo.dtype], S, M, K, EC, int(vec),
            torch.cuda.current_stream(eo.device).cuda_stream)
    _build.check(err, "fused_moe_combine")
    combine_launches += 1
    return y


def _combine(expert_out_flat, val, comb_idx):
    ts = (expert_out_flat, val, comb_idx)
    if all(t.device.type == "cpu" for t in ts):
        return combine_kernel_reference(expert_out_flat, val, comb_idx)
    if not all(t.is_cuda for t in ts):
        raise ValueError("fused_moe_combine runs on CUDA or CPU tensors, got "
                         + ", ".join(str(t.device) for t in ts))
    return _launch_combine(expert_out_flat, val, comb_idx)


# --------------------------------------------------------------- autograd

class _FusedDispatch(torch.autograd.Function):
    """The JAX ``_fused_dispatch`` ``custom_vjp``: the kernel forward; the
    backward recomputes through :func:`reference_moe_dispatch`."""

    @staticmethod
    def forward(ctx, x, gate_w, gate_b, E, C, K, kind):
        out = _dispatch(x, gate_w, gate_b, E, C, K, kind)
        ctx.save_for_backward(x, gate_w, gate_b)
        ctx.args = (E, C, K, kind)
        ctx.mark_non_differentiable(out[1], out[4])
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, d_in, _d_comb, d_val, d_me, _d_ce):
        E, C, K, kind = ctx.args
        with torch.enable_grad():
            prim = [t.detach().requires_grad_() for t in ctx.saved_tensors]
            ei, _, val, me, _ = reference_moe_dispatch(
                *prim, num_expert=E, capacity=C, top_k=K, gate_kind=kind)
            outs, cts = [], []
            for o, g in ((ei, d_in), (val, d_val), (me, d_me)):
                if g is not None:
                    outs.append(o)
                    cts.append(g)
            grads = torch.autograd.grad(outs, prim, cts, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(prim, grads)]
        return (*grads, None, None, None, None)


class _FusedCombine(torch.autograd.Function):
    """The JAX ``_fused_combine`` ``custom_vjp``: the kernel forward; the
    backward recomputes through :func:`reference_moe_combine`."""

    @staticmethod
    def forward(ctx, expert_out_flat, val, comb_idx):
        ctx.save_for_backward(expert_out_flat, val, comb_idx)
        return _combine(expert_out_flat, val, comb_idx)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy):
        eo, val, comb_idx = ctx.saved_tensors
        with torch.enable_grad():
            eo_, val_ = eo.detach().requires_grad_(), \
                val.detach().requires_grad_()
            y = reference_moe_combine(eo_, val_, comb_idx)
            d_eo, d_val = torch.autograd.grad(y, (eo_, val_), dy)
        return d_eo, d_val, None


def fused_moe_dispatch(x, gate_w, gate_b, *, num_expert, capacity, top_k,
                       gate_kind="gshard"):
    """Fused gate + capacity-clamped scatter: ``x [S, M]``, ``gate_w [M,
    E]``, ``gate_b [E]`` → ``(expert_in [E, C, M], comb_idx [S, k] int32,
    val [S, k] f32, me [E] f32, ce [E] f32)``; ``me``/``ce`` are the aux-loss
    sums (mean softmax probability / top-1 load share per expert).
    Differentiable in ``x``, ``gate_w`` and ``gate_b``."""
    if gate_kind not in GATE_KINDS:
        raise ValueError(f"gate_kind {gate_kind!r} not in {GATE_KINDS}")
    if top_k > num_expert:
        raise ValueError(f"top_k {top_k} > num_expert {num_expert}")
    return _FusedDispatch.apply(x, gate_w, gate_b, int(num_expert),
                                int(capacity), int(top_k), gate_kind)


def fused_moe_combine(expert_out_flat, val, comb_idx):
    """Fused weighted gather-sum back to token order: ``y[s] = sum_k
    val[s,k] * expert_out_flat[comb_idx[s,k]]``, the ``E*C`` sentinel
    contributing nothing, rounded as the Pallas kernel rounds
    (:func:`combine_kernel_reference`). Differentiable in
    ``expert_out_flat`` and ``val``."""
    return _FusedCombine.apply(expert_out_flat, val, comb_idx)
