"""``auto_cast`` (a copy of ``paddle_tpu/amp/auto_cast.py``'s O1 rules).

The JAX package casts inside its op dispatch: under an active
``auto_cast``, an op whose name is on the white list gets its float32
inputs cast to the low dtype, an op on the black list gets its low-dtype
inputs cast to float32, and every other op runs in the dtype it is given,
mixed operands promoting as usual. The port has no op dispatch layer, so
each module calls :func:`amp_cast` with the op's paddle name at the point
where the JAX tape would cast: ``Linear`` ("linear"), the layer norm
("layer_norm"), attention ("flash_attention" or
"scaled_dot_product_attention"), the MoE experts' batched products
("einsum"), the gates' softmax ("softmax"), the tied MLM head ("matmul").
``torch.autocast`` is not used: its op lists are not paddle's.
"""
from __future__ import annotations

import contextlib

import torch

__all__ = ["auto_cast", "amp_guard", "amp_cast", "cast_rule",
           "cast_by_rule", "current_amp_state", "WHITE_LIST", "BLACK_LIST"]

# the JAX package's O1 lists (paddle's imperative/amp_auto_cast.cc)
WHITE_LIST = {
    "matmul", "linear", "mm", "bmm", "mv", "einsum", "conv1d", "conv2d",
    "conv3d", "conv1d_transpose", "conv2d_transpose", "conv3d_transpose",
    "flash_attention", "scaled_dot_product_attention", "addmm",
}
BLACK_LIST = {
    "exp", "log", "log2", "log10", "log1p", "pow", "square", "sqrt", "rsqrt",
    "softmax", "log_softmax", "cross_entropy", "nll_loss", "mse_loss",
    "l1_loss", "bce_with_logits", "binary_cross_entropy", "mean", "sum",
    "norm", "layer_norm", "batch_norm", "group_norm", "instance_norm",
    "rms_norm", "logsumexp", "cumsum", "softmax_with_cross_entropy",
}

_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16}


class _AmpState:
    __slots__ = ("enable", "dtype", "level", "custom_white", "custom_black")

    def __init__(self, enable=False, dtype="float16", level="O1",
                 custom_white=None, custom_black=None):
        if dtype not in _DTYPES:
            raise ValueError(f"auto_cast dtype {dtype!r} not in "
                             f"{sorted(_DTYPES)}")
        if level not in ("O1", "O2"):
            raise ValueError("level must be O1 or O2")
        self.enable = bool(enable)
        self.dtype = dtype
        self.level = level
        self.custom_white = set(custom_white or ())
        self.custom_black = set(custom_black or ())


_state = _AmpState()


def current_amp_state() -> _AmpState:
    return _state


@contextlib.contextmanager
def auto_cast(enable=True, custom_white_list=None, custom_black_list=None,
              level="O1", dtype="bfloat16"):
    """``paddle.amp.auto_cast``: inside, :func:`amp_cast` casts by the
    lists (the JAX package's default dtype, bfloat16)."""
    with _entered(_AmpState(enable, dtype, level, custom_white_list,
                            custom_black_list)):
        yield


amp_guard = auto_cast


@contextlib.contextmanager
def _entered(state):
    """Make ``state`` the active one inside (also how a recompute under
    ``torch.utils.checkpoint`` casts as its forward did)."""
    global _state
    saved, _state = _state, state
    try:
        yield
    finally:
        _state = saved


def cast_rule(op_name):
    """What the active ``auto_cast`` does to the inputs of op ``op_name``:
    ``("white", low)`` (float32 inputs to ``low``), ``("black", low)``
    (``low`` inputs to float32), or None. A static program fixes this at
    record time (:class:`paddle_tpu_torch.framework.tape.AmpWrappedOp`)."""
    st = _state
    if not st.enable:
        return None
    black = op_name in BLACK_LIST or op_name in st.custom_black
    white = (op_name in WHITE_LIST or op_name in st.custom_white) \
        and op_name not in st.custom_black
    if white:
        return "white", _DTYPES[st.dtype]
    if black:
        return "black", _DTYPES[st.dtype]
    return None


def cast_by_rule(rule, tensors):
    """``tensors`` cast by a :func:`cast_rule` (None casts nothing);
    ``None`` and non-float inputs unchanged. Returns a tuple."""
    if rule is None:
        return tuple(tensors)
    mode, low = rule
    src, dst = (torch.float32, low) if mode == "white" \
        else (low, torch.float32)
    return tuple(t.to(dst) if isinstance(t, torch.Tensor) and t.dtype == src
                 else t for t in tensors)


def amp_cast(op_name, *tensors):
    """The inputs of op ``op_name`` as the JAX tape hands them to it: under
    an active ``auto_cast``, float32 tensors cast to the low dtype for a
    white-list op, low-dtype tensors cast to float32 for a black-list op;
    otherwise (and for ``None`` and non-float inputs) unchanged. Returns a
    tuple."""
    return cast_by_rule(cast_rule(op_name), tensors)
