"""``paddle_tpu_torch.nn.functional`` against ``paddle_tpu.nn.functional``
on the CPU, case by case on the same numpy inputs: every name of the
activation, common, norm, loss and attention modules. Each case is one
function of the package ``P`` (either), so both run the same call: the
value, and for float outputs the gradient of ``sum(out * w)`` (``w`` a
fixed random array) against the JAX tape's.

The random functionals (dropout at p > 0, ``alpha_dropout``, ``rrelu`` in
training, ``gumbel_softmax``, attention dropout, ``class_center_sample``'s
negatives) draw other numbers than JAX from one seed: they are held to
their distributions (kept share within 4 sigma of ``1 - p`` over >= 20000
draws) and to the exact values each kept or dropped element must take.
``nn.functional``'s closure: every public name of the JAX package's
``nn.functional`` is ported but the convolutions, poolings and extras
(``NOT_PORTED``, ROADMAP Queue 1).

Tolerances (f32): values rtol 1e-5, atol 1e-6; reductions, losses and
gradients rtol 1e-5, atol 1e-5; the resizes' weights sum in other orders
(rtol 1e-5, atol 1e-5); integer results exactly.
"""
import numpy as np
import pytest

import paddle_tpu as jp
import paddle_tpu_torch as tp
from paddle_tpu_torch.framework import place as tplace

ELEM = dict(rtol=1e-5, atol=1e-6)
RED = dict(rtol=1e-5, atol=1e-5)
E, R = "elementwise", "reduction"


@pytest.fixture(autouse=True)
def _cpu_place():
    prev = tplace._current_place
    tp.set_device("cpu")
    yield
    tplace._current_place = prev


_rng = np.random.default_rng(3)


def _n(*shape, scale=1.0):
    return (_rng.standard_normal(shape) * scale).astype(np.float32)


_lab = _rng.integers(0, 5, 6).astype(np.int64)
_lab_ign = _lab.copy()
_lab_ign[[1, 4]] = -100
_soft = np.exp(_n(6, 5))
IN = {
    "A": _n(4, 5), "B": _n(4, 5), "A3": _n(4, 5, scale=3.0),
    "A6": _n(4, 6), "A345": _n(3, 4, 5), "V5": _n(5), "V3": _n(3),
    "W53": _n(5, 3), "W1": np.array([0.3], np.float32), "W3": _n(3),
    "X243": _n(2, 4, 3), "NCHW": _n(2, 3, 4, 5), "NHWC": _n(2, 4, 5, 3),
    "NCHW4": _n(2, 4, 3, 3), "NCHW5": _n(2, 5, 3, 3),
    "IMG": _n(1, 2, 4, 6), "IMG_NHWC": _n(1, 4, 6, 2), "SEQ3": _n(2, 3, 7),
    "VOL": _n(1, 2, 3, 4, 5), "PS": _n(1, 8, 2, 3), "PS_NHWC": _n(1, 2, 3, 8),
    "PU": _n(1, 2, 4, 6), "UF": _n(1, 2, 5, 6), "FOLD": _n(1, 8, 12),
    "FOLD2": _n(1, 8, 6),
    "IDS": _rng.integers(0, 10, (4, 5)).astype(np.int64),
    "EMB": _n(10, 3), "ONEHOT": np.eye(5, dtype=np.float32)[_lab],
    "PRIOR": np.full((1, 5), 0.2, np.float32),
    "X1": _n(4, 5), "X2": _n(4, 3), "BW": _n(2, 5, 3), "BB": _n(2),
    "RM": _n(3, scale=0.1), "RV": np.abs(_n(3)) + 0.5,
    "LOGITS": _n(6, 5), "LAB": _lab, "LAB1": _lab[:, None],
    "LABIGN": _lab_ign, "SOFT": _soft / _soft.sum(1, keepdims=True),
    "CW": np.abs(_n(5)) + 0.5, "LOGP": None,
    "U01": _rng.uniform(0.05, 0.95, (4, 5)).astype(np.float32),
    "T01": (_rng.random((4, 5)) > 0.5).astype(np.float32),
    "PM1": np.where(_rng.random((4, 5)) > 0.5, 1.0, -1.0).astype(np.float32),
    "PM1V": np.where(_rng.random(4) > 0.5, 1.0, -1.0).astype(np.float32),
    "PW": np.abs(_n(5)) + 0.5, "GW": np.abs(_n(4)) + 0.5,
    "DICE_P": None, "DICE_T": _rng.integers(0, 4, (3, 6, 1)).astype(
        np.int64),
    "NP_LAB": np.array([0, 1, 0, 2], np.int64), "NORMZ": np.float32(3.0),
    "CTC_LP": None, "CTC_LAB": np.array([[1, 2, 2], [3, 1, 0]], np.int32),
    "CTC_IL": np.array([6, 5], np.int64),
    "CTC_LL": np.array([3, 2], np.int64),
    "Q": _n(2, 64, 4, 16), "K": _n(2, 64, 4, 16), "V": _n(2, 64, 4, 16),
    "Q8": _n(2, 8, 4, 16), "K8": _n(2, 8, 2, 16), "V8": _n(2, 8, 2, 16),
    "FMASK": _n(2, 1, 8, 8), "BMASK": _rng.random((2, 1, 8, 8)) > 0.3,
}
IN["LOGP"] = np.log(IN["SOFT"]).astype(np.float32)
_dp = np.exp(_n(3, 6, 4))
IN["DICE_P"] = (_dp / _dp.sum(-1, keepdims=True)).astype(np.float32)
IN["CTC_LP"] = np.log(np.exp(_n(6, 2, 4)) / np.exp(_n(6, 2, 4)).sum(
    -1, keepdims=True)).astype(np.float32)


def _F(P):
    return P.nn.functional


CASES = {
    # ---- activation -------------------------------------------------------
    "relu": (lambda P, a: _F(P).relu(a), ["A"], E),
    "relu6": (lambda P, a: _F(P).relu6(a), ["A3"], E),
    "elu": (lambda P, a: _F(P).elu(a, 0.5), ["A"], E),
    "selu": (lambda P, a: _F(P).selu(a), ["A"], E),
    "celu": (lambda P, a: _F(P).celu(a, 1.5), ["A"], E),
    "gelu": (lambda P, a: _F(P).gelu(a), ["A"], E),
    "gelu#tanh": (lambda P, a: _F(P).gelu(a, approximate=True), ["A"], E),
    "sigmoid": (lambda P, a: _F(P).sigmoid(a), ["A"], E),
    "hardsigmoid": (lambda P, a: _F(P).hardsigmoid(a), ["A3"], E),
    "hardswish": (lambda P, a: _F(P).hardswish(a), ["A3"], E),
    "hardtanh": (lambda P, a: _F(P).hardtanh(a, -0.5, 0.7), ["A"], E),
    "hardshrink": (lambda P, a: _F(P).hardshrink(a, 0.4), ["A"], E),
    "softshrink": (lambda P, a: _F(P).softshrink(a, 0.4), ["A"], E),
    "tanhshrink": (lambda P, a: _F(P).tanhshrink(a), ["A"], E),
    "leaky_relu": (lambda P, a: _F(P).leaky_relu(a, 0.1), ["A"], E),
    "prelu": (lambda P, a, w: _F(P).prelu(a, w), ["A", "W1"], E),
    "prelu#channel": (lambda P, a, w: _F(P).prelu(a, w), ["NCHW", "W3"], E),
    "prelu#nhwc": (lambda P, a, w: _F(P).prelu(a, w, data_format="NHWC"),
                   ["NHWC", "W3"], E),
    "rrelu#eval": (lambda P, a: _F(P).rrelu(a), ["A"], E),
    "log_sigmoid": (lambda P, a: _F(P).log_sigmoid(a), ["A3"], E),
    "maxout": (lambda P, a: _F(P).maxout(a, 2, axis=1), ["X243"], E),
    "silu": (lambda P, a: _F(P).silu(a), ["A"], E),
    "swish": (lambda P, a: _F(P).swish(a), ["A"], E),
    "mish": (lambda P, a: _F(P).mish(a), ["A3"], E),
    "softplus": (lambda P, a: _F(P).softplus(a, 2.0, 5.0), ["A3"], E),
    "softsign": (lambda P, a: _F(P).softsign(a), ["A"], E),
    "tanh": (lambda P, a: _F(P).tanh(a), ["A"], E),
    "softmax": (lambda P, a: _F(P).softmax(a), ["A3"], R),
    "softmax#axis0": (lambda P, a: _F(P).softmax(a, axis=0), ["A345"], R),
    "log_softmax": (lambda P, a: _F(P).log_softmax(a, 1), ["A345"], R),
    "glu": (lambda P, a: _F(P).glu(a), ["A6"], E),
    "thresholded_relu": (lambda P, a: _F(P).thresholded_relu(a, 0.5), ["A"],
                         E),
    # relu_ on a result: the JAX tape's rebind drops the gradient to the
    # producer, so its gradient is held to relu's (GRAD_REF)
    "relu_": (lambda P, a: _F(P).relu_(a * 1.0), ["A"], E),
    # ---- common -----------------------------------------------------------
    "linear": (lambda P, x, w, b: _F(P).linear(x, w, b), ["A", "W53", "V3"],
               R),
    "linear#nobias": (lambda P, x, w: _F(P).linear(x, w), ["A", "W53"], R),
    "dropout#p0": (lambda P, a: _F(P).dropout(a, 0.0), ["A"], E),
    "dropout#eval": (lambda P, a: _F(P).dropout(a, 0.5, training=False),
                     ["A"], E),
    "dropout#downscale_eval": (
        lambda P, a: _F(P).dropout(a, 0.5, training=False,
                                   mode="downscale_in_infer"), ["A"], E),
    "dropout2d#eval": (lambda P, a: _F(P).dropout2d(a, 0.5, training=False),
                       ["NCHW"], E),
    "dropout3d#eval": (lambda P, a: _F(P).dropout3d(a, 0.5, training=False),
                       ["VOL"], E),
    "alpha_dropout#eval": (
        lambda P, a: _F(P).alpha_dropout(a, 0.5, training=False), ["A"], E),
    "embedding": (lambda P, i, w: _F(P).embedding(i, w), ["IDS", "EMB"], R),
    "embedding#padding_idx": (
        lambda P, i, w: _F(P).embedding(i, w, padding_idx=2), ["IDS", "EMB"],
        R),
    "one_hot": (lambda P, i: _F(P).one_hot(i, 10), ["IDS"], E),
    "label_smooth": (lambda P, a: _F(P).label_smooth(a, epsilon=0.2),
                     ["ONEHOT"], E),
    "label_smooth#prior": (
        lambda P, a, p: _F(P).label_smooth(a, p, epsilon=0.2),
        ["ONEHOT", "PRIOR"], E),
    "interpolate#nearest_up": (
        lambda P, a: _F(P).interpolate(a, size=[8, 9]), ["IMG"], E),
    "interpolate#nearest_down": (
        lambda P, a: _F(P).interpolate(a, scale_factor=0.5), ["IMG"], E),
    "interpolate#bilinear_up": (
        lambda P, a: _F(P).interpolate(a, size=[7, 11], mode="bilinear"),
        ["IMG"], R),
    "interpolate#bilinear_down": (
        lambda P, a: _F(P).interpolate(a, size=[3, 4], mode="bilinear"),
        ["IMG"], R),
    "interpolate#bicubic_up": (
        lambda P, a: _F(P).interpolate(a, size=[9, 10], mode="bicubic"),
        ["IMG"], R),
    "interpolate#bicubic_down": (
        lambda P, a: _F(P).interpolate(a, size=[2, 5], mode="bicubic"),
        ["IMG"], R),
    "interpolate#align_corners": (
        lambda P, a: _F(P).interpolate(a, size=[7, 11], mode="bilinear",
                                       align_corners=True), ["IMG"], R),
    "interpolate#nhwc": (
        lambda P, a: _F(P).interpolate(a, scale_factor=2, mode="bilinear",
                                       data_format="NHWC"), ["IMG_NHWC"], R),
    "interpolate#linear": (
        lambda P, a: _F(P).interpolate(a, size=[12], mode="linear",
                                       data_format="NCW"), ["SEQ3"], R),
    "interpolate#trilinear": (
        lambda P, a: _F(P).interpolate(a, size=[5, 3, 7], mode="trilinear",
                                       data_format="NCDHW"), ["VOL"], R),
    "interpolate#area": (
        lambda P, a: _F(P).interpolate(a, size=[2, 3], mode="area"), ["IMG"],
        R),
    "upsample": (lambda P, a: _F(P).upsample(a, scale_factor=2), ["IMG"], E),
    "pixel_shuffle": (lambda P, a: _F(P).pixel_shuffle(a, 2), ["PS"], E),
    "pixel_shuffle#nhwc": (
        lambda P, a: _F(P).pixel_shuffle(a, 2, data_format="NHWC"),
        ["PS_NHWC"], E),
    "pixel_unshuffle": (lambda P, a: _F(P).pixel_unshuffle(a, 2), ["PU"], E),
    "channel_shuffle": (lambda P, a: _F(P).channel_shuffle(a, 2), ["PS"], E),
    "unfold": (lambda P, a: _F(P).unfold(a, 2, 1, 1), ["UF"], E),
    "unfold#asym": (lambda P, a: _F(P).unfold(a, [2, 3], 2, [1, 0, 0, 1],
                                              [1, 2]), ["UF"], E),
    "fold": (lambda P, a: _F(P).fold(a, [4, 5], 2), ["FOLD"], R),
    "fold#pad": (lambda P, a: _F(P).fold(a, [3, 4], 2, 2, 1), ["FOLD2"], R),
    "cosine_similarity": (lambda P, a, b: _F(P).cosine_similarity(a, b),
                          ["A", "B"], R),
    "pad": (lambda P, a: _F(P).pad(a, [1, 2], value=0.5), ["A345"], E),
    "bilinear": (lambda P, a, b, w, bb: _F(P).bilinear(a, b, w, bb),
                 ["X1", "X2", "BW", "BB"], R),
    # ---- norm -------------------------------------------------------------
    "batch_norm#eval": (
        lambda P, x, rm, rv, w, b: _F(P).batch_norm(x, rm, rv, w, b),
        ["NCHW", "RM", "RV", "W3", "V3"], R),
    "batch_norm#train": (
        lambda P, x, rm, rv, w, b: (
            _F(P).batch_norm(x, rm, rv, w, b, training=True, momentum=0.8),
            rm, rv), ["NCHW", "RM", "RV", "W3", "V3"], R),
    "batch_norm#nhwc": (
        lambda P, x, rm, rv: _F(P).batch_norm(x, rm, rv, training=True,
                                              data_format="NHWC"),
        ["NHWC", "RM", "RV"], R),
    "layer_norm": (lambda P, x, w, b: _F(P).layer_norm(x, 5, w, b, 1e-5),
                   ["A345", "V5", "V5"], R),
    "layer_norm#2d": (lambda P, x: _F(P).layer_norm(x, [4, 5]), ["A345"],
                      R),
    "rms_norm": (lambda P, x, w: _F(P).rms_norm(x, w), ["A345", "V5"], R),
    "instance_norm": (
        lambda P, x, w, b: _F(P).instance_norm(x, weight=w, bias=b),
        ["NCHW", "W3", "V3"], R),
    "instance_norm#nhwc": (
        lambda P, x: _F(P).instance_norm(x, data_format="NHWC"), ["NHWC"],
        R),
    "group_norm": (
        lambda P, x, w, b: _F(P).group_norm(x, 2, 1e-5, w, b),
        ["NCHW4", "GW", "GW"], R),
    "group_norm#nhwc": (
        lambda P, x: _F(P).group_norm(x, 3, data_format="NHWC"), ["NHWC"],
        R),
    "normalize": (lambda P, x: _F(P).normalize(x), ["A"], R),
    "normalize#p1": (lambda P, x: _F(P).normalize(x, p=1, axis=-1), ["A"],
                     R),
    "local_response_norm": (
        lambda P, x: _F(P).local_response_norm(x, 3, alpha=0.1), ["NCHW5"],
        R),
    "local_response_norm#nhwc": (
        lambda P, x: _F(P).local_response_norm(x, 2, alpha=0.1,
                                               data_format="NHWC"),
        ["NHWC"], R),
    # ---- loss -------------------------------------------------------------
    "cross_entropy": (lambda P, x, y: _F(P).cross_entropy(x, y),
                      ["LOGITS", "LAB"], R),
    "cross_entropy#ignore_weight": (
        lambda P, x, y, w: _F(P).cross_entropy(x, y, weight=w),
        ["LOGITS", "LABIGN", "CW"], R),
    "cross_entropy#smoothing_sum": (
        lambda P, x, y: _F(P).cross_entropy(x, y, reduction="sum",
                                            label_smoothing=0.1),
        ["LOGITS", "LAB1"], R),
    "cross_entropy#none": (
        lambda P, x, y: _F(P).cross_entropy(x, y, reduction="none"),
        ["LOGITS", "LABIGN"], R),
    "cross_entropy#soft": (
        lambda P, x, y: _F(P).cross_entropy(x, y, soft_label=True,
                                            label_smoothing=0.1),
        ["LOGITS", "SOFT"], R),
    "cross_entropy#soft_weight": (
        lambda P, x, y, w: _F(P).cross_entropy(x, y, weight=w,
                                               soft_label=True),
        ["LOGITS", "SOFT", "CW"], R),
    "cross_entropy#no_softmax": (
        lambda P, x, y: _F(P).cross_entropy(x, y, use_softmax=False),
        ["SOFT", "LAB"], R),
    "softmax_with_cross_entropy": (
        lambda P, x, y: _F(P).softmax_with_cross_entropy(
            x, y, return_softmax=True), ["LOGITS", "LAB1"], R),
    "binary_cross_entropy": (
        lambda P, p, t, w: _F(P).binary_cross_entropy(p, t, w),
        ["U01", "T01", "V5"], R),
    "binary_cross_entropy_with_logits": (
        lambda P, z, t, w, pw: _F(P).binary_cross_entropy_with_logits(
            z, t, w, pos_weight=pw), ["A3", "T01", "V5", "PW"], R),
    "nll_loss": (lambda P, x, y, w: _F(P).nll_loss(x, y, w),
                 ["LOGP", "LABIGN", "CW"], R),
    "mse_loss": (lambda P, a, b: _F(P).mse_loss(a, b), ["A", "B"], R),
    "l1_loss": (lambda P, a, b: _F(P).l1_loss(a, b, "sum"), ["A", "B"], R),
    "smooth_l1_loss": (lambda P, a, b: _F(P).smooth_l1_loss(a, b,
                                                            delta=0.5),
                       ["A", "B"], R),
    "kl_div": (lambda P, a, b: _F(P).kl_div(a, b, "batchmean"),
               ["LOGP", "SOFT"], R),
    "margin_ranking_loss": (
        lambda P, a, b, t: _F(P).margin_ranking_loss(a, b, t, 0.1),
        ["A", "B", "PM1"], R),
    "hinge_embedding_loss": (
        lambda P, a, t: _F(P).hinge_embedding_loss(a, t, 0.5),
        ["A", "PM1"], R),
    "cosine_embedding_loss": (
        lambda P, a, b, t: _F(P).cosine_embedding_loss(a, b, t, 0.1),
        ["A", "B", "PM1V"], R),
    "triplet_margin_loss": (
        lambda P, a, b, c: _F(P).triplet_margin_loss(a, b, c, swap=True),
        ["A", "B", "A3"], R),
    "ctc_loss": (
        lambda P, lp, lab, il, ll: _F(P).ctc_loss(lp, lab, il, ll),
        ["CTC_LP", "CTC_LAB", "CTC_IL", "CTC_LL"], R),
    "ctc_loss#norm_by_times": (
        lambda P, lp, lab, il, ll: _F(P).ctc_loss(
            lp, lab, il, ll, reduction="sum", norm_by_times=True),
        ["CTC_LP", "CTC_LAB", "CTC_IL", "CTC_LL"], R),
    "square_error_cost": (lambda P, a, b: _F(P).square_error_cost(a, b),
                          ["A", "B"], E),
    "log_loss": (lambda P, p, t: _F(P).log_loss(p, t), ["U01", "T01"], E),
    "sigmoid_focal_loss": (
        lambda P, z, t, n: _F(P).sigmoid_focal_loss(z, t, n),
        ["A3", "T01", "NORMZ"], R),
    "dice_loss": (lambda P, p, t: _F(P).dice_loss(p, t),
                  ["DICE_P", "DICE_T"], R),
    "npair_loss": (lambda P, a, p, y: _F(P).npair_loss(a, p, y),
                   ["A", "B", "NP_LAB"], R),
    "huber_loss": (lambda P, a, b: _F(P).huber_loss(a, b, 0.5), ["A3", "B"],
                   R),
    # ---- attention --------------------------------------------------------
    "scaled_dot_product_attention#flash": (
        lambda P, q, k, v: _F(P).scaled_dot_product_attention(q, k, v),
        ["Q", "K", "V"], R),
    "scaled_dot_product_attention#flash_causal": (
        lambda P, q, k, v: _F(P).scaled_dot_product_attention(
            q, k, v, is_causal=True), ["Q", "K", "V"], R),
    "scaled_dot_product_attention#float_mask_gqa": (
        lambda P, q, k, v, m: _F(P).scaled_dot_product_attention(
            q, k, v, attn_mask=m), ["Q8", "K8", "V8", "FMASK"], R),
    "scaled_dot_product_attention#bool_mask": (
        lambda P, q, k, v, m: _F(P).scaled_dot_product_attention(
            q, k, v, attn_mask=m, scale=0.3), ["Q8", "K8", "V8", "BMASK"],
        R),
    "scaled_dot_product_attention#dropout_eval": (
        lambda P, q, k, v: _F(P).scaled_dot_product_attention(
            q, k, v, dropout_p=0.3, training=False), ["Q", "K", "V"], R),
}
# the port's gradient held to JAX's of another function (see "relu_")
GRAD_REF = {"relu_": lambda P, a: _F(P).relu(a * 1.0)}
# the JAX ctc_loss (optax, under the package's 64-bit mode) returns f64
# for f32 log-probabilities; the port keeps f32: held in f32
WIDER_IN_JAX = {"ctc_loss"}
# names whose cases are the random tests below
RANDOM = {"dropout", "dropout2d", "dropout3d", "alpha_dropout", "rrelu",
          "gumbel_softmax", "class_center_sample"}


def _flat(out):
    if isinstance(out, (tuple, list)):
        res = []
        for o in out:
            res.extend(_flat(o))
        return res
    return [out]


def _inputs(P, name):
    ins = []
    for k in CASES[name][1]:
        arr = np.asarray(IN[k])
        ins.append(P.to_tensor(arr, stop_gradient=arr.dtype.kind != "f"))
    return ins


def _np(o):
    return np.asarray(o.numpy())


def _float(o):
    return o.dtype.name in ("float32", "float64") and not o.stop_gradient


def _grads(P, ins, outs, ws):
    loss = None
    for o, w in zip(outs, ws):
        if w is not None:
            term = P.sum(o * P.to_tensor(w))
            loss = term if loss is None else loss + term
    loss.backward()
    return [None if t.grad is None else _np(t.grad) for t in ins]


def check_case(name):
    fn, _, kind = CASES[name]
    j_in, t_in = _inputs(jp, name), _inputs(tp, name)
    j_out, t_out = _flat(fn(jp, *j_in)), _flat(fn(tp, *t_in))
    assert len(j_out) == len(t_out), name
    tol = ELEM if kind == E else RED
    for i, (jo, to) in enumerate(zip(j_out, t_out)):
        ja, ta = _np(jo), _np(to)
        what = f"{name} output {i}"
        assert ja.shape == ta.shape, (what, ja.shape, ta.shape)
        if name.split("#")[0] in WIDER_IN_JAX:
            ja = ja.astype(ta.dtype)
        assert ja.dtype == ta.dtype, (what, ja.dtype, ta.dtype)
        if ja.dtype.kind in "biu":
            np.testing.assert_array_equal(ta, ja, err_msg=what)
        else:
            np.testing.assert_allclose(ta, ja, err_msg=what, **tol)
    if name in GRAD_REF:
        j_in = _inputs(jp, name)
        j_out = _flat(GRAD_REF[name](jp, *j_in))
    wrng = np.random.default_rng(7)
    ws = [wrng.standard_normal(_np(o).shape).astype(np.float32)
          if _float(o) else None for o in j_out]
    assert [w is None for w in ws] == [not _float(o) for o in t_out], name
    if not any(w is not None for w in ws):
        return
    jg, tg = _grads(jp, j_in, j_out, ws), _grads(tp, t_in, t_out, ws)
    for i, (a, b) in enumerate(zip(jg, tg)):
        what = f"{name} grad of input {i}"
        # an input that only selects (a label in a where) gets zeros from
        # the JAX tape and no gradient from torch
        if a is not None and b is None:
            assert not a.any(), what
            continue
        assert (a is None) == (b is None), what
        if a is not None:
            np.testing.assert_allclose(b, a, err_msg=what, **RED)


@pytest.mark.parametrize("name", sorted(CASES))
def test_functional_against_jax(name):
    check_case(name)


def test_every_name_has_a_case():
    """Every name has a case here, or among test_torch_conv_pool.py's
    (the convolutions and poolings)."""
    from test_torch_conv_pool import CASES as CONV_POOL_CASES
    covered = {n.split("#")[0] for n in list(CASES) + list(CONV_POOL_CASES)} \
        | RANDOM
    missing = set(tp.nn.functional.__all__) - covered
    assert not missing, sorted(missing)


# every public name of the JAX nn.functional the port leaves for later
# (ROADMAP Queue 1: the extras)
NOT_PORTED = {
    # extras.py
    "pairwise_distance", "soft_margin_loss", "multi_label_soft_margin_loss",
    "multi_margin_loss", "triplet_margin_with_distance_loss",
    "hsigmoid_loss", "diag_embed", "sequence_mask", "zeropad2d",
    "temporal_shift", "affine_grid", "grid_sample", "gather_tree",
    "max_unpool1d", "max_unpool2d", "max_unpool3d", "margin_cross_entropy",
    "rnnt_loss", "sparse_attention", "elu_", "softmax_", "tanh_",
    # the submodules themselves
    "conv", "pooling", "extras",
}


def test_functional_closure():
    """Every public name of the JAX ``nn.functional`` is in the port's
    ``__all__`` or a ported submodule, or in ``NOT_PORTED``, and nothing
    in ``NOT_PORTED`` is ported."""
    import types
    jf, tf = jp.nn.functional, tp.nn.functional
    jnames = {n for n in dir(jf) if not n.startswith("_")}
    modules = {n for n in jnames
               if isinstance(getattr(jf, n), types.ModuleType)}
    assert NOT_PORTED <= jnames
    missing = jnames - set(tf.__all__) - modules - NOT_PORTED
    assert not missing, sorted(missing)
    assert not (NOT_PORTED & set(tf.__all__))
    for m in modules - NOT_PORTED:
        assert hasattr(tf, m), m


# ---- the random functionals ------------------------------------------------

def _big(shape=(200, 100)):
    return np.random.default_rng(5).uniform(1.0, 2.0, shape).astype(
        np.float32)


def _kept_share_ok(kept, n, p):
    sigma = np.sqrt(n * p * (1 - p))
    return abs(kept - n * (1 - p)) <= 4 * sigma


@pytest.mark.parametrize("mode", ["upscale_in_train", "downscale_in_infer"])
def test_dropout_kept_share_and_scaling(mode):
    """p = 0.3 in training: a share of 1 - p kept; kept elements x / (1 - p)
    (upscale) or x (downscale), dropped ones 0; the gradient is the same
    mask and scale; two calls draw different masks, and ``paddle.seed``
    repeats them."""
    p, x = 0.3, _big()
    tp.seed(11)
    a = tp.to_tensor(x, stop_gradient=False)
    out = tp.nn.functional.dropout(a, p, mode=mode)
    o = out.numpy()
    kept = o != 0
    assert _kept_share_ok(kept.sum(), x.size, p)
    scale = 1.0 / (1 - p) if mode == "upscale_in_train" else 1.0
    np.testing.assert_allclose(o[kept], x[kept] * np.float32(scale),
                               rtol=1e-6)
    out.sum().backward()
    np.testing.assert_allclose(a.grad.numpy(),
                               np.where(kept, np.float32(scale), 0),
                               rtol=1e-6)
    again = tp.nn.functional.dropout(tp.to_tensor(x), p, mode=mode).numpy()
    assert ((again != 0) != kept).any()
    tp.seed(11)
    first = tp.nn.functional.dropout(tp.to_tensor(x), p, mode=mode).numpy()
    np.testing.assert_array_equal(first, o)


def test_dropout_axis_and_2d_3d_share_one_draw():
    """With ``axis`` (and in dropout2d/3d: per sample and channel) one draw
    covers every other dim."""
    F = tp.nn.functional
    x = _big((40, 50, 6))
    o = F.dropout(tp.to_tensor(x), 0.4, axis=[0, 1]).numpy()
    zero = o == 0
    assert (zero.all(-1) | (~zero).all(-1)).all()
    assert _kept_share_ok((~zero[..., 0]).sum(), 40 * 50, 0.4)
    x4 = _big((50, 40, 3, 2))
    o4 = F.dropout2d(tp.to_tensor(x4), 0.4).numpy().reshape(50, 40, -1)
    assert ((o4 == 0).all(-1) | (o4 != 0).all(-1)).all()
    assert _kept_share_ok((o4[..., 0] != 0).sum(), 50 * 40, 0.4)
    x5 = _big((50, 40, 2, 2, 2))
    o5 = F.dropout3d(tp.to_tensor(x5), 0.4).numpy().reshape(50, 40, -1)
    assert ((o5 == 0).all(-1) | (o5 != 0).all(-1)).all()


def test_alpha_dropout_values():
    """Dropped elements take a * alpha_p + b, kept ones a * x + b, with the
    JAX function's a and b; a share of 1 - p kept."""
    p, x = 0.2, _big()
    o = tp.nn.functional.alpha_dropout(tp.to_tensor(x), p).numpy()
    alpha_p = -1.6732632423543772 * 1.0507009873554805
    a = np.float32(1.0 / np.sqrt((1.0 - p) * (1.0 + p * alpha_p ** 2)))
    b = -a * alpha_p * p
    dropped = np.isclose(o, a * alpha_p + b, rtol=1e-6)
    assert _kept_share_ok((~dropped).sum(), x.size, p)
    np.testing.assert_allclose(o[~dropped], a * x[~dropped] + b, rtol=1e-5)


def test_rrelu_training_slopes():
    x = -_big()
    o = tp.nn.functional.rrelu(tp.to_tensor(x), 0.1, 0.3,
                               training=True).numpy()
    slope = o / x
    assert slope.min() >= 0.1 - 1e-6 and slope.max() <= 0.3 + 1e-6
    assert abs(slope.mean() - 0.2) < 0.01
    pos = tp.nn.functional.rrelu(tp.to_tensor(-x), training=True).numpy()
    np.testing.assert_array_equal(pos, -x)


@pytest.mark.parametrize("hard", [False, True])
def test_gumbel_softmax(hard):
    """Rows are distributions (one-hot with ``hard``, whose gradient is the
    soft one's); over many draws the argmax follows softmax(x)."""
    x = np.log(np.array([[0.1, 0.2, 0.7]], np.float32)).repeat(6000, 0)
    a = tp.to_tensor(x, stop_gradient=False)
    y = tp.nn.functional.gumbel_softmax(a, hard=hard)
    yn = y.numpy()
    np.testing.assert_allclose(yn.sum(-1), 1.0, rtol=1e-5)
    if hard:
        assert set(np.unique(yn)) <= {0.0, 1.0}
    freq = np.bincount(yn.argmax(-1), minlength=3) / len(yn)
    np.testing.assert_allclose(freq, [0.1, 0.2, 0.7], atol=0.03)
    (y * tp.to_tensor(np.arange(3, dtype=np.float32))).sum().backward()
    assert np.isfinite(a.grad.numpy()).all()


def test_attention_dropout_in_training(monkeypatch):
    """The dense form with dropout: each probability kept with 1 - p and
    divided by it; ``dropout_p > 0`` takes the dense form (not the flash
    route) in training and in eval, and in eval it equals the flash
    path's result at p = 0."""
    from paddle_tpu_torch.nn.functional import attention as tattn
    calls = []
    real = tattn.flash_attention_bshd
    monkeypatch.setattr(tattn, "flash_attention_bshd",
                        lambda *a, **k: (calls.append(1), real(*a, **k))[1])
    F = tp.nn.functional
    q, k, v = (tp.to_tensor(IN[n]) for n in ("Q", "K", "V"))
    ones = tp.to_tensor(np.ones((2, 64, 4, 16), np.float32))
    outs = [F.scaled_dot_product_attention(q, k, ones, dropout_p=0.25)
            for _ in range(2)]
    ref = F.scaled_dot_product_attention(q, k, v, dropout_p=0.25,
                                         training=False).numpy()
    assert not calls
    flash = F.scaled_dot_product_attention(q, k, v).numpy()
    assert calls
    np.testing.assert_allclose(ref, flash, **RED)
    # with v all ones each output is the kept probabilities' sum / (1 - p):
    # its mean over rows is 1, and the two calls' masks differ
    o = outs[0].numpy()[..., 0]
    assert abs(o.mean() - 1.0) < 0.05
    assert not np.array_equal(o, outs[1].numpy()[..., 0])


def test_class_center_sample():
    """Every positive class is sampled, the labels map into the sample,
    and the sample has ``num_samples`` distinct classes."""
    lab = np.array([3, 7, 3, 11, 0], np.int64)
    remap, sampled = tp.nn.functional.class_center_sample(
        tp.to_tensor(lab), 20, 8)
    s, r = sampled.numpy(), remap.numpy()
    assert len(s) == 8 and len(set(s.tolist())) == 8
    assert {0, 3, 7, 11} <= set(s.tolist())
    np.testing.assert_array_equal(s[r], lab)
    j_remap, j_sampled = jp.nn.functional.class_center_sample(
        jp.to_tensor(lab), 20, 3)
    t_remap, t_sampled = tp.nn.functional.class_center_sample(
        tp.to_tensor(lab), 20, 3)
    np.testing.assert_array_equal(t_sampled.numpy(), j_sampled.numpy())
    np.testing.assert_array_equal(t_remap.numpy(), j_remap.numpy())
