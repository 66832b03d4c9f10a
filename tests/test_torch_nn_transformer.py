"""``paddle_tpu_torch.nn``'s transformer layers against ``paddle_tpu.nn``'s
on the CPU: ``MultiHeadAttention`` (self and cross attention, float and
bool masks, ``Cache`` and ``StaticCache``, ``need_weights``), the encoder
and decoder layers post- and pre-LN, their stacks (the clones drawn anew,
the same structured names), ``Transformer`` and its causal mask.

Each case carries the JAX layer's ``state_dict()`` across and holds the
outputs and the gradient of ``sum(out * w)`` for every parameter and
float input (rtol 1e-5, atol 1e-5). Dropout is 0 except where the case
says: attention dropout > 0 in eval takes the dense form in both (the JAX
gate reads ``dropout_p``, not ``training``). At S = 64 without a mask the
JAX layer runs its flash kernel (interpret mode) and the port the flash
kernel's plain version.
"""
import numpy as np
import pytest

import paddle_tpu as jp
import paddle_tpu_torch as tp
from paddle_tpu_torch.framework import place as tplace
from paddle_tpu_torch.nn.functional import attention as tattn

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _cpu_place():
    prev = tplace._current_place
    tp.set_device("cpu")
    yield
    tplace._current_place = prev


_rng = np.random.default_rng(6)


def _n(*shape):
    return _rng.standard_normal(shape).astype(np.float32)


X8 = _n(2, 8, 16)
X64 = _n(2, 64, 16)
MEM = _n(2, 6, 16)
KV = _n(2, 6, 12)
FMASK = _n(2, 1, 8, 8)
BMASK = _rng.random((2, 4, 8, 8)) > 0.3
XMASK = _n(2, 1, 8, 6)


def _pair(make, seed=0):
    jp.seed(seed)
    jl, tl = make(jp), make(tp)
    jsd, tsd = jl.state_dict(), tl.state_dict()
    assert list(jsd) == list(tsd)
    tl.set_state_dict({k: np.asarray(v._value) for k, v in jsd.items()})
    return jl, tl


def _flat(out):
    if isinstance(out, (tuple, list)):
        return [o for x in out for o in _flat(x)]
    return [] if out is None else [out]


_FLASH_CALLS = []


@pytest.fixture(autouse=True)
def _count_flash(monkeypatch):
    """Count the port's calls of the flash route (on the CPU its plain
    version runs, which the launch counters do not count)."""
    real = tattn.flash_attention_bshd

    def counted(*a, **k):
        _FLASH_CALLS.append(1)
        return real(*a, **k)
    monkeypatch.setattr(tattn, "flash_attention_bshd", counted)
    _FLASH_CALLS.clear()


def _hold(make, call, arrays, flash=False):
    """``call(P, layer, *tensors)`` in both packages from the same weights:
    outputs, then the gradients of ``sum(out * w)``; the port's attention
    took the flash route exactly when ``flash``."""
    jl, tl = _pair(make)
    res = {}
    for P, layer in ((jp, jl), (tp, tl)):
        ins = [P.to_tensor(a, stop_gradient=a.dtype.kind != "f")
               for a in arrays]
        outs = [o for o in _flat(call(P, layer, *ins))
                if o.dtype.name == "float32"]
        wrng = np.random.default_rng(1)
        loss = None
        for o in outs:
            w = wrng.standard_normal(o.shape).astype(np.float32)
            term = P.sum(o * P.to_tensor(w))
            loss = term if loss is None else loss + term
        loss.backward()
        res[P] = ([np.asarray(o.numpy()) for o in outs],
                  {k: p.grad for k, p in layer.named_parameters()},
                  [t.grad for t in ins])
    assert bool(_FLASH_CALLS) == flash
    (jo, jg, ji), (to, tg, ti) = res[jp], res[tp]
    assert len(jo) == len(to)
    for a, b in zip(jo, to):
        np.testing.assert_allclose(b, a, **TOL)
    for k, g in jg.items():
        if g is None or tg[k] is None:
            for x in (g, tg[k]):
                assert x is None or not np.asarray(x.numpy()).any(), k
            continue
        np.testing.assert_allclose(tg[k].numpy(), np.asarray(g.numpy()),
                                   err_msg=k, **TOL)
    for a, b in zip(ji, ti):
        if a is not None and b is not None:
            np.testing.assert_allclose(b.numpy(), np.asarray(a.numpy()),
                                       **TOL)


def _mha(**kw):
    return lambda P: P.nn.MultiHeadAttention(16, 4, **kw)


@pytest.mark.parametrize("case", ["self", "flash", "float_mask",
                                  "bool_mask", "cross", "dropout_eval"])
def test_multi_head_attention(case):
    if case == "self":
        _hold(_mha(), lambda P, m, x: m(x), [X8])
    elif case == "flash":
        _hold(_mha(), lambda P, m, x: m(x), [X64], flash=True)
    elif case == "float_mask":
        _hold(_mha(), lambda P, m, x, mk: m(x, attn_mask=mk), [X8, FMASK])
    elif case == "bool_mask":
        _hold(_mha(), lambda P, m, x, mk: m(x, x, x, mk), [X8, BMASK])
    elif case == "cross":
        _hold(_mha(kdim=12, vdim=12, need_weights=True),
              lambda P, m, x, kv, mk: m(x, kv, kv, mk)[0],
              [X8, KV, XMASK])
    else:
        _hold(lambda P: P.nn.MultiHeadAttention(16, 4, dropout=0.3).eval(),
              lambda P, m, x: m(x), [X64])


def test_multi_head_attention_caches():
    """A ``Cache`` grows by each call's keys and values (three steps of one
    token after a 4-token prompt); a ``StaticCache`` holds the memory's
    projections; each step equals JAX's."""
    def call(P, m, x, mem):
        cache = m.gen_cache(x, type=P.nn.MultiHeadAttention.Cache)
        outs = []
        for lo, hi in ((0, 4), (4, 5), (5, 6), (6, 7)):
            out, cache = m(x[:, lo:hi], cache=cache)
            outs.append(out)
        assert cache.k.shape == [2, 7, 4, 4]
        static = m.gen_cache(mem, mem, type=P.nn.MultiHeadAttention.
                             StaticCache)
        outs.append(m(x[:, :3], mem, mem, cache=static))
        return outs
    _hold(_mha(), call, [X8, MEM])


@pytest.mark.parametrize("pre_ln", [False, True])
@pytest.mark.parametrize("act", ["relu", "gelu"])
def test_encoder_layer_and_stack(pre_ln, act):
    def make(P):
        layer = P.nn.TransformerEncoderLayer(
            16, 4, 32, dropout=0.0, activation=act,
            normalize_before=pre_ln)
        norm = P.nn.LayerNorm(16) if pre_ln else None
        return P.nn.TransformerEncoder(layer, 3, norm)
    _hold(make, lambda P, enc, x, mk: enc(x, mk), [X8, FMASK])


def test_encoder_clones_are_drawn_anew_and_cache():
    """The stack's later layers are new draws of the first's architecture
    (not copies); an encoder with caches runs step by step as JAX's."""
    tp.seed(0)
    enc = tp.nn.TransformerEncoder(
        tp.nn.TransformerEncoderLayer(16, 4, 32, dropout=0.0), 2)
    w0 = enc.layers[0].linear1.weight.numpy()
    w1 = enc.layers[1].linear1.weight.numpy()
    assert w0.shape == w1.shape and not np.array_equal(w0, w1)
    assert enc.layers[1].dropout.p == 0.0

    def call(P, e, x):
        cache = e.gen_cache(x)
        out1, cache = e(x[:, :5], cache=cache)
        out2, cache = e(x[:, 5:], cache=cache)
        return [out1, out2]
    _hold(lambda P: P.nn.TransformerEncoder(P.nn.TransformerEncoderLayer(
        16, 4, 32, dropout=0.0), 2), call, [X8])


@pytest.mark.parametrize("pre_ln", [False, True])
def test_decoder_layer_stack_and_caches(pre_ln):
    def make(P):
        layer = P.nn.TransformerDecoderLayer(16, 4, 32, dropout=0.0,
                                             normalize_before=pre_ln)
        return P.nn.TransformerDecoder(
            layer, 2, P.nn.LayerNorm(16) if pre_ln else None)

    def call(P, dec, tgt, mem, mk):
        full = dec(tgt, mem, tgt_mask=mk)
        caches = dec.gen_cache(mem)
        step1, new = dec(tgt[:, :3], mem, cache=caches)
        # a layer's new cache is its self-attention's alone (as in JAX):
        # the next step pairs it with the static cache again
        caches = [(n[0], c[1]) for n, c in zip(new, caches)]
        step2, _ = dec(tgt[:, 3:4], mem, cache=caches)
        return [full, step1, step2]
    _hold(make, call, [X8, MEM, FMASK])


def test_transformer_and_square_mask():
    def make(P):
        return P.nn.Transformer(16, 4, 2, 2, 32, dropout=0.0)

    def call(P, t, src, tgt):
        mask = t.generate_square_subsequent_mask(8)
        return t(src, tgt, tgt_mask=mask)
    _hold(make, call, [X8, X8[:, ::-1].copy()])
    want = np.asarray(jp.nn.Transformer(16, 4, 1, 1, 32)
                      .generate_square_subsequent_mask(5).numpy())
    got = tp.nn.Transformer(16, 4, 1, 1, 32) \
        .generate_square_subsequent_mask(5).numpy()
    np.testing.assert_array_equal(got, want)


def test_dropout_in_training_draws_masks():
    """With dropout in training, two forwards differ and the same seed
    repeats a forward; in eval the encoder is deterministic."""
    enc = tp.nn.TransformerEncoder(tp.nn.TransformerEncoderLayer(
        16, 4, 32, dropout=0.2), 2)
    x = tp.to_tensor(X8)
    tp.seed(5)
    a = enc(x).numpy()
    b = enc(x).numpy()
    tp.seed(5)
    c = enc(x).numpy()
    assert not np.array_equal(a, b)
    np.testing.assert_array_equal(a, c)
    enc.eval()
    np.testing.assert_array_equal(enc(x).numpy(), enc(x).numpy())
