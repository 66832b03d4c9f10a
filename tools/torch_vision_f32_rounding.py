"""How far f32 rounding alone moves a ``vision.models`` model, in the JAX
package and in the port, on the CPU.

    JAX_PLATFORMS=cpu python tools/torch_vision_f32_rounding.py MODEL
        [--mode eval|train] [--shape B,C,H,W] [--kw KEY=VALUE ...]

One set of weights (the port's, from ``paddle.seed(len(MODEL))``; in eval
mode calibrated as ``tests/test_torch_vision.py``'s ``calibrate`` does:
He-uniform weights, BN statistics from a calibration batch of 8) runs in
both packages, in f32 and in f64, on one input: the logits and the
gradient of ``sum(logits * w)`` over every parameter. Each line gives, for
a pair, the logits' relative distance (the norm of the difference over the
norm of the second), the worst parameter's relative gradient distance, and
the worst ratio of an element's difference to the tests' tolerance
(``1e-4 + 1e-4 * |second|``), logits and gradients. Where the port's f32
is as far from JAX's f32 as each package's f32 is from its own f64, the
difference is rounding, which a tolerance on f32 cannot separate from a
fault; the f64 pair is the comparison that can.
"""
from __future__ import annotations

import argparse
import math
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _value(text):
    for cast in (int, float):
        try:
            return cast(text)
        except ValueError:
            pass
    return {"True": True, "False": False}.get(text, text)


def _calibrate(tp, torch, m, shape):
    from paddle_tpu_torch.nn.layer.norm import _BatchNormBase
    bns = [l for l in m.sublayers() if isinstance(l, _BatchNormBase)]
    x = np.random.default_rng(99).random((8,) + tuple(shape[1:]))
    m.eval()
    with tp.no_grad():
        with torch.no_grad():
            for p in m.parameters():
                if len(p.shape) >= 2:
                    p._value.mul_(math.sqrt(6))
        moms = [bn._momentum for bn in bns]
        for bn in bns:
            bn._momentum, bn.training = 0.0, True
        m(tp.to_tensor(x.astype("float32")))
        for bn, mom in zip(bns, moms):
            bn._momentum, bn.training = mom, False


def _run(pkg, zoo, model, kw, state, mode, x, w, dt):
    pkg.set_default_dtype(dt)
    m = getattr(zoo.models, model)(**kw)
    m.set_state_dict({k: v.astype(dt) if v.dtype.kind == "f" else v
                      for k, v in state.items()})
    getattr(m, mode)()
    fwd = m
    if pkg.__name__ == "paddle_tpu":
        fwd = pkg.jit.to_static(m)
    ys = fwd(pkg.to_tensor(x.astype(dt)))
    ys = list(ys) if isinstance(ys, (tuple, list)) else [ys]
    sum(pkg.sum(y * pkg.to_tensor(w[:, :y.shape[1]].astype(dt)))
        for y in ys).backward()
    logits = np.concatenate([np.asarray(y.numpy(), np.float64).ravel()
                             for y in ys])
    grads = {n: np.asarray(p.grad.numpy(), np.float64)
             for n, p in m.named_parameters() if p.grad is not None}
    return logits, grads


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300))


def _ratio(a, b):
    return float((np.abs(a - b) / (1e-4 + 1e-4 * np.abs(b))).max())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("model")
    ap.add_argument("--mode", choices=("eval", "train"), default="eval")
    ap.add_argument("--shape", default="2,3,32,32")
    ap.add_argument("--kw", nargs="*", default=["num_classes=10"])
    args = ap.parse_args(argv)
    import jax
    import torch

    # as tests/conftest.py sets it for the tests
    jax.config.update("jax_default_matmul_precision", "highest")
    import paddle_tpu as jp
    import paddle_tpu.vision as jvision
    import paddle_tpu_torch as tp
    import paddle_tpu_torch.vision as tvision
    tp.set_device("cpu")
    kw = dict((k, _value(v)) for k, v in (a.split("=", 1) for a in args.kw))
    shape = tuple(int(s) for s in args.shape.split(","))
    tp.seed(len(args.model))
    m = getattr(tvision.models, args.model)(**kw)
    if args.mode == "eval":
        _calibrate(tp, torch, m, shape)
    state = {k: np.array(v.numpy()) for k, v in m.state_dict().items()}
    rng = np.random.default_rng(len(shape))
    x = rng.random(shape)
    w = rng.standard_normal((shape[0], 4096))
    out = {}
    for dt in ("float32", "float64"):
        for name, pkg, zoo in (("jax", jp, jvision), ("torch", tp, tvision)):
            out[name, dt] = _run(pkg, zoo, args.model, kw, state, args.mode,
                                 x, w, dt)
    jp.set_default_dtype("float32")
    tp.set_default_dtype("float32")
    print(f"{args.model} {args.mode} {list(shape)} {kw}: max |logit| "
          f"{np.abs(out['jax', 'float64'][0]).max():.6g}")
    for a, b in ((("jax", "float32"), ("jax", "float64")),
                 (("torch", "float32"), ("torch", "float64")),
                 (("torch", "float32"), ("jax", "float32")),
                 (("torch", "float64"), ("jax", "float64"))):
        (la, ga), (lb, gb) = out[a], out[b]
        g_rel = max((_rel(ga[n], gb[n]), n) for n in gb)
        g_ratio = max(_ratio(ga[n], gb[n]) for n in gb)
        print(f"  {a[0]} {a[1]} vs {b[0]} {b[1]}: logits rel "
              f"{_rel(la, lb):.3e} (x tol {_ratio(la, lb):.3g}); gradients "
              f"worst rel {g_rel[0]:.3e} ({g_rel[1]}), x tol {g_ratio:.3g}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
