"""Linear algebra ops (counterpart of ``paddle_tpu/ops/linalg.py``).

``matmul`` promotes a mixed pair by the JAX package's rule first. The
factorizations are ``torch.linalg``'s (LAPACK on the CPU, cuSOLVER on the
card); their outputs are unique up to the usual signs, so tests hold them
by reconstruction. ``lstsq`` is computed from the SVD so it gives the same
residuals, rank and singular values on both devices, as the JAX package's.
"""
from __future__ import annotations

import numpy as np
import torch

from ._dispatch import apply, apply_nondiff, maybe_cast_pair, unwrap, wrap
from ..framework.tensor import Tensor

__all__ = [
    "matmul", "dot", "mm", "bmm", "mv", "t", "norm", "dist", "cross",
    "einsum", "cholesky", "inv", "pinv", "svd", "qr", "lu", "eig", "eigh",
    "eigvals", "eigvalsh", "det", "slogdet", "solve", "triangular_solve",
    "cholesky_solve", "lstsq", "matrix_power", "matrix_rank", "multi_dot",
    "cov", "corrcoef", "histogram", "bincount", "inverse", "lu_unpack",
]

_INF = ("inf", np.inf, float("inf"))
_NINF = ("-inf", -np.inf, float("-inf"))


def matmul(x, y, transpose_x=False, transpose_y=False, name=None):
    if isinstance(x, Tensor) and isinstance(y, Tensor):
        x, y = maybe_cast_pair(x, y)

    def f(a, b):
        if transpose_x and a.ndim > 1:
            a = a.transpose(-1, -2)
        if transpose_y and b.ndim > 1:
            b = b.transpose(-1, -2)
        return torch.matmul(a, b)
    return apply(f, x, y, op_name="matmul")


def dot(x, y, name=None):
    return apply(lambda a, b: torch.sum(a * b, dim=-1), x, y, op_name="dot")


def mm(input, mat2, name=None):
    return matmul(input, mat2)


def bmm(x, y, name=None):
    return apply(torch.matmul, x, y, op_name="bmm")


def mv(x, vec, name=None):
    return apply(torch.matmul, x, vec, op_name="mv")


def t(input, name=None):
    return apply(lambda v: v.permute(*range(v.ndim - 1, -1, -1))
                 if v.ndim >= 2 else v, input, op_name="t")


def norm(x, p="fro", axis=None, keepdim=False, name=None):
    def f(v):
        if axis is None:
            flat = v.reshape(-1)
            if p in ("fro", 2):
                out = torch.sqrt(torch.sum(torch.square(flat)))
            elif p == 1:
                out = torch.sum(torch.abs(flat))
            elif p in _INF:
                out = torch.amax(torch.abs(flat))
            elif p in _NINF:
                out = torch.amin(torch.abs(flat))
            else:
                out = torch.pow(torch.sum(torch.pow(torch.abs(flat), p)),
                                1.0 / p)
            return out.reshape([1] * v.ndim) if keepdim else out
        ax = tuple(axis) if isinstance(axis, (list, tuple)) else (axis,)
        if p == "fro" or (p == 2 and len(ax) == 2):
            return torch.sqrt(torch.sum(torch.square(v), dim=ax,
                                        keepdim=keepdim))
        if p in _INF:
            return torch.amax(torch.abs(v), dim=ax, keepdim=keepdim)
        if p in _NINF:
            return torch.amin(torch.abs(v), dim=ax, keepdim=keepdim)
        if p == 0:
            return torch.sum((v != 0).to(v.dtype), dim=ax, keepdim=keepdim)
        return torch.pow(torch.sum(torch.pow(torch.abs(v), p), dim=ax,
                                   keepdim=keepdim), 1.0 / p)
    return apply(f, x, op_name="norm")


def dist(x, y, p=2, name=None):
    def f(a, b):
        d = (a - b).reshape(-1)
        if p == 0:
            return torch.sum((d != 0).to(a.dtype))
        if p in _INF:
            return torch.amax(torch.abs(d))
        if p in _NINF:
            return torch.amin(torch.abs(d))
        return torch.pow(torch.sum(torch.pow(torch.abs(d), p)), 1.0 / p)
    return apply(f, x, y, op_name="dist")


def cross(x, y, axis=9, name=None):
    def f(a, b):
        ax = axis
        if ax == 9:  # paddle's default: the first axis of size 3
            ax = next(i for i, s in enumerate(a.shape) if s == 3)
        return torch.linalg.cross(a, b, dim=ax)
    return apply(f, x, y, op_name="cross")


def einsum(equation, *operands, name=None):
    if len(operands) == 1 and isinstance(operands[0], (list, tuple)):
        operands = tuple(operands[0])
    return apply(lambda *vs: torch.einsum(equation, *vs), *operands,
                 op_name="einsum")


def cholesky(x, upper=False, name=None):
    return apply(lambda v: torch.linalg.cholesky(v, upper=upper), x,
                 op_name="cholesky")


def inv(x, name=None):
    return apply(torch.linalg.inv, x, op_name="inv")


def pinv(x, rcond=1e-15, hermitian=False, name=None):
    return apply(lambda v: torch.linalg.pinv(v, rtol=rcond,
                                             hermitian=hermitian), x,
                 op_name="pinv")


def svd(x, full_matrices=False, name=None):
    return apply(lambda v: tuple(torch.linalg.svd(
        v, full_matrices=full_matrices)), x, op_name="svd")


def qr(x, mode="reduced", name=None):
    return apply(lambda v: tuple(torch.linalg.qr(v, mode=mode)), x,
                 op_name="qr")


def lu(x, pivot=True, get_infos=False, name=None):
    lu_, piv = torch.linalg.lu_factor(unwrap(x).detach())
    outs = (wrap(lu_), wrap(piv.to(torch.int32)))
    if get_infos:
        return (*outs, wrap(torch.zeros((), dtype=torch.int32,
                                        device=lu_.device)))
    return outs


def eig(x, name=None):
    w, vec = torch.linalg.eig(unwrap(x).detach())
    return wrap(w), wrap(vec)


def _sym(v):
    # the JAX package's eigh symmetrizes its input
    return (v + v.transpose(-1, -2).conj()) / 2


def eigh(x, UPLO="L", name=None):
    return apply(lambda v: tuple(torch.linalg.eigh(_sym(v))), x,
                 op_name="eigh")


def eigvals(x, name=None):
    return wrap(torch.linalg.eigvals(unwrap(x).detach()))


def eigvalsh(x, UPLO="L", name=None):
    return apply(lambda v: torch.linalg.eigvalsh(_sym(v)), x,
                 op_name="eigvalsh")


def det(x, name=None):
    return apply(torch.linalg.det, x, op_name="det")


def slogdet(x, name=None):
    def f(v):
        sign, logdet = torch.linalg.slogdet(v)
        return torch.stack([sign, logdet])
    return apply(f, x, op_name="slogdet")


def solve(x, y, name=None):
    return apply(torch.linalg.solve, x, y, op_name="solve")


def triangular_solve(x, y, upper=True, transpose=False, unitriangular=False,
                     name=None):
    def f(a, b):
        if transpose:
            a = a.transpose(-1, -2)
        return torch.linalg.solve_triangular(
            a, b, upper=upper != transpose, unitriangular=unitriangular)
    return apply(f, x, y, op_name="triangular_solve")


def cholesky_solve(x, y, upper=False, name=None):
    # only the factor's triangle is read (and differentiated)
    return apply(lambda b, l: torch.cholesky_solve(
        b, torch.triu(l) if upper else torch.tril(l), upper=upper), x, y,
        op_name="cholesky_solve")


def lstsq(x, y, rcond=None, driver=None, name=None):
    """Least squares through the SVD (as ``jnp.linalg.lstsq``): solution,
    residuals (empty unless full rank and overdetermined), rank,
    singular values. Not differentiated, as in the JAX package."""
    def f(a, b):
        vec = b.ndim == 1
        b2 = b[:, None] if vec else b
        m, n = a.shape[-2], a.shape[-1]
        u, s, vh = torch.linalg.svd(a, full_matrices=False)
        eps = torch.finfo(a.dtype).eps
        cut = (eps * (m if m > n else n) if rcond is None
               else rcond) * s[..., :1]
        keep = s > cut
        inv_s = torch.where(keep, 1.0 / torch.where(keep, s,
                                                    torch.ones_like(s)),
                            torch.zeros_like(s))
        sol = vh.transpose(-1, -2) @ (inv_s[..., None]
                                      * (u.transpose(-1, -2) @ b2))
        rank_ = keep.sum(-1).to(torch.int64)
        if int(rank_) == n and m > n:
            res = torch.sum(torch.square(b2 - a @ sol), dim=-2)
            res = res[0:1].reshape(-1) if vec else res
        else:
            res = torch.zeros((0,), dtype=a.dtype, device=a.device)
        return (sol[:, 0] if vec else sol), res, rank_, s
    return apply_nondiff(f, x, y)


def matrix_power(x, n, name=None):
    return apply(lambda v: torch.linalg.matrix_power(v, int(n)), x,
                 op_name="matrix_power")


def matrix_rank(x, tol=None, hermitian=False, name=None):
    return apply_nondiff(lambda v: torch.linalg.matrix_rank(
        v, rtol=tol, hermitian=hermitian).to(torch.int64), x)


def multi_dot(x, name=None):
    return apply(lambda *vs: torch.linalg.multi_dot(list(vs)), *x,
                 op_name="multi_dot")


def cov(x, rowvar=True, ddof=True, fweights=None, aweights=None, name=None):
    fw, aw = unwrap(fweights), unwrap(aweights)

    def f(v):
        v2 = v if rowvar or v.ndim < 2 else v.transpose(0, 1)
        return torch.cov(v2, correction=1 if ddof else 0, fweights=fw,
                         aweights=aw)
    return apply(f, x, op_name="cov")


def corrcoef(x, rowvar=True, name=None):
    return apply(lambda v: torch.corrcoef(
        v if rowvar or v.ndim < 2 else v.transpose(0, 1)), x,
        op_name="corrcoef")


def histogram(input, bins=100, min=0, max=0, name=None):
    v = unwrap(input).detach()
    u = v.reshape(-1).to(torch.float64)
    lo, hi = (min, max) if (min != 0 or max != 0) else (None, None)
    if lo is None:
        lo, hi = float(u.min()), float(u.max())
        if lo == hi:
            lo, hi = lo - 1, hi + 1
    return wrap(torch.histc(u, bins=int(bins), min=lo, max=hi)
                .to(torch.int64))


def bincount(x, weights=None, minlength=0, name=None):
    v = unwrap(x).detach().reshape(-1)
    w = unwrap(weights)
    w = None if w is None else w.detach().reshape(-1)
    out = torch.bincount(v, weights=w, minlength=int(minlength))
    return wrap(out.to(w.dtype) if w is not None else out.to(torch.int64))


def inverse(x, name=None):
    """``paddle.inverse``: ``linalg.inv``."""
    return inv(x, name=name)


def lu_unpack(x, y, unpack_ludata=True, unpack_pivots=True, name=None):
    """``lu()``'s packed factorization → (P, L, U). ``y`` holds 1-based
    pivots (sequential row swaps, LAPACK's getrf); the permutation is
    built on the host, as in the JAX package."""
    v = unwrap(x)
    M, N = v.shape[-2], v.shape[-1]
    K = M if M < N else N
    P = None
    if unpack_pivots:
        piv = unwrap(y).detach().cpu().numpy() - 1

        def unpack_p(p1):
            perm = np.arange(M)
            for i, pi in enumerate(p1):
                perm[i], perm[pi] = perm[pi], perm[i]
            Pm = np.zeros((M, M), np.float64)
            Pm[perm, np.arange(M)] = 1.0
            return Pm

        if piv.ndim == 1:
            Pn = unpack_p(piv)
        else:
            flat = piv.reshape(-1, piv.shape[-1])
            Pn = np.stack([unpack_p(p) for p in flat]).reshape(
                piv.shape[:-1] + (M, M))
        P = wrap(torch.as_tensor(Pn, device=v.device).to(v.dtype))
    if not unpack_ludata:
        return P, None, None

    def f(lu_v):
        L = torch.tril(lu_v[..., :, :K], -1) + torch.eye(
            M, K, dtype=lu_v.dtype, device=lu_v.device)
        U = torch.triu(lu_v[..., :K, :])
        return L, U
    L, U = apply(f, x, op_name="lu_unpack")
    return P, L, U
