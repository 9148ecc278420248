"""Matrix-free OT operators, Class 1 (port of ``otamg/ot/operators.py``).

The constraint matrix ``A = [I_n (x) p^T ; q^T (x) I_m]`` is applied on the
``(m, n)`` plan matrix ``X``: every application is a GEMV or a rank-2
outer-product update.  Dual vectors are flat ``(n + m,)`` tensors with the
``n`` block first (reference layout ``y = [r-part; l-part]``).

The port runs f64 throughout, so the JAX package's TPU workarounds
(chunked reductions for emulated f64, ``out_dtype`` high-precision
accumulation) are plain f64 torch reductions here: ``vdot_hi`` and
``norm_hi`` keep their names, and ``sum_chunked`` is ``torch.sum``.  The
Class-2 operators are a later slice.
"""

from __future__ import annotations

import torch


def split_dual(y: torch.Tensor, n: int):
    """Split a flat dual vector into its (n,) and (m,) blocks."""
    return y[:n], y[n:]


def apply_A(X: torch.Tensor, p: torch.Tensor, q: torch.Tensor):
    """``A @ vec(X)`` = ``[X^T p; X q]`` (reference ``Ax.m``)."""
    return torch.cat([X.T @ p, X @ q])


def vdot_hi(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Dot product of two tensors of any shape, flattened."""
    return torch.dot(a.reshape(-1), b.reshape(-1))


def norm_hi(a: torch.Tensor) -> torch.Tensor:
    """2-norm of a tensor of any shape, flattened."""
    return torch.sqrt(vdot_hi(a, a))


def apply_At(y: torch.Tensor, p: torch.Tensor, q: torch.Tensor):
    """``unvec(A^T y)`` = ``p yn^T + ym q^T`` (reference ``Aty.m``)."""
    yn, ym = split_dual(y, q.shape[0])
    return torch.outer(p, yn) + torch.outer(ym, q)


def asat_diags(S: torch.Tensor, p: torch.Tensor, q: torch.Tensor):
    """Diagonal blocks of ``H0 = A diag(s) A^T`` (reference
    ``ASAt.m:9-19``): ``d1 = S^T (p*p)`` (n,), ``d2 = S (q*q)`` (m,)."""
    return S.T @ (p * p), S @ (q * q)


def apply_asat(z: torch.Tensor, S: torch.Tensor, p: torch.Tensor,
               q: torch.Tensor, d1=None, d2=None) -> torch.Tensor:
    """Matrix-free ``H0 @ z`` with ``H0 = A diag(s) A^T``::

        out1 = d1*z1 + q * (S^T (p*z2))
        out2 = p * (S (q*z1)) + d2*z2
    """
    n = q.shape[0]
    if d1 is None or d2 is None:
        d1, d2 = asat_diags(S, p, q)
    z1, z2 = split_dual(z, n)
    out1 = d1 * z1 + q * (S.T @ (p * z2))
    out2 = p * (S @ (q * z1)) + d2 * z2
    return torch.cat([out1, out2])


def prox_box(X: torch.Tensor, gama: torch.Tensor) -> torch.Tensor:
    """Projection onto ``[0, gama]`` (reference ``prox`` lambda,
    ``Class1/APD_SsN_Class1.m:29``); ``gama`` may be a 0-d ``inf``."""
    return torch.minimum(torch.clamp_min(X, 0.0), gama)


def inv_aat(x: torch.Tensor, p: torch.Tensor, q: torch.Tensor,
            sg1, sg2=None) -> torch.Tensor:
    """Closed-form ``(diag(sg1 I_n, sg2 I_m) + A A^T)^{-1} x``
    (reference ``invAAt.m:17-18``): two scaled identities plus a rank-1
    coupling, inverted exactly in O(m + n)."""
    if sg2 is None:
        sg2 = sg1
    n = q.shape[0]
    np2 = torch.dot(p, p)
    nq2 = torch.dot(q, q)
    vn, vm = split_dual(x, n)
    den = sg1 * sg2 + sg1 * nq2 + sg2 * np2
    qvn = torch.dot(q, vn)
    pvm = torch.dot(p, vm)
    yn = vn / (sg1 + np2) + (np2 / (sg1 + np2) * qvn - pvm) * q / den
    ym = vm / (sg2 + nq2) + (nq2 / (sg2 + nq2) * pvm - qvn) * p / den
    return torch.cat([yn, ym])


def kkt_class1(X, lam, C, b, p, q, gama):
    """Primal/dual KKT residual norms for Class 1
    (reference ``Class1/APD_SsN_Class1.m:63-65``)::

        KKT(lam) = || A x - b ||
        KKT(x)   = || x - prox(x - c - A^T lam) ||
    """
    kkt_l = torch.linalg.vector_norm(apply_A(X, p, q) - b)
    R = X - prox_box(X - C - apply_At(lam, p, q), gama)
    return norm_hi(R), kkt_l
