"""Preconditioned conjugate gradients (port of ``otamg/krylov/pcg.py``).

Shewchuk-style PCG as in reference ``PCG.m:1-6,76-86``: one operator
application, one preconditioner application, two dots and three axpys per
iteration, stopping on ``delta_new <= tol^2 * delta_0`` or ``maxit``.

The JAX ``lax.while_loop`` is a Python loop here; each iteration reads
one status code from the device (continue / done / done by breakdown).

The preconditioner menu of ``PCG.m:34-66`` is :func:`make_preconditioner`
for explicit dense matrices, and :func:`pcg_matrix` the reference-shaped
entry for them.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from otamg_torch.config import PCGOptions, Preconditioner
from otamg_torch.device import fetch


class PCGResult(NamedTuple):
    x: torch.Tensor
    iters: int               # iterations taken
    res: torch.Tensor        # final relative residual sqrt(delta_new/delta_0)
    resk: torch.Tensor | None = None  # (resk_len,) relative residual after
    #   iteration i+1 at entry i, 0 beyond ``iters`` (``PCG.m:74,85``)


def pcg(matvec: Callable[[torch.Tensor], torch.Tensor],
        e: torch.Tensor,
        precond: Callable[[torch.Tensor], torch.Tensor] | None = None,
        x0: torch.Tensor | None = None,
        retol: float = 1e-11,
        maxit: int = 10_000,
        resk_len: int = 0) -> PCGResult:
    """Solve ``H d = e`` for SPD ``H`` given as a matvec closure, with the
    reference stopping rule measured in the preconditioner norm and the
    JAX package's breakdown guard (``qp <= 0`` stops and keeps the
    current iterate).  With ``resk_len > 0`` the relative residual of
    every iteration is returned as ``PCGResult.resk`` (the reference's
    fourth output), in a vector of that length."""
    if precond is None:
        precond = lambda r: r
    if x0 is None:
        x0 = torch.zeros_like(e)
    # Low-precision floor on the tolerance (never binds in f64).
    retol_eff = max(retol, 4 * torch.finfo(e.dtype).eps)
    tol2 = retol_eff ** 2

    r = e - matvec(x0)
    p = precond(r)
    delta0 = torch.dot(r, p)
    safe_delta0 = torch.where(delta0 == 0, 1.0, delta0)
    d = x0
    delta = delta0
    it = 0
    done = maxit <= 0 or bool(fetch(
        torch.logical_not(delta0 > tol2 * delta0) | (delta0 == 0)))
    hist = []
    while not done:
        q = matvec(p)
        qp = torch.dot(q, p)
        breakdown = torch.logical_not(qp > 0)
        alpha = torch.where(breakdown, 0.0,
                            delta / torch.where(qp == 0, 1.0, qp))
        d1 = d + alpha * p
        r1 = r - alpha * q
        w = precond(r1)
        delta_new = torch.dot(r1, w)
        beta = delta_new / torch.where(delta == 0, 1.0, delta)
        p1 = w + beta * p
        stop = (torch.logical_not(delta_new > tol2 * delta0)
                | torch.logical_not(torch.isfinite(delta_new)))
        # 0: go on, 1: converged or non-finite, 2: breakdown (rejected).
        status = fetch(torch.where(breakdown, 2, stop.to(torch.int64)))
        if status == 2:
            break
        it += 1
        d, r, p, delta = d1, r1, p1, delta_new
        if resk_len > 0:
            hist.append(torch.sqrt(torch.abs(delta / safe_delta0)))
        done = status == 1 or it >= maxit
    res = torch.sqrt(torch.abs(delta / safe_delta0))
    resk = None
    if resk_len > 0:
        resk = torch.zeros(resk_len, dtype=e.dtype, device=e.device)
        if hist:
            k = min(len(hist), resk_len)
            resk[:k] = torch.stack(hist[:k])
            # iterations past the vector's end overwrite its last entry
            resk[k - 1] = hist[-1]
    return PCGResult(d, it, res, resk)


def _tri_solve(T: torch.Tensor, b: torch.Tensor,
               upper: bool) -> torch.Tensor:
    return torch.linalg.solve_triangular(T, b[:, None], upper=upper)[:, 0]


def make_preconditioner(H: torch.Tensor, which: Preconditioner,
                        omega: float = 1.5, nf: int | None = None
                        ) -> Callable[[torch.Tensor], torch.Tensor]:
    """``r -> M^{-1} r`` for an explicit dense SPD ``H`` (reference
    ``PCG.m:34-66`` and ``pre_cond_M`` at ``:90-105``).

    * NONE   — identity.
    * JACOBI — divide by ``diag(H)`` (reference default, ``PCG.m:23``).
    * SSOR   — ``omega*(2-omega) * (D+omega*U)^{-1} D (D+omega*L)^{-1}``
      by two dense triangular solves (``PCG.m:96-99``).
    * ICHOL  — the *complete* Cholesky factor, as the JAX package uses
      (stronger than the reference's zero-fill incomplete one, which only
      a hand-selected ``precd=4`` reaches, ``PCG.m:46``).
    * BI_SSOR — the explicit bipartite-SSOR inverse (``PCG.m:55-66``);
      needs the fine-node count ``nf``.
    """
    if which == Preconditioner.NONE:
        return lambda r: r
    if which == Preconditioner.JACOBI:
        dinv = 1.0 / torch.diagonal(H)
        return lambda r: r * dinv
    if which == Preconditioner.SSOR:
        dg = torch.diagonal(H)
        DL = torch.diag(dg) + omega * torch.tril(H, -1)
        DU = torch.diag(dg) + omega * torch.triu(H, 1)
        scale = omega * (2.0 - omega)
        return lambda r: scale * _tri_solve(
            DU, dg * _tri_solve(DL, r, upper=False), upper=True)
    if which == Preconditioner.ICHOL:
        Lc = torch.linalg.cholesky(H)
        return lambda r: _tri_solve(Lc.T, _tri_solve(Lc, r, upper=False),
                                    upper=True)
    if which == Preconditioner.BI_SSOR:
        if nf is None:
            raise ValueError("BI_SSOR requires the fine-node count nf "
                             "(reference PCG.m:67 errors likewise)")
        invV = 1.0 / torch.diagonal(H)[:nf]
        invT = 1.0 / torch.diagonal(H)[nf:]
        U = H[:nf, nf:]
        scale = omega * (2.0 - omega)

        def apply_bissor(r):
            r1, r2 = r[:nf], r[nf:]
            # [invV + w^2 invV U invT U' invV, -w invV U invT;
            #  -w invT U' invV,                 invT]
            Ut_invV_r1 = U.T @ (invV * r1)
            p1 = (invV * r1 + (omega ** 2) * invV * (U @ (invT * Ut_invV_r1))
                  - omega * invV * (U @ (invT * r2)))
            p2 = -omega * invT * Ut_invV_r1 + invT * r2
            return scale * torch.cat([p1, p2])

        return apply_bissor
    raise ValueError(f"unknown preconditioner {which}")


def pcg_matrix(H: torch.Tensor, e: torch.Tensor,
               opts: PCGOptions = PCGOptions(),
               x0: torch.Tensor | None = None,
               nf: int | None = None,
               resk: bool = False) -> PCGResult:
    """Reference-shaped entry ``[d, it, res, resk] = PCG(H, e,
    pcg_options)`` for an explicit dense matrix (``PCG.m:1``); pass
    ``resk=True`` for the per-iteration residual history (4th output)."""
    precond = make_preconditioner(H, opts.precd, opts.omega, nf)
    return pcg(lambda v: H @ v, e, precond, x0, opts.retol, opts.maxit,
               resk_len=opts.maxit if resk else 0)
