"""Preconditioned conjugate gradients (port of ``otamg/krylov/pcg.py``).

Shewchuk-style PCG as in reference ``PCG.m:1-6,76-86``: one operator
application, one preconditioner application, two dots and three axpys per
iteration, stopping on ``delta_new <= tol^2 * delta_0`` or ``maxit``.

The JAX ``lax.while_loop`` is a Python loop here; each iteration reads
one status code from the device (continue / done / done by breakdown).
``make_preconditioner`` and ``pcg_matrix`` are a later slice.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from otamg_torch.device import fetch


class PCGResult(NamedTuple):
    x: torch.Tensor
    iters: int               # iterations taken
    res: torch.Tensor        # final relative residual sqrt(delta_new/delta_0)


def pcg(matvec: Callable[[torch.Tensor], torch.Tensor],
        e: torch.Tensor,
        precond: Callable[[torch.Tensor], torch.Tensor] | None = None,
        x0: torch.Tensor | None = None,
        retol: float = 1e-11,
        maxit: int = 10_000) -> PCGResult:
    """Solve ``H d = e`` for SPD ``H`` given as a matvec closure, with the
    reference stopping rule measured in the preconditioner norm and the
    JAX package's breakdown guard (``qp <= 0`` stops and keeps the
    current iterate)."""
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
        done = status == 1 or it >= maxit
    res = torch.sqrt(torch.abs(delta / safe_delta0))
    return PCGResult(d, it, res)
