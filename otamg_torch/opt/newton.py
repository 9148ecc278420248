"""Newton-system solvers for the SsN subproblem, Krylov family (port of
``otamg/opt/newton.py``).

Each SsN step solves ``J_k zeta = -F_k`` with
``J_k = b_{k+1} I + (diag(t) + A diag(s) A^T) / t_k``
(reference ``Class1/APD_SsN_Class1.m:143-147``).  A solver is a closure
``solve(S, tvec, bk1, tk, rhs, key) -> NewtonSolveResult``; the AMG family
lives in :mod:`otamg_torch.hybrid`.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from otamg_torch.config import PCGOptions, Preconditioner
from otamg_torch.krylov.pcg import pcg
from otamg_torch.ot import operators as op


class NewtonSolveResult(NamedTuple):
    zeta: torch.Tensor
    iters: int | torch.Tensor  # inner-solver iterations (the AMG
    #                            solvers: a 0-d int64 tensor on the device)
    res: torch.Tensor       # relative residual reached
    ncomp: torch.Tensor     # info[0]: number of graph components (0 if n/a)
    last: torch.Tensor      # info[1]: last large-component index (0 if n/a)


NewtonSolver = Callable[..., NewtonSolveResult]


def make_pcg_solver(p: torch.Tensor, q: torch.Tensor,
                    opts: PCGOptions = PCGOptions()) -> NewtonSolver:
    """Matrix-free PCG on ``J_k`` (reference ``inner_solver=2`` with the
    ``ASAtz`` operator form).  ``opts.precd`` selects NONE, JACOBI or
    BI_SSOR, the menu entries with a matrix-free form on the bipartite
    block structure ``J_k = [[V, U], [U^T, T]]``."""
    if opts.precd in (Preconditioner.SSOR, Preconditioner.ICHOL):
        raise ValueError(
            f"{opts.precd} needs the assembled matrix; the matrix-free "
            "Newton PCG supports NONE/JACOBI/BI_SSOR")
    n = q.shape[0]

    def solve(S, tvec, bk1, tk, rhs, key=None) -> NewtonSolveResult:
        del key
        d1, d2 = op.asat_diags(S, p, q)
        diag = bk1 + (tvec + torch.cat([d1, d2])) / tk

        def matvec(v):
            return bk1 * v + (tvec * v
                              + op.apply_asat(v, S, p, q, d1, d2)) / tk

        if opts.precd == Preconditioner.NONE:
            precond = lambda r: r
        elif opts.precd == Preconditioner.BI_SSOR:
            # Explicit bipartite-SSOR inverse (``PCG.m:55-66``); the
            # off-diagonal block application is two masked GEMVs.
            omega = opts.omega
            scale = omega * (2.0 - omega)
            invV = 1.0 / diag[:n]
            invT = 1.0 / diag[n:]

            def U_mv(r2):   # (m,) -> (n,)
                return q * (S.T @ (p * r2)) / tk

            def Ut_mv(r1):  # (n,) -> (m,)
                return p * (S @ (q * r1)) / tk

            def precond(r):
                r1, r2 = r[:n], r[n:]
                t = Ut_mv(invV * r1)
                p1 = (invV * r1
                      + omega ** 2 * invV * U_mv(invT * t)
                      - omega * invV * U_mv(invT * r2))
                p2 = -omega * invT * t + invT * r2
                return scale * torch.cat([p1, p2])
        else:
            precond = lambda v: v / diag

        r = pcg(matvec, rhs, precond, retol=opts.retol, maxit=opts.maxit)
        zero = torch.zeros((), dtype=torch.int64, device=rhs.device)
        return NewtonSolveResult(r.x, r.iters, r.res, zero, zero)

    return solve
