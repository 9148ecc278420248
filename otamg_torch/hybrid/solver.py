"""Hybrid Newton-system solvers (port of the f64 path of
``otamg/hybrid/solver.py``).

The SsN Jacobian system ``He zeta = z`` (``He = bk1 I + (T + H0)/tk``) is
transformed by the similarity ``Q0 = diag(q, -p)`` into ``Ae u = f`` with
``Ae = diag(g) - E/tk``, ``E_ij = p_i^2 q_j^2 s_ij`` and
``g = bk1 [q^2; p^2] + (k + a0diag)/tk`` (``Hybrid_AMG.m:16-24``): the
graph Laplacian of the bipartite active-set graph plus a diagonal.  All
graph components are solved at once in one masked hierarchy whose
projections act per component through the labels.

The same transform serves the nullspace-augmented PCG
(``make_aug_pcg_solver``); ``make_direct_solver`` assembles the Jacobian
densely.  Not in this slice: the mixed-precision branch of
``build_he_solver`` (``solve_dtype``).
"""

from __future__ import annotations

import dataclasses

import torch

from otamg_torch import random as jr
from otamg_torch.amg.graph import connected_components_bipartite, segment_sum
from otamg_torch.amg.hierarchy import (amg_solve, setup_hierarchy,
                                       setup_hierarchy_generic)
from otamg_torch.config import AMGOptions, PCGOptions
from otamg_torch.krylov.pcg import pcg
from otamg_torch.opt.newton import NewtonSolveResult, NewtonSolver
from otamg_torch.ot import operators as op


def _transform(S, tvec, bk1, tk, rhs, p, q):
    """Shared Q0-transform pieces (``Hybrid_AMG.m:16-24``)."""
    p2 = p * p
    q2 = q * q
    q0 = torch.cat([q, -p])
    qp2 = torch.cat([q2, p2])
    E = (p2[:, None] * q2[None, :]) * S
    a0diag = torch.cat([E.sum(dim=0), E.sum(dim=1)])
    kdiag = qp2 * tvec
    g = bk1 * qp2 + (kdiag + a0diag) / tk
    f = q0 * rhs
    return E, g, kdiag, f, q0


def _component_info(E, kdiag):
    """Component labels and per-component near-singularity flags
    (``Hybrid_AMG.m:33-40,60-66``: a component is near-singular iff the
    ``K`` diagonal vanishes on it), the component count, and ``last``:
    the 1-based ordinal (in increasing root-label order) of the last
    component with more than 100 nodes (``Hybrid_AMG.m:51,80,113``)."""
    N = kdiag.shape[0]
    labels = connected_components_bipartite(E)
    nsp = segment_sum(kdiag, labels, N)[labels] == 0
    roots = labels == torch.arange(N, device=labels.device)
    ncomp = roots.sum()
    sizes = segment_sum(torch.ones(N, dtype=torch.int64,
                                   device=labels.device), labels, N)
    ordinal = torch.cumsum(roots.to(torch.int64), 0)
    last = torch.where(roots & (sizes > 100), ordinal, 0).amax()
    return labels, nsp, ncomp, last


def _a0diag_hi(S, p, q):
    """Exact ``A0`` diagonal: column/row sums of
    ``E_ij = p_i^2 q_j^2 s_ij``."""
    p2 = p * p
    q2 = q * q
    return torch.cat([q2 * (S.T @ p2), p2 * (S @ q2)])


def _check_solve_dtype(solve_dtype) -> None:
    if solve_dtype is not None:
        raise NotImplementedError(
            "solve_dtype (the mixed-precision hierarchy with f64 "
            "refinement) is not ported yet: ROADMAP.md Queue 1 item 11")


def make_hybrid_amg_solver(p: torch.Tensor, q: torch.Tensor,
                           opts: AMGOptions, twogrid: bool = False,
                           solve_dtype=None) -> NewtonSolver:
    """Newton solver through the hybrid AMG path (``inner_solver=4``),
    in the problem's precision.  ``twogrid=True`` is the two-level
    variant of ``Hybrid_twogrid.m``: one coarse level solved by
    Jacobi-PCG capped at 100 iterations (``twogrid_bigph.m:98-99``),
    deliberately inexact."""
    _check_solve_dtype(solve_dtype)
    if twogrid:
        opts = dataclasses.replace(
            opts, max_levels=2, coarse_solver="pcg",
            coarse_pcg=PCGOptions(retol=1e-11, maxit=100))

    def solve(S, tvec, bk1, tk, rhs, key) -> NewtonSolveResult:
        k_setup, k_solve = jr.split(key)
        he_solve, ncomp, last = build_he_solver(S, tvec, bk1, tk, p, q,
                                                opts, k_setup)
        zeta, iters, rel = he_solve(rhs, k_solve)
        return NewtonSolveResult(zeta, iters, rel, ncomp, last)

    return solve


def build_he_solver(S, tvec, bk1, tk, p, q, opts: AMGOptions, key):
    """Build the hierarchy once and return ``(he_solve, ncomp, last)``,
    where ``he_solve(rhs, key) -> (zeta, iters, rel)`` solves
    ``He zeta = rhs`` and may be called again against the same ``He``."""
    E, g, kdiag, _, q0 = _transform(S, tvec, bk1, tk, torch.zeros_like(tvec),
                                    p, q)
    labels, nsp, ncomp, last = _component_info(E, kdiag)
    if opts.bigph:
        # bk1*Q + K/tk equals Ae @ (component indicator) exactly: the
        # analytic form of the kernel-projection quantities.
        gk = bk1 * torch.cat([q * q, p * p]) + kdiag / tk
        lv1, dense = setup_hierarchy(E, g, 1.0 / tk, labels, nsp, opts,
                                     key, gk=gk)
    else:
        # Non-bigph mode (``Class_AMG.m:72``): assemble the dense Ae and
        # run the generic weighted-Jacobi/MIS hierarchy.
        n, m = q.shape[0], p.shape[0]
        Ae = torch.zeros(n + m, n + m, dtype=E.dtype, device=E.device)
        Ae[:n, n:] = E.T
        Ae[n:, :n] = E
        Ae = Ae * (-1.0 / tk) + torch.diag(g)
        lv1, dense = setup_hierarchy_generic(Ae, opts, key, labels, nsp)

    def he_solve(rhs, kguess):
        f = q0 * rhs
        # Random initial guess scaled as the reference's bk1*tk*rand
        # (Hybrid_AMG.m:69).
        guess = (bk1 * tk) * jr.uniform(kguess, f.shape, f.dtype, f.device)
        r = amg_solve(lv1, dense, f, guess, opts)
        return q0 * r.x, r.iters, r.rel_res

    return he_solve, ncomp, last


def make_aug_pcg_solver(p: torch.Tensor, q: torch.Tensor,
                        opts: PCGOptions) -> NewtonSolver:
    """Nullspace-augmented PCG (``aug_PCG.m``, ``inner_solver=3``) on the
    bordered system ``[[Y^T QK Y, Y^T QK], [QK Y, Ae]]``, ``Y`` the
    component indicator matrix: matrix-free through segment sums over
    the component labels, the coarse unknowns carried at their
    component-root positions of an N-padded vector (identity on the
    other positions)."""
    n = q.shape[0]

    def solve(S, tvec, bk1, tk, rhs, key=None) -> NewtonSolveResult:
        del key
        E, g, kdiag, f, q0 = _transform(S, tvec, bk1, tk, rhs, p, q)
        N = g.shape[0]
        labels, _, ncomp, _ = _component_info(E, kdiag)
        roots = labels == torch.arange(N, device=labels.device)
        qk = bk1 * torch.cat([q * q, p * p]) + kdiag / tk  # bk1 Q + K/tk
        inv_tk = 1.0 / tk

        def ae_mv(v):
            v1, v2 = v[:n], v[n:]
            o1 = g[:n] * v1 - inv_tk * (E.T @ v2)
            o2 = g[n:] * v2 - inv_tk * (E @ v1)
            return torch.cat([o1, o2])

        def aug_mv(x):
            U, u = x[:N], x[N:]
            Yu = U[labels]
            top = segment_sum(qk * (Yu + u), labels, N)
            top = torch.where(roots, top, U)
            return torch.cat([top, qk * Yu + ae_mv(u)])

        diag_aug = torch.cat([torch.where(roots, segment_sum(qk, labels, N),
                                          1.0), g])
        aug_f = torch.cat([torch.where(roots, segment_sum(f, labels, N),
                                       0.0), f])
        r = pcg(aug_mv, aug_f, lambda v: v / diag_aug,
                retol=opts.retol, maxit=opts.maxit)
        U, u = r.x[:N], r.x[N:]
        zero = torch.zeros((), dtype=torch.int64, device=rhs.device)
        return NewtonSolveResult(q0 * (U[labels] + u), r.iters, r.res,
                                 ncomp, zero)

    return solve


def dense_asat(S: torch.Tensor, p: torch.Tensor,
               q: torch.Tensor) -> torch.Tensor:
    """``H0 = A diag(s) A^T`` assembled as an ``(n + m, n + m)`` matrix
    (``ASAt.m``)."""
    d1, d2 = op.asat_diags(S, p, q)
    off = (q[:, None] * S.T) * p[None, :]   # diag(q) Y^T diag(p), (n, m)
    return torch.cat([torch.cat([torch.diag(d1), off], 1),
                      torch.cat([off.T, torch.diag(d2)], 1)])


def spd_solve(J: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """``J^{-1} rhs`` through a Cholesky factorization (what
    ``jax.scipy.linalg.solve(..., assume_a="pos")`` does)."""
    L = torch.linalg.cholesky(J)
    return torch.cholesky_solve(rhs[:, None], L)[:, 0]


def make_direct_solver(p: torch.Tensor, q: torch.Tensor) -> NewtonSolver:
    """Dense direct solve of ``Jk zeta = rhs`` (``inner_solver=1``,
    ``Class1/APD_SsN_Class1.m:143-145``): materializes the (n+m)^2
    Jacobian; an oracle for small systems."""
    N = p.shape[0] + q.shape[0]

    def solve(S, tvec, bk1, tk, rhs, key=None) -> NewtonSolveResult:
        del key
        I = torch.eye(N, dtype=S.dtype, device=S.device)
        Jk = bk1 * I + (torch.diag(tvec) + dense_asat(S, p, q)) / tk
        zero = torch.zeros((), dtype=torch.int64, device=rhs.device)
        return NewtonSolveResult(spd_solve(Jk, rhs), 1,
                                 torch.zeros((), dtype=S.dtype,
                                             device=S.device), zero, zero)

    return solve
