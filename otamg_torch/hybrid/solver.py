"""Hybrid AMG Newton-system solver (port of the f64 path of
``otamg/hybrid/solver.py``).

The SsN Jacobian system ``He zeta = z`` (``He = bk1 I + (T + H0)/tk``) is
transformed by the similarity ``Q0 = diag(q, -p)`` into ``Ae u = f`` with
``Ae = diag(g) - E/tk``, ``E_ij = p_i^2 q_j^2 s_ij`` and
``g = bk1 [q^2; p^2] + (k + a0diag)/tk`` (``Hybrid_AMG.m:16-24``): the
graph Laplacian of the bipartite active-set graph plus a diagonal.  All
graph components are solved at once in one masked hierarchy whose
projections act per component through the labels.

Not in this slice: the mixed-precision branch of ``build_he_solver``
(``solve_dtype``), the two-grid variant, ``make_aug_pcg_solver`` and
``make_direct_solver``.
"""

from __future__ import annotations

import torch

from otamg_torch import random as jr
from otamg_torch.amg.graph import connected_components_bipartite, segment_sum
from otamg_torch.amg.hierarchy import (amg_solve, setup_hierarchy,
                                       setup_hierarchy_generic)
from otamg_torch.config import AMGOptions
from otamg_torch.opt.newton import NewtonSolveResult, NewtonSolver


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


def make_hybrid_amg_solver(p: torch.Tensor, q: torch.Tensor,
                           opts: AMGOptions,
                           solve_dtype=None) -> NewtonSolver:
    """Newton solver through the hybrid AMG path (``inner_solver=4``),
    in the problem's precision."""
    if solve_dtype is not None:
        raise NotImplementedError(
            "solve_dtype (the mixed-precision hierarchy with f64 "
            "refinement) is not ported yet: ROADMAP.md Queue 1 item 11")

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
