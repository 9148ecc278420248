"""Hybrid Newton-system solvers (port of ``otamg/hybrid/solver.py``).

The SsN Jacobian system ``He zeta = z`` (``He = bk1 I + (T + H0)/tk``) is
transformed by the similarity ``Q0 = diag(q, -p)`` into ``Ae u = f`` with
``Ae = diag(g) - E/tk``, ``E_ij = p_i^2 q_j^2 s_ij`` and
``g = bk1 [q^2; p^2] + (k + a0diag)/tk`` (``Hybrid_AMG.m:16-24``): the
graph Laplacian of the bipartite active-set graph plus a diagonal.  All
graph components are solved at once in one masked hierarchy whose
projections act per component through the labels.

With ``solve_dtype="float32"`` the hierarchy is built and cycled in
fp32 and the solution is refined in the problem's precision: the kernel
coordinate of each near-singular component is solved exactly in f64, and
each refinement round runs one fp32 correction solve through the
deflated cycle (``build_he_solver``).

The same transform serves the nullspace-augmented PCG
(``make_aug_pcg_solver``); ``make_direct_solver`` assembles the Jacobian
densely.
"""

from __future__ import annotations

import dataclasses

import torch

from otamg_torch import random as jr
from otamg_torch.amg.graph import connected_components_bipartite, segment_sum
from otamg_torch.amg.hierarchy import (amg_solve, setup_hierarchy,
                                       setup_hierarchy_generic)
from otamg_torch.config import AMGOptions, PCGOptions
from otamg_torch.device import fetch
from otamg_torch.krylov.pcg import pcg
from otamg_torch.opt.newton import NewtonSolveResult, NewtonSolver
from otamg_torch.ot import operators as op
from otamg_torch.sparse.segment import segment_plan


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


def _component_info(E, kdiag, exit_every: int = 1):
    """Component labels and per-component near-singularity flags
    (``Hybrid_AMG.m:33-40,60-66``: a component is near-singular iff the
    ``K`` diagonal vanishes on it), the component count, and ``last``:
    the 1-based ordinal (in increasing root-label order) of the last
    component with more than 100 nodes (``Hybrid_AMG.m:51,80,113``).
    ``exit_every`` is label propagation's read interval."""
    N = kdiag.shape[0]
    labels = connected_components_bipartite(E, exit_every=exit_every)
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


@dataclasses.dataclass
class RefineCounts:
    """What the mixed-precision Newton solves did since the last
    ``reset()``: solves, refinement rounds (one fp32 correction solve
    each), rounds reverted by the safeguard, and correction cycles summed
    over the rounds."""

    solves: int = 0
    rounds: int = 0
    reverted: int = 0
    cycles: int = 0

    def reset(self) -> None:
        self.solves = self.rounds = self.reverted = self.cycles = 0


refine_counts = RefineCounts()


def make_hybrid_amg_solver(p: torch.Tensor, q: torch.Tensor,
                           opts: AMGOptions, twogrid: bool = False,
                           solve_dtype=None, refine: int = 10,
                           exit_every: int = 1) -> NewtonSolver:
    """Newton solver through the hybrid AMG path (``inner_solver=4``).
    ``twogrid=True`` is the two-level variant of ``Hybrid_twogrid.m``:
    one coarse level solved by Jacobi-PCG capped at 100 iterations
    (``twogrid_bigph.m:98-99``), deliberately inexact.  With
    ``solve_dtype`` (``"float32"``) the hierarchy runs in that dtype and
    up to ``refine`` rounds of refinement bring the solution to the
    problem's precision (:func:`build_he_solver`).  ``exit_every`` is
    the read interval of every loop of the Newton solve (label
    propagation, MIS rounds, AMG iterations)."""
    if twogrid:
        opts = dataclasses.replace(
            opts, max_levels=2, coarse_solver="pcg",
            coarse_pcg=PCGOptions(retol=1e-11, maxit=100))

    def solve(S, tvec, bk1, tk, rhs, key) -> NewtonSolveResult:
        k_setup, k_solve = jr.split(key)
        he_solve, ncomp, last = build_he_solver(S, tvec, bk1, tk, p, q,
                                                opts, k_setup, solve_dtype,
                                                refine, exit_every)
        zeta, iters, rel = he_solve(rhs, k_solve)
        return NewtonSolveResult(zeta, iters, rel, ncomp, last)

    return solve


def build_he_solver(S, tvec, bk1, tk, p, q, opts: AMGOptions, key,
                    solve_dtype=None, refine: int = 10, exit_every: int = 1):
    """Build the hierarchy once and return ``(he_solve, ncomp, last)``,
    where ``he_solve(rhs, key) -> (zeta, iters, rel)`` solves
    ``He zeta = rhs`` and may be called again against the same ``He``.

    With ``solve_dtype`` below the problem's dtype (the mixed path), the
    hierarchy is built from ``E``, ``g``, ``1/tk`` and the analytic
    ``gk`` cast once to it, and ``he_solve`` works in deflated
    coordinates ``u = Y a + w``: ``a`` is each near-singular component's
    kernel coordinate, solved exactly in the problem's precision from the
    1-D equation ``bk1 (xi^T Q xi) a = xi^T (f - Ae w)``, and ``w`` is
    kernel-free.  Up to ``refine`` rounds each take the true residual
    through the structured operator and add one correction solve of the
    deflated fp32 cycle; a round that does not lower the residual is
    reverted and ends the loop.  Unlike the JAX package, the correction
    solve's right-hand side is scaled by a power of two to unit norm.
    ``iters`` is the most correction cycles of any round; each round
    costs one host read besides its solve's.  ``iters`` is a 0-d int64
    tensor on the device.  ``exit_every`` is the read interval of the
    loops inside (:func:`otamg_torch.amg.hierarchy.amg_solve`)."""
    hi = S.dtype
    lo = hi if solve_dtype is None else getattr(torch, solve_dtype)
    E, g, kdiag, _, q0 = _transform(S, tvec, bk1, tk, torch.zeros_like(tvec),
                                    p, q)
    labels, nsp, ncomp, last = _component_info(E, kdiag, exit_every)
    # Only a blocked solve names the interval (1 is the default).
    every = {} if exit_every == 1 else dict(exit_every=exit_every)
    if opts.bigph:
        # bk1*Q + K/tk equals Ae @ (component indicator) exactly: the
        # analytic form of the kernel-projection quantities.
        gk = bk1 * torch.cat([q * q, p * p]) + kdiag / tk
        lv1, dense = setup_hierarchy(E.to(lo), g.to(lo), 1.0 / tk, labels,
                                     nsp, opts, key, gk=gk.to(lo), **every)
    else:
        # Non-bigph mode (``Class_AMG.m:72``): assemble the dense Ae and
        # run the generic weighted-Jacobi/MIS hierarchy.
        n, m = q.shape[0], p.shape[0]
        Ae = torch.zeros(n + m, n + m, dtype=lo, device=E.device)
        Ae[:n, n:] = E.T
        Ae[n:, :n] = E
        Ae = (Ae * torch.as_tensor(-1.0 / tk, dtype=lo, device=E.device)
              + torch.diag(g.to(lo)))
        lv1, dense = setup_hierarchy_generic(Ae, opts, key, labels, nsp)

    def draw_guess(f, kguess):
        # Random initial guess scaled as the reference's bk1*tk*rand
        # (Hybrid_AMG.m:69), drawn in the solve dtype.
        return (bk1 * tk) * jr.uniform(kguess, f.shape, lo, f.device)

    if lo == hi:
        def he_solve(rhs, kguess):
            f = q0 * rhs
            r = amg_solve(lv1, dense, f, draw_guess(f, kguess), opts,
                          **every)
            return q0 * r.x, r.iters, r.rel_res

        return he_solve, ncomp, last

    # The kernel-mode quantities, in the problem's precision.
    n, N = q.shape[0], tvec.shape[0]
    qp2 = torch.cat([q * q, p * p])
    ghi = bk1 * qp2 + (kdiag + _a0diag_hi(S, p, q)) / tk
    p2, q2 = p * p, q * q
    nsp_f = nsp.to(hi)
    # The component labels are fixed for the Newton solve: one plan
    # serves every sum of the refinement rounds.
    plan = segment_plan(labels, N)
    qsum = segment_sum(qp2 * nsp_f, labels, N, plan)
    den = bk1 * qsum
    safe_den = torch.where(den > 0, den, 1.0)
    zeros_lo = torch.zeros(N, dtype=lo, device=S.device)

    def ae_hi(v):
        """``Ae v`` through the structured operator: two masked GEMVs."""
        ev1 = p2 * (S @ (q2 * v[:n]))
        ev2 = q2 * (S.T @ (p2 * v[n:]))
        return ghi * v - torch.cat([ev2, ev1]) / tk

    def deflate(w):
        mean = segment_sum(qp2 * w * nsp_f, labels, N, plan)
        mean = torch.where(qsum > 0,
                           mean / torch.where(qsum > 0, qsum, 1.0), 0.0)
        return w - torch.where(nsp, mean[labels], 0.0) * nsp_f

    def he_solve(rhs, kguess):
        f = q0 * rhs
        nf = torch.linalg.vector_norm(f)
        safe_nf = torch.where(nf > 0, nf, 1.0)
        segf = segment_sum(f * nsp_f, labels, N, plan)

        def residual(w):
            """``(wd, a, r)``: ``w`` deflated, its kernel coordinates
            ``a(wd)`` per node, and ``r = f - bk1 Q Y a - Ae wd``; no
            intermediate grows with ``a`` as ``bk1 -> 0``."""
            wd = deflate(w)
            segw = segment_sum(qp2 * wd * nsp_f, labels, N, plan)
            a = torch.where(den > 0, (segf - bk1 * segw) / safe_den, 0.0)
            a = torch.where(nsp, a[labels], 0.0)
            return wd, a, f - bk1 * qp2 * a * nsp_f - ae_hi(wd)

        refine_counts.solves += 1
        w = draw_guess(f, kguess).to(hi)
        rel = torch.linalg.vector_norm(residual(w)[2]) / safe_nf
        rounds, iters = 0, 0
        go = fetch(rel > opts.retol)
        while go and rounds < refine:
            wd, _, r = residual(w)
            # The correction solve sees r scaled by a power of two to
            # unit norm: the same fp32 roundings, but no squares in its
            # norms that underflow (a residual of 1e-20 is common at
            # small bk1, and a backend that flushes subnormals would see
            # a zero residual there).
            nr = torch.linalg.vector_norm(r)
            scale = torch.exp2(-torch.round(torch.log2(
                torch.where(nr > 0, nr, 1.0))))
            cor = amg_solve(lv1, dense, (r * scale).to(lo), zeros_lo, opts,
                            deflated=True, **every)
            w2 = wd + cor.x.to(hi) / scale
            rel2 = torch.linalg.vector_norm(residual(w2)[2]) / safe_nf
            ok, go, cycles = fetch(torch.stack([
                (rel2 < rel).to(torch.int64),
                (rel2 > opts.retol).to(torch.int64), cor.iters]))
            iters = max(iters, cycles)
            refine_counts.rounds += 1
            refine_counts.cycles += cycles
            if ok:
                w, rel, rounds = w2, rel2, rounds + 1
            else:
                # Safeguard: a correction that does not lower the true
                # residual is reverted and ends the loop.
                refine_counts.reverted += 1
                w, rounds = wd, refine
        wd, a, _ = residual(w)
        return (q0 * (wd + a),
                torch.full((), iters, dtype=torch.int64, device=f.device),
                rel)

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
        plan = segment_plan(labels, N)  # every PCG iteration's sum
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
            top = segment_sum(qk * (Yu + u), labels, N, plan)
            top = torch.where(roots, top, U)
            return torch.cat([top, qk * Yu + ae_mv(u)])

        diag_aug = torch.cat([torch.where(
            roots, segment_sum(qk, labels, N, plan), 1.0), g])
        aug_f = torch.cat([torch.where(
            roots, segment_sum(f, labels, N, plan), 0.0), f])
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
