"""SMW-reduced Newton solvers for partial OT (port of
``otamg/hybrid/pot.py``; reference ``Class2/AMG4POT.m``,
``Class2/PCG4POT.m``).

The POT Jacobian is the arrow system ``He = bk1 I + (cT + cH0)/tk`` on
``n+m+1`` unknowns with ``cH0 = G diag(s) G^T``, ``G = [A; phi^T]``.
Sherman-Morrison-Woodbury eliminates the last row/column down to the core
``(n+m)`` system ``Ae = bk1 I + (T + H0)/tk``, the Class-1 form, solved
twice (``Ae vv = v``, ``Ae ww = w``; ``AMG4POT.m:45-51``).  The two AMG
solves share one hierarchy setup, where the reference builds it twice.
"""

from __future__ import annotations

import torch

from otamg_torch import random as jr
from otamg_torch.config import AMGOptions, PCGOptions
from otamg_torch.hybrid.solver import (build_he_solver, dense_asat,
                                       make_aug_pcg_solver, spd_solve)
from otamg_torch.opt.newton import NewtonSolveResult, NewtonSolver
from otamg_torch.ot import operators as op


def _smw_rhs(S, bk1, tk, rhs, p, q, Phi):
    """The SMW reduction's scalars and core right-hand sides:
    ``(sg, phi_e, v, w, z2)``."""
    sg = 1.0 / tk
    z1, z2 = rhs[:-1], rhs[-1]
    SPhi = S * Phi
    phi_e = bk1 + sg * op.vdot_hi(Phi, SPhi)
    v = op.apply_A(SPhi, p, q)
    w = z1 - (sg / phi_e) * z2 * v
    return sg, phi_e, v, w, z2


def _smw_combine(sg, phi_e, v, vv, ww, z2):
    """``zeta`` of the arrow system from the two core solutions."""
    tt = sg ** 2 / (phi_e - sg ** 2 * torch.dot(v, vv))
    zeta1 = ww + tt * vv * torch.dot(v, ww)
    zeta2 = (z2 - sg * torch.dot(v, zeta1)) / phi_e
    return torch.cat([zeta1, zeta2[None]])


def make_pot_amg_solver(p: torch.Tensor, q: torch.Tensor, Phi: torch.Tensor,
                        opts: AMGOptions, twogrid: bool = False,
                        solve_dtype=None, refine: int = 10,
                        exit_every: int = 1) -> NewtonSolver:
    """POT Newton solver: SMW reduction and hybrid AMG core solves on one
    shared hierarchy (``AMG4POT.m`` with the 'amg'/'twogrid' backends).
    The two-grid options are built afresh from ``opts``, as the JAX
    package does: ``fuse_deep``, ``coarse_solver`` and ``coarse_target``
    go back to their defaults.  ``solve_dtype`` and ``refine`` select the
    mixed-precision core solves of
    :func:`otamg_torch.hybrid.solver.build_he_solver`; both share the one
    fp32 hierarchy.  ``exit_every`` is the read interval of the loops
    inside."""
    if twogrid:
        opts = AMGOptions(
            retol=opts.retol, bigph=opts.bigph, maxit=opts.maxit,
            theta=opts.theta, smoth=opts.smoth, cycle=opts.cycle,
            isnsp=opts.isnsp, inter=opts.inter, max_levels=2,
            coarsen_ratio=opts.coarsen_ratio,
            coarse_pcg=PCGOptions(retol=1e-11, maxit=100))

    def solve(S, tvec, bk1, tk, rhs, key) -> NewtonSolveResult:
        sg, phi_e, v, w, z2 = _smw_rhs(S, bk1, tk, rhs, p, q, Phi)
        kg1, kg2, ks = jr.split(key, 3)
        he_solve, ncomp, last = build_he_solver(S, tvec, bk1, tk, p, q,
                                                opts, ks, solve_dtype,
                                                refine, exit_every)
        vv, it1, res1 = he_solve(v, kg1)
        ww, it2, res2 = he_solve(w, kg2)
        return NewtonSolveResult(_smw_combine(sg, phi_e, v, vv, ww, z2),
                                 torch.maximum(it1, it2),
                                 torch.maximum(res1, res2), ncomp, last)

    return solve


def make_pot_pcg_solver(p: torch.Tensor, q: torch.Tensor, Phi: torch.Tensor,
                        opts: PCGOptions) -> NewtonSolver:
    """POT Newton solver with augmented-PCG core solves
    (``Class2/PCG4POT.m``)."""
    core = make_aug_pcg_solver(p, q, opts)

    def solve(S, tvec, bk1, tk, rhs, key) -> NewtonSolveResult:
        sg, phi_e, v, w, z2 = _smw_rhs(S, bk1, tk, rhs, p, q, Phi)
        k1, k2 = jr.split(key)
        r1 = core(S, tvec, bk1, tk, v, k1)
        r2 = core(S, tvec, bk1, tk, w, k2)
        return NewtonSolveResult(
            _smw_combine(sg, phi_e, v, r1.zeta, r2.zeta, z2),
            max(r1.iters, r2.iters), torch.maximum(r1.res, r2.res),
            torch.maximum(r1.ncomp, r2.ncomp), torch.zeros_like(r1.ncomp))

    return solve


def make_pot_direct_solver(p: torch.Tensor, q: torch.Tensor,
                           Phi: torch.Tensor) -> NewtonSolver:
    """Dense direct solve of the full arrow system (``inner_solver=1``,
    ``Class2/APD_SsN_Class2.m:148-152``); an oracle for small systems."""
    N = p.shape[0] + q.shape[0] + 1

    def solve(S, tvec, bk1, tk, rhs, key=None) -> NewtonSolveResult:
        del key
        ss = op.apply_A(S * Phi, p, q)
        spp = op.vdot_hi(Phi, S * Phi)
        cH0 = torch.cat([torch.cat([dense_asat(S, p, q), ss[:, None]], 1),
                         torch.cat([ss, spp[None]])[None, :]])
        cT = torch.diag(torch.cat([tvec, tvec.new_zeros(1)]))
        I = torch.eye(N, dtype=S.dtype, device=S.device)
        Jk = bk1 * I + (cT + cH0) / tk
        zero = torch.zeros((), dtype=torch.int64, device=rhs.device)
        return NewtonSolveResult(spd_solve(Jk, rhs), 1,
                                 torch.zeros((), dtype=S.dtype,
                                             device=S.device), zero, zero)

    return solve
