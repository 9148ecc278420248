"""APD + SsN outer optimizer for problem Class 1 (port of the loop driver
of ``otamg/opt/apd.py``).

The inexact accelerated primal-dual loop with semismooth-Newton inner
solves of ``Class1/APD_SsN_Class1.m:101-275``: momentum schedule,
adaptive SsN inexactness, active-set Jacobian, Armijo backtracking on the
dual merit, stagnation breaks, extrapolation and the random-restart
heuristic.  The plan stays on the device; the JAX while-loops (SsN,
Armijo) are Python loops that each read one flag per test, and the outer
step reads its metrics once.  Along ``lam_old + step * zeta`` the map
``A^T lam`` is affine in ``step``, so ``A^T zeta`` is computed once and a
backtrack costs one pass over the plan.

Precision: with an fp32 plan the dual state (``lam``, ``wlk``, ``bk1``
inside the SsN loop) and every O(mn) reduction into the dual space
(``A x``, the merit's dots, the KKT norms, the objective) are f64, while
the plan-space arrays and the Newton system stay fp32, as in the JAX
package with ``jax_enable_x64``.

``solve_class1`` checkpoints its state every ``checkpoint_every`` outer
iterations and resumes from the latest checkpoint onto the uninterrupted
trajectory (:mod:`otamg_torch.diag.checkpoint`).  ``explicit_dist``
raises; the chunked and fused drivers are not ported.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, NamedTuple

import numpy as np
import torch

from otamg_torch import random as jr
from otamg_torch.config import APDOptions, InnerSolver
from otamg_torch.device import fetch
from otamg_torch.opt.admm import warmup_class1
from otamg_torch.opt.newton import NewtonSolver, make_pcg_solver
from otamg_torch.ot import operators as op
from otamg_torch.ot.problems import Class1Problem


class OuterMetrics(NamedTuple):
    kkt_x: float
    kkt_l: float
    fxk: float
    ssn_it: int
    it_min: int
    it_avg: int
    it_max: int
    it_sum: int
    fail: int
    restarted: bool
    ncomp: int
    last: int


@dataclasses.dataclass
class SolveResult:
    X: Any
    lam: Any
    converged: bool
    iters: int
    kkt_x: np.ndarray          # raw norms, index 0 = warm start
    kkt_l: np.ndarray
    fxk: np.ndarray
    ssn_itnum: np.ndarray
    solver_itnum: np.ndarray   # (iters, 3) min/avg/max, -1 where unset
    restarts: np.ndarray
    fail_count: int
    wall_time: float
    inner_total: int = 0       # total inner-solver iterations
    state: tuple | None = None  # (X, V, lam, bk, key) when requested
    info_ncomp: np.ndarray | None = None  # per-outer info[0] (num_comp)
    info_last: np.ndarray | None = None   # per-outer info[1] (it_num)


def hi_dtypes(dtype):
    """``(hi, acc)`` for a plan of ``dtype``: the dual state's dtype, f64
    for an fp32 plan, and the ``out_dtype`` of the reductions into it
    (None where it is the plan's own)."""
    hi = torch.float64 if dtype == torch.float32 else dtype
    return hi, (hi if hi != dtype else None)


def _merit(lam, Zk, wlk, bk1, tk, gama, capacitated: bool, acc=None):
    """Dual merit for the Armijo search
    (``Class1/APD_SsN_Class1.m:182-189``): ``f0 + tk/2 ||prox(z)||^2``, or
    for capacity-constrained problems ``f0 + tk/2 (||z||^2 -
    ||z - prox(z)||^2)`` — identical when ``gama = inf``.  ``acc``
    accumulates the O(mn) dots in a higher precision."""
    f0 = bk1 / 2 * torch.dot(lam, lam) - torch.dot(wlk, lam)
    PZ = op.prox_box(Zk, gama)
    if capacitated:
        return f0 + 0.5 * tk * (op.vdot_hi(Zk, Zk, acc)
                                - op.vdot_hi(Zk - PZ, Zk - PZ, acc))
    return f0 + 0.5 * tk * op.vdot_hi(PZ, PZ, acc)


def make_solver_from_options(p, q, opts: APDOptions) -> NewtonSolver:
    """The ``inner_solver`` menu (``Class1/APD_SsN_Class1.m:66-71``)."""
    from otamg_torch.hybrid import (make_aug_pcg_solver, make_direct_solver,
                                    make_hybrid_amg_solver)

    if opts.explicit_dist:
        raise NotImplementedError("explicit_dist is not ported")
    if opts.inner_solver == InnerSolver.DIRECT:
        return make_direct_solver(p, q)
    if opts.inner_solver == InnerSolver.PCG:
        return make_pcg_solver(p, q, opts.pcg)
    if opts.inner_solver == InnerSolver.AUG_PCG:
        return make_aug_pcg_solver(p, q, opts.pcg)
    if opts.inner_solver == InnerSolver.AMG:
        return make_hybrid_amg_solver(p, q, opts.amg,
                                      solve_dtype=opts.solve_dtype)
    if opts.inner_solver == InnerSolver.TWOGRID:
        return make_hybrid_amg_solver(p, q, opts.amg, twogrid=True,
                                      solve_dtype=opts.solve_dtype)
    raise ValueError(f"unknown inner solver {opts.inner_solver}")


class _Ssn(NamedTuple):
    lam: torch.Tensor
    Zk: torch.Tensor
    it: int
    it_min: int
    it_sum: int
    it_max: int
    fail: int
    ncomp: torch.Tensor
    last: torch.Tensor


def make_class1_step(prob: Class1Problem, opts: APDOptions,
                     solver: NewtonSolver | None = None,
                     capacitated: bool | None = None):
    """Build the APD outer step ``(k, X, V, lam, bk, key, resk_prev,
    kkt_norm0) -> (X, V, lam, bk, key, resk, metrics)`` for ``prob``,
    where ``resk`` is the step's max(kkt_x, kkt_l) on the device and
    ``metrics`` holds host numbers (one read per step).  With
    ``solver=None`` the Newton solver is built here, once.  ``lam`` is
    in the dual dtype of :func:`hi_dtypes`."""
    p, q, C, gama = prob.p, prob.q, prob.C, prob.gama
    b = prob.b
    dev, dtype = C.device, C.dtype
    hi, acc = hi_dtypes(dtype)
    b_hi = b.to(hi)
    if capacitated is None:
        capacitated = bool(fetch(torch.any(torch.isfinite(gama))))
    if solver is None:
        solver = make_solver_from_options(p, q, opts)
    zeros_t = torch.zeros(prob.n + prob.m, dtype=dtype, device=dev)
    # Inner-solver budget, to count FailAMG-style budget hits
    # (Class1/APD_SsN_Class1.m:163-166).
    solver_maxit = (opts.amg.maxit if opts.inner_solver in
                    (InnerSolver.AMG, InnerSolver.TWOGRID)
                    else opts.pcg.maxit)

    def F_of(lam, Zk, bk1, wlk):
        return (bk1 * lam
                - op.apply_A(op.prox_box(Zk, gama), p, q, acc).to(hi) - wlk)

    def ssn_solve(Wk, wlk, lam0, bk1, tk, ssn_tol, key) -> _Ssn:
        """The SsN loop (``Class1/APD_SsN_Class1.m:137-238``).  ``lam0``,
        ``wlk`` and ``bk1`` are in the dual dtype, the z-space arrays in
        the plan's."""
        lam = lam0
        Zk = (Wk - op.apply_At(lam0.to(dtype), p, q)) / tk
        nF0 = torch.linalg.vector_norm(F_of(lam, Zk, bk1, wlk))
        it, it_min, it_sum, it_max, fail = 0, np.iinfo(np.int32).max, 0, 0, 0
        ncomp = last = torch.zeros((), dtype=torch.int64, device=dev)
        done = bool(fetch(nF0 <= ssn_tol))
        while not done:
            lam_old = lam
            At_lam = op.apply_At(lam_old.to(dtype), p, q)
            Zk_old = (Wk - At_lam) / tk
            S = ((Zk_old >= 0) & (Zk_old <= gama)).to(dtype)
            Fk_old = F_of(lam_old, Zk_old, bk1, wlk)
            nFk_old = torch.linalg.vector_norm(Fk_old)
            key, sub = jr.split(key)
            sol = solver(S, zeros_t, bk1.to(dtype), tk, (-Fk_old).to(dtype),
                         sub)
            zeta = sol.zeta.to(hi)
            # Armijo backtracking (:182-211), affine in `step`.
            At_zeta = op.apply_At(sol.zeta.to(dtype), p, q)
            cF_old = _merit(lam_old, Zk_old, wlk, bk1, tk, gama, capacitated,
                            acc)
            ress = torch.abs(torch.dot(Fk_old, zeta))
            step, ll = 1.0, 0
            while True:
                lam_t = lam_old + step * zeta
                Z_t = (Wk - At_lam - step * At_zeta) / tk
                cF_new = _merit(lam_t, Z_t, wlk, bk1, tk, gama, capacitated,
                                acc)
                # A non-finite merit is "not yet acceptable".
                if ll >= opts.ll_max or fetch(
                        cF_new <= cF_old - opts.nu * step * ress):
                    break
                step *= opts.delta
                ll += 1
            nFk_new = torch.linalg.vector_norm(F_of(lam_t, Z_t, bk1, wlk))
            it += 1
            # Break conditions of :213-231: converged, stagnated, budget.
            conv = nFk_new <= ssn_tol
            stag = torch.abs(nFk_old - nFk_new) < ssn_tol / 100
            # A stagnation exit that leaves ||F|| above the tolerance is
            # rejected (it carried < ssn_tol/100 of progress).
            reject = stag & ~conv
            lam = torch.where(reject, lam_old, lam_t)
            Zk = torch.where(reject, Zk_old, Z_t)
            it_min = min(it_min, sol.iters)
            it_sum += sol.iters
            it_max = max(it_max, sol.iters)
            fail += int(sol.iters >= solver_maxit)
            ncomp, last = sol.ncomp, sol.last
            done = bool(fetch(conv | stag)) or it >= opts.ssn_maxit
        return _Ssn(lam, Zk, it, it_min, it_sum, it_max, fail, ncomp, last)

    def outer_step(k, X, V, lam, bk, key, resk_prev, kkt_norm0):
        """One APD iteration (``Class1/APD_SsN_Class1.m:101-275``)."""
        kf = float(k)
        ak = torch.sqrt(kf ** 2 * bk)
        bk1 = bk / (1 + ak)
        tk = bk * (1 + ak) / (ak * ak)
        ssn_tol = torch.clamp_min(bk1 / kf ** 2, opts.ssn_tol1)
        Wk = -C + bk * (X + ak * V) / (ak * ak)
        wlk = (bk1 * (lam - (op.apply_A(X, p, q, acc).to(hi) - b_hi) / bk)
               - b_hi)

        key, sub = jr.split(key)
        ssn = ssn_solve(Wk, wlk, lam, bk1.to(hi), tk, ssn_tol, sub)
        lam1 = ssn.lam
        X1 = op.prox_box(ssn.Zk, gama)
        V1 = X1 + (X1 - X) / ak

        # Restart heuristic (:241-249): the normalized new KKT residual
        # against the raw previous one, as the reference does.
        kx1, kl1 = op.kkt_class1(X1, lam1, C, b, p, q, gama, acc)
        rr = torch.maximum(kx1 / (1 + kkt_norm0[0]),
                           kl1 / (1 + kkt_norm0[1]))
        key, sub = jr.split(key)
        restart = (bk1 < opts.restart_bk_floor) & (rr > resk_prev)
        bk1 = torch.where(restart, jr.uniform(sub, (), dtype, dev), bk1)
        X1 = torch.where(restart, X, X1)
        lam1 = torch.where(restart, lam, lam1)
        V1 = torch.where(restart, X, V1)

        # Final residual record (:253-254) at the possibly-reverted state.
        kx, kl = op.kkt_class1(X1, lam1, C, b, p, q, gama, acc)
        fxk = op.vdot_hi(C, X1, acc)
        kx_h, kl_h, fx_h, rs_h, nc_h, la_h = fetch(torch.stack([
            t.to(torch.float64) for t in (kx, kl, fxk, restart, ssn.ncomp,
                                          ssn.last)]))
        avg = ssn.it_sum // max(ssn.it, 1) if ssn.it > 0 else -1
        metrics = OuterMetrics(
            kkt_x=kx_h, kkt_l=kl_h, fxk=fx_h, ssn_it=ssn.it,
            it_min=ssn.it_min if ssn.it > 0 else -1, it_avg=avg,
            it_max=ssn.it_max if ssn.it > 0 else -1, it_sum=ssn.it_sum,
            fail=ssn.fail, restarted=bool(rs_h), ncomp=int(nc_h),
            last=int(la_h))
        return (X1, V1, lam1, bk1, key, torch.maximum(kx, kl).to(dtype),
                metrics)

    return outer_step


def solve_class1(prob: Class1Problem, opts: APDOptions = APDOptions(),
                 solver: NewtonSolver | None = None,
                 warm: tuple | None = None,
                 verbose: bool = False,
                 checkpoint_dir: str | None = None,
                 checkpoint_every: int = 10,
                 resume: bool = False,
                 return_state: bool = False) -> SolveResult:
    """End-to-end Class-1 solve: A-ADMM warm start + APD-SsN to the
    relative KKT tolerance (``KKT_Tol = 1e-6``,
    ``Class1/APD_SsN_Class1.m:35,264-268``), on the device of ``prob``.

    With ``checkpoint_dir`` the state ``(X, V, lam, bk, key, k, resk)`` is
    saved after every ``checkpoint_every``-th outer iteration; with
    ``resume`` the solve restarts from the latest checkpoint there (if
    any) at iteration ``k + 1``, and its trajectory equals the
    uninterrupted one.  The records of a resumed solve start at the warm
    start and go on from ``k + 1``."""
    t0 = time.perf_counter()
    C = prob.C
    dtype, dev = C.dtype, C.device
    hi, acc = hi_dtypes(dtype)
    if warm is None:
        X, lam = warmup_class1(prob, opts.warmup.maxit)
    else:
        X, lam = warm
    lam = lam.to(hi)
    kx, kl = op.kkt_class1(X, lam, C, prob.b, prob.p, prob.q, prob.gama, acc)
    kx0, kl0, fx0 = fetch(torch.stack([
        t.to(torch.float64) for t in (kx, kl, op.vdot_hi(C, X))]))
    kkt_norm0 = torch.tensor([kx0, kl0], dtype=dtype, device=dev)
    V = X

    step = make_class1_step(prob, opts, solver)
    key = jr.PRNGKey(opts.seed)
    bk = torch.ones((), dtype=dtype, device=dev)
    resk = torch.tensor(max(kx0, kl0), dtype=dtype, device=dev)
    k_start = 1
    if resume and checkpoint_dir is not None:
        from otamg_torch.diag import checkpoint as ckpt

        if ckpt.latest_step(checkpoint_dir) is not None:
            # The warm-start state is the template: each array returns
            # on its device and in its dtype.
            st = ckpt.load_state(checkpoint_dir, template=dict(
                X=X, V=X, lam=lam, bk=bk, key=key, resk=resk))
            X, V, lam, bk, key = st.X, st.V, st.lam, st.bk, st.key
            k_start = st.k + 1
            if st.resk is not None:
                resk = st.resk

    kkt_x, kkt_l, fxk = [kx0], [kl0], [fx0]
    ssn_itnum, solver_itnum, restarts = [], [], []
    info_ncomp, info_last = [], []
    fail_total = inner_total = 0
    converged = False
    k_final = opts.maxit
    for k in range(k_start, opts.maxit + 1):
        X, V, lam, bk, key, resk, mtr = step(k, X, V, lam, bk, key, resk,
                                             kkt_norm0)
        kkt_x.append(mtr.kkt_x)
        kkt_l.append(mtr.kkt_l)
        fxk.append(mtr.fxk)
        ssn_itnum.append(mtr.ssn_it)
        solver_itnum.append((mtr.it_min, mtr.it_avg, mtr.it_max))
        restarts.append(mtr.restarted)
        info_ncomp.append(mtr.ncomp)
        info_last.append(mtr.last)
        fail_total += mtr.fail
        inner_total += mtr.it_sum
        if verbose:
            print(f"APD it={k:3d} kkt_x={mtr.kkt_x:.2e} "
                  f"kkt_l={mtr.kkt_l:.2e} fk={mtr.fxk:.6e} "
                  f"ssn={mtr.ssn_it} inner={solver_itnum[-1]}"
                  + (" RESTART" if mtr.restarted else ""))
        if max(mtr.kkt_x / (1 + kx0), mtr.kkt_l / (1 + kl0)) <= opts.kkt_tol:
            converged = True
            k_final = k
            break
        if checkpoint_dir is not None and k % checkpoint_every == 0:
            from otamg_torch.diag import checkpoint as ckpt

            ckpt.save_state(checkpoint_dir,
                            ckpt.APDState(X, V, lam, bk, key, k, resk))

    return SolveResult(
        X=X, lam=lam, converged=converged, iters=k_final,
        kkt_x=np.asarray(kkt_x), kkt_l=np.asarray(kkt_l),
        fxk=np.asarray(fxk), ssn_itnum=np.asarray(ssn_itnum),
        solver_itnum=np.asarray(solver_itnum),
        restarts=np.asarray(restarts), fail_count=fail_total,
        wall_time=time.perf_counter() - t0, inner_total=inner_total,
        state=(X, V, lam, bk, key) if return_state else None,
        info_ncomp=np.asarray(info_ncomp), info_last=np.asarray(info_last))
