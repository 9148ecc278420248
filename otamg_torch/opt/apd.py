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
trajectory (:mod:`otamg_torch.diag.checkpoint`).

On a row-sharded problem (:func:`otamg_torch.dist.shard_class1`)
``solve_class1`` runs with the problem's mesh active: the plan-shaped
state is this rank's rows, the duals are replicated, and the operators,
the Newton solvers and the checkpoints (one file per process) take
their collectives from :mod:`otamg_torch.dist.api`.  ``X`` of the result
is this rank's rows.  ``explicit_dist`` builds the hybrid AMG solver
with the explicit transform mesh and ``fuse_deep`` off, as the JAX
package does.

``solve_class1_chunked`` and ``solve_class1_fused`` follow the same
trajectory with fewer host reads: every loop of the step reads once a
block (``make_class1_step(exit_every=...)``), the metrics stay on the
device and are read once a chunk (or once a solve), and a step's
convergence flag rides on the next step's first read.  They run a
row-sharded problem as ``solve_class1`` does; every flag a block reads
is replicated (reduced over the mesh), so every rank leaves each loop
after the same block, and on a card the AMG block's CUDA graph holds
the level's collectives.  Around the Newton solve their step runs as
the regions of :mod:`otamg_torch.opt.regions`, on a card one CUDA graph
each, with the step's collectives inside.
"""

from __future__ import annotations

import dataclasses
import time
import types
from typing import Any, NamedTuple

import numpy as np
import torch

from otamg_torch import random as jr
from otamg_torch.config import APDOptions, InnerSolver
from otamg_torch.device import fetch
from otamg_torch.dist import api
from otamg_torch.graphs import ARMIJO_TRIALS, cond_counts
from otamg_torch.opt.admm import warmup_class1
from otamg_torch.opt.newton import NewtonSolver, make_pcg_solver
from otamg_torch.opt.regions import (Regions, StepFns, armijo_steps,
                                     count_solve, ssn_counters,
                                     step_signature)
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
        return f0 + 0.5 * tk * (op.vdot_plan(Zk, Zk, acc)
                                - op.vdot_plan(Zk - PZ, Zk - PZ, acc))
    return f0 + 0.5 * tk * op.vdot_plan(PZ, PZ, acc)


def make_solver_from_options(p, q, opts: APDOptions,
                             exit_every: int = 1,
                             mesh=None) -> NewtonSolver:
    """The ``inner_solver`` menu (``Class1/APD_SsN_Class1.m:66-71``);
    ``exit_every`` is the AMG solvers' read interval.  With
    ``explicit_dist`` the hybrid AMG solver's transform runs on ``mesh``
    (the problem's; the active one by default), or on a mesh of this one
    process for an unsharded problem."""
    from otamg_torch.hybrid import (make_aug_pcg_solver, make_direct_solver,
                                    make_hybrid_amg_solver)

    if opts.inner_solver == InnerSolver.DIRECT:
        return make_direct_solver(p, q)
    if opts.inner_solver == InnerSolver.PCG:
        return make_pcg_solver(p, q, opts.pcg)
    if opts.inner_solver == InnerSolver.AUG_PCG:
        return make_aug_pcg_solver(p, q, opts.pcg)
    if opts.inner_solver == InnerSolver.AMG:
        dist_mesh = None
        if opts.explicit_dist:
            dist_mesh = (mesh or api.current_mesh()
                         or api.one_process_mesh(p.device))
        return make_hybrid_amg_solver(p, q, opts.amg,
                                      solve_dtype=opts.solve_dtype,
                                      exit_every=exit_every,
                                      dist_mesh=dist_mesh)
    if opts.inner_solver == InnerSolver.TWOGRID:
        return make_hybrid_amg_solver(p, q, opts.amg, twogrid=True,
                                      solve_dtype=opts.solve_dtype,
                                      exit_every=exit_every)
    raise ValueError(f"unknown inner solver {opts.inner_solver}")


class _Ssn(NamedTuple):
    lam: torch.Tensor
    Zk: torch.Tensor
    it: int
    it_min: torch.Tensor
    it_sum: torch.Tensor
    it_max: torch.Tensor
    fail: torch.Tensor
    ncomp: torch.Tensor
    last: torch.Tensor


class StepRecord(NamedTuple):
    """An outer step's metrics left on the device: ``rec`` stacks
    ``kkt_x, kkt_l, fxk, restarted, ncomp, last, it_min, it_sum, it_max,
    fail`` as float64; ``ssn_it`` is known on the host."""

    ssn_it: int
    rec: torch.Tensor


def read_metrics(ssn_it: int, row) -> OuterMetrics:
    """:class:`OuterMetrics` from a :class:`StepRecord`'s host row."""
    kx, kl, fx, rs, nc, la, imin, isum, imax, fail = row
    done = ssn_it > 0
    return OuterMetrics(
        kkt_x=kx, kkt_l=kl, fxk=fx, ssn_it=ssn_it,
        it_min=int(imin) if done else -1,
        it_avg=int(isum) // max(ssn_it, 1) if done else -1,
        it_max=int(imax) if done else -1, it_sum=int(isum), fail=int(fail),
        restarted=bool(rs), ncomp=int(nc), last=int(la))


def armijo(trial, opts: APDOptions):
    """The loop driver's Armijo search over the trials of
    :func:`otamg_torch.opt.regions.armijo_steps`, one read a trial:
    ``trial(step) -> (accept, carry)``; returns the ``carry`` of the
    accepted trial (trial ``ll_max`` when none passes).  The blocked
    drivers search in blocks (:meth:`otamg_torch.opt.regions.Regions.
    armijo`)."""
    for ll, step in enumerate(armijo_steps(opts)):
        accept, carry = trial(step)
        cond_counts.add(ARMIJO_TRIALS)
        # A non-finite merit is "not yet acceptable".
        if ll >= opts.ll_max or fetch(accept):
            return carry


def make_class1_step(prob: Class1Problem, opts: APDOptions,
                     solver: NewtonSolver | None = None,
                     capacitated: bool | None = None,
                     exit_every: int = 1):
    """Build the APD outer step ``(k, X, V, lam, bk, key, resk_prev,
    kkt_norm0, conv_prev=None, record=False) -> (X, V, lam, bk, key,
    resk, metrics)`` for ``prob``, where ``resk`` is the step's
    max(kkt_x, kkt_l) on the device.  With ``solver=None`` the Newton
    solver is built here, once, with the same ``exit_every``.  ``lam``
    is in the dual dtype of :func:`hi_dtypes`.

    ``exit_every`` is the read interval of every data-dependent loop of
    the step, the counterpart of the JAX step's ``fused=True``.  At 1
    each loop test is one read and the step runs op by op: the loop
    driver's reference trajectory.  Above 1 the loops inside the Newton
    solve read once a block (:func:`otamg_torch.amg.hierarchy.amg_solve`)
    and the rest of the step runs as the regions of
    :mod:`otamg_torch.opt.regions` (one CUDA graph each on a card), with
    one read for the SsN entry test and one per block of Armijo trials;
    the trajectory is the loop's.  ``metrics`` holds host numbers (one
    read per step), or with ``record=True`` is a :class:`StepRecord`
    left on the device.  The device flag ``conv_prev`` (the previous
    step converged) rides on the step's first read: when it is set the
    step returns None."""
    p, q, C, gama = prob.p, prob.q, prob.C, prob.gama
    b = prob.b
    dev, dtype = C.device, C.dtype
    hi, acc = hi_dtypes(dtype)
    if capacitated is None:
        capacitated = bool(fetch(api.pmax(torch.any(torch.isfinite(gama)),
                                          prob.mesh)))
    if solver is None:
        solver = make_solver_from_options(p, q, opts, exit_every, prob.mesh)
    zeros_t = torch.zeros(prob.n + prob.m, dtype=dtype, device=dev)
    # Inner-solver budget, to count FailAMG-style budget hits
    # (Class1/APD_SsN_Class1.m:163-166).
    solver_maxit = (opts.amg.maxit if opts.inner_solver in
                    (InnerSolver.AMG, InnerSolver.TWOGRID)
                    else opts.pcg.maxit)

    # The problem's tensors, ``b`` made once (a property, which gathers
    # under a mesh), and the step's algebra over ``d``, which holds them:
    # ``loop_d`` (the loop) or the regions' state.
    data = dict(C=C, gama=gama, p=p, q=q, b=b)
    loop_d = types.SimpleNamespace(**data)

    def F_of(d, lam, Zk, bk1, wlk):
        return (bk1 * lam - op.apply_A(op.prox_box(Zk, d.gama), d.p, d.q,
                                       acc).to(hi) - wlk)

    def merit(d, lam, Zk, wlk, bk1, tk):
        return _merit(lam, Zk, wlk, bk1, tk, d.gama, capacitated, acc)

    def head(d, kf2, X, V, lam, bk):
        """``(ak, bk1, tk, ssn_tol, Wk, wlk)`` of step ``k``; ``kf2`` is
        ``k^2`` on the device, so that every driver divides by it
        alike."""
        ak = torch.sqrt(kf2 * bk)
        bk1 = bk / (1 + ak)
        tk = bk * (1 + ak) / (ak * ak)
        ssn_tol = torch.clamp_min(bk1 / kf2, opts.ssn_tol1)
        Wk = -d.C + bk * (X + ak * V) / (ak * ak)
        b_hi = d.b.to(hi)
        wlk = (bk1 * (lam - (op.apply_A(X, d.p, d.q, acc).to(hi) - b_hi)
                      / bk) - b_hi)
        return ak, bk1, tk, ssn_tol, Wk, wlk

    def pre(d, lam, Wk, tk, bk1, wlk):
        """``(A^T lam, z, S, F, ||F||)`` at the SsN iterate ``lam``."""
        At_lam = op.apply_At(lam.to(dtype), d.p, d.q)
        Zk = (Wk - At_lam) / tk
        Fk = F_of(d, lam, Zk, bk1, wlk)
        return (At_lam, Zk, ((Zk >= 0) & (Zk <= d.gama)).to(dtype), Fk,
                torch.linalg.vector_norm(Fk))

    def trial(lam_old, zeta, Wk, At_lam, At_zeta, tk, step, step_lo):
        """An Armijo trial's ``(lam, z)`` (:182-211), affine in the
        step."""
        return lam_old + step * zeta, (Wk - At_lam - step_lo * At_zeta) / tk

    def exit_test(nFk_old, nFk_new, ssn_tol):
        # Break conditions of :213-231: converged, stagnated.
        return (nFk_new <= ssn_tol,
                torch.abs(nFk_old - nFk_new) < ssn_tol / 100)

    def tail(d, X, lam, ak, bk1, Zk, lam1, u, resk_prev, kkt_norm0, info):
        """``(X1, V1, lam1, bk1, resk, rec)``: the new iterate after the
        restart heuristic, whose draw is ``u``, and the record row;
        ``info`` is the SsN loop's ``(ncomp, last, it_min, it_sum,
        it_max, fail)``."""
        X1 = op.prox_box(Zk, d.gama)
        V1 = X1 + (X1 - X) / ak
        # Restart heuristic (:241-249): the normalized new KKT residual
        # against the raw previous one, as the reference does.
        kx1, kl1 = op.kkt_class1(X1, lam1, d.C, d.b, d.p, d.q, d.gama, acc)
        rr = torch.maximum(kx1 / (1 + kkt_norm0[0]),
                           kl1 / (1 + kkt_norm0[1]))
        restart = (bk1 < opts.restart_bk_floor) & (rr > resk_prev)
        bk1 = torch.where(restart, u, bk1)
        X1 = torch.where(restart, X, X1)
        lam1 = torch.where(restart, lam, lam1)
        V1 = torch.where(restart, X, V1)
        # Final residual record (:253-254) at the possibly-reverted state.
        kx, kl = op.kkt_class1(X1, lam1, d.C, d.b, d.p, d.q, d.gama, acc)
        fxk = op.vdot_plan(d.C, X1, acc)
        rec = torch.stack([t.to(torch.float64)
                           for t in (kx, kl, fxk, restart, *info)])
        return X1, V1, lam1, bk1, torch.maximum(kx, kl).to(dtype), rec

    if exit_every > 1:
        def r_pre(st):
            (st.At_lam, st.Zk_old, st.S, st.Fk_old,
             st.nFk_old) = pre(st, st.lam_c, st.Wk, st.tk, st.bk1h, st.wlk)
            st.rhs = (-st.Fk_old).to(dtype)

        def r_head(st):
            (st.ak, st.bk1, st.tk, st.ssn_tol, st.Wk,
             st.wlk) = head(st, st.kf2.to(dtype), st.X, st.V, st.lam, st.bk)
            st.bk1h = st.bk1.to(hi)
            st.lam_c = st.lam
            st.it_min, st.it_sum, st.it_max, st.fail = ssn_counters(dev)
            st.ncomp = st.last = torch.zeros((), dtype=torch.int64,
                                             device=dev)
            r_pre(st)
            st.Zk = st.Zk_old
            st.flags = torch.stack([st.nFk_old <= st.ssn_tol, st.conv])

        def r_prepare(st):
            st.zeta_h = st.zeta.to(hi)
            st.At_zeta = op.apply_At(st.zeta.to(dtype), st.p, st.q)
            st.cF_old = merit(st, st.lam_c, st.Zk_old, st.wlk, st.bk1h,
                              st.tk)
            st.ress = torch.abs(torch.dot(st.Fk_old, st.zeta_h))

        def r_trial(st, step, step_lo, nu_step):
            lam_t, Z_t = trial(st.lam_c, st.zeta_h, st.Wk, st.At_lam,
                               st.At_zeta, st.tk, step, step_lo)
            cF_new = merit(st, lam_t, Z_t, st.wlk, st.bk1h, st.tk)
            nF = torch.linalg.vector_norm(F_of(st, lam_t, Z_t, st.bk1h,
                                              st.wlk))
            conv, stag = exit_test(st.nFk_old, nF, st.ssn_tol)
            return cF_new <= st.cF_old - nu_step * st.ress, conv | stag, nF

        def r_accept(st):
            lam_t, Z_t = trial(st.lam_c, st.zeta_h, st.Wk, st.At_lam,
                               st.At_zeta, st.tk, st.step,
                               st.step.to(dtype))
            conv, stag = exit_test(st.nFk_old, st.nF_sel, st.ssn_tol)
            # A stagnation exit that leaves ||F|| above the tolerance is
            # rejected (it carried < ssn_tol/100 of progress).
            reject = stag & ~conv
            st.lam_c = torch.where(reject, st.lam_c, lam_t)
            st.Zk = torch.where(reject, st.Zk_old, Z_t)

        def r_tail(st):
            (st.X1, st.V1, st.lam1, st.bk_out, st.resk, st.rec) = tail(
                st, st.X, st.lam, st.ak, st.bk1, st.Zk, st.lam_c,
                st.u.to(dtype), st.resk_prev, st.kkt0,
                (st.ncomp, st.last, st.it_min, st.it_sum, st.it_max,
                 st.fail))

        def r_solve(st, key):
            return solver(st.S, zeros_t, st.bk1, st.tk, st.rhs, key)

        mesh = api.live_mesh(prob.mesh)
        regions = Regions(
            step_signature(1, (C, gama, p, q, b), exit_every,
                           (capacitated, opts.nu, opts.ssn_tol1,
                            opts.restart_bk_floor, solver_maxit), mesh),
            dev, mesh, opts, exit_every, solver_maxit)
        fns = StepFns(r_head, r_pre, r_prepare, r_trial, r_accept, r_tail,
                      r_solve)
        token = object()

        def blocked_step(k, X, V, lam, bk, key, resk_prev, kkt_norm0,
                         conv_prev=None, record=False):
            """One APD iteration as regions; the SsN chain's key, then
            the restart draw's, split off as the loop splits them."""
            st = regions.st
            regions.own(token, data)
            key, sub = jr.split(key)
            key, sub_r = jr.split(key)
            regions.load(
                kf2=float(k * k), u=float(jr.uniform(sub_r, (), dtype)),
                X=X, V=V, lam=lam, bk=bk, resk_prev=resk_prev,
                kkt0=kkt_norm0, conv=False if conv_prev is None else conv_prev)
            it = regions.ssn(fns, sub)
            if it is None:
                return None
            # The state is written anew by the next step: copies out.
            rec = StepRecord(it, st.rec.clone())
            metrics = rec if record else read_metrics(it, fetch(rec.rec))
            return (st.X1.clone(), st.V1.clone(), st.lam1.clone(),
                    st.bk_out.clone(), key, st.resk.clone(), metrics)

        blocked_step.regions = regions
        return api.on_mesh(prob.mesh, blocked_step)

    def ssn_solve(Wk, wlk, lam0, bk1, tk, ssn_tol, key, conv_prev):
        """The SsN loop (``Class1/APD_SsN_Class1.m:137-238``).  ``lam0``,
        ``wlk`` and ``bk1`` are in the dual dtype, the z-space arrays in
        the plan's.  None when ``conv_prev`` reads set."""
        lam = lam0
        Zk = (Wk - op.apply_At(lam0.to(dtype), p, q)) / tk
        nF0 = torch.linalg.vector_norm(F_of(loop_d, lam, Zk, bk1, wlk))
        it = 0
        counters = ssn_counters(dev)
        ncomp = last = torch.zeros((), dtype=torch.int64, device=dev)
        if conv_prev is None:
            done = bool(fetch(nF0 <= ssn_tol))
        else:
            done, stop = fetch(torch.stack([nF0 <= ssn_tol, conv_prev]))
            if stop:
                return None
        while not done:
            lam_old = lam
            At_lam, Zk_old, S, Fk_old, nFk_old = pre(loop_d, lam_old, Wk, tk,
                                                     bk1, wlk)
            key, sub = jr.split(key)
            sol = solver(S, zeros_t, bk1.to(dtype), tk, (-Fk_old).to(dtype),
                         sub)
            zeta = sol.zeta.to(hi)
            At_zeta = op.apply_At(sol.zeta.to(dtype), p, q)
            cF_old = merit(loop_d, lam_old, Zk_old, wlk, bk1, tk)
            ress = torch.abs(torch.dot(Fk_old, zeta))

            def try_step(step):
                lam_t, Z_t = trial(lam_old, zeta, Wk, At_lam, At_zeta, tk,
                                   step, step)
                cF_new = merit(loop_d, lam_t, Z_t, wlk, bk1, tk)
                return cF_new <= cF_old - opts.nu * step * ress, (lam_t, Z_t)

            lam_t, Z_t = armijo(try_step, opts)
            nFk_new = torch.linalg.vector_norm(F_of(loop_d, lam_t, Z_t, bk1,
                                                    wlk))
            it += 1
            conv, stag = exit_test(nFk_old, nFk_new, ssn_tol)
            # A stagnation exit that leaves ||F|| above the tolerance is
            # rejected (it carried < ssn_tol/100 of progress).
            reject = stag & ~conv
            lam = torch.where(reject, lam_old, lam_t)
            Zk = torch.where(reject, Zk_old, Z_t)
            counters = count_solve(counters, sol.iters, solver_maxit)
            ncomp, last = sol.ncomp, sol.last
            done = bool(fetch(conv | stag)) or it >= opts.ssn_maxit
        return _Ssn(lam, Zk, it, *counters, ncomp, last)

    def outer_step(k, X, V, lam, bk, key, resk_prev, kkt_norm0,
                   conv_prev=None, record=False):
        """One APD iteration (``Class1/APD_SsN_Class1.m:101-275``);
        ``record`` leaves the metrics on the device."""
        kf2 = torch.full((), float(k * k), dtype=dtype, device=dev)
        ak, bk1, tk, ssn_tol, Wk, wlk = head(loop_d, kf2, X, V, lam, bk)
        key, sub = jr.split(key)
        ssn = ssn_solve(Wk, wlk, lam, bk1.to(hi), tk, ssn_tol, sub,
                        conv_prev)
        if ssn is None:
            return None
        key, sub = jr.split(key)
        X1, V1, lam1, bk1, resk, rec = tail(
            loop_d, X, lam, ak, bk1, ssn.Zk, ssn.lam,
            jr.uniform(sub, (), dtype, dev), resk_prev, kkt_norm0,
            (ssn.ncomp, ssn.last, ssn.it_min, ssn.it_sum, ssn.it_max,
             ssn.fail))
        rec = StepRecord(ssn.it, rec)
        metrics = (rec if record
                   else read_metrics(rec.ssn_it, fetch(rec.rec)))
        return X1, V1, lam1, bk1, key, resk, metrics

    return api.on_mesh(prob.mesh, outer_step)


class _History:
    """The per-iteration records of a Class-1 solve, index 0 the warm
    start."""

    def __init__(self, kx0, kl0, fx0, verbose: bool):
        self.kx0, self.kl0 = kx0, kl0
        self.kkt_x, self.kkt_l, self.fxk = [kx0], [kl0], [fx0]
        self.ssn_itnum, self.solver_itnum, self.restarts = [], [], []
        self.info_ncomp, self.info_last = [], []
        self.fail_total = self.inner_total = 0
        self.verbose = verbose

    def add(self, k: int, mtr: OuterMetrics, kkt_tol: float) -> bool:
        """Record iteration ``k``; True when it converged."""
        self.kkt_x.append(mtr.kkt_x)
        self.kkt_l.append(mtr.kkt_l)
        self.fxk.append(mtr.fxk)
        self.ssn_itnum.append(mtr.ssn_it)
        self.solver_itnum.append((mtr.it_min, mtr.it_avg, mtr.it_max))
        self.restarts.append(mtr.restarted)
        self.info_ncomp.append(mtr.ncomp)
        self.info_last.append(mtr.last)
        self.fail_total += mtr.fail
        self.inner_total += mtr.it_sum
        if self.verbose:
            print(f"APD it={k:3d} kkt_x={mtr.kkt_x:.2e} "
                  f"kkt_l={mtr.kkt_l:.2e} fk={mtr.fxk:.6e} "
                  f"ssn={mtr.ssn_it} inner={self.solver_itnum[-1]}"
                  + (" RESTART" if mtr.restarted else ""))
        return max(mtr.kkt_x / (1 + self.kx0),
                   mtr.kkt_l / (1 + self.kl0)) <= kkt_tol

    def result(self, X, lam, converged, iters, t0, state=None):
        return SolveResult(
            X=X, lam=lam, converged=converged, iters=iters,
            kkt_x=np.asarray(self.kkt_x), kkt_l=np.asarray(self.kkt_l),
            fxk=np.asarray(self.fxk), ssn_itnum=np.asarray(self.ssn_itnum),
            solver_itnum=np.asarray(self.solver_itnum),
            restarts=np.asarray(self.restarts), fail_count=self.fail_total,
            wall_time=time.perf_counter() - t0,
            inner_total=self.inner_total, state=state,
            info_ncomp=np.asarray(self.info_ncomp),
            info_last=np.asarray(self.info_last))


def _start(prob: Class1Problem, opts: APDOptions, warm):
    """Warm start and its KKT residuals on the device: ``(X, lam, kx0,
    kl0, fx0)``, ``lam`` in the dual dtype."""
    C = prob.C
    hi, acc = hi_dtypes(C.dtype)
    if warm is None:
        X, lam = warmup_class1(prob, opts.warmup.maxit)
    else:
        X, lam = warm
    lam = lam.to(hi)
    kx, kl = op.kkt_class1(X, lam, C, prob.b, prob.p, prob.q, prob.gama, acc)
    return X, lam, kx, kl, op.vdot_plan(C, X)


def _resume(checkpoint_dir, X, lam, bk, key, resk, mesh=None):
    """``(X, V, lam, bk, key, resk, k_start)`` from the latest
    checkpoint; the warm-start state is the template (each array returns
    on its device and in its dtype), ``mesh`` that of a sharded state."""
    from otamg_torch.diag import checkpoint as ckpt

    st = ckpt.load_state(checkpoint_dir, template=dict(
        X=X, V=X, lam=lam, bk=bk, key=key, resk=resk), mesh=mesh)
    return (st.X, st.V, st.lam, st.bk, st.key,
            resk if st.resk is None else st.resk, st.k + 1)


@api.on_problem_mesh
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
    X, lam, kx, kl, fx = _start(prob, opts, warm)
    kx0, kl0, fx0 = fetch(torch.stack([t.to(torch.float64)
                                       for t in (kx, kl, fx)]))
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
            X, V, lam, bk, key, resk, k_start = _resume(
                checkpoint_dir, X, lam, bk, key, resk, prob.mesh)

    hist = _History(kx0, kl0, fx0, verbose)
    converged = False
    k_final = opts.maxit
    for k in range(k_start, opts.maxit + 1):
        X, V, lam, bk, key, resk, mtr = step(k, X, V, lam, bk, key, resk,
                                             kkt_norm0)
        if hist.add(k, mtr, opts.kkt_tol):
            converged = True
            k_final = k
            break
        if checkpoint_dir is not None and k % checkpoint_every == 0:
            from otamg_torch.diag import checkpoint as ckpt

            ckpt.save_state(checkpoint_dir,
                            ckpt.APDState(X, V, lam, bk, key, k, resk),
                            prob.mesh)

    return hist.result(X, lam, converged, k_final, t0,
                       (X, V, lam, bk, key) if return_state else None)


FUSED_EXIT_EVERY = 8
"""The read interval of the inner loops under :func:`solve_class1_fused`
and :func:`otamg_torch.opt.apd2.solve_class2_fused`."""


@api.on_problem_mesh
def solve_class1_chunked(prob: Class1Problem,
                         opts: APDOptions = APDOptions(),
                         solver: NewtonSolver | None = None,
                         warm: tuple | None = None,
                         chunk: int = 8,
                         verbose: bool = False,
                         checkpoint_dir: str | None = None,
                         resume: bool = False) -> SolveResult:
    """Chunked driver: the trajectory of :func:`solve_class1` with the
    records of ``chunk`` outer iterations read at once, and every loop
    inside the step reading once per block of ``chunk`` tests
    (``make_class1_step(exit_every=chunk)``; on a card the AMG cycles of
    a block replay as one CUDA graph).  A step's convergence flag stays
    on the device and rides on the next step's first read.

    ``checkpoint_dir`` saves the state, in the loop driver's format, at
    every chunk boundary; ``resume=True`` restores the latest checkpoint
    (the loop driver's too) and continues on the uninterrupted
    trajectory.  A row-sharded problem runs with its mesh active, as in
    :func:`solve_class1`, its checkpoints one file per process."""
    t0 = time.perf_counter()
    C = prob.C
    dtype, dev = C.dtype, C.device
    X, lam, kx, kl, fx = _start(prob, opts, warm)
    kx0, kl0, fx0 = fetch(torch.stack([t.to(torch.float64)
                                       for t in (kx, kl, fx)]))
    kkt_norm0 = torch.tensor([kx0, kl0], dtype=dtype, device=dev)
    V = X

    step = make_class1_step(prob, opts, solver, exit_every=chunk)
    key = jr.PRNGKey(opts.seed)
    bk = torch.ones((), dtype=dtype, device=dev)
    resk = torch.tensor(max(kx0, kl0), dtype=dtype, device=dev)
    k = 1
    if resume and checkpoint_dir is not None:
        from otamg_torch.diag import checkpoint as ckpt

        if ckpt.latest_step(checkpoint_dir) is not None:
            X, V, lam, bk, key, resk, k = _resume(checkpoint_dir, X, lam,
                                                  bk, key, resk, prob.mesh)

    hist = _History(kx0, kl0, fx0, verbose)
    converged = False
    while k <= opts.maxit and not converged:
        pending, conv = [], None
        while len(pending) < chunk and k <= opts.maxit:
            out = step(k, X, V, lam, bk, key, resk, kkt_norm0, conv,
                       record=True)
            if out is None:
                break
            X, V, lam, bk, key, resk, rec = out
            pending.append(rec)
            conv = torch.maximum(rec.rec[0] / (1 + kx0),
                                 rec.rec[1] / (1 + kl0)) <= opts.kkt_tol
            k += 1
        rows = fetch(torch.stack([r.rec for r in pending]))
        k0 = k - len(pending)
        for i, (r, row) in enumerate(zip(pending, rows)):
            converged = hist.add(k0 + i, read_metrics(r.ssn_it, row),
                                 opts.kkt_tol)
        if checkpoint_dir is not None and not converged:
            from otamg_torch.diag import checkpoint as ckpt

            ckpt.save_state(checkpoint_dir,
                            ckpt.APDState(X, V, lam, bk, key, k - 1, resk),
                            prob.mesh)
    return hist.result(X, lam, converged, k - 1, t0)


@api.on_problem_mesh
def solve_class1_fused(prob: Class1Problem,
                       opts: APDOptions = APDOptions(),
                       solver: NewtonSolver | None = None,
                       warm: tuple | None = None) -> SolveResult:
    """Fused driver: warm start and the whole APD loop with no read of
    their own.  Every loop inside the step reads once per block of
    :data:`FUSED_EXIT_EVERY` tests; each step's convergence flag rides on
    the next step's first read; the records stay in ``(maxit + 1)``-long
    device tensors, read once at the end.  The trajectory of
    :func:`solve_class1`, on a row-sharded problem too."""
    t0 = time.perf_counter()
    C = prob.C
    dtype, dev = C.dtype, C.device
    X, lam, kx, kl, fx = _start(prob, opts, warm)
    kx0, kl0 = kx.to(torch.float64), kl.to(torch.float64)
    kkt_norm0 = torch.stack([kx, kl]).to(dtype)
    V = X
    step = make_class1_step(prob, opts, solver, exit_every=FUSED_EXIT_EVERY)
    key = jr.PRNGKey(opts.seed)
    bk = torch.ones((), dtype=dtype, device=dev)
    resk = torch.maximum(kx, kl).to(dtype)
    recs = torch.zeros((opts.maxit + 1, 10), dtype=torch.float64,
                       device=dev)
    recs[0, :3] = torch.stack([kx0, kl0, fx.to(torch.float64)])
    ssn_it = [0]
    conv = None
    for k in range(1, opts.maxit + 1):
        out = step(k, X, V, lam, bk, key, resk, kkt_norm0, conv,
                   record=True)
        if out is None:
            break
        X, V, lam, bk, key, resk, rec = out
        recs[k] = rec.rec
        ssn_it.append(rec.ssn_it)
        conv = torch.maximum(rec.rec[0] / (1 + kx0),
                             rec.rec[1] / (1 + kl0)) <= opts.kkt_tol
    iters = len(ssn_it) - 1
    rows = fetch(recs[:iters + 1])
    hist = _History(rows[0][0], rows[0][1], rows[0][2], False)
    converged = False
    for k in range(1, iters + 1):
        converged = hist.add(k, read_metrics(ssn_it[k], rows[k]),
                             opts.kkt_tol)
    return hist.result(X, lam, converged, iters, t0)
