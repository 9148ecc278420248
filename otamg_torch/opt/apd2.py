"""APD + SsN outer optimizer for problem Class 2, partial OT (port of the
loop driver of ``otamg/opt/apd2.py``).

The three-block primal ``(x, y, z)`` and ``(n+m+1)``-dimensional dual of
``Class2/APD_SsN_Class2.m:95-285``.  Differences from Class 1, kept as
the JAX package has them:

* prox is the nonnegative projection (``:25``);
* SsN floor tolerance 1e-10 (``:28``);
* the stagnation break uses ``< SsN_Tol``, not ``/100`` (``:223``), and a
  stagnation exit that leaves ``||F||`` above the tolerance is rejected;
* in the marginal tail (x/y/z residuals at target, only the feasibility
  residual above) the SsN entry test is relaxed to ``10 * SsN_Tol``;
* the restart sets ``bk1 = 10*bk1`` with no random draw (``:254``);
* four KKT residuals (x, y, z, lambda; ``:56-59``).

As in :mod:`otamg_torch.opt.apd` the JAX while-loops are Python loops
that read one flag per test, and the outer step reads its metrics once.
``H^T lam`` is affine in the Armijo step, so ``H^T zeta`` is computed
once per SsN step.  Slack blocks ``(y; z)`` travel as one ``(n + m,)``
vector ``us``.  With an fp32 plan the dual state and the O(mn)
reductions into the dual space are f64, as in
:mod:`otamg_torch.opt.apd`.  ``solve_class2`` checkpoints and resumes as
``solve_class1`` does; ``solve_class2_chunked`` and
``solve_class2_fused`` follow its trajectory with fewer host reads, as
their Class-1 counterparts do, and polish only at exit.  A row-sharded
problem (:func:`otamg_torch.dist.shard_class2`) runs through every
driver as in :mod:`otamg_torch.opt.apd`: the plan blocks are this
rank's rows, the slacks ``us`` and the duals are replicated.
"""

from __future__ import annotations

import dataclasses
import time
import types
from typing import Any, NamedTuple

import numpy as np
import torch

from otamg_torch import random as jr
from otamg_torch.config import AMGOptions, APDOptions, InnerSolver
from otamg_torch.device import fetch
from otamg_torch.dist import api
from otamg_torch.krylov.pcg import pcg
from otamg_torch.opt.admm import warmup_class2
from otamg_torch.opt.apd import (FUSED_EXIT_EVERY, StepRecord, armijo,
                                 hi_dtypes)
from otamg_torch.opt.newton import NewtonSolveResult, NewtonSolver
from otamg_torch.opt.regions import (Regions, StepFns, count_solve,
                                     ssn_counters, step_signature)
from otamg_torch.ot import operators as op
from otamg_torch.ot.problems import Class2Problem


def default_class2_options() -> APDOptions:
    """Reference Class-2 budgets: SsN floor tolerance 1e-10
    (``Class2/APD_SsN_Class2.m:28``) and AMG ``maxit=40, smoth=10``
    (``Class2/APD_SsN_Class2.m:80-81``; the Class-1 defaults are 30/5)."""
    return APDOptions(ssn_tol1=1e-10, amg=AMGOptions(maxit=40, smoth=10))


class Outer2Metrics(NamedTuple):
    kkt_x: float
    kkt_y: float
    kkt_z: float
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
class Solve2Result:
    X: Any
    y: Any
    z: Any
    lam: Any
    converged: bool
    iters: int
    kkt: np.ndarray            # (iters+1, 4) raw norms [x, y, z, lam]
    fxk: np.ndarray
    ssn_itnum: np.ndarray
    solver_itnum: np.ndarray
    restarts: np.ndarray
    fail_count: int
    wall_time: float
    inner_total: int = 0       # total inner-solver iterations
    info_ncomp: np.ndarray | None = None  # per-outer info[0] (num_comp)
    info_last: np.ndarray | None = None   # per-outer info[1] (it_num)
    polished: bool = False     # the feasibility polish was accepted


def make_pot_solver_from_options(p, q, Phi, opts: APDOptions,
                                 exit_every: int = 1) -> NewtonSolver:
    """The Class-2 ``inner_solver`` menu; ``exit_every`` is the AMG
    solvers' read interval."""
    from otamg_torch.hybrid.pot import (make_pot_amg_solver,
                                        make_pot_direct_solver,
                                        make_pot_pcg_solver)

    if opts.inner_solver == InnerSolver.DIRECT:
        return make_pot_direct_solver(p, q, Phi)
    if opts.inner_solver == InnerSolver.PCG:
        return _make_arrow_pcg_solver(p, q, Phi, opts)
    if opts.inner_solver == InnerSolver.AUG_PCG:
        return make_pot_pcg_solver(p, q, Phi, opts.pcg)
    if opts.inner_solver == InnerSolver.AMG:
        return make_pot_amg_solver(p, q, Phi, opts.amg,
                                   solve_dtype=opts.solve_dtype,
                                   exit_every=exit_every)
    if opts.inner_solver == InnerSolver.TWOGRID:
        return make_pot_amg_solver(p, q, Phi, opts.amg, twogrid=True,
                                   solve_dtype=opts.solve_dtype,
                                   exit_every=exit_every)
    raise ValueError(f"unknown inner solver {opts.inner_solver}")


def _make_arrow_pcg_solver(p, q, Phi, opts: APDOptions) -> NewtonSolver:
    """Matrix-free Jacobi-PCG on the full (n+m+1) arrow Jacobian
    (``inner_solver=2``, ``Class2/APD_SsN_Class2.m:153-159``): the extra
    row is ``ss = A (S*Phi)`` with corner ``spp = <Phi, S*Phi>``."""

    def solve(S, tvec, bk1, tk, rhs, key=None) -> NewtonSolveResult:
        del key
        d1, d2 = op.asat_diags(S, p, q)
        SPhi = S * Phi
        ss = op.apply_A(SPhi, p, q)
        spp = op.vdot_plan(Phi, SPhi)
        diag = bk1 + torch.cat([tvec + torch.cat([d1, d2]), spp[None]]) / tk

        def matvec(v):
            v1, vlast = v[:-1], v[-1]
            top = (tvec * v1 + op.apply_asat(v1, S, p, q, d1, d2)
                   + vlast * ss) / tk
            bot = (torch.dot(ss, v1) + spp * vlast) / tk
            return bk1 * v + torch.cat([top, bot[None]])

        r = pcg(matvec, rhs, lambda v: v / diag,
                retol=opts.pcg.retol, maxit=opts.pcg.maxit)
        zero = torch.zeros((), dtype=torch.int64, device=rhs.device)
        return NewtonSolveResult(r.x, r.iters, r.res, zero, zero)

    return solve


class _Ssn2(NamedTuple):
    lam: torch.Tensor
    ZX: torch.Tensor       # (m, n) plan block of z(lam)
    zs: torch.Tensor       # (n + m,) slack block of z(lam)
    it: int
    it_min: torch.Tensor
    it_sum: torch.Tensor
    it_max: torch.Tensor
    fail: torch.Tensor
    ncomp: torch.Tensor
    last: torch.Tensor


def _merit2(lam, ZX, zs, wlk, bk1, tk, acc=None):
    """Dual merit of the Class-2 Armijo search: ``f0 + tk/2 (||prox(z_X)||^2
    + ||prox(z_s)||^2)``."""
    f0 = bk1 / 2 * torch.dot(lam, lam) - torch.dot(wlk, lam)
    PX = op.prox_nonneg(ZX)
    ps = op.prox_nonneg(zs)
    return f0 + 0.5 * tk * (op.vdot_plan(PX, PX, acc)
                            + op.vdot_hi(ps, ps, acc))


def read_metrics2(ssn_it: int, row) -> Outer2Metrics:
    """:class:`Outer2Metrics` from a Class-2 :class:`StepRecord`'s host
    row ``kkt_x, kkt_y, kkt_z, kkt_l, fxk, restarted, ncomp, last,
    it_min, it_sum, it_max, fail``."""
    kx, ky, kz, kl, fx, rs, nc, la, imin, isum, imax, fail = row
    done = ssn_it > 0
    return Outer2Metrics(
        kkt_x=kx, kkt_y=ky, kkt_z=kz, kkt_l=kl, fxk=fx, ssn_it=ssn_it,
        it_min=int(imin) if done else -1,
        it_avg=int(isum) // max(ssn_it, 1) if done else -1,
        it_max=int(imax) if done else -1, it_sum=int(isum), fail=int(fail),
        restarted=bool(rs), ncomp=int(nc), last=int(la))


def make_class2_step(prob: Class2Problem, opts: APDOptions,
                     solver: NewtonSolver | None = None,
                     exit_every: int = 1):
    """Build the Class-2 APD outer step ``(k, X, us, VX, vs, lam, bk, key,
    kkt0, prev_kkt, conv_prev=None, record=False) -> (X, us, VX, vs, lam,
    bk, key, metrics)`` for ``prob``.  ``kkt0`` holds the warm start's
    four raw KKT residuals and ``prev_kkt`` the previous step's (``kkt0``
    at ``k = 1``), on the host or the device; the residuals are rounded
    to the plan's dtype, as the JAX package keeps them on its device.
    With ``solver=None`` the Newton solver is built here, once, with the
    same ``exit_every``.  ``lam`` is in the dual dtype of
    :func:`otamg_torch.opt.apd.hi_dtypes`.

    ``exit_every``, ``conv_prev`` and ``record`` as in
    :func:`otamg_torch.opt.apd.make_class1_step`: above 1 the step runs
    as the regions of :mod:`otamg_torch.opt.regions`; ``metrics`` holds
    host numbers (one read per step) or, with ``record``, is a
    :class:`otamg_torch.opt.apd.StepRecord`."""
    p, q, C, Phi = prob.p, prob.q, prob.C, prob.Phi
    b = prob.b
    n = prob.n
    dtype, dev = C.dtype, C.device
    hi, acc = hi_dtypes(dtype)
    if solver is None:
        solver = make_pot_solver_from_options(p, q, Phi, opts, exit_every)
    solver_maxit = (opts.amg.maxit if opts.inner_solver in
                    (InnerSolver.AMG, InnerSolver.TWOGRID)
                    else opts.pcg.maxit)

    # The problem's tensors, ``b`` made once (a property, which gathers
    # under a mesh), and the step's algebra over ``d``, which holds them:
    # ``loop_d`` (the loop) or the regions' state.
    data = dict(C=C, Phi=Phi, p=p, q=q, b=b)
    loop_d = types.SimpleNamespace(**data)

    def Hu(d, X, us, out_dtype=None):
        return op.apply_H(X, us[:n], us[n:], d.p, d.q, d.Phi, out_dtype)

    def z_of(d, lam, WX, ws, tk):
        """``(H^T lam, z(lam))``, each split into its plan and slack
        blocks."""
        HtX, Hts = op.apply_Ht(lam.to(dtype), d.p, d.q, d.Phi)
        return HtX, Hts, (WX - HtX) / tk, (ws - Hts) / tk

    def F_of(d, lam, ZX, zs, bk1, wlk):
        PX, ps = op.prox_nonneg(ZX), op.prox_nonneg(zs)
        return bk1 * lam - Hu(d, PX, ps, acc).to(hi) - wlk

    def head(d, kf2, X, us, VX, vs, lam, bk, kkt0, prev_kkt):
        """``(ak, bk1, tk, ssn_tol, WX, ws, wlk, tail)`` of step ``k``
        (``kf2 = k^2`` on the device, as in Class 1); ``tail`` (a device
        flag) is the marginal-tail signature of the previous step."""
        ak = torch.sqrt(kf2 * bk)
        bk1 = bk / (1 + ak)
        tk = bk * (1 + ak) / (ak * ak)
        ssn_tol = torch.clamp_min(bk1 / kf2, opts.ssn_tol1)
        WX = -d.C + bk * (X + ak * VX) / (ak * ak)
        ws = bk * (us + ak * vs) / (ak * ak)   # the slack block of c is 0
        b_hi = d.b.to(hi)
        wlk = bk1 * (lam - (Hu(d, X, us, acc).to(hi) - b_hi) / bk) - b_hi
        prev_rel = prev_kkt / (1 + kkt0)
        tail = ((prev_rel[:3].amax() <= opts.kkt_tol)
                & (prev_rel[3] > opts.kkt_tol))
        return ak, bk1, tk, ssn_tol, WX, ws, wlk, tail

    def entry_tol(tail, ssn_tol):
        # In the marginal tail the previous lambda already meets the
        # inexactness criterion up to a constant, and noise-scale Newton
        # nudges would re-excite the feasibility residual.
        return torch.where(tail, 10.0 * ssn_tol, ssn_tol)

    def pre(d, lam, WX, ws, tk, bk1, wlk):
        """``(H^T lam, z, S, tmask, F, ||F||)`` at the SsN iterate
        ``lam``, ``H^T lam`` and ``z`` as their two blocks."""
        HtX, Hts, ZX, zs = z_of(d, lam, WX, ws, tk)
        Fk = F_of(d, lam, ZX, zs, bk1, wlk)
        return (HtX, Hts, ZX, zs, (ZX >= 0).to(dtype), (zs >= 0).to(dtype),
                Fk, torch.linalg.vector_norm(Fk))

    def trial(lam_old, zeta, WX, ws, HtX, Hts, HtzX, Htzs, tk, step,
              step_lo):
        """An Armijo trial's ``(lam, z_X, z_s)`` (:199-231), affine in the
        step."""
        return (lam_old + step * zeta, (WX - HtX - step_lo * HtzX) / tk,
                (ws - Hts - step_lo * Htzs) / tk)

    def exit_test(nFk_old, nFk_new, ssn_tol):
        # Class 2's stagnation test uses the full tolerance (:223).
        return nFk_new <= ssn_tol, torch.abs(nFk_old - nFk_new) < ssn_tol

    def tail_of(d, X, us, lam, ak, bk1, ZX, zs, lam1, kkt0, prev_kkt, info):
        """``(X1, us1, VX1, vs1, lam1, bk1, rec)``: the new iterate after
        the restart (:246-256: the normalized new residual against the
        raw previous one, as the reference does; no draw) and the record
        row; ``info`` as in Class 1."""
        X1 = op.prox_nonneg(ZX)
        us1 = op.prox_nonneg(zs)
        VX1 = X1 + (X1 - X) / ak
        vs1 = us1 + (us1 - us) / ak
        kk = op.kkt_class2(X1, us1[:n], us1[n:], lam1, d.C, d.b, d.p, d.q,
                           d.Phi, acc)
        rr = torch.amax(torch.stack([r / (1 + r0)
                                     for r, r0 in zip(kk, kkt0)]))
        restart = (bk1 < opts.restart_bk_floor) & (rr > prev_kkt.amax())
        bk1 = torch.where(restart, 10 * bk1, bk1)
        X1 = torch.where(restart, X, X1)
        us1 = torch.where(restart, us, us1)
        lam1 = torch.where(restart, lam, lam1)
        VX1 = torch.where(restart, X, VX1)
        vs1 = torch.where(restart, us, vs1)
        kx, ky, kz, kl = op.kkt_class2(X1, us1[:n], us1[n:], lam1, d.C, d.b,
                                       d.p, d.q, d.Phi, acc)
        fxk = op.vdot_plan(d.C, X1, acc)
        rec = torch.stack([t.to(torch.float64)
                           for t in (kx, ky, kz, kl, fxk, restart, *info)])
        return X1, us1, VX1, vs1, lam1, bk1, rec

    if exit_every > 1:
        def r_pre(st):
            (st.HtX_old, st.Hts_old, st.ZX_old, st.zs_old, st.S, st.tmask,
             st.Fk_old, st.nFk_old) = pre(st, st.lam_c, st.WX, st.ws, st.tk,
                                          st.bk1h, st.wlk)
            st.rhs = (-st.Fk_old).to(dtype)

        def r_head(st):
            (st.ak, st.bk1, st.tk, st.ssn_tol, st.WX, st.ws, st.wlk,
             tail) = head(st, st.kf2.to(dtype), st.X, st.us, st.VX, st.vs,
                          st.lam, st.bk, st.kkt0, st.prev_kkt)
            st.bk1h = st.bk1.to(hi)
            st.lam_c = st.lam
            st.it_min, st.it_sum, st.it_max, st.fail = ssn_counters(dev)
            st.ncomp = st.last = torch.zeros((), dtype=torch.int64,
                                             device=dev)
            r_pre(st)
            st.ZX, st.zs = st.ZX_old, st.zs_old
            st.flags = torch.stack([
                st.nFk_old <= entry_tol(tail, st.ssn_tol), st.conv])

        def r_prepare(st):
            st.zeta_h = st.zeta.to(hi)
            st.HtzX, st.Htzs = op.apply_Ht(st.zeta.to(dtype), st.p, st.q,
                                           st.Phi)
            st.cF_old = _merit2(st.lam_c, st.ZX_old, st.zs_old, st.wlk,
                                st.bk1h, st.tk, acc)
            st.ress = torch.abs(torch.dot(st.Fk_old, st.zeta_h))

        def r_trial_at(st, step, step_lo):
            return trial(st.lam_c, st.zeta_h, st.WX, st.ws, st.HtX_old,
                         st.Hts_old, st.HtzX, st.Htzs, st.tk, step, step_lo)

        def r_trial(st, step, step_lo, nu_step):
            lam_t, ZX_t, zs_t = r_trial_at(st, step, step_lo)
            cF_new = _merit2(lam_t, ZX_t, zs_t, st.wlk, st.bk1h, st.tk, acc)
            nF = torch.linalg.vector_norm(F_of(st, lam_t, ZX_t, zs_t,
                                              st.bk1h, st.wlk))
            conv, stag = exit_test(st.nFk_old, nF, st.ssn_tol)
            return cF_new <= st.cF_old - nu_step * st.ress, conv | stag, nF

        def r_accept(st):
            lam_t, ZX_t, zs_t = r_trial_at(st, st.step, st.step.to(dtype))
            conv, stag = exit_test(st.nFk_old, st.nF_sel, st.ssn_tol)
            # A stagnation exit above the tolerance is rejected: in the
            # marginal tail such sub-tolerance nudges re-excite kkt_l.
            reject = stag & ~conv
            st.lam_c = torch.where(reject, st.lam_c, lam_t)
            st.ZX = torch.where(reject, st.ZX_old, ZX_t)
            st.zs = torch.where(reject, st.zs_old, zs_t)

        def r_tail(st):
            (st.X1, st.us1, st.VX1, st.vs1, st.lam1, st.bk_out,
             st.rec) = tail_of(st, st.X, st.us, st.lam, st.ak, st.bk1,
                               st.ZX, st.zs, st.lam_c, st.kkt0, st.prev_kkt,
                               (st.ncomp, st.last, st.it_min, st.it_sum,
                                st.it_max, st.fail))

        def r_solve(st, key):
            return solver(st.S, st.tmask, st.bk1, st.tk, st.rhs, key)

        mesh = api.live_mesh(prob.mesh)
        regions = Regions(
            step_signature(2, (C, Phi, p, q, b), exit_every,
                           (opts.nu, opts.ssn_tol1, opts.restart_bk_floor,
                            opts.kkt_tol, solver_maxit), mesh),
            dev, mesh, opts, exit_every, solver_maxit)
        fns = StepFns(r_head, r_pre, r_prepare, r_trial, r_accept, r_tail,
                      r_solve)
        token = object()

        def blocked_step(k, X, us, VX, vs, lam, bk, key, kkt0, prev_kkt,
                         conv_prev=None, record=False):
            """One APD iteration as regions."""
            st = regions.st
            regions.own(token, data)
            key, sub = jr.split(key)
            regions.load(
                kf2=float(k * k),
                X=X, us=us, VX=VX, vs=vs, lam=lam, bk=bk,
                kkt0=torch.as_tensor(kkt0, dtype=dtype, device=dev),
                prev_kkt=torch.as_tensor(prev_kkt, dtype=dtype, device=dev),
                conv=False if conv_prev is None else conv_prev)
            it = regions.ssn(fns, sub)
            if it is None:
                return None
            # The state is written anew by the next step: copies out.
            rec = StepRecord(it, st.rec.clone())
            metrics = rec if record else read_metrics2(it, fetch(rec.rec))
            return (st.X1.clone(), st.us1.clone(), st.VX1.clone(),
                    st.vs1.clone(), st.lam1.clone(), st.bk_out.clone(), key,
                    metrics)

        blocked_step.regions = regions
        return api.on_mesh(prob.mesh, blocked_step)

    def ssn_solve(WX, ws, wlk, lam0, bk1, tk, ssn_tol, key, tail,
                  conv_prev):
        """The SsN loop (``Class2/APD_SsN_Class2.m:136-243``).  ``tail``
        (a device flag) relaxes the entry test to ``10 * ssn_tol``.  None
        when ``conv_prev`` reads set."""
        lam = lam0
        _, _, ZX, zs = z_of(loop_d, lam0, WX, ws, tk)
        nF0 = torch.linalg.vector_norm(F_of(loop_d, lam0, ZX, zs, bk1, wlk))
        it = 0
        counters = ssn_counters(dev)
        ncomp = last = torch.zeros((), dtype=torch.int64, device=dev)
        if conv_prev is None:
            done = bool(fetch(nF0 <= entry_tol(tail, ssn_tol)))
        else:
            done, stop = fetch(torch.stack([nF0 <= entry_tol(tail, ssn_tol),
                                            conv_prev]))
            if stop:
                return None
        while not done:
            lam_old = lam
            (HtX_old, Hts_old, ZX_old, zs_old, S, tmask, Fk_old,
             nFk_old) = pre(loop_d, lam_old, WX, ws, tk, bk1, wlk)
            key, sub = jr.split(key)
            sol = solver(S, tmask, bk1.to(dtype), tk, (-Fk_old).to(dtype),
                         sub)
            zeta = sol.zeta.to(hi)
            HtzX, Htzs = op.apply_Ht(sol.zeta.to(dtype), p, q, Phi)
            cF_old = _merit2(lam_old, ZX_old, zs_old, wlk, bk1, tk, acc)
            ress = torch.abs(torch.dot(Fk_old, zeta))

            def try_step(step):
                t = trial(lam_old, zeta, WX, ws, HtX_old, Hts_old, HtzX,
                          Htzs, tk, step, step)
                cF_new = _merit2(*t, wlk, bk1, tk, acc)
                return cF_new <= cF_old - opts.nu * step * ress, t

            lam_t, ZX_t, zs_t = armijo(try_step, opts)
            nFk_new = torch.linalg.vector_norm(F_of(loop_d, lam_t, ZX_t, zs_t,
                                                    bk1, wlk))
            it += 1
            conv, stag = exit_test(nFk_old, nFk_new, ssn_tol)
            # A stagnation exit above the tolerance is rejected: in the
            # marginal tail such sub-tolerance nudges re-excite kkt_l.
            reject = stag & ~conv
            lam = torch.where(reject, lam_old, lam_t)
            ZX = torch.where(reject, ZX_old, ZX_t)
            zs = torch.where(reject, zs_old, zs_t)
            counters = count_solve(counters, sol.iters, solver_maxit)
            ncomp, last = sol.ncomp, sol.last
            done = bool(fetch(conv | stag)) or it >= opts.ssn_maxit
        return _Ssn2(lam, ZX, zs, it, *counters, ncomp, last)

    def outer_step(k, X, us, VX, vs, lam, bk, key, kkt0, prev_kkt,
                   conv_prev=None, record=False):
        """One APD iteration (``Class2/APD_SsN_Class2.m:95-285``)."""
        kf2 = torch.full((), float(k * k), dtype=dtype, device=dev)
        kkt0 = torch.as_tensor(kkt0, dtype=dtype, device=dev)
        prev_kkt = torch.as_tensor(prev_kkt, dtype=dtype, device=dev)
        ak, bk1, tk, ssn_tol, WX, ws, wlk, tail = head(
            loop_d, kf2, X, us, VX, vs, lam, bk, kkt0, prev_kkt)
        key, sub = jr.split(key)
        ssn = ssn_solve(WX, ws, wlk, lam, bk1.to(hi), tk, ssn_tol, sub, tail,
                        conv_prev)
        if ssn is None:
            return None
        X1, us1, VX1, vs1, lam1, bk1, rec = tail_of(
            loop_d, X, us, lam, ak, bk1, ssn.ZX, ssn.zs, ssn.lam, kkt0,
            prev_kkt, (ssn.ncomp, ssn.last, ssn.it_min, ssn.it_sum,
                       ssn.it_max, ssn.fail))
        rec = StepRecord(ssn.it, rec)
        metrics = (rec if record
                   else read_metrics2(rec.ssn_it, fetch(rec.rec)))
        return X1, us1, VX1, vs1, lam1, bk1, key, metrics

    return api.on_mesh(prob.mesh, outer_step)


def _polish(prob: Class2Problem, X, us, lam, acc=None):
    """Feasibility polish and an honest re-measurement of the full KKT
    (the tail safeguard; see ``operators.feasibility_polish``).  The
    rounding is dual-aware.  Returns ``(X, us, kkt, fx)`` with ``kkt``
    and ``fx`` on the host (one read)."""
    n = prob.n
    p, q, C, Phi, b = prob.p, prob.q, prob.C, prob.Phi, prob.b
    Xp, yp, zp = op.feasibility_polish(X, us[:n], us[n:], p, q, Phi, b,
                                       lam=lam.to(X.dtype))
    k = op.kkt_class2(Xp, yp, zp, lam, C, b, p, q, Phi, acc)
    got = fetch(torch.stack([t.to(torch.float64)
                             for t in (*k, op.vdot_plan(C, Xp, acc))]))
    return Xp, torch.cat([yp, zp]), np.asarray(got[:4]), got[4]


class _History2:
    """The per-iteration records of a Class-2 solve, index 0 the warm
    start."""

    def __init__(self, kkt0: np.ndarray, fx0: float, verbose: bool):
        self.kkt0 = kkt0
        self.kkt_hist, self.fxk = [kkt0], [fx0]
        self.ssn_itnum, self.solver_itnum, self.restarts = [], [], []
        self.info_ncomp, self.info_last = [], []
        self.fail_total = self.inner_total = 0
        self.verbose = verbose

    def add(self, k: int, mtr: Outer2Metrics) -> np.ndarray:
        """Record iteration ``k``; returns its four KKT residuals."""
        kk = np.asarray([mtr.kkt_x, mtr.kkt_y, mtr.kkt_z, mtr.kkt_l])
        self.kkt_hist.append(kk)
        self.fxk.append(mtr.fxk)
        self.ssn_itnum.append(mtr.ssn_it)
        self.solver_itnum.append((mtr.it_min, mtr.it_avg, mtr.it_max))
        self.restarts.append(mtr.restarted)
        self.info_ncomp.append(mtr.ncomp)
        self.info_last.append(mtr.last)
        self.fail_total += mtr.fail
        self.inner_total += mtr.it_sum
        if self.verbose:
            print(f"APD2 it={k:3d} kkt={kk[0]:.2e}/{kk[1]:.2e}/"
                  f"{kk[2]:.2e}/{kk[3]:.2e} fk={mtr.fxk:.6e} "
                  f"ssn={mtr.ssn_it} inner={self.solver_itnum[-1]}"
                  + (" RESTART" if mtr.restarted else ""))
        return kk

    def result(self, X, us, lam, n, converged, iters, t0, polished):
        return Solve2Result(
            X=X, y=us[:n], z=us[n:], lam=lam, converged=converged,
            iters=iters, kkt=np.asarray(self.kkt_hist),
            fxk=np.asarray(self.fxk), ssn_itnum=np.asarray(self.ssn_itnum),
            solver_itnum=np.asarray(self.solver_itnum),
            restarts=np.asarray(self.restarts), fail_count=self.fail_total,
            wall_time=time.perf_counter() - t0,
            inner_total=self.inner_total,
            info_ncomp=np.asarray(self.info_ncomp),
            info_last=np.asarray(self.info_last), polished=polished)


def _start2(prob: Class2Problem, opts: APDOptions):
    """Warm start and its four KKT residuals and objective stacked on the
    device: ``(X, us, lam, k0)``, ``lam`` in the dual dtype."""
    hi, acc = hi_dtypes(prob.C.dtype)
    ws = warmup_class2(prob, opts.warmup.maxit)
    X, lam = ws.X, ws.lam.to(hi)
    k0 = op.kkt_class2(X, ws.y, ws.z, lam, prob.C, prob.b, prob.p, prob.q,
                       prob.Phi, acc)
    got = torch.stack([t.to(torch.float64)
                       for t in (*k0, op.vdot_plan(prob.C, X))])
    return X, torch.cat([ws.y, ws.z]), lam, got


def _resume2(checkpoint_dir, X, us, lam, bk, key, mesh=None):
    """``(X, us, VX, vs, lam, bk, key, prev_kkt, k_start)`` from the
    latest checkpoint (the warm-start state is the template, ``mesh``
    that of a sharded state)."""
    from otamg_torch.diag import checkpoint as ckpt

    d = ckpt.load_dict(checkpoint_dir, template=dict(
        X=X, us=us, VX=X, vs=us, lam=lam, bk=bk, key=key), mesh=mesh)
    return (d["X"], d["us"], d["VX"], d["vs"], d["lam"], d["bk"], d["key"],
            d["prev_kkt"].numpy(), d["k"] + 1)


@api.on_problem_mesh
def solve_class2(prob: Class2Problem, opts: APDOptions | None = None,
                 solver: NewtonSolver | None = None,
                 verbose: bool = False,
                 checkpoint_dir: str | None = None,
                 checkpoint_every: int = 10,
                 resume: bool = False) -> Solve2Result:
    """End-to-end Class-2 solve: A-ADMM warm start + APD-SsN to relative
    KKT <= 1e-6 (``Class2/APD_SsN_Class2.m:27,276-280``), on the device
    of ``prob``.  With ``opts.feas_polish``, an iteration whose x/y/z
    residuals are at target while the feasibility residual is not tries
    :func:`_polish` and accepts it only on full convergence.

    ``checkpoint_dir``, ``checkpoint_every`` and ``resume`` as in
    :func:`otamg_torch.opt.apd.solve_class1`; the state saved is
    ``X, us, VX, vs, lam, bk, key`` and ``prev_kkt``, the previous
    iteration's four raw KKT residuals (the restart heuristic's)."""
    if opts is None:
        opts = default_class2_options()
    t0 = time.perf_counter()
    n = prob.n
    dtype, dev = prob.C.dtype, prob.C.device
    hi, acc = hi_dtypes(dtype)
    X, us, lam, got = _start2(prob, opts)
    got = fetch(got)
    kkt0 = np.asarray(got[:4])
    # The restart and tail tests read kkt0 and the previous residuals on
    # the device.
    kkt0_d = torch.tensor(kkt0, dtype=torch.float64, device=dev)
    VX, vs = X, us

    step = make_class2_step(prob, opts, solver)
    key = jr.PRNGKey(opts.seed)
    bk = torch.ones((), dtype=dtype, device=dev)
    prev = kkt0_d
    k_start = 1
    if resume and checkpoint_dir is not None:
        from otamg_torch.diag import checkpoint as ckpt

        if ckpt.latest_step(checkpoint_dir) is not None:
            X, us, VX, vs, lam, bk, key, prev, k_start = _resume2(
                checkpoint_dir, X, us, lam, bk, key, prob.mesh)
            prev = torch.as_tensor(prev, device=dev)

    hist = _History2(kkt0, got[4], verbose)
    converged = polished = False
    k_final = opts.maxit
    for k in range(k_start, opts.maxit + 1):
        X, us, VX, vs, lam, bk, key, rec = step(k, X, us, VX, vs, lam, bk,
                                                key, kkt0_d, prev,
                                                record=True)
        kk = hist.add(k, read_metrics2(rec.ssn_it, fetch(rec.rec)))
        prev = rec.rec[:4]
        rr = (kk / (1 + kkt0)).max()
        if rr <= opts.kkt_tol:
            converged = True
            k_final = k
            break
        if (opts.feas_polish
                and (kk[:3] / (1 + kkt0[:3])).max() <= opts.kkt_tol):
            # Complementarity at target, feasibility the sole straggler.
            Xp, usp, kkp, fxp = _polish(prob, X, us, lam, acc)
            if verbose:
                print(f"POLISH it={k} kkt={kkp[0]:.2e}/{kkp[1]:.2e}/"
                      f"{kkp[2]:.2e}/{kkp[3]:.2e} "
                      f"rr={(kkp / (1 + kkt0)).max():.2e}")
            if (kkp / (1 + kkt0)).max() <= opts.kkt_tol:
                X, us = Xp, usp
                hist.kkt_hist[-1] = kkp
                hist.fxk[-1] = fxp
                converged = polished = True
                k_final = k
                break
        if checkpoint_dir is not None and k % checkpoint_every == 0:
            from otamg_torch.diag import checkpoint as ckpt

            ckpt.save_dict(checkpoint_dir, k, dict(
                X=X, us=us, VX=VX, vs=vs, lam=lam, bk=bk, key=key,
                prev_kkt=prev), prob.mesh, sharded=("X", "VX"))

    return hist.result(X, us, lam, n, converged, k_final, t0, polished)


def _polish_applicable(opts: APDOptions, kk: np.ndarray,
                       kkt0: np.ndarray) -> bool:
    """Polish precondition: unconverged, complementarity (x/y/z) at
    target, feasibility (lam) the sole straggler."""
    rr = (kk / (1 + kkt0)).max()
    return bool(opts.feas_polish and rr > opts.kkt_tol
                and (kk[:3] / (1 + kkt0[:3])).max() <= opts.kkt_tol)


def _polish_final(prob: Class2Problem, opts: APDOptions, hist: _History2,
                  X, us, lam, converged: bool):
    """Exit-time feasibility polish of the chunked and fused drivers
    (``otamg/opt/apd2.py:581-604``): the loop driver polishes inline, at
    every iteration it sees; these see the final state only.  When the
    run ends unconverged with x/y/z at target and only the feasibility
    residual stalled, :func:`_polish` is accepted if the re-measured full
    KKT passes.  Returns ``(X, us, converged, polished)``."""
    kkt0 = hist.kkt0
    if converged or len(hist.kkt_hist) < 2 or not _polish_applicable(
            opts, np.asarray(hist.kkt_hist[-1]), kkt0):
        return X, us, converged, False
    Xp, usp, kkp, fxp = _polish(prob, X, us, lam, hi_dtypes(X.dtype)[1])
    if (kkp / (1 + kkt0)).max() > opts.kkt_tol:
        return X, us, False, False
    hist.kkt_hist[-1] = kkp
    hist.fxk[-1] = fxp
    return Xp, usp, True, True


@api.on_problem_mesh
def solve_class2_chunked(prob: Class2Problem,
                         opts: APDOptions | None = None,
                         solver: NewtonSolver | None = None,
                         chunk: int = 8,
                         verbose: bool = False,
                         checkpoint_dir: str | None = None,
                         resume: bool = False) -> Solve2Result:
    """Chunked Class-2 driver (see
    :func:`otamg_torch.opt.apd.solve_class1_chunked`): the trajectory of
    :func:`solve_class2`, except that the feasibility polish, with
    ``opts.feas_polish``, is tried once at exit (:func:`_polish_final`).
    The restart and tail tests read the previous step's residuals on the
    device.  Checkpoints at chunk boundaries, in the loop driver's
    format.  A row-sharded problem runs with its mesh active, as in
    :func:`solve_class2`."""
    if opts is None:
        opts = default_class2_options()
    t0 = time.perf_counter()
    n = prob.n
    dtype, dev = prob.C.dtype, prob.C.device
    X, us, lam, got = _start2(prob, opts)
    got = fetch(got)
    kkt0 = np.asarray(got[:4])
    kkt0_d = torch.tensor(kkt0, dtype=torch.float64, device=dev)
    kkt0_lo = kkt0_d.to(dtype)
    VX, vs = X, us

    step = make_class2_step(prob, opts, solver, exit_every=chunk)
    key = jr.PRNGKey(opts.seed)
    bk = torch.ones((), dtype=dtype, device=dev)
    prev = torch.tensor(kkt0, dtype=dtype, device=dev)
    k = 1
    if resume and checkpoint_dir is not None:
        from otamg_torch.diag import checkpoint as ckpt

        if ckpt.latest_step(checkpoint_dir) is not None:
            X, us, VX, vs, lam, bk, key, prev, k = _resume2(
                checkpoint_dir, X, us, lam, bk, key, prob.mesh)
            prev = torch.as_tensor(prev, dtype=dtype, device=dev)

    hist = _History2(kkt0, got[4], verbose)
    converged = False
    while k <= opts.maxit and not converged:
        pending, conv = [], None
        while len(pending) < chunk and k <= opts.maxit:
            out = step(k, X, us, VX, vs, lam, bk, key, kkt0_lo, prev, conv,
                       record=True)
            if out is None:
                break
            X, us, VX, vs, lam, bk, key, rec = out
            pending.append(rec)
            prev = rec.rec[:4].to(dtype)
            conv = (rec.rec[:4] / (1 + kkt0_d)).amax() <= opts.kkt_tol
            k += 1
        rows = fetch(torch.stack([r.rec for r in pending]))
        k0 = k - len(pending)
        for i, (r, row) in enumerate(zip(pending, rows)):
            kk = hist.add(k0 + i, read_metrics2(r.ssn_it, row))
            converged = bool((kk / (1 + kkt0)).max() <= opts.kkt_tol)
        if checkpoint_dir is not None and not converged:
            from otamg_torch.diag import checkpoint as ckpt

            ckpt.save_dict(checkpoint_dir, k - 1, dict(
                X=X, us=us, VX=VX, vs=vs, lam=lam, bk=bk, key=key,
                prev_kkt=prev), prob.mesh, sharded=("X", "VX"))
    X, us, converged, polished = _polish_final(prob, opts, hist, X, us, lam,
                                               converged)
    return hist.result(X, us, lam, n, converged, k - 1, t0, polished)


@api.on_problem_mesh
def solve_class2_fused(prob: Class2Problem,
                       opts: APDOptions | None = None,
                       solver: NewtonSolver | None = None) -> Solve2Result:
    """Fused Class-2 driver (see
    :func:`otamg_torch.opt.apd.solve_class1_fused`): warm start and the
    whole APD loop with no read of their own, records read once at the
    end, the feasibility polish tried once at exit
    (:func:`_polish_final`), on a row-sharded problem too."""
    if opts is None:
        opts = default_class2_options()
    t0 = time.perf_counter()
    n = prob.n
    dtype, dev = prob.C.dtype, prob.C.device
    X, us, lam, got = _start2(prob, opts)
    kkt0 = got[:4]
    VX, vs = X, us
    step = make_class2_step(prob, opts, solver, exit_every=FUSED_EXIT_EVERY)
    key = jr.PRNGKey(opts.seed)
    bk = torch.ones((), dtype=dtype, device=dev)
    kkt0_lo = prev = kkt0.to(dtype)
    recs = torch.zeros((opts.maxit + 1, 12), dtype=torch.float64,
                       device=dev)
    recs[0, :5] = got
    ssn_it = [0]
    conv = None
    for k in range(1, opts.maxit + 1):
        out = step(k, X, us, VX, vs, lam, bk, key, kkt0_lo, prev, conv,
                   record=True)
        if out is None:
            break
        X, us, VX, vs, lam, bk, key, rec = out
        recs[k] = rec.rec
        ssn_it.append(rec.ssn_it)
        prev = rec.rec[:4].to(dtype)
        conv = (rec.rec[:4] / (1 + kkt0)).amax() <= opts.kkt_tol
    iters = len(ssn_it) - 1
    rows = fetch(recs[:iters + 1])
    kkt0 = np.asarray(rows[0][:4])
    hist = _History2(kkt0, rows[0][4], False)
    converged = False
    for k in range(1, iters + 1):
        kk = hist.add(k, read_metrics2(ssn_it[k], rows[k]))
        converged = bool((kk / (1 + kkt0)).max() <= opts.kkt_tol)
    X, us, converged, polished = _polish_final(prob, opts, hist, X, us, lam,
                                               converged)
    return hist.result(X, us, lam, n, converged, iters, t0, polished)
