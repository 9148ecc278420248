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
``solve_class1`` does; the chunked and fused drivers are not ported.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, NamedTuple

import numpy as np
import torch

from otamg_torch import random as jr
from otamg_torch.config import AMGOptions, APDOptions, InnerSolver
from otamg_torch.device import fetch
from otamg_torch.krylov.pcg import pcg
from otamg_torch.opt.admm import warmup_class2
from otamg_torch.opt.apd import hi_dtypes
from otamg_torch.opt.newton import NewtonSolveResult, NewtonSolver
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


def make_pot_solver_from_options(p, q, Phi, opts: APDOptions) -> NewtonSolver:
    """The Class-2 ``inner_solver`` menu."""
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
                                   solve_dtype=opts.solve_dtype)
    if opts.inner_solver == InnerSolver.TWOGRID:
        return make_pot_amg_solver(p, q, Phi, opts.amg, twogrid=True,
                                   solve_dtype=opts.solve_dtype)
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
        spp = op.vdot_hi(Phi, SPhi)
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
    it_min: int
    it_sum: int
    it_max: int
    fail: int
    ncomp: torch.Tensor
    last: torch.Tensor


def make_class2_step(prob: Class2Problem, opts: APDOptions,
                     solver: NewtonSolver | None = None):
    """Build the Class-2 APD outer step ``(k, X, us, VX, vs, lam, bk, key,
    kkt0, prev_kkt) -> (X, us, VX, vs, lam, bk, key, metrics)`` for
    ``prob``.  ``kkt0`` holds the warm start's four raw KKT residuals and
    ``prev_kkt`` the previous step's (``kkt0`` at ``k = 1``), both on the
    host; ``metrics`` holds host numbers (one read per step).  With
    ``solver=None`` the Newton solver is built here, once.  ``lam`` is in
    the dual dtype of :func:`otamg_torch.opt.apd.hi_dtypes`; the host
    residuals are rounded to the plan's dtype, as the JAX package keeps
    them on its device."""
    p, q, C, Phi = prob.p, prob.q, prob.C, prob.Phi
    b = prob.b
    n = prob.n
    dtype = C.dtype
    hi, acc = hi_dtypes(dtype)
    b_hi = b.to(hi)
    np_lo = np.float32 if dtype == torch.float32 else np.float64
    if solver is None:
        solver = make_pot_solver_from_options(p, q, Phi, opts)
    solver_maxit = (opts.amg.maxit if opts.inner_solver in
                    (InnerSolver.AMG, InnerSolver.TWOGRID)
                    else opts.pcg.maxit)

    def Hu(X, us, out_dtype=None):
        return op.apply_H(X, us[:n], us[n:], p, q, Phi, out_dtype)

    def ssn_solve(WX, ws, wlk, lam0, bk1, tk, ssn_tol, key,
                  tail: bool) -> _Ssn2:
        """The SsN loop (``Class2/APD_SsN_Class2.m:136-243``).  ``tail``
        relaxes the entry test to ``10 * ssn_tol``: in the marginal tail
        the previous lambda already meets the inexactness criterion up to
        a constant, and noise-scale Newton nudges would re-excite the
        feasibility residual."""

        def z_of(lam):
            HtX, Hts = op.apply_Ht(lam.to(dtype), p, q, Phi)
            return (WX - HtX) / tk, (ws - Hts) / tk

        def F_of(lam, ZX, zs):
            PX, ps = op.prox_nonneg(ZX), op.prox_nonneg(zs)
            return bk1 * lam - Hu(PX, ps, acc).to(hi) - wlk

        def merit(lam, ZX, zs):
            f0 = bk1 / 2 * torch.dot(lam, lam) - torch.dot(wlk, lam)
            PX = op.prox_nonneg(ZX)
            ps = op.prox_nonneg(zs)
            return f0 + 0.5 * tk * (op.vdot_hi(PX, PX, acc)
                                    + op.vdot_hi(ps, ps, acc))

        lam = lam0
        ZX, zs = z_of(lam0)
        nF0 = torch.linalg.vector_norm(F_of(lam0, ZX, zs))
        entry_tol = 10.0 * ssn_tol if tail else ssn_tol
        it, it_min, it_sum, it_max, fail = 0, np.iinfo(np.int32).max, 0, 0, 0
        ncomp = last = torch.zeros((), dtype=torch.int64, device=C.device)
        done = bool(fetch(nF0 <= entry_tol))
        while not done:
            lam_old = lam
            HtX_old, Hts_old = op.apply_Ht(lam_old.to(dtype), p, q, Phi)
            ZX_old = (WX - HtX_old) / tk
            zs_old = (ws - Hts_old) / tk
            S = (ZX_old >= 0).to(dtype)
            tmask = (zs_old >= 0).to(dtype)
            Fk_old = F_of(lam_old, ZX_old, zs_old)
            nFk_old = torch.linalg.vector_norm(Fk_old)
            key, sub = jr.split(key)
            sol = solver(S, tmask, bk1.to(dtype), tk, (-Fk_old).to(dtype),
                         sub)
            zeta = sol.zeta.to(hi)
            # Armijo (:199-231), affine in the step.
            HtzX, Htzs = op.apply_Ht(sol.zeta.to(dtype), p, q, Phi)
            cF_old = merit(lam_old, ZX_old, zs_old)
            ress = torch.abs(torch.dot(Fk_old, zeta))
            step, ll = 1.0, 0
            while True:
                lam_t = lam_old + step * zeta
                ZX_t = (WX - HtX_old - step * HtzX) / tk
                zs_t = (ws - Hts_old - step * Htzs) / tk
                cF_new = merit(lam_t, ZX_t, zs_t)
                # A non-finite merit is "not yet acceptable".
                if ll >= opts.ll_max or fetch(
                        cF_new <= cF_old - opts.nu * step * ress):
                    break
                step *= opts.delta
                ll += 1
            nFk_new = torch.linalg.vector_norm(F_of(lam_t, ZX_t, zs_t))
            it += 1
            conv = nFk_new <= ssn_tol
            # Class 2's stagnation test uses the full tolerance (:223).
            stag = torch.abs(nFk_old - nFk_new) < ssn_tol
            # A stagnation exit above the tolerance is rejected: in the
            # marginal tail such sub-tolerance nudges re-excite kkt_l.
            reject = stag & ~conv
            lam = torch.where(reject, lam_old, lam_t)
            ZX = torch.where(reject, ZX_old, ZX_t)
            zs = torch.where(reject, zs_old, zs_t)
            it_min = min(it_min, sol.iters)
            it_sum += sol.iters
            it_max = max(it_max, sol.iters)
            fail += int(sol.iters >= solver_maxit)
            ncomp, last = sol.ncomp, sol.last
            done = bool(fetch(conv | stag)) or it >= opts.ssn_maxit
        return _Ssn2(lam, ZX, zs, it, it_min, it_sum, it_max, fail, ncomp,
                     last)

    def outer_step(k, X, us, VX, vs, lam, bk, key, kkt0, prev_kkt):
        """One APD iteration (``Class2/APD_SsN_Class2.m:95-285``)."""
        kf = float(k)
        ak = torch.sqrt(kf ** 2 * bk)
        bk1 = bk / (1 + ak)
        tk = bk * (1 + ak) / (ak * ak)
        ssn_tol = torch.clamp_min(bk1 / kf ** 2, opts.ssn_tol1)
        WX = -C + bk * (X + ak * VX) / (ak * ak)
        ws = bk * (us + ak * vs) / (ak * ak)   # the slack block of c is 0
        wlk = bk1 * (lam - (Hu(X, us, acc).to(hi) - b_hi) / bk) - b_hi
        # Marginal-tail signature of the previous iteration.
        kkt0 = np.asarray(kkt0, np_lo)
        prev_kkt = np.asarray(prev_kkt, np_lo)
        prev_rel = prev_kkt / (1 + kkt0)
        tail = bool(prev_rel[:3].max() <= opts.kkt_tol
                    and prev_rel[3] > opts.kkt_tol)

        key, sub = jr.split(key)
        ssn = ssn_solve(WX, ws, wlk, lam, bk1.to(hi), tk, ssn_tol, sub, tail)
        lam1 = ssn.lam
        X1 = op.prox_nonneg(ssn.ZX)
        us1 = op.prox_nonneg(ssn.zs)
        VX1 = X1 + (X1 - X) / ak
        vs1 = us1 + (us1 - us) / ak

        # Restart (:246-256): the normalized new residual against the raw
        # previous one, as the reference does; no draw.
        kk = op.kkt_class2(X1, us1[:n], us1[n:], lam1, C, b, p, q, Phi, acc)
        rr = torch.amax(torch.stack([r / float(1 + r0)
                                     for r, r0 in zip(kk, kkt0)]))
        restart = (bk1 < opts.restart_bk_floor) & (rr > float(prev_kkt.max()))
        bk1 = torch.where(restart, 10 * bk1, bk1)
        X1 = torch.where(restart, X, X1)
        us1 = torch.where(restart, us, us1)
        lam1 = torch.where(restart, lam, lam1)
        VX1 = torch.where(restart, X, VX1)
        vs1 = torch.where(restart, us, vs1)

        kx, ky, kz, kl = op.kkt_class2(X1, us1[:n], us1[n:], lam1, C, b,
                                       p, q, Phi, acc)
        fxk = op.vdot_hi(C, X1, acc)
        kx_h, ky_h, kz_h, kl_h, fx_h, rs_h, nc_h, la_h = fetch(torch.stack([
            t.to(torch.float64) for t in (kx, ky, kz, kl, fxk, restart,
                                          ssn.ncomp, ssn.last)]))
        avg = ssn.it_sum // max(ssn.it, 1) if ssn.it > 0 else -1
        metrics = Outer2Metrics(
            kkt_x=kx_h, kkt_y=ky_h, kkt_z=kz_h, kkt_l=kl_h, fxk=fx_h,
            ssn_it=ssn.it, it_min=ssn.it_min if ssn.it > 0 else -1,
            it_avg=avg, it_max=ssn.it_max if ssn.it > 0 else -1,
            it_sum=ssn.it_sum, fail=ssn.fail, restarted=bool(rs_h),
            ncomp=int(nc_h), last=int(la_h))
        return X1, us1, VX1, vs1, lam1, bk1, key, metrics

    return outer_step


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
                             for t in (*k, op.vdot_hi(C, Xp, acc))]))
    return Xp, torch.cat([yp, zp]), np.asarray(got[:4]), got[4]


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
    C = prob.C
    dtype, dev = C.dtype, C.device
    hi, acc = hi_dtypes(dtype)

    ws = warmup_class2(prob, opts.warmup.maxit)
    X, lam = ws.X, ws.lam.to(hi)
    us = torch.cat([ws.y, ws.z])
    k0 = op.kkt_class2(X, ws.y, ws.z, lam, C, prob.b, prob.p, prob.q,
                       prob.Phi, acc)
    got = fetch(torch.stack([t.to(torch.float64)
                             for t in (*k0, op.vdot_hi(C, X))]))
    kkt0 = np.asarray(got[:4])
    VX, vs = X, us

    step = make_class2_step(prob, opts, solver)
    key = jr.PRNGKey(opts.seed)
    bk = torch.ones((), dtype=dtype, device=dev)
    prev = kkt0
    k_start = 1
    if resume and checkpoint_dir is not None:
        from otamg_torch.diag import checkpoint as ckpt

        if ckpt.latest_step(checkpoint_dir) is not None:
            # The warm-start state is the template (devices and dtypes).
            d = ckpt.load_dict(checkpoint_dir, template=dict(
                X=X, us=us, VX=VX, vs=vs, lam=lam, bk=bk, key=key))
            X, us, VX, vs = d["X"], d["us"], d["VX"], d["vs"]
            lam, bk, key = d["lam"], d["bk"], d["key"]
            k_start = d["k"] + 1
            prev = d["prev_kkt"].numpy()

    kkt_hist = [kkt0]
    fxk = [got[4]]
    ssn_itnum, solver_itnum, restarts = [], [], []
    info_ncomp, info_last = [], []
    fail_total = inner_total = 0
    converged = polished = False
    k_final = opts.maxit
    for k in range(k_start, opts.maxit + 1):
        X, us, VX, vs, lam, bk, key, mtr = step(k, X, us, VX, vs, lam, bk,
                                                key, kkt0, prev)
        kk = prev = np.asarray([mtr.kkt_x, mtr.kkt_y, mtr.kkt_z, mtr.kkt_l])
        kkt_hist.append(kk)
        fxk.append(mtr.fxk)
        ssn_itnum.append(mtr.ssn_it)
        solver_itnum.append((mtr.it_min, mtr.it_avg, mtr.it_max))
        restarts.append(mtr.restarted)
        info_ncomp.append(mtr.ncomp)
        info_last.append(mtr.last)
        fail_total += mtr.fail
        inner_total += mtr.it_sum
        if verbose:
            print(f"APD2 it={k:3d} kkt={kk[0]:.2e}/{kk[1]:.2e}/"
                  f"{kk[2]:.2e}/{kk[3]:.2e} fk={mtr.fxk:.6e} "
                  f"ssn={mtr.ssn_it} inner={solver_itnum[-1]}"
                  + (" RESTART" if mtr.restarted else ""))
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
                kkt_hist[-1] = kkp
                fxk[-1] = fxp
                converged = polished = True
                k_final = k
                break
        if checkpoint_dir is not None and k % checkpoint_every == 0:
            from otamg_torch.diag import checkpoint as ckpt

            ckpt.save_dict(checkpoint_dir, k, dict(
                X=X, us=us, VX=VX, vs=vs, lam=lam, bk=bk, key=key,
                prev_kkt=prev))

    return Solve2Result(
        X=X, y=us[:n], z=us[n:], lam=lam, converged=converged,
        iters=k_final, kkt=np.asarray(kkt_hist), fxk=np.asarray(fxk),
        ssn_itnum=np.asarray(ssn_itnum),
        solver_itnum=np.asarray(solver_itnum),
        restarts=np.asarray(restarts), fail_count=fail_total,
        wall_time=time.perf_counter() - t0, inner_total=inner_total,
        info_ncomp=np.asarray(info_ncomp), info_last=np.asarray(info_last),
        polished=polished)
