"""Parity of otamg_torch's Newton solvers with the JAX package on a Class-2
Newton system, on the CPU in f64: the POT solvers of
``otamg_torch.hybrid.pot`` and the arrow PCG of ``otamg_torch.opt.apd2``
on the full ``(n+m+1)`` system, and the Class-1 menu (augmented PCG,
direct, two-grid) on its ``(n+m)`` core.

The system is the first SsN step's at outer iteration 9 of a JAX Class-2
solve.  Its slack mask ``tmask`` is nonzero, so the components that touch
an active slack are not near-singular (``nsp`` false): the hierarchy
branches that Class 1 (``tvec = 0``) never reaches."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import otamg.config as jcfg
import otamg_torch.config as tcfg
from otamg.amg import hierarchy as jh
from otamg.hybrid import pot as jpot
from otamg.hybrid import solver as jhyb
from otamg.opt import apd2 as japd2
from otamg.opt.admm import warmup_class2
from otamg.ot import operators as jop
from otamg.ot import random_class2
from otamg_torch import interop
from otamg_torch.amg import hierarchy as th
from otamg_torch.hybrid import pot as tpot
from otamg_torch.hybrid import solver as thyb
from otamg_torch.opt import apd2 as tapd2

T = lambda a: torch.as_tensor(np.array(a))
N_ = lambda t: t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def close(got, want, rtol, what):
    """rtol relative to the largest entry of ``want``."""
    got, want = N_(got), N_(want)
    assert got.shape == want.shape, f"{what}: shape"
    scale = float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale,
                               err_msg=f"{what}: rtol {rtol} (of max)")


@pytest.fixture(scope="module")
def system():
    prob = random_class2(jax.random.PRNGKey(7), 20, 16, mu_frac=0.6)
    p, q, C, Phi, b = prob.p, prob.q, prob.C, prob.Phi, prob.b
    n = prob.n
    opts = jcfg.APDOptions(ssn_tol1=1e-10,
                           inner_solver=jcfg.InnerSolver.DIRECT)
    ws = warmup_class2(prob, 100)
    X, lam = ws.X, ws.lam
    us = jnp.concatenate([ws.y, ws.z])
    k0 = jnp.stack(jop.kkt_class2(X, ws.y, ws.z, lam, C, b, p, q, Phi))
    step = japd2.make_class2_step(prob, opts)
    VX, vs, bk, key, prev = X, us, jnp.asarray(1.0), jax.random.PRNGKey(0), k0
    for k in range(1, 9):
        X, us, VX, vs, lam, bk, key, mtr = step(
            jnp.int32(k), X, us, VX, vs, lam, bk, key, k0, prev, prob)
        prev = jnp.stack([mtr.kkt_x, mtr.kkt_y, mtr.kkt_z, mtr.kkt_l])
    # The first SsN step of outer iteration 9 (apd2.py:351-368, 262-273).
    kf = 9.0
    ak = jnp.sqrt(kf ** 2 * bk)
    bk1 = bk / (1 + ak)
    tk = bk * (1 + ak) / ak ** 2
    WX = -C + bk * (X + ak * VX) / ak ** 2
    wss = bk * (us + ak * vs) / ak ** 2
    wlk = bk1 * (lam - (jop.apply_H(X, us[:n], us[n:], p, q, Phi) - b)
                 / bk) - b
    HtX, Hts = jop.apply_Ht(lam, p, q, Phi)
    ZX, zs = (WX - HtX) / tk, (wss - Hts) / tk
    F = bk1 * lam - jop.apply_H(jnp.maximum(ZX, 0), jnp.maximum(zs[:n], 0),
                                jnp.maximum(zs[n:], 0), p, q, Phi) - wlk
    S = (ZX >= 0).astype(float)
    tmask = (zs >= 0).astype(float)
    E, g, kdiag, _, _ = jhyb._transform(S, tmask, bk1, tk, tmask, p, q)
    labels, nsp, ncomp, last = jhyb._component_info(E, kdiag)
    nsp = np.asarray(nsp)
    gk = bk1 * jnp.concatenate([q * q, p * p]) + kdiag / tk
    return dict(S=np.asarray(S), tmask=np.asarray(tmask), bk1=float(bk1),
                tk=float(tk), rhs=-np.asarray(F), p=np.asarray(p),
                q=np.asarray(q), Phi=np.asarray(Phi), E=np.asarray(E),
                g=np.asarray(g), kdiag=np.asarray(kdiag),
                labels=np.asarray(labels), nsp=nsp, ncomp=int(ncomp),
                last=int(last), gk=np.asarray(gk))


def amg_opts(cfg, cycle="F"):
    return dataclasses.replace(
        cfg.APDOptions().amg, maxit=40, smoth=10, cycle=cfg.Cycle[cycle],
        fuse_deep=True, coarse_target=6)


def test_system_reaches_non_singular_components(system):
    s = system
    labels, nsp, ncomp, last = thyb._component_info(T(s["E"]),
                                                    T(s["kdiag"]))
    assert np.array_equal(labels.numpy(), s["labels"]), "labels: exact"
    assert np.array_equal(nsp.numpy(), s["nsp"]), "nsp: exact"
    assert (int(ncomp), int(last)) == (s["ncomp"], s["last"])
    assert s["tmask"].any() and not s["nsp"].all(), \
        "the system must reach nsp-false components"


@pytest.mark.parametrize("cycle", ["F", "W"])
def test_hierarchy_with_non_singular_components(system, cycle):
    """``setup_hierarchy`` as ``build_he_solver`` calls it: every level
    array equals JAX's."""
    s = system
    key = jax.random.PRNGKey(4)
    j1, jd = jh.setup_hierarchy(
        jnp.asarray(s["E"]), jnp.asarray(s["g"]), 1.0 / s["tk"],
        jnp.asarray(s["labels"]), jnp.asarray(s["nsp"]),
        amg_opts(jcfg, cycle), key, gk=jnp.asarray(s["gk"]))
    t1, td = th.setup_hierarchy(
        T(s["E"]), T(s["g"]), 1.0 / s["tk"], T(s["labels"]).long(),
        T(s["nsp"]), amg_opts(tcfg, cycle), interop.key(key),
        gk=T(s["gk"]))
    assert len(jd) >= 3 and len(td) == len(jd), "level count"
    for f in ("W", "Axi", "xx", "Exi1", "Etxi2"):
        close(getattr(t1, f), getattr(j1, f), 1e-10, f"level 1 {f}")
    assert np.array_equal(t1.nsp.numpy(), np.asarray(j1.nsp))
    for i, (lt, lj) in enumerate(zip(td, jd)):
        for f in ("active", "nsp", "labels"):
            assert np.array_equal(N_(getattr(lt, f)),
                                  np.asarray(getattr(lj, f))), (i, f)
        for f in ("A", "Axi", "xx") + (("P",) if i else ()):
            close(getattr(lt, f), getattr(lj, f), 1e-10,
                  f"dense level {i} {f}")
    inv = lambda lv: N_(lv.evecs) @ np.diag(N_(lv.einv)) @ N_(lv.evecs).T
    close(inv(td[-1]), inv(jd[-1]), 1e-8, "coarsest filtered inverse")
    # a projected cycle on it, carried across
    tc1, tcd = interop.hierarchy(
        {k: np.asarray(v) for k, v in j1._asdict().items()},
        [{k: np.asarray(v) for k, v in lv._asdict().items()} for lv in jd],
        device="cpu")
    gamma = {"W": 2, "F": 3}[cycle]
    Nn = s["g"].shape[0]
    r = s["rhs"][:-1]
    cj = jh.make_cycle(len(jd), 10, gamma, Nn)
    ct = th.make_cycle(len(tcd), 10, gamma, Nn)
    close(ct(tc1, tcd, T(r)), cj(j1, jd, jnp.asarray(r)), 1e-10,
          f"{cycle}-cycle")


def _newton_args(s, core: bool):
    """(jax args, port args) of ``solve(S, tvec, bk1, tk, rhs, key)``."""
    key = jax.random.PRNGKey(11)
    rhs = s["rhs"][:-1] if core else s["rhs"]
    return ((jnp.asarray(s["S"]), jnp.asarray(s["tmask"]), s["bk1"],
             s["tk"], jnp.asarray(rhs), key),
            (T(s["S"]), T(s["tmask"]),
             torch.tensor(s["bk1"], dtype=torch.float64),
             torch.tensor(s["tk"], dtype=torch.float64), T(rhs),
             interop.key(key)))


def _pot_solver(pkg, name, p, q, Phi):
    cfg = jcfg if pkg == "jax" else tcfg
    mod = jpot if pkg == "jax" else tpot
    apd2 = japd2 if pkg == "jax" else tapd2
    if name == "amg":
        return mod.make_pot_amg_solver(p, q, Phi, amg_opts(cfg))
    if name == "twogrid":
        return mod.make_pot_amg_solver(p, q, Phi, amg_opts(cfg),
                                       twogrid=True)
    if name == "aug_pcg":
        return mod.make_pot_pcg_solver(p, q, Phi, cfg.PCGOptions())
    if name == "direct":
        return mod.make_pot_direct_solver(p, q, Phi)
    return apd2._make_arrow_pcg_solver(p, q, Phi, cfg.APDOptions())


@pytest.mark.parametrize("name", ["amg", "twogrid", "aug_pcg", "direct",
                                  "arrow_pcg"])
def test_pot_newton_solvers(system, name):
    """The full arrow system: the same zeta and inner iterations."""
    s = system
    ja, ta = _newton_args(s, core=False)
    sj = _pot_solver("jax", name, *(jnp.asarray(s[k])
                                     for k in ("p", "q", "Phi")))(*ja)
    st = _pot_solver("port", name, *(T(s[k]) for k in ("p", "q", "Phi")))(*ta)
    assert st.iters == int(sj.iters), f"{name} iters: exact"
    close(st.zeta, sj.zeta, 1e-8, f"{name} zeta")
    assert (int(st.ncomp), int(st.last)) == (int(sj.ncomp), int(sj.last))
    # the solution solves the arrow system
    direct = _pot_solver("port", "direct", *(T(s[k]) for k in
                                             ("p", "q", "Phi")))(*ta)
    close(st.zeta, direct.zeta, 1e-6, f"{name} against the direct solve")


@pytest.mark.parametrize("name", ["aug_pcg", "direct", "twogrid"])
def test_class1_newton_solvers(system, name):
    """The Class-1 menu on the ``(n+m)`` core system with ``tvec`` the
    slack mask."""
    s = system
    ja, ta = _newton_args(s, core=True)

    def make(hyb, cfg, p, q):
        if name == "aug_pcg":
            return hyb.make_aug_pcg_solver(p, q, cfg.PCGOptions())
        if name == "direct":
            return hyb.make_direct_solver(p, q)
        return hyb.make_hybrid_amg_solver(p, q, amg_opts(cfg), twogrid=True)

    sj = make(jhyb, jcfg, jnp.asarray(s["p"]), jnp.asarray(s["q"]))(*ja)
    st = make(thyb, tcfg, T(s["p"]), T(s["q"]))(*ta)
    assert st.iters == int(sj.iters), f"{name} iters: exact"
    close(st.zeta, sj.zeta, 1e-8, f"{name} zeta")
    assert int(st.ncomp) == int(sj.ncomp)
