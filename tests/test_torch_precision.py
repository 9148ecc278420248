"""Parity of otamg_torch's precision architecture with the JAX package on
the CPU (JAX with ``jax_enable_x64``):

* ``out_dtype`` of the operators: fp32 operands, f64 accumulation;
* the deflated cycle (smoothers, coarse solve, fused deep matrix) on a
  JAX fp32 hierarchy carried across;
* the mixed branch of ``build_he_solver`` (fp32 hierarchy, exact kernel
  deflation, f64 refinement with its revert safeguard) on captured
  Newton systems;
* ``solve_class1``/``solve_class2`` with ``solve_dtype="float32"`` end to
  end, and with fp32 plans (dual state and O(mn) reductions in f64).

Every tolerance is stated where it is checked."""

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
from otamg.opt import solve_class1 as j_solve1
from otamg.opt.admm import warmup_class1 as j_warm1
from otamg.opt.admm import warmup_class2 as j_warm2
from otamg.ot import operators as jop
from otamg.ot import random_class1 as j_random1
from otamg.ot import random_class2 as j_random2
from otamg_torch import interop
from otamg_torch import random as tr
from otamg_torch.amg import hierarchy as th
from otamg_torch.hybrid import pot as tpot
from otamg_torch.hybrid import solver as thyb
from otamg_torch.opt import apd2 as tapd2
from otamg_torch.opt import solve_class1 as t_solve1
from otamg_torch.opt.admm import WarmStart2
from otamg_torch.ot import operators as top
from otamg_torch.ot import random_class1 as t_random1
from otamg_torch.ot import random_class2 as t_random2

T = lambda a: torch.as_tensor(np.array(a))
N_ = lambda t: t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
F32 = "float32"


def close(got, want, rtol, what):
    """rtol relative to the largest entry of ``want``."""
    got, want = N_(got), N_(want)
    assert got.shape == want.shape, f"{what}: shape"
    scale = float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale,
                               err_msg=f"{what}: rtol {rtol} (of max)")


def close_norm(got, want, rtol, what):
    """Every entry within ``rtol`` of ``want``'s 2-norm."""
    got, want = N_(got).astype(np.float64), N_(want).astype(np.float64)
    assert got.shape == want.shape, f"{what}: shape"
    err = np.abs(got - want).max()
    assert err <= rtol * np.linalg.norm(want), \
        f"{what}: max err {err:.3e} above {rtol} of the norm"


def assert_kernel_free(v, labels, nsp, what):
    """Every near-singular component's mean is at most 1e-6 of the
    vector's norm."""
    v, labels, nsp = N_(v).astype(np.float64), N_(labels), N_(nsp)
    norm = np.linalg.norm(v)
    for c in np.unique(labels[nsp]):
        on = (labels == c) & nsp
        mean = v[on].mean()
        assert abs(mean) <= 1e-6 * norm, \
            f"{what}: component {c} mean {mean:.3e} (norm {norm:.3e})"


# ---------------------------------------------------------------------------
# Operators with out_dtype
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def fp32_operands():
    rng = np.random.default_rng(5)
    m, n = 24, 20
    a = lambda *s: rng.uniform(size=s).astype(np.float32)
    X, C, Phi = a(m, n), a(m, n), a(m, n)
    p, q, y, z = a(m), a(n), a(n), a(m)
    b = np.concatenate([a(n), a(m)]).astype(np.float32)
    lam = rng.standard_normal(n + m)            # f64 dual
    lam2 = rng.standard_normal(n + m + 1)
    b2 = np.concatenate([b, [np.float32(3.0)]]).astype(np.float32)
    return dict(X=X, C=C, Phi=Phi, p=p, q=q, y=y, z=z, b=b, b2=b2,
                lam=lam, lam2=lam2, gama=np.float32(np.inf))


def _op_call(mod, name, d, conv):
    c = {k: conv(v) for k, v in d.items()}
    f64 = jnp.float64 if mod is jop else torch.float64
    if name == "apply_A":
        return mod.apply_A(c["X"], c["p"], c["q"], f64)
    if name == "vdot_hi":
        return mod.vdot_hi(c["C"], c["X"], f64)
    if name == "norm_hi":
        return mod.norm_hi(c["X"], f64)
    if name == "apply_H":
        return mod.apply_H(c["X"], c["y"], c["z"], c["p"], c["q"], c["Phi"],
                           f64)
    if name == "kkt_class1":
        return mod.kkt_class1(c["X"], c["lam"], c["C"], c["b"], c["p"],
                              c["q"], c["gama"], f64)
    return mod.kkt_class2(c["X"], c["y"], c["z"], c["lam2"], c["C"],
                          c["b2"], c["p"], c["q"], c["Phi"], f64)


@pytest.mark.parametrize("name", ["apply_A", "vdot_hi", "norm_hi", "apply_H",
                                  "kkt_class1", "kkt_class2"])
def test_operator_out_dtype(fp32_operands, name):
    """fp32 operands accumulated in f64, to 1e-13 relative (the f32*f32
    products are exact in f64; only the order of the sums differs)."""
    want = _op_call(jop, name, fp32_operands, jnp.asarray)
    got = _op_call(top, name, fp32_operands, T)
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    for g_, w_ in zip(got, want):
        assert g_.dtype == torch.float64, f"{name}: accumulates in f64"
        close(g_, w_, 1e-13, name)


# ---------------------------------------------------------------------------
# Captured Newton systems
# ---------------------------------------------------------------------------

AMG_J = jcfg.AMGOptions(cycle=jcfg.Cycle.F, fuse_deep=True, coarse_target=6)
AMG_T = tcfg.AMGOptions(cycle=tcfg.Cycle.F, fuse_deep=True, coarse_target=6)


# The last outer iteration of the JAX 48x40 mixed Class-1 solve below
# whose SsN loop runs (iterations 44-60 take no SsN step): its bk1 is the
# smallest of any Newton system of the solve.
C1_LAST_SSN_ITER = 43


@pytest.fixture(scope="module")
def c1_system():
    return capture_c1_system()


def capture_c1_system():
    """The first SsN step's Newton system at the last outer iteration
    with an SsN step of a JAX 48x40 mixed Class-1 solve
    (``random_class1(PRNGKey(42), 48, 40)``, AMG inner solver, F-cycle,
    fuse_deep, ``solve_dtype="float32"``): the smallest ``bk1`` of the
    solve, 4.9e-6, with ``||rhs||`` 3.4e-9
    (``Class1/APD_SsN_Class1.m:101-147``)."""
    prob = j_random1(jax.random.PRNGKey(42), 48, 40)
    opts = jcfg.APDOptions(inner_solver=jcfg.InnerSolver.AMG, amg=AMG_J,
                           solve_dtype=F32)
    full = j_solve1(prob, opts)
    ssn = np.asarray(full.ssn_itnum)
    assert full.converged and ssn[C1_LAST_SSN_ITER - 1] > 0 \
        and not ssn[C1_LAST_SSN_ITER:].any()
    res = j_solve1(prob, dataclasses.replace(opts,
                                             maxit=C1_LAST_SSN_ITER - 1),
                   return_state=True)
    X, V, lam, bk, _ = (np.asarray(a) for a in res.state)
    p, q, C, b = (np.asarray(a) for a in (prob.p, prob.q, prob.C, prob.b))
    n = q.shape[0]
    k = float(C1_LAST_SSN_ITER)
    ak = np.sqrt(k * k * bk)
    bk1 = bk / (1 + ak)
    tk = bk * (1 + ak) / ak ** 2
    Wk = -C + bk * (X + ak * V) / ak ** 2
    Zk = (Wk - (np.outer(p, lam[:n]) + np.outer(lam[n:], q))) / tk
    wlk = bk1 * (lam - (np.concatenate([X.T @ p, X @ q]) - b) / bk) - b
    PZ = np.maximum(Zk, 0.0)
    F = bk1 * lam - np.concatenate([PZ.T @ p, PZ @ q]) - wlk
    return dict(S=(Zk >= 0).astype(float), tvec=np.zeros(n + p.shape[0]),
                bk1=float(bk1), tk=float(tk), rhs=-F, p=p, q=q)


@pytest.fixture(scope="module")
def c2_system():
    """The first SsN step's Newton system at outer iteration 9 of a JAX
    Class-2 solve (``random_class2(PRNGKey(7), 20, 16, mu_frac=0.6)``,
    direct inner solver), as ``tests/test_torch_pot.py`` builds it: its
    slack mask makes some components not near-singular."""
    prob = j_random2(jax.random.PRNGKey(7), 20, 16, mu_frac=0.6)
    p, q, C, Phi, b = prob.p, prob.q, prob.C, prob.Phi, prob.b
    n = prob.n
    ws = j_warm2(prob, 100)
    X, lam = ws.X, ws.lam
    us = jnp.concatenate([ws.y, ws.z])
    k0 = jnp.stack(jop.kkt_class2(X, ws.y, ws.z, lam, C, b, p, q, Phi))
    step = japd2.make_class2_step(prob, jcfg.APDOptions(
        ssn_tol1=1e-10, inner_solver=jcfg.InnerSolver.DIRECT))
    VX, vs, bk, key, prev = X, us, jnp.asarray(1.0), jax.random.PRNGKey(0), k0
    for k in range(1, 9):
        X, us, VX, vs, lam, bk, key, mtr = step(
            jnp.int32(k), X, us, VX, vs, lam, bk, key, k0, prev, prob)
        prev = jnp.stack([mtr.kkt_x, mtr.kkt_y, mtr.kkt_z, mtr.kkt_l])
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
    return dict(S=np.asarray((ZX >= 0).astype(float)),
                tvec=np.asarray((zs >= 0).astype(float)), bk1=float(bk1),
                tk=float(tk), rhs=-np.asarray(F),
                key=np.asarray(jax.random.PRNGKey(11)), p=np.asarray(p),
                q=np.asarray(q), Phi=np.asarray(Phi))


def _system(request, name):
    return request.getfixturevalue(f"{name}_system")


def _fp32_hierarchy(s):
    """The JAX fp32 hierarchy ``build_he_solver`` builds for ``s`` (bigph),
    the same carried across to the port, and the level-1 labels/nsp."""
    E, g, kdiag, _, _ = jhyb._transform(
        *(jnp.asarray(s[k]) for k in ("S", "tvec")), s["bk1"], s["tk"],
        jnp.zeros_like(jnp.asarray(s["tvec"])), jnp.asarray(s["p"]),
        jnp.asarray(s["q"]))
    labels, nsp, _, _ = jhyb._component_info(E, kdiag)
    gk = s["bk1"] * jnp.concatenate([s["q"] ** 2, s["p"] ** 2]) + kdiag / s["tk"]
    f32 = jnp.float32
    hj = jh.setup_hierarchy(E.astype(f32), g.astype(f32),
                            jnp.asarray(1.0 / s["tk"], f32), labels, nsp,
                            AMG_J, jax.random.PRNGKey(4), gk=gk.astype(f32))
    ht = interop.hierarchy(
        {k: np.asarray(v) for k, v in hj[0]._asdict().items()},
        [{k: np.asarray(v) for k, v in lv._asdict().items()} for lv in hj[1]],
        device="cpu")
    assert ht[0].E.dtype == torch.float32 and len(hj[1]) >= 3
    return hj, ht


@pytest.fixture(scope="module")
def hierarchies(c1_system, c2_system):
    return {"c1": _fp32_hierarchy(c1_system), "c2": _fp32_hierarchy(c2_system)}


def _vectors(N, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(N).astype(np.float32),
            rng.standard_normal(N).astype(np.float32))


# ---------------------------------------------------------------------------
# The deflated cycle
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("system", ["c1", "c2"])
@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("e_is_zero", [False, True])
def test_deflated_smooth_bip(hierarchies, system, transpose, e_is_zero):
    """The fused bipartite sweep with ``deflated=True``, to 1e-5 of the
    vector's norm; the result is kernel-free."""
    (j1, _), (t1, _) = hierarchies[system]
    N = t1.g.shape[0]
    e, r = _vectors(N, 1 + transpose + 2 * e_is_zero)
    want = jh._projected_smooth_bip(j1, jnp.asarray(e), jnp.asarray(r), 5,
                                    transpose, N, True, e_is_zero)
    got = th._projected_smooth_bip(t1, T(e), T(r), 5, transpose, N, True,
                                   e_is_zero)
    close_norm(got, want, 1e-5, "deflated bipartite sweep")
    assert_kernel_free(got, t1.labels, t1.nsp, "deflated bipartite sweep")


@pytest.mark.parametrize("level", ["bip", "dense"])
@pytest.mark.parametrize("transpose", [False, True])
def test_deflated_smooth_generic(hierarchies, level, transpose):
    """The generic sweep with ``deflated=True`` on the bipartite level and
    on the first dense level, to 1e-5 of the vector's norm; the result is
    kernel-free."""
    (j1, jd), (t1, td) = hierarchies["c1"]
    if level == "bip":
        jl, tl, jops, tops = j1, t1, (jh.bip_matvec, jh.bip_smooth_apply), \
            (th.bip_matvec, th.bip_smooth_apply)
    else:
        jl, tl, jops, tops = jd[0], td[0], \
            (jh.dense_matvec, jh.dense_smooth_apply), \
            (th.dense_matvec, th.dense_smooth_apply)
    N = t1.g.shape[0]
    e, r = _vectors(th._lvl_size(tl), 7 + transpose)
    want = jh._projected_smooth(*jops, jl, jnp.asarray(e), jnp.asarray(r), 5,
                                transpose, N, True)
    got = th._projected_smooth(*tops, tl, T(e), T(r), 5, transpose, N, True)
    close_norm(got, want, 1e-5, f"deflated {level} sweep")
    assert_kernel_free(got, tl.labels, tl.nsp, f"deflated {level} sweep")


def test_deflated_coarse_solve(hierarchies):
    """The deflated spectrally filtered coarse solve, to 1e-5; the
    correction is kernel-free."""
    (_, jd), (t1, td) = hierarchies["c1"]
    N = t1.g.shape[0]
    r = _vectors(td[-1].A.shape[0], 11)[0]
    want = jh._coarse_solve(jd[-1], jnp.asarray(r), N, True, 1e-11, 10_000,
                            True)
    got = th._coarse_solve(td[-1], T(r), N, True, 1e-11, 10_000, True)
    close(got, want, 1e-5, "deflated coarse solve")
    assert_kernel_free(got, td[-1].labels, td[-1].nsp, "deflated coarse")


@pytest.mark.parametrize("cycle", ["F", "V", "W"])
def test_deflated_deep_matrix_and_cycle(hierarchies, cycle):
    """``build_deep`` of the deflated cycle and one deflated cycle with
    and without it, to 1e-5."""
    hj, (t1, td) = hierarchies["c1"]
    N = t1.g.shape[0]
    gamma = {"V": 1, "W": 2, "F": 3}[cycle]
    cj = jh.make_cycle(len(hj[1]), 5, gamma, N, deflated=True)
    ct = th.make_cycle(len(td), 5, gamma, N, deflated=True)
    Dj = cj.build_deep(hj[0], hj[1], jnp.float32)
    Dt = ct.build_deep(t1, td, torch.float32)
    close(Dt, Dj, 1e-5, f"{cycle} deflated deep matrix")
    r = _vectors(N, 13)[0]
    close_norm(ct(t1, td, T(r)), cj(hj[0], hj[1], jnp.asarray(r)), 1e-5,
               f"deflated {cycle}-cycle")
    close_norm(ct(t1, td, T(r), Dt), cj(hj[0], hj[1], jnp.asarray(r), Dj),
               1e-5, f"deflated {cycle}-cycle with deep_D")


# ---------------------------------------------------------------------------
# The mixed branch of build_he_solver
# ---------------------------------------------------------------------------


@pytest.fixture
def jax_rounds(monkeypatch, c1_system, c2_system):
    """Counts the JAX mixed solver's correction solves (one a round) as
    they run inside its refinement while-loop (the systems are captured
    first, uncounted)."""
    count = [0]
    orig = jhyb.amg_solve

    def bump(_):
        count[0] += 1

    def counted(*args, **kw):
        res = orig(*args, **kw)
        jax.debug.callback(bump, res.iters)
        return res

    monkeypatch.setattr(jhyb, "amg_solve", counted)
    return count


def _he_args(s, bigph=True):
    amg = lambda cfg: dataclasses.replace(
        AMG_J if cfg is jcfg else AMG_T, bigph=bigph)
    jargs = (jnp.asarray(s["S"]), jnp.asarray(s["tvec"]),
             jnp.asarray(s["bk1"]), jnp.asarray(s["tk"]),
             jnp.asarray(s["p"]), jnp.asarray(s["q"]), amg(jcfg))
    targs = (T(s["S"]), T(s["tvec"]),
             torch.tensor(s["bk1"], dtype=torch.float64),
             torch.tensor(s["tk"], dtype=torch.float64), T(s["p"]),
             T(s["q"]), amg(tcfg))
    return jargs, targs


@pytest.mark.parametrize("system,bigph", [("c1", True), ("c1", False),
                                          ("c2", True)])
@pytest.mark.parametrize("scale", ["unit", "captured"])
def test_mixed_he_solver(request, jax_rounds, system, bigph, scale):
    """Mixed ``build_he_solver`` on a captured Newton system: the port
    reaches ``rel < retol`` and its solution agrees with the JAX
    package's to 1e-9.  With the right-hand side scaled to unit norm the
    JAX package reaches ``retol`` too, in the same refinement rounds.  As
    captured, the Class-1 system's residuals after two rounds are ~1e-20:
    the squares in the JAX package's fp32 norms flush to zero on XLA:CPU,
    its later correction solves see a zero residual, and it stops above
    ``retol`` with a reverted round, so there the port may take fewer
    rounds.  The fp32 cycle counts of a round follow the order of the
    sums and are not compared."""
    s = _system(request, system)
    rhs = s["rhs"][:s["tvec"].shape[0]]
    if scale == "unit":
        rhs = rhs / np.linalg.norm(rhs)
    jargs, targs = _he_args(s, bigph)
    ks, kg = jax.random.split(jax.random.PRNGKey(3))
    he_j, nc_j, _ = jhyb.build_he_solver(*jargs, F32, 10, jnp.float64, ks)
    zj, _, relj = he_j(jnp.asarray(rhs), kg)
    thyb.refine_counts.reset()
    he_t, nc_t, _ = thyb.build_he_solver(*targs, interop.key(ks), F32)
    zt, itt, relt = he_t(T(rhs), interop.key(kg))
    assert zt.dtype == torch.float64 and int(nc_t) == int(nc_j)
    assert float(relt) < AMG_T.retol, "the port reaches retol"
    close(zt, zj, 1e-9, "mixed Newton solution")
    c = thyb.refine_counts
    assert c.solves == 1 and c.reverted == 0 and 0 < itt <= AMG_T.maxit
    if scale == "unit":
        assert float(relj) < AMG_J.retol
        assert c.rounds == jax_rounds[0], "rounds: exact"
    else:
        assert 1 <= c.rounds <= jax_rounds[0]


def test_mixed_pot_solver(c2_system, jax_rounds):
    """The POT solver with ``solve_dtype``: two mixed core solves on one
    fp32 hierarchy, to 1e-9, with the same refinement rounds."""
    s = c2_system
    key = jax.random.PRNGKey(11)
    args = [s[k] for k in ("S", "tvec", "bk1", "tk", "rhs")]
    rj = jpot.make_pot_amg_solver(*(jnp.asarray(s[k]) for k in
                                    ("p", "q", "Phi")), AMG_J,
                                  solve_dtype=F32)(
        *(jnp.asarray(a) for a in args), key)
    thyb.refine_counts.reset()
    rt = tpot.make_pot_amg_solver(*(T(s[k]) for k in ("p", "q", "Phi")),
                                  AMG_T, solve_dtype=F32)(
        *(torch.as_tensor(np.asarray(a)) for a in args), interop.key(key))
    close(rt.zeta, rj.zeta, 1e-9, "mixed POT Newton solution")
    assert thyb.refine_counts.solves == 2
    assert thyb.refine_counts.rounds == jax_rounds[0], "rounds: exact"


@pytest.mark.parametrize("bad_from", [1, 2])
def test_refinement_revert_safeguard(c1_system, monkeypatch, bad_from):
    """A correction that raises the residual is reverted and ends the
    loop: from round ``bad_from`` on, the correction solve returns its
    own result times -1e3.  Both packages return the iterate from before
    that round: the deflated initial guess (to 1e-9 of each other), or
    round 1's iterate, equal to each package's own ``refine=1`` solve to
    1e-12 and to the other package's to 1e-4 (round 1 ends one fp32
    correction solve, whose cycle counts follow the order of the sums)."""
    s = c1_system
    rhs = s["rhs"] / np.linalg.norm(s["rhs"])
    jargs, targs = _he_args(s)
    ks, kg = jax.random.split(jax.random.PRNGKey(3))

    def solve_j(refine):
        he, _, _ = jhyb.build_he_solver(*jargs, F32, refine, jnp.float64, ks)
        return he(jnp.asarray(rhs), kg)

    def solve_t(refine):
        he, _, _ = thyb.build_he_solver(*targs, interop.key(ks), F32, refine)
        return he(T(rhs), interop.key(kg))

    before_j, before_t = solve_j(bad_from - 1), solve_t(bad_from - 1)
    # In the JAX package's while-loop, round 1 corrects the full residual
    # and later rounds see one below 1e-3 of it; the port's rounds are
    # counted on the host.
    thr = 1e-3 * float(np.linalg.norm(
        np.concatenate([s["q"], -s["p"]]) * rhs)) if bad_from == 2 else np.inf
    orig_j, orig_t = jhyb.amg_solve, thyb.amg_solve
    calls = [0]

    def bad_j(lv1, dense, b, guess, opts, deflated=False):
        r = orig_j(lv1, dense, b, guess, opts, deflated=deflated)
        return r._replace(x=jnp.where(jnp.linalg.norm(b) < thr, -1e3 * r.x,
                                      r.x))

    def bad_t(lv1, dense, b, guess, opts, deflated=False):
        r = orig_t(lv1, dense, b, guess, opts, deflated=deflated)
        calls[0] += 1
        return r._replace(x=-1e3 * r.x) if calls[0] >= bad_from else r

    monkeypatch.setattr(jhyb, "amg_solve", bad_j)
    monkeypatch.setattr(thyb, "amg_solve", bad_t)
    zj, _, relj = solve_j(10)
    thyb.refine_counts.reset()
    zt, _, relt = solve_t(10)
    assert thyb.refine_counts.rounds == bad_from, "the loop ends there"
    assert thyb.refine_counts.reverted == 1
    close(zt, before_t[0], 1e-12, "port: the iterate before the round")
    close(zj, before_j[0], 1e-12, "JAX: the iterate before the round")
    assert float(relt) == float(before_t[2])
    close(zt, zj, 1e-9 if bad_from == 1 else 1e-4, "port against JAX")


def test_menu_passes_solve_dtype():
    """The AMG and TWOGRID entries of both menus take ``solve_dtype``;
    only ``explicit_dist`` still raises."""
    from otamg_torch.opt.apd import make_solver_from_options

    p, q = torch.ones(4, dtype=torch.float64), torch.ones(3,
                                                          dtype=torch.float64)
    for inner in ("AMG", "TWOGRID"):
        opts = tcfg.APDOptions(inner_solver=tcfg.InnerSolver[inner],
                               solve_dtype=F32)
        assert callable(make_solver_from_options(p, q, opts))
        assert callable(tapd2.make_pot_solver_from_options(
            p, q, torch.ones(4, 3, dtype=torch.float64), opts))
    with pytest.raises(NotImplementedError, match="explicit_dist"):
        make_solver_from_options(p, q, tcfg.APDOptions(explicit_dist=True))


# ---------------------------------------------------------------------------
# End to end
# ---------------------------------------------------------------------------


def assert_same_solve(rj, rt, fx_rtol):
    assert rt.converged == rj.converged, "converged: exact"
    assert rt.iters == rj.iters, "outer iterations: exact"
    assert rt.fail_count == rj.fail_count, "fail_count: exact"
    np.testing.assert_allclose(rt.fxk, rj.fxk, rtol=fx_rtol,
                               err_msg=f"fxk trajectory: rtol {fx_rtol}")


def class1_options(cfg, inner, cycle="F", fuse=True, **kw):
    return cfg.APDOptions(
        inner_solver=cfg.InnerSolver[inner],
        amg=cfg.AMGOptions(cycle=cfg.Cycle[cycle], fuse_deep=fuse,
                           coarse_target=6), **kw)


@pytest.mark.parametrize("inner,cycle,fuse", [("AMG", "F", True),
                                              ("AMG", "W", False),
                                              ("TWOGRID", "F", True)])
def test_mixed_solve_class1(inner, cycle, fuse):
    """``random_class1(PRNGKey(42), 24, 20)`` with
    ``solve_dtype="float32"``: converged, iterations, fail_count and SsN
    steps exact, fxk to 1e-8."""
    rj = j_solve1(j_random1(jax.random.PRNGKey(42), 24, 20),
                  class1_options(jcfg, inner, cycle, fuse, solve_dtype=F32))
    thyb.refine_counts.reset()
    rt = t_solve1(t_random1(tr.PRNGKey(42), 24, 20, device="cpu"),
                  class1_options(tcfg, inner, cycle, fuse, solve_dtype=F32))
    assert rj.converged
    assert_same_solve(rj, rt, 1e-8)
    assert np.array_equal(rt.ssn_itnum, rj.ssn_itnum), "SsN steps: exact"
    assert thyb.refine_counts.rounds >= thyb.refine_counts.solves > 0


def class2_options(cfg, inner, **kw):
    o = japd2.default_class2_options() if cfg is jcfg \
        else tapd2.default_class2_options()
    return dataclasses.replace(
        o, inner_solver=cfg.InnerSolver[inner],
        amg=dataclasses.replace(o.amg, cycle=cfg.Cycle.F, fuse_deep=True,
                                coarse_target=6), **kw)


@pytest.mark.parametrize("inner", ["AMG", "TWOGRID"])
def test_mixed_solve_class2(inner):
    """``random_class2(PRNGKey(7), 20, 16, mu_frac=0.6)`` with the
    Class-2 defaults and ``solve_dtype="float32"``: converged,
    iterations, fail_count and SsN steps exact, fxk to 1e-8."""
    rj = japd2.solve_class2(
        j_random2(jax.random.PRNGKey(7), 20, 16, mu_frac=0.6),
        class2_options(jcfg, inner, solve_dtype=F32))
    thyb.refine_counts.reset()
    rt = tapd2.solve_class2(
        t_random2(tr.PRNGKey(7), 20, 16, mu_frac=0.6, device="cpu"),
        class2_options(tcfg, inner, solve_dtype=F32))
    assert rj.converged
    assert_same_solve(rj, rt, 1e-8)
    assert np.array_equal(rt.ssn_itnum, rj.ssn_itnum), "SsN steps: exact"
    assert thyb.refine_counts.rounds >= thyb.refine_counts.solves > 0


# fp32 plans.  The JAX package's own fp32-plan solves of these problems
# do not converge: from outer iteration 19 (Class 1) and 25 (Class 2) on,
# ||F|| cannot fall to the SsN tolerance through fp32 plan arithmetic, every
# SsN loop runs to its 50-step cap and the feasibility residual grows.  In
# that regime single fp32 roundings decide the path, and so do the
# fp32 warm start's (the ADMM warm start runs in the plan's dtype, and at
# 20x16 Class 2's rounding moves its KKT residuals by ~30%).  So both
# packages start from the JAX warm start and are held over the outer
# iterations where the two agree to fp32 rounding: 18 for Class 1 and 9
# for Class 2, where the Class-2 objectives part by 7e-6 at iteration 10.
@pytest.mark.parametrize("inner", ["PCG", "AMG"])
def test_fp32_plan_class1(inner):
    """An fp32 plan keeps ``lam`` and the reductions in f64: converged,
    iterations and fail_count exact, fxk to 1e-6 relative."""
    pj = j_random1(jax.random.PRNGKey(42), 24, 20, dtype=jnp.float32)
    ws = j_warm1(pj, 100)
    rj = j_solve1(pj, class1_options(jcfg, inner, maxit=18),
                  warm=(ws.X, ws.lam))
    rt = t_solve1(t_random1(tr.PRNGKey(42), 24, 20, dtype=torch.float32,
                            device="cpu"),
                  class1_options(tcfg, inner, maxit=18),
                  warm=(T(ws.X), T(ws.lam)))
    assert rt.X.dtype == torch.float32 and rt.lam.dtype == torch.float64
    assert_same_solve(rj, rt, 1e-6)


def test_fp32_plan_class2(monkeypatch):
    """Class 2 with an fp32 plan: converged, iterations and fail_count
    exact, fxk to 1e-6 relative."""
    pj = j_random2(jax.random.PRNGKey(7), 20, 16, mu_frac=0.6,
                   dtype=jnp.float32)
    ws = j_warm2(pj, 100)
    monkeypatch.setattr(tapd2, "warmup_class2", lambda prob, maxit: (
        WarmStart2(*(T(getattr(ws, f)) for f in WarmStart2._fields))))
    rj = japd2.solve_class2(pj, class2_options(jcfg, "AMG", maxit=9))
    rt = tapd2.solve_class2(
        t_random2(tr.PRNGKey(7), 20, 16, mu_frac=0.6, dtype=torch.float32,
                  device="cpu"), class2_options(tcfg, "AMG", maxit=9))
    assert rt.X.dtype == torch.float32 and rt.lam.dtype == torch.float64
    assert_same_solve(rj, rt, 1e-6)
