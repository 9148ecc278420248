"""Parity of otamg_torch.amg (graph algorithms, generic and bipartite
hierarchies, cycles, amg_solve) and otamg_torch.hybrid with the JAX
package, on the CPU in f64 (and the mixed-precision Newton solver on one
system; ``tests/test_torch_precision.py`` holds the rest of it).  Hierarchies are compared level for level;
the cycle and the solve run on one hierarchy carried across through
otamg_torch.interop, so they see identical state."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import otamg.config as jcfg
import otamg_torch.config as tcfg
from otamg.amg import graph as jgraph
from otamg.amg import hierarchy as jh
from otamg.hybrid import solver as jhyb
from otamg.opt import solve_class1 as j_solve
from otamg.ot import random_class1 as j_random
from otamg.sparse import CSR as JCSR
from otamg_torch import interop
from otamg_torch.amg import graph as tgraph
from otamg_torch.amg import hierarchy as th
from otamg_torch.hybrid import solver as thyb
from otamg_torch.sparse import CSR

T = lambda a: torch.as_tensor(np.array(a))
N_ = lambda t: t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def close(got, want, rtol, what):
    """rtol relative to the largest entry of ``want`` (entries near zero
    carry summation-order noise of the array's own scale)."""
    got, want = N_(got), N_(want)
    assert got.shape == want.shape, f"{what}: shape"
    scale = float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale,
                               err_msg=f"{what}: rtol {rtol} (of max)")


def grid_laplacian(nx, ny):
    N = nx * ny
    A = np.zeros((N, N))
    for i in range(nx):
        for j in range(ny):
            k = i * ny + j
            A[k, k] = 4.0
            for di, dj in ((1, 0), (-1, 0), (0, 1), (0, -1)):
                ii, jj = i + di, j + dj
                if 0 <= ii < nx and 0 <= jj < ny:
                    A[k, ii * ny + jj] = -1.0
    return A


@pytest.fixture(scope="module")
def ssn_state():
    """E, g, ... of the Newton system at outer iteration 9 of a real
    24x20 JAX solve (PCG inner solver to keep the fixture cheap)."""
    prob = j_random(jax.random.PRNGKey(42), 24, 20)
    res = j_solve(prob, jcfg.APDOptions(inner_solver=jcfg.InnerSolver.PCG,
                                        maxit=8), return_state=True)
    X, V, lam, bk, _ = (np.asarray(a) for a in res.state)
    p, q, C = (np.asarray(a) for a in (prob.p, prob.q, prob.C))
    k = 9.0
    ak = np.sqrt(k * k * bk)
    bk1 = bk / (1 + ak)
    tk = bk * (1 + ak) / ak ** 2
    Wk = -C + bk * (X + ak * V) / ak ** 2
    n = q.shape[0]
    Zk = (Wk - (np.outer(p, lam[:n]) + np.outer(lam[n:], q))) / tk
    S = (Zk >= 0).astype(float)
    tvec = np.zeros(n + p.shape[0])
    E, g, kdiag, _, _ = jhyb._transform(S, tvec, bk1, tk, tvec, p, q)
    labels, nsp, ncomp, last = jhyb._component_info(E, kdiag)
    gk = bk1 * np.concatenate([q * q, p * p]) + np.asarray(kdiag) / tk
    rhs = np.random.default_rng(9).standard_normal(n + p.shape[0])
    return dict(S=S, p=p, q=q, bk1=float(bk1), tk=float(tk), tvec=tvec,
                E=np.asarray(E), g=np.asarray(g), kdiag=np.asarray(kdiag),
                labels=np.asarray(labels), nsp=np.asarray(nsp),
                ncomp=int(ncomp), last=int(last), gk=gk, rhs=rhs)


AMG_J = jcfg.AMGOptions(cycle=jcfg.Cycle.F, fuse_deep=True, coarse_target=6)
AMG_T = tcfg.AMGOptions(cycle=tcfg.Cycle.F, fuse_deep=True, coarse_target=6)


@pytest.fixture(scope="module")
def bip_hierarchies(ssn_state):
    s = ssn_state
    key = jax.random.PRNGKey(1)
    hj = jh.setup_hierarchy(jnp.asarray(s["E"]), jnp.asarray(s["g"]),
                            1.0 / s["tk"], jnp.asarray(s["labels"]),
                            jnp.asarray(s["nsp"]), AMG_J, key,
                            gk=jnp.asarray(s["gk"]))
    ht = th.setup_hierarchy(T(s["E"]), T(s["g"]), 1.0 / s["tk"],
                            T(s["labels"]).long(), T(s["nsp"]), AMG_T,
                            interop.key(key), gk=T(s["gk"]))
    return hj, ht


def test_connected_components(ssn_state):
    s = ssn_state
    got = tgraph.connected_components_bipartite(T(s["E"]))
    assert np.array_equal(got.numpy(), s["labels"]), "labels: exact"
    # a graph with several components
    rng = np.random.default_rng(3)
    mask = (rng.uniform(size=(30, 25)) > 0.93).astype(float)
    want = np.asarray(jgraph.connected_components_bipartite(
        jnp.asarray(mask)))
    got = tgraph.connected_components_bipartite(T(mask)).numpy()
    assert np.array_equal(got, want) and len(np.unique(want)) > 3


def test_component_stats():
    labels = np.asarray([0, 0, 2, 0, 2, 5])
    w = np.asarray([1.0, 2.0, 3.0, 4.0, 5.0, 6.0])
    sizes, wsums = tgraph.component_stats(T(labels).long(), T(w))
    assert sizes.tolist() == [3, 3, 2, 3, 2, 1]
    assert wsums.tolist() == [7.0, 7.0, 8.0, 7.0, 8.0, 6.0]


def test_component_info(ssn_state):
    s = ssn_state
    labels, nsp, ncomp, last = thyb._component_info(T(s["E"]), T(s["kdiag"]))
    assert np.array_equal(labels.numpy(), s["labels"])
    assert np.array_equal(nsp.numpy(), s["nsp"])
    assert (int(ncomp), int(last)) == (s["ncomp"], s["last"])


def test_transform_and_a0diag(ssn_state):
    s = ssn_state
    args = (s["S"], s["tvec"], s["bk1"], s["tk"], s["rhs"], s["p"], s["q"])
    want = jhyb._transform(*(jnp.asarray(a) for a in args))
    got = thyb._transform(*(T(a) for a in args))
    for g_, w_, name in zip(got, want, ("E", "g", "kdiag", "f", "q0")):
        close(g_, w_, 1e-14, f"_transform {name}")
    close(thyb._a0diag_hi(T(s["S"]), T(s["p"]), T(s["q"])),
          jhyb._a0diag_hi(jnp.asarray(s["S"]), s["p"], s["q"]), 1e-14,
          "_a0diag_hi")


def test_strength_and_mis():
    rng = np.random.default_rng(4)
    k = 40
    B = rng.uniform(size=(k, k)) * (rng.uniform(size=(k, k)) > 0.8)
    A = -(B + B.T)
    A[np.diag_indices(k)] = -A.sum(axis=1) + 0.1
    active = np.ones(k, bool)
    active[-3:] = False
    Sj = jgraph.strength_dense(jnp.asarray(A), jnp.asarray(active))
    St = tgraph.strength_dense(T(A), T(active))
    close(St, Sj, 1e-14, "strength_dense")
    As = np.asarray(Sj) >= 0.25
    for seed in range(4):
        cj = jgraph.mis_dense(jnp.asarray(As), jnp.asarray(active),
                              jax.random.PRNGKey(seed))
        ct = tgraph.mis_dense(T(As), T(active),
                              interop.key(jax.random.PRNGKey(seed)))
        assert np.array_equal(ct.isC.numpy(), np.asarray(cj.isC)), "isC"
        assert np.array_equal(ct.isF.numpy(), np.asarray(cj.isF)), "isF"


def test_mis_bailout_branch():
    """Few connected nodes: the random bail-out picks the same C set."""
    k = 64
    As = np.zeros((k, k), bool)
    As[0, 1] = As[1, 0] = True
    active = np.ones(k, bool)
    key = jax.random.PRNGKey(5)
    cj = jgraph.mis_dense(jnp.asarray(As), jnp.asarray(active), key)
    ct = tgraph.mis_dense(T(As), T(active), interop.key(key))
    assert np.array_equal(ct.isC.numpy(), np.asarray(cj.isC))
    assert np.array_equal(ct.isF.numpy(), np.asarray(cj.isF))


@pytest.fixture(scope="module")
def grid_csr():
    A = grid_laplacian(12, 10) + 0.01 * np.eye(120)
    b = np.random.default_rng(31).standard_normal(120)
    return A, b


GEN_J = jcfg.AMGOptions(maxit=60, coarse_target=30)
GEN_T = tcfg.AMGOptions(maxit=60, coarse_target=30)


def test_setup_hierarchy_generic_csr(grid_csr):
    A, _ = grid_csr
    key = jax.random.PRNGKey(0)
    j0, jrest = jh.setup_hierarchy_generic(
        JCSR.from_dense(jnp.asarray(A), row_cap=5), GEN_J, key)
    t0, trest = th.setup_hierarchy_generic(
        CSR.from_dense(T(A), row_cap=5), GEN_T, interop.key(key))
    assert isinstance(t0, th.CSRLevel) and isinstance(j0, jh.CSRLevel)
    assert len(trest) == len(jrest) >= 2, "level count"
    close(t0.dg, j0.dg, 1e-14, "CSR head diagonal")
    for lt, lj in zip(trest, jrest):
        assert np.array_equal(lt.active.numpy(), np.asarray(lj.active))
        close(lt.A, lj.A, 1e-10, "generic level A")
        close(lt.P, lj.P, 1e-10, "generic level P")


def test_amg_solve_matrix_csr(grid_csr):
    A, b = grid_csr
    rj = jh.amg_solve_matrix(JCSR.from_dense(jnp.asarray(A), row_cap=5),
                             jnp.asarray(b), GEN_J)
    rt = th.amg_solve_matrix(CSR.from_dense(T(A), row_cap=5), T(b), GEN_T)
    assert rt.iters == int(rj.iters), "iters: exact"
    close(rt.x, rj.x, 1e-10, "amg_solve_matrix x")
    close(rt.rel_res, rj.rel_res, 1e-6, "rel_res")


def test_setup_hierarchy_bipartite(bip_hierarchies):
    (j1, jd), (t1, td) = bip_hierarchies
    assert len(jd) >= 3, "the JAX hierarchy needs >= 3 dense levels"
    assert len(td) == len(jd), "level count"
    for f in ("W", "Axi", "xx", "Exi1", "Etxi2"):
        close(getattr(t1, f), getattr(j1, f), 1e-9, f"level 1 {f}")
    for i, (lt, lj) in enumerate(zip(td, jd)):
        for f in ("active", "nsp", "labels"):
            assert np.array_equal(N_(getattr(lt, f)),
                                  np.asarray(getattr(lj, f))), (i, f)
        close(lt.A, lj.A, 1e-9, f"dense level {i} A")
        if i:
            close(lt.P, lj.P, 1e-9, f"dense level {i} P")
        close(lt.Axi, lj.Axi, 1e-9, f"dense level {i} Axi")
    # eigenvectors differ by sign and basis between LAPACK builds; the
    # filtered inverse they make does not
    inv = lambda lv: N_(lv.evecs) @ np.diag(N_(lv.einv)) @ N_(lv.evecs).T
    close(inv(td[-1]), inv(jd[-1]), 1e-8, "coarsest filtered inverse")


def _carried(hj):
    j1, jd = hj
    return interop.hierarchy(
        {k: np.asarray(v) for k, v in j1._asdict().items()},
        [{k: np.asarray(v) for k, v in lv._asdict().items()} for lv in jd],
        device="cpu")


@pytest.mark.parametrize("cycle", ["F", "V", "W"])
def test_cycle_and_amg_solve_carried(ssn_state, bip_hierarchies, cycle):
    """One cycle and one amg_solve (fuse_deep=True) on the same
    hierarchy, carried across."""
    hj, _ = bip_hierarchies
    t1, td = _carried(hj)
    s = ssn_state
    gamma = {"V": 1, "W": 2, "F": 3}[cycle]
    N = s["g"].shape[0]
    cj = jh.make_cycle(len(hj[1]), 5, gamma, N)
    ct = th.make_cycle(len(td), 5, gamma, N)
    r = s["rhs"]
    close(ct(t1, td, T(r)), cj(hj[0], hj[1], jnp.asarray(r)), 1e-10,
          f"{cycle}-cycle")
    Dj = cj.build_deep(hj[0], hj[1], jnp.float64)
    Dt = ct.build_deep(t1, td, torch.float64)
    close(Dt, Dj, 1e-10, f"{cycle} deep matrix")
    close(ct(t1, td, T(r), Dt), cj(hj[0], hj[1], jnp.asarray(r), Dj), 1e-10,
          f"{cycle}-cycle with deep_D")
    jo = jcfg.AMGOptions(cycle=jcfg.Cycle[cycle], fuse_deep=True,
                         coarse_target=6)
    to = tcfg.AMGOptions(cycle=tcfg.Cycle[cycle], fuse_deep=True,
                         coarse_target=6)
    guess = np.random.default_rng(2).uniform(size=N) * 1e-3
    rj = jh.amg_solve(hj[0], hj[1], jnp.asarray(r), jnp.asarray(guess), jo)
    rt = th.amg_solve(t1, td, T(r), T(guess), to)
    assert rt.iters == int(rj.iters), "amg_solve iters: exact"
    close(rt.x, rj.x, 1e-8, "amg_solve x")


@pytest.mark.parametrize("bigph", [True, False])
def test_hybrid_newton_solve(ssn_state, bigph):
    s = ssn_state
    jo = jcfg.AMGOptions(cycle=jcfg.Cycle.F, fuse_deep=True, coarse_target=6,
                         bigph=bigph)
    to = tcfg.AMGOptions(cycle=tcfg.Cycle.F, fuse_deep=True, coarse_target=6,
                         bigph=bigph)
    key = jax.random.PRNGKey(3)
    sj = jhyb.make_hybrid_amg_solver(jnp.asarray(s["p"]), jnp.asarray(s["q"]),
                                     jo)(
        jnp.asarray(s["S"]), jnp.asarray(s["tvec"]), s["bk1"], s["tk"],
        jnp.asarray(s["rhs"]), key)
    st = thyb.make_hybrid_amg_solver(T(s["p"]), T(s["q"]), to)(
        T(s["S"]), T(s["tvec"]), torch.tensor(s["bk1"], dtype=torch.float64),
        torch.tensor(s["tk"], dtype=torch.float64), T(s["rhs"]),
        interop.key(key))
    assert st.iters == int(sj.iters), "Newton iters: exact"
    close(st.zeta, sj.zeta, 1e-8, "Newton zeta")
    assert (int(st.ncomp), int(st.last)) == (int(sj.ncomp), int(sj.last))


def test_mixed_precision_not_ported(ssn_state):
    """The mixed-precision solver (``solve_dtype="float32"``: fp32
    hierarchy, f64 refinement) on the same Newton system: the solution
    to 1e-9 of the JAX package's, both at the refinement target."""
    s = ssn_state
    key = jax.random.PRNGKey(3)
    sj = jhyb.make_hybrid_amg_solver(jnp.asarray(s["p"]), jnp.asarray(s["q"]),
                                     AMG_J, solve_dtype="float32")(
        jnp.asarray(s["S"]), jnp.asarray(s["tvec"]), s["bk1"], s["tk"],
        jnp.asarray(s["rhs"]), key)
    st = thyb.make_hybrid_amg_solver(T(s["p"]), T(s["q"]), AMG_T,
                                     solve_dtype="float32")(
        T(s["S"]), T(s["tvec"]), torch.tensor(s["bk1"], dtype=torch.float64),
        torch.tensor(s["tk"], dtype=torch.float64), T(s["rhs"]),
        interop.key(key))
    assert st.zeta.dtype == torch.float64
    assert float(sj.res) < AMG_J.retol and float(st.res) < AMG_T.retol
    close(st.zeta, sj.zeta, 1e-9, "mixed Newton zeta")
    assert (int(st.ncomp), int(st.last)) == (int(sj.ncomp), int(sj.last))
