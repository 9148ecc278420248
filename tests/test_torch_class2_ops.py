"""Parity of otamg_torch's Class-2 problems, operators and warm start (and
the assignment and capacitated generators) with the JAX package, on the
CPU in f64.  Inputs are made from numpy seeds or the shared PRNG and
handed to both packages."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.io as sio
import torch

from otamg.opt.admm import warmup_class2 as j_warmup2
from otamg.ot import operators as jop
from otamg.ot import problems as jprob
from otamg_torch import interop
from otamg_torch import random as tr
from otamg_torch.opt.admm import warmup_class2 as t_warmup2
from otamg_torch.ot import operators as top
from otamg_torch.ot import problems as tprob

M, N = 20, 16
T = lambda a: torch.as_tensor(np.array(a))
FIELDS2 = ("C", "r", "l", "p", "q", "Phi", "mu")


def close(got, want, rtol, what):
    """rtol relative to the largest entry of ``want`` (entries near zero
    carry summation-order noise of the array's own scale)."""
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, f"{what}: shape"
    scale = float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale,
                               err_msg=f"{what}: rtol {rtol} (of max)")


def carried2(pj):
    """The JAX problem carried across to the port, on the CPU."""
    return interop.problem2(*(np.asarray(getattr(pj, f)) for f in FIELDS2),
                            device="cpu")


def assert_same_problem(pt, pj, fields):
    for f in fields:
        assert np.array_equal(getattr(pt, f).numpy(),
                              np.asarray(getattr(pj, f))), f"{f}: exact"


@pytest.mark.parametrize("mu_frac", [None, 0.6])
def test_random_class2(mu_frac):
    """Every draw bit for bit, the drawn ``frac`` included; ``mu`` is
    ``frac * min(<r,q>, <l,p>)``, a dot product (summation order)."""
    pj = jprob.random_class2(jax.random.PRNGKey(7), M, N, mu_frac=mu_frac)
    pt = tprob.random_class2(tr.PRNGKey(7), M, N, mu_frac=mu_frac,
                             device="cpu")
    assert_same_problem(pt, pj, ("C", "r", "l", "p", "q", "Phi"))
    close(pt.mu, pj.mu, 1e-15, "mu")
    close(pt.b, pj.b, 1e-15, "b")
    assert pt.b.shape == (N + M + 1,)
    if mu_frac is None:
        cap = min(float(pt.r.sum()), float(pt.l.sum()))
        frac = float(jax.random.uniform(jax.random.split(
            jax.random.PRNGKey(7), 4)[3], (), dtype=jnp.float64))
        close(pt.mu, frac * cap, 1e-15, "drawn frac")


def test_assignment_and_capacitated_problems():
    pj = jprob.assignment_problem(jax.random.PRNGKey(5), 12)
    pt = tprob.assignment_problem(tr.PRNGKey(5), 12, device="cpu")
    assert_same_problem(pt, pj, ("C", "r", "l", "p", "q", "gama"))
    pj = jprob.capacitated_problem(jax.random.PRNGKey(3), M, N,
                                   cap_scale=1.5)
    pt = tprob.capacitated_problem(tr.PRNGKey(3), M, N, cap_scale=1.5,
                                   device="cpu")
    assert_same_problem(pt, pj, ("C", "r", "p", "q"))
    close(pt.l, pj.l, 1e-15, "l (summation order)")
    close(pt.gama, pj.gama, 1e-15, "gama (summation order)")
    assert pt.gama.shape == (M, N)


def test_load_class2_mat(tmp_path):
    rng = np.random.default_rng(21)
    d = dict(m=M, n=N, c=rng.uniform(size=(M * N, 1)),
             r=rng.uniform(size=(N, 1)), l=rng.uniform(size=(M, 1)),
             p=rng.uniform(0.5, 2, (M, 1)), q=rng.uniform(0.5, 2, (N, 1)),
             phi=rng.uniform(0.5, 1.5, (M * N, 1)), mu=np.array([[3.25]]))
    path = str(tmp_path / "data4.mat")
    sio.savemat(path, d)
    pj = jprob.load_class2_mat(path)
    pt = tprob.load_class2_mat(path, device="cpu")
    assert_same_problem(pt, pj, FIELDS2)
    # MATLAB's column-major vec: entry (i, j) is element i + j*m.
    assert float(pt.Phi[3, 2]) == d["phi"][3 + 2 * M, 0]
    d["q"][1] = 0.0
    sio.savemat(path, d)
    with pytest.raises(ValueError, match="zero elements"):
        tprob.load_class2_mat(path, device="cpu")


def test_new_constructors_default_to_cuda(tmp_path):
    """``device=None`` means CUDA, and raises without it, for every
    constructor and loader."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    path = str(tmp_path / "data4.mat")
    sio.savemat(path, dict(m=2, n=2, c=np.ones((4, 1)), r=np.ones((2, 1)),
                           l=np.ones((2, 1)), p=np.ones((2, 1)),
                           q=np.ones((2, 1)), phi=np.ones((4, 1)),
                           mu=np.array([[1.0]])))
    key = tr.PRNGKey(0)
    calls = [lambda: tprob.random_class2(key, 4, 3),
             lambda: tprob.assignment_problem(key, 4),
             lambda: tprob.capacitated_problem(key, 4, 3),
             lambda: tprob.load_class2_mat(path),
             lambda: interop.problem2(*([np.ones(2)] * 6), np.ones(()))]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(12)
    return dict(
        X=rng.uniform(-1, 1, (M, N)), y=rng.uniform(-1, 1, N),
        z=rng.uniform(-1, 1, M), p=rng.uniform(0.5, 2, M),
        q=rng.uniform(0.5, 2, N), Phi=rng.uniform(0.5, 1.5, (M, N)),
        lam=rng.standard_normal(N + M + 1), C=rng.uniform(size=(M, N)),
        b=rng.uniform(size=N + M + 1))


def test_apply_H_and_Ht(data):
    d = data
    args = ("X", "y", "z", "p", "q", "Phi")
    close(top.apply_H(*(T(d[a]) for a in args)),
          jop.apply_H(*(jnp.asarray(d[a]) for a in args)), 1e-12, "apply_H")
    got = top.apply_Ht(T(d["lam"]), T(d["p"]), T(d["q"]), T(d["Phi"]))
    want = jop.apply_Ht(jnp.asarray(d["lam"]), d["p"], d["q"], d["Phi"])
    close(got[0], want[0], 1e-12, "apply_Ht plan part")
    close(got[1], want[1], 0.0, "apply_Ht slack part")
    # adjointness: <H u, lam> = <u, H^T lam>
    lhs = float(torch.dot(top.apply_H(*(T(d[a]) for a in args)),
                          T(d["lam"])))
    rhs = float(torch.sum(T(d["X"]) * got[0])
                + torch.dot(torch.cat([T(d["y"]), T(d["z"])]), got[1]))
    assert abs(lhs - rhs) <= 1e-12 * abs(lhs)
    x = np.linspace(-2, 2, 9)
    assert np.array_equal(top.prox_nonneg(T(x)).numpy(),
                          np.asarray(jop.prox_nonneg(jnp.asarray(x))))


@pytest.mark.parametrize("sg", [0.3, 7.0])
def test_inv_hht(data, sg):
    d = data
    v = d["lam"]
    got = top.inv_hht(T(v), T(d["p"]), T(d["q"]), sg, T(d["Phi"]))
    want = jop.inv_hht(jnp.asarray(v), jnp.asarray(d["p"]),
                       jnp.asarray(d["q"]), sg, jnp.asarray(d["Phi"]))
    close(got, want, 1e-12, "inv_hht")
    # (sg I + H H^T) inv_hht(v) = v
    n = N
    HtX, Hts = top.apply_Ht(got, T(d["p"]), T(d["q"]), T(d["Phi"]))
    back = sg * got + top.apply_H(HtX, Hts[:n], Hts[n:], T(d["p"]),
                                  T(d["q"]), T(d["Phi"]))
    close(back, v, 1e-12, "(sg I + H H^T) inv_hht(v)")


def test_kkt_class2(data):
    d = data
    args = ("X", "y", "z", "lam", "C", "b", "p", "q", "Phi")
    got = top.kkt_class2(*(T(d[a]) for a in args))
    want = jop.kkt_class2(*(jnp.asarray(d[a]) for a in args))
    for g_, w_, name in zip(got, want, ("x", "y", "z", "lam")):
        close(g_, w_, 1e-12, f"kkt_class2 {name}")


def _perturbed_point(key, m, n, sparse: bool):
    """The perturbed feasible points of ``tests/test_operators.py``'s
    polish tests: a mass-scaled product coupling (dense, or on a ~8%
    support), slacks absorbing the marginal remainders, entries then
    scaled by ``1 + 1e-5 U(0, 1)``."""
    from otamg.ot import random_class2

    prob = random_class2(jax.random.PRNGKey(key), m, n, mu_frac=0.5)
    Phi, b = prob.Phi, prob.b
    X = jnp.outer(prob.l, prob.r)
    if sparse:
        k1, k2 = jax.random.split(jax.random.PRNGKey(key + 1))
        X = jnp.where(jax.random.uniform(k1, (m, n)) < 0.08, X, 0.0)
    else:
        k2 = jax.random.PRNGKey(key + 1)
    X = X * (b[-1] / jop.vdot_hi(Phi, X))
    y = jnp.maximum(b[:n] - X.sum(axis=0), 0.0)
    z = jnp.maximum(b[n:n + m] - X.sum(axis=1), 0.0)
    X = X * (1 + 1e-5 * jax.random.uniform(k2, X.shape))
    return prob, X, y, z


@pytest.mark.parametrize("dual_aware", [False, True])
@pytest.mark.parametrize("point", [(3, 20, 16, False), (5, 24, 18, True)],
                         ids=["dense", "sparse"])
def test_feasibility_polish(point, dual_aware):
    prob, X, y, z = _perturbed_point(*point)
    m, n = prob.m, prob.n
    lam = None
    if dual_aware:
        # duals above the 1e-5 saturation threshold on about half of the
        # columns and rows
        lam = np.random.default_rng(8).uniform(-1e-4, 1e-4, n + m + 1)
    pt = carried2(prob)
    want = jop.feasibility_polish(
        X, y, z, prob.p, prob.q, prob.Phi, prob.b,
        lam=None if lam is None else jnp.asarray(lam))
    got = top.feasibility_polish(
        T(X), T(y), T(z), pt.p, pt.q, pt.Phi, pt.b,
        lam=None if lam is None else T(lam))
    for g_, w_, name in zip(got, want, ("X", "y", "z")):
        close(g_, w_, 1e-12, f"polished {name}")
    Xp, yp, zp = got
    r1 = float(torch.linalg.vector_norm(
        top.apply_H(Xp, yp, zp, pt.p, pt.q, pt.Phi) - pt.b))
    assert float(Xp.min()) >= 0 and float(yp.min()) >= 0
    assert float(zp.min()) >= 0
    if not dual_aware:
        assert r1 < 1e-11, f"polish left r={r1:.2e}"


def test_warmup_class2():
    """100 iterations.  The mass multiplier ``lam[-1]`` is ill-conditioned
    in the A-ADMM: in the JAX package alone a 1-ulp change of ``mu``
    moves it by 2.7e-11 (of |lam| <= 0.1), so the two packages'
    summation orders part it by ~1e-10; it is held to 1e-8 of its value,
    everything else to 1e-10."""
    pj = jprob.random_class2(jax.random.PRNGKey(7), M, N, mu_frac=0.6)
    wj = j_warmup2(pj, 100)
    wt = t_warmup2(carried2(pj), 100)
    for f in ("X", "y", "z"):
        close(getattr(wt, f), getattr(wj, f), 1e-10, f"warmup_class2 {f}")
    close(wt.lam[:-1], wj.lam[:-1], 1e-10, "warmup_class2 lam[:-1]")
    np.testing.assert_allclose(float(wt.lam[-1]), float(wj.lam[-1]),
                               rtol=1e-8, err_msg="mass multiplier")
