"""Parity of otamg_torch's problem, operator, warm-start, PCG and Newton-PCG
modules with the JAX package, on the CPU in f64.  Inputs are made from
numpy seeds (or the shared PRNG) and handed to both packages."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import otamg.config as jcfg
import otamg_torch.config as tcfg
from otamg.krylov.pcg import pcg as j_pcg
from otamg.opt.admm import warmup_class1 as j_warmup
from otamg.opt.newton import make_pcg_solver as j_make_pcg
from otamg.ot import operators as jop
from otamg.ot.problems import load_class1_mat as j_load
from otamg.ot.problems import random_class1 as j_random
from otamg_torch import interop
from otamg_torch import random as tr
from otamg_torch.krylov.pcg import pcg as t_pcg
from otamg_torch.opt.admm import warmup_class1 as t_warmup
from otamg_torch.opt.newton import make_pcg_solver as t_make_pcg
from otamg_torch.ot import operators as top
from otamg_torch.ot.problems import load_class1_mat as t_load
from otamg_torch.ot.problems import random_class1 as t_random

M, N = 24, 20
T = lambda a: torch.as_tensor(np.asarray(a))


def close(got, want, rtol, what, atol=0.0):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol,
                               err_msg=f"{what}: rtol {rtol}")


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(11)
    return dict(
        X=rng.uniform(-1, 1, (M, N)), p=rng.uniform(0.5, 2, M),
        q=rng.uniform(0.5, 2, N), y=rng.standard_normal(N + M),
        S=(rng.uniform(size=(M, N)) > 0.4).astype(float),
        gama=rng.uniform(0.1, 0.8, (M, N)), C=rng.uniform(size=(M, N)))


def test_config_is_a_copy():
    for name in ("PCGOptions", "AMGOptions", "WarmupOptions", "APDOptions",
                 "MeshOptions"):
        j = dataclasses.asdict(getattr(jcfg, name)())
        t = dataclasses.asdict(getattr(tcfg, name)())
        norm = lambda d: {k: (v.name if hasattr(v, "name") else v)
                          for k, v in d.items() if not isinstance(v, dict)}
        assert norm(j) == norm(t), name
    for enum in ("Preconditioner", "Cycle", "InnerSolver"):
        assert ([(e.name, e.value) for e in getattr(jcfg, enum)]
                == [(e.name, e.value) for e in getattr(tcfg, enum)])


def test_random_class1():
    pj = j_random(jax.random.PRNGKey(42), M, N)
    pt = t_random(tr.PRNGKey(42), M, N, device="cpu")
    assert np.array_equal(np.asarray(pj.C), pt.C.numpy()), "C: exact"
    assert np.array_equal(np.asarray(pj.r), pt.r.numpy()), "r: exact"
    close(pt.l, pj.l, 1e-15, "l (summation order)")
    for f in ("p", "q", "gama"):
        assert np.array_equal(np.asarray(getattr(pj, f)),
                              getattr(pt, f).numpy())


def test_default_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        t_random(tr.PRNGKey(0), 4, 3)


def test_load_class1_mat(tmp_path):
    import scipy.io as sio

    rng = np.random.default_rng(3)
    m, n = 6, 5
    path = str(tmp_path / "data1-test.mat")
    sio.savemat(path, dict(
        c=rng.uniform(size=(m * n, 1)), gama=np.full((m * n, 1), np.inf),
        l=rng.uniform(size=(m, 1)), r=rng.uniform(size=(n, 1)),
        p=np.ones((m, 1)), q=np.ones((n, 1)), m=m, n=n))
    pj = j_load(path)
    pt = t_load(path, device="cpu")
    for f in ("C", "r", "l", "p", "q", "gama"):
        assert np.array_equal(np.asarray(getattr(pj, f)),
                              getattr(pt, f).numpy()), f


def test_apply_A_At_asat(data):
    X, p, q, y, S = (data[k] for k in ("X", "p", "q", "y", "S"))
    close(top.apply_A(T(X), T(p), T(q)), jop.apply_A(X, p, q), 1e-12,
          "apply_A")
    close(top.apply_At(T(y), T(p), T(q)), jop.apply_At(y, p, q), 1e-12,
          "apply_At")
    for got, want in zip(top.asat_diags(T(S), T(p), T(q)),
                         jop.asat_diags(S, p, q)):
        close(got, want, 1e-12, "asat_diags")
    close(top.apply_asat(T(y), T(S), T(p), T(q)),
          jop.apply_asat(jnp.asarray(y), S, p, q), 1e-12, "apply_asat")


@pytest.mark.parametrize("finite", [False, True])
def test_prox_box(data, finite):
    Z = 2 * data["X"]
    gama = data["gama"] if finite else np.asarray(np.inf)
    close(top.prox_box(T(Z), T(gama)), jop.prox_box(Z, gama), 1e-12,
          "prox_box")


def test_inv_aat(data):
    p, q, y = data["p"], data["q"], data["y"]
    for sg1, sg2 in ((0.7, None), (0.3, 2.5)):
        close(top.inv_aat(T(y), T(p), T(q), sg1, sg2),
              jop.inv_aat(jnp.asarray(y), p, q, sg1, sg2), 1e-12, "inv_aat")


@pytest.mark.parametrize("finite", [False, True])
def test_kkt_class1(data, finite):
    X, p, q, y, C = (data[k] for k in ("X", "p", "q", "y", "C"))
    X = np.abs(X)
    b = np.concatenate([X.T @ p, X @ q]) + 0.01
    gama = data["gama"] if finite else np.asarray(np.inf)
    want = jop.kkt_class1(X, y, C, b, p, q, gama)
    got = top.kkt_class1(T(X), T(y), T(C), T(b), T(p), T(q), T(gama))
    for g, w, name in zip(got, want, ("kkt_x", "kkt_l")):
        close(g, w, 1e-12, name)


def test_warmup_class1():
    pj = j_random(jax.random.PRNGKey(5), M, N)
    pt = interop.problem(*(np.asarray(getattr(pj, f)) for f in
                           ("C", "r", "l", "p", "q", "gama")), device="cpu")
    wj = j_warmup(pj, 100)
    wt = t_warmup(pt, 100)
    # rtol 1e-9 relative to each array's largest entry: 100 iterations
    # of f64 GEMVs summed in another order leave ~1e-13 absolute noise,
    # which entries near zero would read as a large relative error.
    for got, want, name in ((wt.X, wj.X, "warmup X"),
                            (wt.lam, wj.lam, "warmup lam")):
        close(got, want, 1e-9, name,
              atol=1e-9 * float(np.abs(np.asarray(want)).max()))


def _spd(rng, k):
    B = rng.standard_normal((k, k))
    return B @ B.T + k * np.eye(k)


def test_pcg():
    rng = np.random.default_rng(2)
    H = _spd(rng, 40)
    e = rng.standard_normal(40)
    dinv = 1.0 / np.diag(H)
    rj = j_pcg(lambda v: jnp.asarray(H) @ v, jnp.asarray(e),
               lambda r: r * dinv, retol=1e-11, maxit=200)
    rt = t_pcg(lambda v: T(H) @ v, T(e), lambda r: r * T(dinv),
               retol=1e-11, maxit=200)
    assert rt.iters == int(rj.iters), "pcg iters: exact"
    close(rt.x, rj.x, 1e-10, "pcg x")
    # maxit binds: same truncated iterate
    rj = j_pcg(lambda v: jnp.asarray(H) @ v, jnp.asarray(e), maxit=5)
    rt = t_pcg(lambda v: T(H) @ v, T(e), maxit=5)
    assert rt.iters == int(rj.iters) == 5
    close(rt.x, rj.x, 1e-10, "pcg x at maxit")


@pytest.mark.parametrize("precd", ["JACOBI", "NONE", "BI_SSOR"])
def test_make_pcg_solver(data, precd):
    p, q, S = data["p"], data["q"], data["S"]
    rhs = np.random.default_rng(4).standard_normal(N + M)
    tvec = np.zeros(N + M)
    jopts = jcfg.PCGOptions(precd=jcfg.Preconditioner[precd], maxit=500)
    topts = tcfg.PCGOptions(precd=tcfg.Preconditioner[precd], maxit=500)
    sj = j_make_pcg(jnp.asarray(p), jnp.asarray(q), jopts)(
        jnp.asarray(S), jnp.asarray(tvec), 1e-2, 0.5, jnp.asarray(rhs))
    st = t_make_pcg(T(p), T(q), topts)(T(S), T(tvec), 1e-2, 0.5, T(rhs))
    assert st.iters == int(sj.iters), "Newton PCG iters: exact"
    close(st.zeta, sj.zeta, 1e-9, "Newton PCG zeta")
