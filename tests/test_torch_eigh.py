"""The method of the coarsest eigendecomposition kernel
(``otamg_torch/csrc/coarse_eigh.cu``), step by step in torch ops on the
CPU (``eigh_steps.coarse_eigh_steps_plain``: Householder
tridiagonalisation, xSTEBZ's splitting and multisection on Sturm counts,
xSTEIN's inverse iteration with modified Gram-Schmidt inside clusters,
back-transformation), held to ``torch.linalg.eigh`` and to
``jnp.linalg.eigh`` with LAPACK's test threshold, and one Class-1 solve
whose setup uses it, held to the JAX package's solve.  The kernel itself
runs only on a card (``tests/test_torch_setup_graph.py``'s ``cuda``
tests and ``chip_smoke.py``)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import otamg.config as jcfg
import otamg_torch.config as tcfg
from otamg.amg import hierarchy as jh
from otamg.opt import solve_class1 as j_solve
from otamg.ot import random_class1 as j_random
from otamg_torch import random as tr
from otamg_torch.amg import hierarchy as th
from otamg_torch.opt import solve_class1 as t_solve
from otamg_torch.ot import random_class1 as t_random
import eigh_steps as es
from test_torch_setup_graph import CASES, clustered, newton_system

# LAPACK's threshold for its eigensolver tests (xSYT21's ratios), as
# chip_smoke.py holds the kernel.
C = 30


def random_symmetric(n, seed=0):
    B = np.random.default_rng(seed).standard_normal((n, n))
    return 0.5 * (B + B.T)


def diagonal(n=12):
    """Repeated entries, so the split T is twelve 1x1 blocks."""
    return np.diag(np.array([2.0, -1.0, 2.0, 0.0, 5.0, 2.0] * (n // 6)))


def tridiagonal(n=20, seed=1):
    rng = np.random.default_rng(seed)
    e = rng.standard_normal(n - 1)
    return np.diag(rng.standard_normal(n)) + np.diag(e, 1) + np.diag(e, -1)


@functools.cache
def coarsest(name, target):
    """The coarsest dense matrix of the JAX package's hierarchy for the
    Newton system of ``CASES[name]``, coarsened to ``target``."""
    seed = CASES[name][0]
    E, g, inv_tk, labels, nsp, gk = (
        t.numpy() if isinstance(t, torch.Tensor) else t
        for t in newton_system(*CASES[name]))
    opts = jcfg.AMGOptions(cycle=jcfg.Cycle.F, fuse_deep=True,
                           coarse_target=target)
    _, dense = jh.setup_hierarchy(
        jnp.asarray(E), jnp.asarray(g), inv_tk, jnp.asarray(labels),
        jnp.asarray(nsp), opts, jax.random.PRNGKey(seed),
        gk=jnp.asarray(gk))
    return np.array(dense[-1].A)


MATRICES = {
    "n1": lambda: random_symmetric(1),
    "n2": lambda: random_symmetric(2),
    "n3": lambda: random_symmetric(3),
    "diagonal": diagonal,
    "tridiagonal": tridiagonal,
    "random8": lambda: random_symmetric(8, 8),
    "random17": lambda: random_symmetric(17, 17),
    "random33": lambda: random_symmetric(33, 33),
    "random64": lambda: random_symmetric(64, 64),
    "clustered48": lambda: clustered(48, torch.float64).numpy(),
    "coarsest-repair": lambda: coarsest("repair", 6),
    "coarsest-bail": lambda: coarsest("bail", 6),
    "coarsest-repair-24": lambda: coarsest("repair", 24),
    "coarsest-bail-24": lambda: coarsest("bail", 24),
}


def held(lam, V, A, want):
    """LAPACK's tests in 1-norms: the eigenvalues within ``C n eps
    max|lam|`` of ``want``, ``||A V - V diag(lam)|| <= C n eps ||A||``,
    ``||V^T V - I|| <= C n eps``."""
    n = A.shape[0]
    eps = np.finfo(A.dtype).eps
    A64, V64, lam64 = (np.asarray(x, dtype=np.float64) for x in (A, V, lam))
    tol = C * n * eps
    assert np.abs(lam64 - want).max() <= tol * max(np.abs(want).max(), 1e-300)
    assert (np.abs(A64 @ V64 - V64 * lam64).sum(axis=0).max()
            <= tol * np.abs(A64).sum(axis=0).max())
    assert np.abs(V64.T @ V64 - np.eye(n)).sum(axis=0).max() <= tol


@pytest.mark.parametrize("dtype", [np.float64, np.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("name", sorted(MATRICES))
def test_steps_plain_is_eigh(name, dtype):
    """``coarse_eigh_steps_plain`` against ``torch.linalg.eigh`` and
    ``jnp.linalg.eigh`` of the same matrix in the same type, ``info`` 0,
    eigenvalues ascending."""
    A = MATRICES[name]().astype(dtype)
    lam, V, info = es.coarse_eigh_steps_plain(torch.as_tensor(A))
    assert int(info) == 0 and lam.dtype == V.dtype == torch.from_numpy(A).dtype
    assert bool((lam[1:] >= lam[:-1]).all())
    held(lam.numpy(), V.numpy(), A,
         torch.linalg.eigvalsh(torch.as_tensor(A)).double().numpy())
    held(lam.numpy(), V.numpy(), A,
         np.asarray(jnp.linalg.eigh(jnp.asarray(A))[0], dtype=np.float64))


def test_steps_plain_clusters_and_splits():
    """The clustered matrix leaves a cluster for modified Gram-Schmidt
    (neighbouring eigenvalues within ``1e-3 ||T||_1``), and the coarsest
    matrices of the hierarchies split T into blocks: the steps run both
    branches of the method."""
    d, e, _, _ = es._tridiagonalize(clustered(48, torch.float64))
    e, e2, pivmin, first, last = es._split(d, e)
    lam, ok = es._bisect(d, e, e2, pivmin, first, last)
    x = es._perturb(lam, first)
    T1 = float((d.abs() + e.abs() + torch.cat([e.new_zeros(1),
                                                 e[:-1]]).abs()).max())
    assert ok and bool(((x[1:] - x[:-1]).abs() <= 1e-3 * T1).any())
    d, e, _, _ = es._tridiagonalize(torch.as_tensor(coarsest("bail", 24)))
    _, _, _, first, last = es._split(d, e)
    assert int((first == last).sum()) > 0


def test_class1_solve_with_steps_plain(monkeypatch):
    """Class 1 at 24x20 (AMG, F-cycle, ``fuse_deep``) with every setup's
    coarsest eigendecomposition done by ``coarse_eigh_steps_plain``:
    JAX's iterations and failures, and its objective to 1e-8."""
    calls = []

    def steps(A):
        calls.append(A.shape[0])
        return es.coarse_eigh_steps_plain(A)

    monkeypatch.setattr(th, "coarse_eigh", steps)

    def options(cfg):
        return cfg.APDOptions(inner_solver=cfg.InnerSolver.AMG,
                              amg=cfg.AMGOptions(cycle=cfg.Cycle.F,
                                                 fuse_deep=True))

    rj = j_solve(j_random(jax.random.PRNGKey(42), 24, 20), options(jcfg))
    rt = t_solve(t_random(tr.PRNGKey(42), 24, 20, device="cpu"),
                 options(tcfg))
    assert calls
    assert rt.converged == rj.converged
    assert (rt.iters, rt.fail_count) == (rj.iters, rj.fail_count)
    np.testing.assert_allclose(rt.fxk[-1], rj.fxk[-1], rtol=1e-8)
