"""End-to-end parity of otamg_torch's Class-1 solve with the JAX package on
the CPU in f64: the same problem and options give the same outcome
(converged, outer iterations, inner-solver failures) and the same
objective trajectory."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import otamg.config as jcfg
import otamg_torch.config as tcfg
from otamg.amg.hierarchy import capacity_schedule
from otamg.opt import solve_class1 as j_solve
from otamg.ot import random_class1 as j_random
from otamg_torch import interop
from otamg_torch import random as tr
from otamg_torch.opt import solve_class1 as t_solve
from otamg_torch.ot import random_class1 as t_random

M, N = 24, 20


def options(cfg, inner):
    return cfg.APDOptions(
        inner_solver=cfg.InnerSolver[inner],
        amg=cfg.AMGOptions(cycle=cfg.Cycle.F, fuse_deep=True, coarse_target=6))


def assert_same_solve(rj, rt):
    assert rt.converged == rj.converged, "converged: exact"
    assert rt.iters == rj.iters, "outer iterations: exact"
    assert rt.fail_count == rj.fail_count, "fail_count: exact"
    np.testing.assert_allclose(rt.fxk, rj.fxk, rtol=1e-8,
                               err_msg="fxk trajectory: rtol 1e-8")


@pytest.mark.parametrize("inner", ["AMG", "PCG"])
def test_solve_class1_matches_jax(inner):
    if inner == "AMG":
        # coarse_target=6 gives the 24x20 Newton systems a deep enough
        # hierarchy for the F-tape and the fused deep correction.
        caps = capacity_schedule(M, M + N, options(jcfg, inner).amg)
        assert len(caps) >= 3, f"only {len(caps)} dense levels"
    rj = j_solve(j_random(jax.random.PRNGKey(42), M, N), options(jcfg, inner))
    rt = t_solve(t_random(tr.PRNGKey(42), M, N, device="cpu"),
                 options(tcfg, inner))
    assert rj.converged
    assert_same_solve(rj, rt)
    assert np.array_equal(rt.ssn_itnum, rj.ssn_itnum), "SsN steps: exact"


def test_capacitated_solve_matches_jax():
    """Finite capacity: the box prox and the capacitated merit.  In the
    tail ||F|| sits near the SsN tolerance, where rounding-level
    differences move single SsN steps between outer iterations; the
    outcome and the objective trajectory still agree."""
    pj = j_random(jax.random.PRNGKey(3), 16, 16)
    mass = float(jnp.sum(pj.r))
    gama = 2.0 * (np.outer(np.asarray(pj.l), np.asarray(pj.r)) / mass).max()
    pj = pj.__class__(C=pj.C, r=pj.r, l=pj.l, p=pj.p, q=pj.q,
                      gama=jnp.full((16, 16), gama))
    pt = interop.problem(*(np.asarray(getattr(pj, f)) for f in
                           ("C", "r", "l", "p", "q", "gama")), device="cpu")
    rj = j_solve(pj, options(jcfg, "PCG"))
    rt = t_solve(pt, options(tcfg, "PCG"))
    assert rj.converged and float(rt.X.max()) > 0.99 * gama
    assert_same_solve(rj, rt)
