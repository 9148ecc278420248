"""End-to-end parity of otamg_torch's Class-2 solve, and of the Class-1
solve with the rest of the inner-solver menu, with the JAX package on the
CPU in f64: the same problem and options give the same outcome
(converged, outer iterations, inner-solver failures, SsN steps) and the
same objective trajectory."""

import dataclasses

import jax
import numpy as np
import pytest
from scipy.optimize import linprog

import otamg.config as jcfg
import otamg_torch.config as tcfg
from otamg.opt import solve_class1 as j_solve1
from otamg.opt.apd2 import default_class2_options as j_defaults
from otamg.opt.apd2 import solve_class2 as j_solve2
from otamg.ot import random_class1 as j_random1
from otamg.ot import random_class2 as j_random2
from otamg_torch import random as tr
from otamg_torch.opt import solve_class1 as t_solve1
from otamg_torch.opt.apd2 import default_class2_options as t_defaults
from otamg_torch.opt.apd2 import solve_class2 as t_solve2
from otamg_torch.ot import random_class1 as t_random1
from otamg_torch.ot import random_class2 as t_random2

M2, N2 = 20, 16


def assert_same_solve(rj, rt):
    assert rt.converged == rj.converged, "converged: exact"
    assert rt.iters == rj.iters, "outer iterations: exact"
    assert rt.fail_count == rj.fail_count, "fail_count: exact"
    assert np.array_equal(rt.ssn_itnum, rj.ssn_itnum), "SsN steps: exact"
    np.testing.assert_allclose(rt.fxk, rj.fxk, rtol=1e-8,
                               err_msg="fxk trajectory: rtol 1e-8")


def test_default_class2_options():
    def flat(o):
        return {k: (v.name if hasattr(v, "name") else v)
                for k, v in dataclasses.asdict(o).items()
                if not isinstance(v, dict)}

    j, t = j_defaults(), t_defaults()
    assert flat(t) == flat(j) and flat(t.amg) == flat(j.amg)
    assert (t.ssn_tol1, t.amg.maxit, t.amg.smoth) == (1e-10, 40, 10)


@pytest.fixture(scope="module")
def lp_objective():
    """The Class-2 LP over ``(x, y, z)`` solved by HiGHS, as
    ``tests/test_end_to_end.py`` builds it."""
    import chip_smoke

    pt = t_random2(tr.PRNGKey(7), M2, N2, mu_frac=0.6, device="cpu")
    c, A_eq, b_eq = chip_smoke.class2_lp(pt)
    lp = linprog(c, A_eq=A_eq, b_eq=b_eq, bounds=(0, None), method="highs")
    assert lp.status == 0
    return lp.fun


@pytest.mark.parametrize("inner,polish", [
    ("AMG", False), ("AUG_PCG", False), ("DIRECT", False),
    ("PCG", False), ("TWOGRID", False),
    ("AMG", True), ("AUG_PCG", True), ("DIRECT", True)])
def test_solve_class2_matches_jax(lp_objective, inner, polish):
    """``random_class2(PRNGKey(7), 20, 16, mu_frac=0.6)`` with the
    Class-2 defaults: with ``feas_polish`` the polish is accepted
    (iteration 38) long before the plain run ends (51)."""
    jo = dataclasses.replace(j_defaults(),
                             inner_solver=jcfg.InnerSolver[inner],
                             feas_polish=polish)
    to = dataclasses.replace(t_defaults(),
                             inner_solver=tcfg.InnerSolver[inner],
                             feas_polish=polish)
    rj = j_solve2(j_random2(jax.random.PRNGKey(7), M2, N2, mu_frac=0.6), jo)
    pt = t_random2(tr.PRNGKey(7), M2, N2, mu_frac=0.6, device="cpu")
    rt = t_solve2(pt, to)
    assert rj.converged
    assert_same_solve(rj, rt)
    assert rt.polished == rj.polished == polish
    np.testing.assert_allclose(rt.kkt, rj.kkt, rtol=1e-6,
                               atol=1e-8 * np.abs(rj.kkt).max())
    assert abs(rt.fxk[-1] - lp_objective) / abs(lp_objective) < 1e-5
    # the mass budget is met: <phi, x> = mu
    np.testing.assert_allclose(float((pt.Phi * rt.X).sum()), float(pt.mu),
                               rtol=1e-4)


@pytest.mark.parametrize("inner", ["DIRECT", "AUG_PCG", "TWOGRID"])
def test_solve_class1_rest_of_menu(inner):
    """Class 1 at 24x20, as ``tests/test_torch_end_to_end.py`` runs AMG
    and PCG."""
    def options(cfg):
        return cfg.APDOptions(
            inner_solver=cfg.InnerSolver[inner],
            amg=cfg.AMGOptions(cycle=cfg.Cycle.F, fuse_deep=True,
                               coarse_target=6))

    rj = j_solve1(j_random1(jax.random.PRNGKey(42), 24, 20), options(jcfg))
    rt = t_solve1(t_random1(tr.PRNGKey(42), 24, 20, device="cpu"),
                  options(tcfg))
    assert rj.converged
    assert_same_solve(rj, rt)
