"""End-to-end parity of the port's Class-1 solve with the JAX package's
at 64x64 on the CPU in f64, with ``fuse_deep`` off and on (AMG inner
solver, F-cycle, the default depth): the same outcome, iterations and
failures, and the objective trajectory to 1e-8.  The SsN steps are not
compared: at this size single steps move between outer iterations where
``||F||`` sits at the SsN tolerance (summation order), as at 16x16 with
the PCG inner solver (``tests/test_torch_cli.py``)."""

import jax
import numpy as np
import pytest

import otamg.config as jcfg
import otamg_torch.config as tcfg
from otamg.opt import solve_class1 as j_solve
from otamg.ot import random_class1 as j_random
from otamg_torch import random as tr
from otamg_torch.opt import solve_class1 as t_solve
from otamg_torch.ot import random_class1 as t_random


@pytest.mark.parametrize("fuse_deep", [False, True], ids=["tape", "fused"])
def test_class1_64_matches_jax(fuse_deep):
    def options(cfg):
        return cfg.APDOptions(inner_solver=cfg.InnerSolver.AMG,
                              amg=cfg.AMGOptions(cycle=cfg.Cycle.F,
                                                 fuse_deep=fuse_deep))

    rj = j_solve(j_random(jax.random.PRNGKey(0), 64, 64), options(jcfg))
    rt = t_solve(t_random(tr.PRNGKey(0), 64, 64, device="cpu"),
                 options(tcfg))
    assert rj.converged and rt.converged
    assert (rt.iters, rt.fail_count) == (rj.iters, rj.fail_count)
    k = min(len(rt.fxk), len(rj.fxk))
    np.testing.assert_allclose(rt.fxk[:k], rj.fxk[:k], rtol=1e-8)
