"""The device-side branch ``otamg_torch.graphs.when`` on the CPU, where it
is a Python ``if`` on its predicate, against its select form (the plain
version, ``graphs.select_form``) and against the JAX package: ``when``
itself (run, skip, nested, the counts), the defect repair of the setup,
the AMG block's steps after its exit, and the Armijo trials and the
mixed refinement's cycles of the chunked driver against the loop
driver's.  On a card the same bodies are CUDA-graph conditional nodes
(``csrc/conditional.cu``); ``chip_smoke.py`` (phase ``conditional``)
holds them to the select form there."""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import otamg.config as jcfg
import otamg_torch.config as tcfg
from otamg.amg import hierarchy as jh
from otamg_torch import graphs
from otamg_torch import random as tr
from otamg_torch.amg import hierarchy as th
from otamg_torch.hybrid import solver as thyb
from otamg_torch.opt import apd
from otamg_torch.ot import random_class1
from test_torch_setup_graph import CASES, leaves, newton_system

AMG_J = jcfg.AMGOptions(cycle=jcfg.Cycle.F, fuse_deep=True, coarse_target=6)
AMG_T = tcfg.AMGOptions(cycle=tcfg.Cycle.F, fuse_deep=True, coarse_target=6)


_jax_setup = jax.jit(jh.setup_hierarchy, static_argnums=5)


def jax_setup(system, seed):
    """The JAX package's ``setup_hierarchy`` of a Newton system of
    :func:`newton_system` (compiled once for the setup cases' shapes)."""
    E, g, inv_tk, labels, nsp, gk = (jnp.asarray(t.numpy())
                                     if isinstance(t, torch.Tensor) else t
                                     for t in system)
    return _jax_setup(E, g, inv_tk, labels, nsp, AMG_J,
                      jax.random.PRNGKey(seed), gk)


def counted(fn):
    """``(fn(), the counts of the bodies it ran)``."""
    graphs.cond_counts.reset()
    out = fn()
    return out, graphs.cond_counts.read()


@pytest.mark.parametrize("outer,inner",
                         list(itertools.product([True, False], repeat=2)))
def test_when_runs_skips_and_nests(outer, inner):
    """A body writes its buffers in place where its predicate holds and
    leaves them as they are elsewhere, a body nested in another only
    where both hold; the counts are the bodies that ran.  The select
    form gives the same bits and counts."""
    rng = np.random.default_rng(3)
    x, a0 = (torch.as_tensor(rng.normal(size=7)) for _ in range(2))

    def run():
        a, b = a0.clone(), torch.zeros((), dtype=torch.int64)
        p, q = torch.tensor(outer), torch.tensor(inner)

        def body():
            a.copy_(a * x + 1)
            graphs.when(q, lambda: b.copy_(b + 10), [b],
                        count=(graphs.REFINE_CYCLES,))

        graphs.when(p, body, [a, b], count=(graphs.AMG_CYCLES,))
        return a, b

    (a, b), got = counted(run)
    assert torch.equal(a, a0 * x + 1 if outer else a0)
    assert int(b) == (10 if outer and inner else 0)
    assert got == dict(repairs=0, amg_cycles=int(outer),
                       refine_cycles=int(outer and inner), armijo_trials=0)
    with graphs.select_form():
        (a_s, b_s), want = counted(run)
    assert torch.equal(a_s, a) and torch.equal(b_s, b) and want == got


@pytest.mark.parametrize("name", sorted(CASES))
def test_setup_repair_as_select_and_jax(name):
    """``setup_solve`` on the repair and bail cases: every leaf of the
    hierarchy, the deep matrix and the stats equal the select form's bit
    for bit, the repairs built are the repairs the stats count, and the
    levels are the JAX package's (its ``lax.cond``) to 1e-12."""
    seed = CASES[name][0]
    system = newton_system(*CASES[name])

    def setup():
        th.setup_stats.reset()
        lv1, dense, deep = th.setup_solve(*system[:5], AMG_T,
                                          tr.PRNGKey(seed), system[5])
        return leaves(lv1, dense), deep, th.setup_stats.read()

    (got, deep, stats), counts = counted(setup)
    with graphs.select_form():
        (want, deep_s, stats_s), counts_s = counted(setup)
    assert len(got) == len(want)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert torch.equal(deep, deep_s) and stats == stats_s
    assert counts == counts_s
    assert counts["repairs"] == stats[1]
    assert (stats[1] > 0) if name == "repair" else (stats[3] > 0)

    _, jd = jax_setup(system, seed)
    _, td, _ = th.setup_solve(*system[:5], AMG_T, tr.PRNGKey(seed),
                              system[5])
    assert len(td) == len(jd)
    for i, (lt, lj) in enumerate(zip(td, jd)):
        for f in ("A", "P")[:1 + bool(i)]:
            want = np.asarray(getattr(lj, f))
            np.testing.assert_allclose(
                getattr(lt, f).numpy(), want, rtol=1e-12,
                atol=1e-12 * float(np.abs(want).max()), err_msg=f"{i} {f}")


def test_amg_block_stops_at_its_exit():
    """``amg_solve`` in blocks of 4 on a 40 x 36 Newton system (the
    setup cases' shapes): ``x``, ``rel`` and ``iters`` equal the select
    form's bit for bit and the JAX package's ``amg_solve`` (``iters``
    exactly), and the cycles run are ``iters``: none after the exit
    inside the last block."""
    system = newton_system(10, 40, 36, 0.1)
    E = system[0]
    lv1, dense, deep = th.setup_solve(*system[:5], AMG_T, tr.PRNGKey(10),
                                      system[5])
    rng = np.random.default_rng(10)
    b = torch.as_tensor(rng.normal(size=E.shape[0] + E.shape[1]))
    guess = torch.as_tensor(rng.uniform(size=b.shape[0]) * 1e-3)

    def solve():
        return th.amg_solve(lv1, dense, b, guess, AMG_T, exit_every=4,
                            deep=deep)

    got, counts = counted(solve)
    with graphs.select_form():
        want, counts_s = counted(solve)
    iters = int(got.iters)
    assert iters > 4 and iters % 4
    assert counts["amg_cycles"] == iters == counts_s["amg_cycles"]
    assert torch.equal(got.x, want.x) and torch.equal(got.iters, want.iters)
    assert torch.equal(got.rel_res, want.rel_res)

    rj = jax.jit(jh.amg_solve, static_argnums=4)(
        *jax_setup(system, 10), jnp.asarray(b.numpy()),
        jnp.asarray(guess.numpy()), AMG_J)
    assert iters == int(rj.iters)
    want_x = np.asarray(rj.x)
    np.testing.assert_allclose(got.x.numpy(), want_x, rtol=1e-10,
                               atol=1e-10 * np.abs(want_x).max())


def class1_opts(solve_dtype):
    return tcfg.APDOptions(
        inner_solver=tcfg.InnerSolver.AMG, solve_dtype=solve_dtype,
        amg=tcfg.AMGOptions(cycle=tcfg.Cycle.F, fuse_deep=True,
                            coarse_target=6))


@pytest.mark.parametrize("solve_dtype", [None, "float32"],
                         ids=["f64", "mixed"])
def test_chunked_counts_equal_loop(solve_dtype):
    """A 24 x 24 Class-1 solve: the chunked driver (chunk 3) counts the
    loop driver's Armijo trials, repairs, AMG cycles and refinement
    cycles, and the same refinement rounds, reverts and cycles; in f64
    the AMG cycles are the solve's inner iterations."""
    prob = random_class1(tr.PRNGKey(0), 24, 24, device="cpu")
    opts = class1_opts(solve_dtype)
    out = []
    for solve in (apd.solve_class1,
                  lambda p, o: apd.solve_class1_chunked(p, o, chunk=3)):
        thyb.refine_counts.reset()
        res, counts = counted(lambda: solve(prob, opts))
        rc = thyb.refine_counts
        out.append((res, counts, (rc.solves, rc.rounds, rc.reverted,
                                  rc.cycles)))
    (loop, c_loop, r_loop), (chunked, c_chunked, r_chunked) = out
    assert chunked.iters == loop.iters and np.array_equal(chunked.fxk,
                                                          loop.fxk)
    assert c_chunked == c_loop and r_chunked == r_loop
    assert c_loop["armijo_trials"] >= int(loop.ssn_itnum.sum()) > 0
    if solve_dtype is None:
        assert c_loop["amg_cycles"] == loop.inner_total
        assert c_loop["refine_cycles"] == 0
    else:
        assert c_loop["refine_cycles"] == r_loop[3] > 0
        assert c_loop["amg_cycles"] == r_loop[3]
