"""The port's chunked and fused APD drivers (``otamg_torch.opt``) on the
CPU: the loop driver's trajectory bit for bit with fewer host reads, the
loops inside a step unchanged by their read interval, checkpoints that
cross drivers, the CLI's ``--driver``, and the chunked and fused drivers
against the JAX package's.  The deterministic segment sum and the CUDA
graph of the AMG block run only on a card (``cuda`` marker)."""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

import otamg.config as jcfg
import otamg_torch.config as tcfg
from otamg.opt import apd as japd
from otamg.opt import apd2 as japd2
from otamg.ot import random_class1 as j_random1
from otamg.ot import random_class2 as j_random2
from otamg_torch import random as tr
from otamg_torch.amg import graph as tgraph
from otamg_torch.amg import hierarchy as th
from otamg_torch.device import fetch
from otamg_torch.hybrid import solver as thyb
from otamg_torch.opt import apd, apd2
from otamg_torch.ot import random_class1, random_class2
from otamg_torch.sparse.segment import (segment_plan, segment_sum,
                                        segment_sum_plain)


def class1_opts(cfg=tcfg, **kw):
    """AMG inner solver, F-cycle, fuse_deep, as tests/test_torch_end_to_end
    runs 24x20."""
    return cfg.APDOptions(inner_solver=cfg.InnerSolver.AMG, amg=cfg.AMGOptions(
        cycle=cfg.Cycle.F, fuse_deep=True, coarse_target=6), **kw)


def run_counted(solve, *args, **kw):
    """(result, host reads per outer iteration)."""
    r0 = fetch.reads
    res = solve(*args, **kw)
    return res, (fetch.reads - r0) / res.iters


def assert_same_trajectory(got, want, fields):
    """Bit for bit on the CPU: the counts and every record."""
    for f in ("converged", "iters", "fail_count", "inner_total"):
        assert getattr(got, f) == getattr(want, f), f
    for f in fields:
        assert np.array_equal(getattr(got, f), getattr(want, f)), f
    assert torch.equal(got.X, want.X) and torch.equal(got.lam, want.lam)


C1_FIELDS = ("kkt_x", "kkt_l", "fxk", "ssn_itnum", "solver_itnum",
             "restarts", "info_ncomp", "info_last")
C2_FIELDS = ("kkt", "fxk", "ssn_itnum", "solver_itnum", "restarts",
             "info_ncomp", "info_last")


@pytest.fixture(scope="module")
def class1_loop():
    prob = random_class1(tr.PRNGKey(42), 24, 20, device="cpu")
    res, reads = run_counted(apd.solve_class1, prob, class1_opts())
    assert res.converged
    return prob, res, reads


@pytest.fixture(scope="module")
def class2_loop():
    prob = random_class2(tr.PRNGKey(7), 20, 16, mu_frac=0.6, device="cpu")
    res, reads = run_counted(apd2.solve_class2, prob,
                             apd2.default_class2_options())
    assert res.converged
    return prob, res, reads


DRIVERS = [("chunked", 1), ("chunked", 3), ("chunked", 8), ("fused", None)]


def fewer_reads(reads, loop_reads, chunk):
    """Host reads per outer iteration: chunk 1 no more than the loop
    driver's, chunk 3 strictly fewer, chunk 8 and fused under half."""
    if chunk == 1:
        assert reads <= loop_reads
    elif chunk == 3:
        assert reads < loop_reads
    else:
        assert reads < loop_reads / 2, (reads, loop_reads)


@pytest.mark.parametrize("driver,chunk", DRIVERS,
                         ids=["chunk1", "chunk3", "chunk8", "fused"])
def test_class1_drivers_equal_loop(class1_loop, driver, chunk):
    prob, base, base_reads = class1_loop
    if driver == "fused":
        res, reads = run_counted(apd.solve_class1_fused, prob, class1_opts())
    else:
        res, reads = run_counted(apd.solve_class1_chunked, prob,
                                 class1_opts(), chunk=chunk)
    assert_same_trajectory(res, base, C1_FIELDS)
    fewer_reads(reads, base_reads, chunk)


@pytest.mark.parametrize("driver,chunk", DRIVERS,
                         ids=["chunk1", "chunk3", "chunk8", "fused"])
def test_class2_drivers_equal_loop(class2_loop, driver, chunk):
    prob, base, base_reads = class2_loop
    opts = apd2.default_class2_options()
    if driver == "fused":
        res, reads = run_counted(apd2.solve_class2_fused, prob, opts)
    else:
        res, reads = run_counted(apd2.solve_class2_chunked, prob, opts,
                                 chunk=chunk)
    assert_same_trajectory(res, base, C2_FIELDS)
    assert res.polished == base.polished
    fewer_reads(reads, base_reads, chunk)


# ---------------------------------------------------------------------------
# The loops of a step: their read interval changes nothing
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def newton_system():
    """The last Newton system of the port's 24x20 AMG solve, 12 outer
    iterations in: the solver's arguments as the SsN loop passed them."""
    prob = random_class1(tr.PRNGKey(42), 24, 20, device="cpu")
    opts = class1_opts(maxit=12)
    inner = thyb.make_hybrid_amg_solver(prob.p, prob.q, opts.amg)
    seen = []

    def solver(*args):
        seen.append(args)
        return inner(*args)

    apd.solve_class1(prob, opts, solver=solver)
    S, tvec, bk1, tk, rhs, key = seen[-1]
    return prob, opts.amg, S, tvec, bk1, tk, rhs, key


@pytest.mark.parametrize("deflated", [False, True],
                         ids=["f64", "deflated"])
def test_amg_solve_blocks_change_nothing(newton_system, deflated):
    """``x``, ``iters`` and ``rel`` of ``amg_solve`` for block sizes 1, 2
    and 8, bit for bit."""
    prob, amg, S, tvec, bk1, tk, rhs, key = newton_system
    E, g, kdiag, f, _ = thyb._transform(S, tvec, bk1, tk, rhs, prob.p,
                                        prob.q)
    labels, nsp, _, _ = thyb._component_info(E, kdiag)
    gk = bk1 * torch.cat([prob.q ** 2, prob.p ** 2]) + kdiag / tk
    lv1, dense = th.setup_hierarchy(E, g, 1.0 / tk, labels, nsp, amg, key,
                                    gk=gk)
    guess = torch.as_tensor(
        np.random.default_rng(5).uniform(size=f.shape[0]) * 1e-3)
    if deflated:
        f = f / torch.linalg.vector_norm(f)
        guess = torch.zeros_like(f)
    runs = [th.amg_solve(lv1, dense, f, guess, amg, deflated=deflated,
                         exit_every=k) for k in (1, 2, 8)]
    assert int(runs[0].iters) > 2
    for r in runs[1:]:
        assert torch.equal(r.x, runs[0].x)
        assert torch.equal(r.iters, runs[0].iters)
        assert torch.equal(r.rel_res, runs[0].rel_res)


def test_amg_solve_zero_rhs():
    """A zero right-hand side runs no iteration, whatever the block."""
    A = torch.eye(6, dtype=torch.float64) * 2 - 0.5
    lv0, rest = th.setup_hierarchy_generic(A, tcfg.AMGOptions(), tr.PRNGKey(0))
    for k in (1, 4):
        r = th.amg_solve(lv0, rest, torch.zeros(6, dtype=torch.float64),
                         torch.zeros(6, dtype=torch.float64),
                         tcfg.AMGOptions(), exit_every=k)
        assert int(r.iters) == 0 and float(r.rel_res) == 1.0


@pytest.mark.parametrize("density", [0.04, 0.3], ids=["sparse", "dense"])
def test_label_propagation_blocks_change_nothing(density):
    """The labels for block sizes 1, 2 and 8, and a round at the fixpoint
    leaves them unchanged (so the rounds past the exit of a block need no
    mask)."""
    rng = np.random.default_rng(3)
    E = torch.as_tensor(rng.uniform(size=(30, 26))
                        * (rng.uniform(size=(30, 26)) < density))
    runs = [tgraph.connected_components_bipartite(E, exit_every=k)
            for k in (1, 2, 8)]
    for L in runs[1:]:
        assert torch.equal(L, runs[0])
    assert torch.equal(tgraph.label_round(E != 0, runs[0]), runs[0])
    assert int((runs[0] == torch.arange(56)).sum()) > 1 or density > 0.1


@pytest.mark.parametrize("density", [0.005, 0.2], ids=["bail", "rounds"])
def test_mis_blocks_change_nothing(density):
    """The C/F split for block sizes 1, 2 and 8, on a strength graph that
    bails out (too few connections) and one that runs rounds."""
    rng = np.random.default_rng(4)
    N = 40
    As = rng.uniform(size=(N, N)) < density
    As = torch.as_tensor(As | As.T) & ~torch.eye(N, dtype=torch.bool)
    active = torch.ones(N, dtype=torch.bool)
    active[-3:] = False
    As = As & active[:, None] & active[None, :]
    runs = [tgraph.mis_dense(As, active, tr.PRNGKey(11), exit_every=k)
            for k in (1, 2, 8)]
    for r in runs[1:]:
        assert torch.equal(r.isC, runs[0].isC)
        assert torch.equal(r.isF, runs[0].isF)
    assert int(runs[0].isC.sum()) > 0


def test_segment_sum_plain_is_index_add():
    rng = np.random.default_rng(6)
    labels = torch.as_tensor(rng.integers(0, 9, size=50))
    data = torch.as_tensor(rng.standard_normal(50))
    want = torch.zeros(12, dtype=torch.float64).index_add_(0, labels, data)
    assert torch.equal(segment_sum(data, labels, 12), want)
    assert torch.equal(segment_sum_plain(data, labels.to(torch.int32), 12),
                       want)


# ---------------------------------------------------------------------------
# Checkpoints across drivers, the CLI, the fp32 dual dtype
# ---------------------------------------------------------------------------


def test_class1_resume_across_drivers(tmp_path):
    """A chunked run stopped at a chunk boundary resumes under chunked
    and under loop, and a loop checkpoint under chunked, each onto the
    uninterrupted trajectory."""
    prob = random_class1(tr.PRNGKey(5), 16, 12, device="cpu")
    opts = class1_opts()
    full = apd.solve_class1(prob, opts)
    assert full.iters > 12
    stop = dataclasses.replace(opts, maxit=12)
    ck = str(tmp_path / "chunked")
    apd.solve_class1_chunked(prob, stop, chunk=4, checkpoint_dir=ck)
    r1 = apd.solve_class1_chunked(prob, opts, chunk=4, checkpoint_dir=ck,
                                  resume=True)
    r2 = apd.solve_class1(prob, opts, checkpoint_dir=ck, resume=True)
    ck2 = str(tmp_path / "loop")
    apd.solve_class1(prob, stop, checkpoint_dir=ck2, checkpoint_every=4)
    r3 = apd.solve_class1_chunked(prob, opts, chunk=4, checkpoint_dir=ck2,
                                  resume=True)
    for r in (r1, r2, r3):
        assert (r.converged, r.iters) == (full.converged, full.iters)
        assert torch.equal(r.X, full.X)
        assert np.array_equal(r.fxk[-3:], full.fxk[-3:])


def test_class2_resume_across_drivers(tmp_path):
    """As ``tests/test_cli_diag.py::test_class2_cross_driver_resume``:
    loop checkpoint to chunked resume and back."""
    prob = random_class2(tr.PRNGKey(8), 12, 10, mu_frac=0.5, device="cpu")

    def mkopts(maxit):
        return tcfg.APDOptions(ssn_tol1=1e-10, maxit=maxit, kkt_tol=1e-30,
                               inner_solver=tcfg.InnerSolver.AUG_PCG)

    full = apd2.solve_class2(prob, mkopts(16))
    ck = str(tmp_path / "lc")
    apd2.solve_class2(prob, mkopts(8), checkpoint_dir=ck, checkpoint_every=4)
    r1 = apd2.solve_class2_chunked(prob, mkopts(16), chunk=4,
                                   checkpoint_dir=ck, resume=True)
    ck2 = str(tmp_path / "cl")
    apd2.solve_class2_chunked(prob, mkopts(8), chunk=4, checkpoint_dir=ck2)
    r2 = apd2.solve_class2(prob, mkopts(16), checkpoint_dir=ck2, resume=True)
    r3 = apd2.solve_class2_chunked(prob, mkopts(16), chunk=4,
                                   checkpoint_dir=ck2, resume=True)
    for r in (r1, r2, r3):
        assert torch.equal(r.X, full.X) and r.iters == full.iters == 16
        assert np.array_equal(r.kkt[-1], full.kkt[-1])


@pytest.mark.parametrize("driver", ["chunked", "fused"])
def test_cli_drivers_match_jax_cli(driver, capsys):
    """``--driver chunked|fused`` against the JAX CLI in this process:
    the same report except ``wall_time_s``, the objective to 1e-8."""
    from otamg.cli import main as j_main
    from otamg_torch.cli import main as t_main

    def run(main, argv, capsys):
        capsys.readouterr()
        rc = main(argv)
        return rc, json.loads(capsys.readouterr().out.strip()
                              .splitlines()[-1])

    argv = ["class1", "--m", "20", "--n", "16", "--inner", "amg",
            "--cycle", "f", "--driver", driver, "--chunk", "4"]
    rc_j, rep_j = run(j_main, argv, capsys)
    rc_t, rep_t = run(t_main, argv + ["--device", "cpu"], capsys)
    assert rc_t == rc_j == 0 and rep_t["converged"]
    assert set(rep_t) == set(rep_j)
    assert rep_t["objective"] == pytest.approx(rep_j["objective"], rel=1e-8)
    for k in set(rep_j) - {"wall_time_s", "objective"}:
        assert rep_t[k] == rep_j[k], k
    rc_l, rep_l = run(t_main, argv[:-4] + ["--device", "cpu"], capsys)
    assert {k: v for k, v in rep_l.items() if k != "wall_time_s"} == \
        {k: v for k, v in rep_t.items() if k != "wall_time_s"}


def test_cli_fused_checkpoint_warning(tmp_path, capsys):
    from otamg_torch.cli import main as t_main

    rc = t_main(["class1", "--m", "8", "--n", "8", "--inner", "pcg",
                 "--device", "cpu", "--driver", "fused", "--checkpoint",
                 str(tmp_path / "ck")])
    err = capsys.readouterr().err
    assert rc == 0 and "--checkpoint is ignored with --driver fused" in err


@pytest.mark.parametrize("driver", ["loop", "chunked"])
def test_fp32_plan_keeps_f64_duals(driver, monkeypatch, capsys):
    """``--fp32``: the plan in fp32, the dual state in f64, under every
    driver (the port's choice; the JAX CLI solves in fp32 throughout,
    ROADMAP Queue 3)."""
    import otamg_torch.opt as topt
    from otamg_torch.cli import main as t_main

    name = "solve_class1" + ("" if driver == "loop" else "_chunked")
    solve, got = getattr(topt, name), []

    def kept(*args, **kw):
        got.append(solve(*args, **kw))
        return got[-1]

    monkeypatch.setattr(topt, name, kept)
    rc = t_main(["class1", "--m", "24", "--n", "20", "--fp32", "--device",
                 "cpu", "--maxit", "3", "--driver", driver, "--chunk", "3"])
    assert rc == 1 and '"iters": 3' in capsys.readouterr().out
    assert got[0].X.dtype == torch.float32
    assert got[0].lam.dtype == torch.float64


# ---------------------------------------------------------------------------
# Against the JAX package's chunked and fused drivers
# ---------------------------------------------------------------------------


def test_class1_chunked_and_fused_match_jax():
    """``random_class1(PRNGKey(5), 16, 12)`` with the PCG inner solver
    (``tests/test_cli_diag.py``'s problem and options)."""
    jp = j_random1(jax.random.PRNGKey(5), 16, 12)
    tp = random_class1(tr.PRNGKey(5), 16, 12, device="cpu")
    jo = jcfg.APDOptions(inner_solver=jcfg.InnerSolver.PCG)
    to = tcfg.APDOptions(inner_solver=tcfg.InnerSolver.PCG)
    for rj, rt in ((japd.solve_class1_chunked(jp, jo, chunk=4),
                    apd.solve_class1_chunked(tp, to, chunk=4)),
                   (japd.solve_class1_fused(jp, jo),
                    apd.solve_class1_fused(tp, to))):
        assert rj.converged and rt.converged
        assert (rt.iters, rt.fail_count) == (rj.iters, rj.fail_count)
        np.testing.assert_allclose(rt.fxk, rj.fxk, rtol=1e-8)


def test_class2_chunked_matches_jax():
    """``random_class2(PRNGKey(8), 12, 10, mu_frac=0.5)`` with the
    augmented PCG (``tests/test_cli_diag.py``'s problem and options)."""
    jp = j_random2(jax.random.PRNGKey(8), 12, 10, mu_frac=0.5)
    tp = random_class2(tr.PRNGKey(8), 12, 10, mu_frac=0.5, device="cpu")
    jo = jcfg.APDOptions(ssn_tol1=1e-10, maxit=16, kkt_tol=1e-30,
                         inner_solver=jcfg.InnerSolver.AUG_PCG)
    to = tcfg.APDOptions(ssn_tol1=1e-10, maxit=16, kkt_tol=1e-30,
                         inner_solver=tcfg.InnerSolver.AUG_PCG)
    rj = japd2.solve_class2_chunked(jp, jo, chunk=4)
    rt = apd2.solve_class2_chunked(tp, to, chunk=4)
    assert (rt.iters, rt.fail_count) == (rj.iters, rj.fail_count) == (16, 0)
    assert np.array_equal(rt.ssn_itnum, rj.ssn_itnum)
    np.testing.assert_allclose(rt.fxk, rj.fxk, rtol=1e-8)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs these checks")
    return torch.device("cuda")


@pytest.mark.cuda
def test_segment_sum_kernel(card):
    """The scan kernel and the plan kernel against the plain version on
    the same inputs: bit for bit where the call is exact (the CPU's
    order), to 1e-12 where it is tiled; two calls equal each other, and
    the no-plan call equals the call over a plan."""
    g = torch.Generator(device=card).manual_seed(0)
    for L, nseg in ((700, 1000), (1 << 16, 1 << 14)):
        labels = torch.randint(0, nseg // 3, (L,), generator=g, device=card)
        data = torch.randn(L, generator=g, device=card, dtype=torch.float64)
        plan = segment_plan(labels, nseg)
        got = segment_sum(data, labels, nseg)
        want = segment_sum_plain(data.cpu(), labels.cpu(), nseg)
        assert torch.equal(got, segment_sum(data, labels, nseg))
        assert torch.equal(got, segment_sum(data, labels, nseg, plan))
        if nseg * L <= (1 << 24):
            assert torch.equal(got.cpu(), want)
        else:
            torch.testing.assert_close(got.cpu(), want, rtol=1e-12,
                                       atol=1e-12)


@pytest.mark.cuda
def test_amg_graph_replays(card):
    """The chunked Class-1 driver on the card: the loop driver's outcome,
    one capture, and the AMG blocks replayed."""
    th.amg_graphs.clear()
    prob = random_class1(tr.PRNGKey(42), 24, 20, device=card)
    base = apd.solve_class1(prob, class1_opts())
    res = apd.solve_class1_chunked(prob, class1_opts(), chunk=8)
    assert (res.iters, res.fail_count) == (base.iters, base.fail_count)
    np.testing.assert_allclose(res.fxk, base.fxk, rtol=1e-10)
    assert th.amg_graphs.captures == 1 and th.amg_graphs.replays > 0
