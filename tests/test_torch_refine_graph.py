"""The mixed-precision refinement rounds of the blocked drivers
(``otamg_torch.hybrid.solver.Refinement``): the rounds as regions over a
static state, one host read a block of ``exit_every`` correction cycles
and none of the rounds' own, equal to the loop's rounds
(``exit_every == 1``) bit for bit: the solution, ``iters``, ``rel`` and
the refinement counts, reverted rounds included.  The chunked and fused
drivers' mixed solves are held to the loop driver bit for bit and to the
JAX package's fused driver; two gloo ranks hold the sharded blocked solve
to the unsharded one.  The CUDA graphs of the regions run only on a card
(``cuda`` marker); the JAX package is imported only where a test
compares with it, so on the card ``python -m pytest --noconftest
tests/test_torch_refine_graph.py -m cuda`` runs without it."""

import collections
import dataclasses
import math

import numpy as np
import pytest
import torch

import otamg_torch.config as tcfg
import torch_dist_ranks as R
from otamg_torch import graphs
from otamg_torch import random as tr
from otamg_torch.device import fetch
from otamg_torch.hybrid import pot as tpot
from otamg_torch.hybrid import solver as thyb
from otamg_torch.opt import apd, apd2
from otamg_torch.ot import random_class1, random_class2

AMG_T = tcfg.AMGOptions(cycle=tcfg.Cycle.F, fuse_deep=True, coarse_target=6)
F32 = "float32"
# Tensor methods that read a value to the host.
HOST_READS = ("item", "tolist", "numpy", "__bool__", "__float__", "__int__")


def newton_arrays(seed=9, m=40, n=36, density=0.05):
    """``(S, tvec, bk1, tk, p, q)`` of a Class-1 Newton system as
    ``tests/test_torch_setup_graph.py::newton_inputs`` makes it (``tvec``
    0: every component near-singular), with its ``bk1`` 1e-3 and ``tk``
    0.5."""
    rng = np.random.default_rng(seed)
    S = (rng.uniform(size=(m, n)) < density).astype(float)
    p, q = rng.uniform(0.5, 1.5, m), rng.uniform(0.5, 1.5, n)
    return S, np.zeros(n + m), np.float64(1e-3), np.float64(0.5), p, q


SYSTEMS = {"front": R.front_arrays, "newton": newton_arrays}


def system(device="cpu", name="front"):
    """``(S, tvec, bk1, tk, p, q)`` of a Class-1 bigph Newton system of
    :data:`SYSTEMS` (``front``: ``torch_dist_ranks.front_arrays``,
    ``tvec`` 0 on half the nodes; ``newton``: :func:`newton_arrays`)
    and a right-hand side made from seed 1."""
    arrays = SYSTEMS[name]()
    args = tuple(torch.as_tensor(np.array(a), device=device) for a in arrays)
    rhs = np.random.default_rng(1).standard_normal(args[1].shape[0])
    return args, torch.as_tensor(rhs, device=device)


def counts() -> tuple:
    c = thyb.refine_counts
    return c.solves, c.rounds, c.reverted, c.cycles


def mixed_solve(exit_every, opts=AMG_T, refine=10, device="cpu",
                name="front"):
    """``(zeta, iters, rel, counts, reads, he_solve)`` of one mixed
    ``he_solve`` of :func:`system` ``name`` with read interval
    ``exit_every``."""
    args, rhs = system(device, name)
    thyb.refine_counts.reset()
    he, _, _ = thyb.build_he_solver(*args, opts, tr.PRNGKey(3), F32, refine,
                                    exit_every)
    r0 = fetch.reads
    zeta, iters, rel = he(rhs, tr.PRNGKey(5))
    return zeta, iters, rel, counts(), fetch.reads - r0, he


def assert_same(got, want):
    """Bit for bit: ``zeta``, ``iters``, ``rel`` and the four counts."""
    assert torch.equal(got[0], want[0]), "zeta"
    assert torch.equal(got[1], want[1]), "iters"
    assert torch.equal(got[2], want[2]), "rel"
    assert got[3] == want[3], "solves, rounds, reverted, cycles"


CASES = {"retol": dict(opts=AMG_T),
         "entry": dict(opts=dataclasses.replace(AMG_T, retol=2.0)),
         "refine0": dict(refine=0)}


@pytest.mark.parametrize("exit_every", [3, 8])
@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("sys_name", sorted(SYSTEMS))
def test_blocked_equals_loop(sys_name, name, exit_every):
    """The blocked refinement equals the loop bit for bit on both
    Class-1 bigph systems: refined to ``retol``; ``rel0 <= retol`` at
    entry (``retol`` 2: no round); ``refine = 0`` (no round)."""
    kw = dict(CASES[name], name=sys_name)
    want = mixed_solve(1, **kw)
    got = mixed_solve(exit_every, **kw)
    assert isinstance(got[5], thyb.Refinement)
    assert not isinstance(want[5], thyb.Refinement)
    assert_same(got[:4], want[:4])
    rounds = want[3][1]
    assert rounds > 0 if name == "retol" else rounds == 0
    if name == "retol":
        assert float(got[2]) <= AMG_T.retol


def cycles_by_round(monkeypatch):
    """Record each loop round's correction cycles (the loop's
    ``amg_solve`` calls) in the returned list."""
    seen = []
    orig = thyb.amg_solve

    def recorded(*a, **kw):
        r = orig(*a, **kw)
        seen.append(int(r.iters))
        return r

    monkeypatch.setattr(thyb, "amg_solve", recorded)
    return seen


@pytest.mark.parametrize("exit_every", [3, 8])
def test_blocked_reads(monkeypatch, exit_every):
    """A blocked ``he_solve`` reads once a block: its steps are one a
    cycle (a round ends in the step of its last cycle; a round of no
    cycle takes one step), so the reads are ``ceil(steps / exit_every)``
    (at least one block), at most the blocks replayed plus one, and
    fewer than the loop's ``1 + rounds + cycles``."""
    seen = cycles_by_round(monkeypatch)
    want = mixed_solve(1)
    blocks = collections.Counter()
    run = thyb.Refinement.run

    def counted(self, name, fn):
        blocks[name] += 1
        run(self, name, fn)

    monkeypatch.setattr(thyb.Refinement, "run", counted)
    got = mixed_solve(exit_every)
    steps = sum(max(c, 1) for c in seen)
    assert len(seen) == want[3][1] and sum(seen) == want[3][3]
    assert got[4] == max(1, math.ceil(steps / exit_every))
    assert got[4] <= blocks["block"] + 1 and blocks["head"] == 1
    assert got[4] < want[4] == 1 + len(seen) + sum(seen)


def bad_correction(thr):
    """A ``correct`` that turns every correction whose residual was below
    ``thr`` (``1/scale`` the residual's norm to a power of two) into
    -1e3 times itself."""
    orig = thyb.correct

    def bad(wd, x, scale):
        return torch.where(1.0 / scale < thr, orig(wd, -1e3 * x, scale),
                           orig(wd, x, scale))

    return bad


@pytest.mark.parametrize("exit_every", [3, 8])
@pytest.mark.parametrize("bad_from", [1, 2])
def test_revert_through_the_seam(monkeypatch, bad_from, exit_every):
    """A correction that raises the residual from round ``bad_from`` on,
    put in through ``correct``, is reverted and ends the rounds: blocked
    equals loop bit for bit, with ``bad_from`` rounds and 1 reverted; the
    result is the loop's with ``refine = bad_from - 1``.  Round 2's
    residual is below 1e-2 of round 1's (``rel`` after 1 and 0 rounds),
    so a threshold between them (their geometric mean) tells the rounds
    apart."""
    args, rhs = system()
    f = float(torch.linalg.vector_norm(thyb.newton_front(
        *args, AMG_T, tr.PRNGKey(3), F32).q0 * rhs))
    r0, r1 = (float(mixed_solve(1, refine=k)[2]) * f for k in (0, 1))
    assert r1 < 1e-2 * r0
    thr = math.inf if bad_from == 1 else math.sqrt(r0 * r1)
    before = mixed_solve(1, refine=bad_from - 1)
    monkeypatch.setattr(thyb, "correct", bad_correction(thr))
    want = mixed_solve(1)
    got = mixed_solve(exit_every)
    assert_same(got[:4], want[:4])
    assert want[3][1:3] == (bad_from, 1)
    assert torch.equal(got[0], before[0]) and torch.equal(got[2], before[2])


def pot_inputs():
    """A POT Newton system on :func:`system`'s Class-1 core: ``Phi`` and
    the right-hand side of ``n + m + 1`` made from seed 2."""
    args, _ = system()
    S, tvec, bk1, tk, p, q = args
    rng = np.random.default_rng(2)
    Phi = torch.as_tensor(rng.uniform(0.5, 1.5, S.shape))
    rhs = torch.as_tensor(rng.standard_normal(tvec.shape[0] + 1))
    return (p, q, Phi), (S, tvec, bk1, tk, rhs)


@pytest.mark.parametrize("exit_every", [3, 8])
def test_pot_two_solves_on_one_front(exit_every):
    """The POT solver's two mixed core solves on one front: blocked
    equals loop bit for bit (``zeta``, ``iters``, ``res``) with the same
    counts; the first solve's result survives the second's."""
    (p, q, Phi), call = pot_inputs()
    out = []
    for e in (1, exit_every):
        thyb.refine_counts.reset()
        solve = tpot.make_pot_amg_solver(p, q, Phi, AMG_T, solve_dtype=F32,
                                         exit_every=e)
        out.append((solve(*call, tr.PRNGKey(11)), counts()))
    (want, cw), (got, cg) = out
    assert torch.equal(got.zeta, want.zeta)
    assert torch.equal(got.iters, want.iters)
    assert torch.equal(got.res, want.res)
    assert cg == cw and cw[0] == 2 and cw[1] >= 2


@pytest.fixture
def guarded(monkeypatch):
    """Every refinement region runs with the host reads patched to raise,
    but for the predicate of a ``when`` (on a card a conditional node);
    returns the count of the regions run, by name."""
    inside = [False]
    ran = collections.Counter()

    def refuse(what, fn):
        def wrapped(*a, **kw):
            if inside[0]:
                raise AssertionError(f"{what} inside a region")
            return fn(*a, **kw)
        return wrapped

    for name in HOST_READS:
        monkeypatch.setattr(torch.Tensor, name,
                            refuse(name, getattr(torch.Tensor, name)))

    def branch(pred):
        # when's branch on the CPU; on a card a conditional node.
        was, inside[0] = inside[0], False
        try:
            return holds(pred)
        finally:
            inside[0] = was

    holds = graphs._holds
    monkeypatch.setattr(graphs, "_holds", branch)
    monkeypatch.setattr(thyb, "fetch", refuse("fetch", thyb.fetch))
    run = thyb.Refinement.run

    def run_guarded(self, name, fn):
        def region(st):
            inside[0] = True
            try:
                fn(st)
            finally:
                inside[0] = False

        ran[name] += 1
        run(self, name, region)

    monkeypatch.setattr(thyb.Refinement, "run", run_guarded)
    return ran


def test_regions_read_nothing(guarded):
    """The head and the blocks read nothing on the host, in a Newton
    solve and in a chunked mixed solve; the reads are the blocks'."""
    got = mixed_solve(3)
    assert guarded["head"] == 1 and guarded["block"] == got[4]
    prob = random_class1(tr.PRNGKey(42), 24, 20, device="cpu")
    res = apd.solve_class1_chunked(prob, class1_opts(), chunk=3)
    assert res.converged and guarded["head"] > 1


def class1_opts(cfg=tcfg):
    return cfg.APDOptions(inner_solver=cfg.InnerSolver.AMG, solve_dtype=F32,
                          amg=cfg.AMGOptions(cycle=cfg.Cycle.F, fuse_deep=True,
                                             coarse_target=6))


def class2_opts(cfg=None):
    if cfg is None:
        cfg, o = tcfg, apd2.default_class2_options()
    else:
        from otamg.opt import apd2 as japd2
        o = japd2.default_class2_options()
    return dataclasses.replace(
        o, inner_solver=cfg.InnerSolver.AMG, solve_dtype=F32,
        amg=dataclasses.replace(o.amg, cycle=cfg.Cycle.F, fuse_deep=True,
                                coarse_target=6))


def same_trajectory(got, want):
    """Bit for bit: counts, objectives, SsN steps, inner iterations, the
    plan and the duals."""
    return (got.iters == want.iters and got.fail_count == want.fail_count
            and got.inner_total == want.inner_total
            and np.array_equal(got.fxk, want.fxk)
            and np.array_equal(got.ssn_itnum, want.ssn_itnum)
            and np.array_equal(got.solver_itnum, want.solver_itnum)
            and torch.equal(got.X, want.X) and torch.equal(got.lam, want.lam))


def driver_runs(cls):
    """The loop driver's run, then the blocked drivers' (name, run,
    refinement counts, reads per outer iteration, loop's reads)."""
    if cls == 1:
        prob = random_class1(tr.PRNGKey(42), 24, 20, device="cpu")
        opts, mod = class1_opts(), apd
    else:
        prob = random_class2(tr.PRNGKey(7), 20, 16, mu_frac=0.6,
                             device="cpu")
        opts, mod = class2_opts(), apd2
    loop = getattr(mod, f"solve_class{cls}")
    runs = [("loop", loop)]
    chunked = getattr(mod, f"solve_class{cls}_chunked")
    runs.append(("chunk8", lambda p, o: chunked(p, o, chunk=8)))
    if cls == 1:
        runs.insert(1, ("chunk3", lambda p, o: chunked(p, o, chunk=3)))
        runs.append(("fused", getattr(mod, f"solve_class{cls}_fused")))
    out = []
    for name, solve in runs:
        thyb.refine_counts.reset()
        r0 = fetch.reads
        res = solve(prob, opts)
        out.append((name, res, counts(), (fetch.reads - r0) / res.iters))
    return out


@pytest.fixture(scope="module")
def jax_fused():
    """The JAX package's fused driver on the same problems and options:
    Class 1 at 24x20 and Class 2 at 20x16."""
    import jax

    import otamg.config as jcfg
    from otamg.opt import apd as japd
    from otamg.opt import apd2 as japd2
    from otamg.ot import random_class1 as j_random1
    from otamg.ot import random_class2 as j_random2

    return {1: japd.solve_class1_fused(
                j_random1(jax.random.PRNGKey(42), 24, 20), class1_opts(jcfg)),
            2: japd2.solve_class2_fused(
                j_random2(jax.random.PRNGKey(7), 20, 16, mu_frac=0.6),
                class2_opts(jcfg))}


@pytest.mark.parametrize("cls", [1, 2])
def test_drivers_equal_loop_and_jax(cls, jax_fused):
    """``solve_class1_chunked`` (chunk 3, 8) and ``_fused`` at 24x20,
    ``solve_class2_chunked`` (chunk 8) at 20x16, mixed: each equals its
    loop run bit for bit (refinement counts too) with fewer reads, and
    the JAX package's fused mixed run in converged, iterations and
    failures exactly and in every objective to rtol 1e-8."""
    (_, loop, loop_counts, loop_reads), *blocked = driver_runs(cls)
    jr_ = jax_fused[cls]
    assert loop.converged and jr_.converged
    assert (loop.iters, loop.fail_count) == (jr_.iters, jr_.fail_count)
    np.testing.assert_allclose(loop.fxk, np.asarray(jr_.fxk), rtol=1e-8)
    assert loop_counts[1] >= loop_counts[0] > 0
    for name, res, c, reads in blocked:
        assert same_trajectory(res, loop), name
        assert c == loop_counts, name
        assert reads < loop_reads, name


def test_sharded_blocked_equals_unsharded(tmp_path):
    """Two gloo ranks (``torch_dist_ranks.refine_rank``): the blocked
    mixed Newton solve (``exit_every`` 3) on the row-sharded system
    equals the unsharded one to 1e-12 on every rank (absolute, over the
    solution's largest magnitude), with the same rounds and cycles."""
    want = mixed_solve(3)
    ctx, outdir = R.spawn(R.refine_rank, 2, str(tmp_path))
    for out in R.collect(ctx, outdir, 2):
        got = out["blocked"]
        assert not isinstance(got, str), got
        zeta, iters, rounds, cycles = got
        scale = float(want[0].abs().max())
        assert np.abs(zeta - want[0].numpy()).max() <= 1e-12 * scale
        assert (iters, rounds, cycles) == (int(want[1]), want[3][1],
                                           want[3][3])


# ---------------------------------------------------------------------------
# On a card
# ---------------------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs these checks")
    return torch.device("cuda")


@pytest.mark.cuda
def test_refine_capture_equals_eager(card):
    """The captured refinement (``exit_every`` 8, over the front's CUDA
    graph) equals the loop's eager rounds on the card bit for bit, at the
    capture and at a replay: each region captured once (head and block),
    the head replayed once a Newton solve."""
    thyb.front_graphs.clear()
    thyb.refine_graphs.clear()
    want = mixed_solve(1, device=card)
    for _ in range(2):
        got = mixed_solve(8, device=card)
        assert_same(got[:4], want[:4])
    assert thyb.refine_graphs.captures == 2
    assert sum(1 for key in thyb.refine_graphs.blocks
               if key[1] == "head") == 1
    assert thyb.refine_graphs.replays == 2 * (1 + got[4])
