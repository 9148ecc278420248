"""The outer step of the chunked and fused drivers as regions with no host
read (``otamg_torch.opt.regions``): every region of both classes reads
nothing from the host, the step signature tells apart what its graphs
bake in, and on a card the captured regions replay the loop driver's
step bit for bit (``cuda`` marker; ``chip_smoke.py`` runs the drivers
on the card).  No JAX: the drivers are held to the port's loop driver,
which ``tests/test_torch_drivers.py`` holds to the JAX package."""

import collections
import dataclasses

import numpy as np
import pytest
import torch

import otamg_torch.config as tcfg
from otamg_torch import graphs
from otamg_torch import random as tr
from otamg_torch.opt import apd, apd2, regions
from otamg_torch.ot import capacitated_problem, random_class1, random_class2

OPTS1 = tcfg.APDOptions(inner_solver=tcfg.InnerSolver.AMG, amg=tcfg.AMGOptions(
    cycle=tcfg.Cycle.F, fuse_deep=True, coarse_target=6))
# Tensor methods that read a value to the host.
HOST_READS = ("item", "tolist", "numpy", "__bool__", "__float__", "__int__")


def case(name, device="cpu"):
    """``(problem, options, loop driver, chunked driver)`` of a case; the
    fp32 plan stalls at 24x20, so it runs 4 outer iterations; ``mixed``
    solves the Newton systems in fp32 with f64 refinement."""
    if name == "class2":
        return (random_class2(tr.PRNGKey(7), 20, 16, mu_frac=0.6,
                              device=device),
                apd2.default_class2_options(), apd2.solve_class2,
                apd2.solve_class2_chunked)
    if name == "capacitated":
        prob = capacitated_problem(tr.PRNGKey(3), 24, 20, device=device)
    elif name == "fp32":
        prob = random_class1(tr.PRNGKey(42), 24, 20, dtype=torch.float32,
                             device=device)
    else:
        prob = random_class1(tr.PRNGKey(42), 32, 32, device=device)
    opts = {"fp32": dataclasses.replace(OPTS1, maxit=4),
            "mixed": dataclasses.replace(OPTS1, solve_dtype="float32")
            }.get(name, OPTS1)
    return prob, opts, apd.solve_class1, apd.solve_class1_chunked


@pytest.fixture
def guarded(monkeypatch):
    """Every region runs with the host reads patched to raise, but for
    the predicate of a ``when`` (on a card a conditional node); returns
    the count of the regions run, by name."""
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
    for mod in (apd, apd2, regions):
        monkeypatch.setattr(mod, "fetch", refuse("fetch", mod.fetch))
    run = regions.Regions.run

    def run_guarded(self, name, fn):
        def region(st):
            inside[0] = True
            try:
                fn(st)
            finally:
                inside[0] = False

        ran[name] += 1
        run(self, name, region)

    monkeypatch.setattr(regions.Regions, "run", run_guarded)
    return ran


@pytest.mark.parametrize("name", ["class1", "capacitated", "class2", "fp32",
                                  "mixed"])
def test_regions_read_nothing(guarded, name):
    """A chunked solve (chunk 3) with every region refusing host reads
    walks the loop driver's trajectory bit for bit; the first case runs
    every region, the Armijo blocks and the tail alone among them."""
    prob, opts, loop, chunked = case(name)
    want = loop(prob, opts)
    assert not guarded
    got = chunked(prob, opts, chunk=3)
    assert (got.iters, got.fail_count) == (want.iters, want.fail_count)
    assert np.array_equal(got.fxk, want.fxk)
    assert np.array_equal(got.ssn_itnum, want.ssn_itnum)
    assert torch.equal(got.X, want.X) and torch.equal(got.lam, want.lam)
    # A chunk's step after the converged one stops at its head.
    assert got.iters <= guarded["head"] <= got.iters + 1
    if name == "class1":
        assert set(guarded) == {"head", "first", "trials", "accept_pre",
                                "accept_tail", "tail"}


def test_step_signature_tells_apart(tmp_path):
    """Classes, shapes, dtypes, the block size, the capacities and the
    live mesh (a gloo group of one process) each give their own
    signature; the same problem and options give the same one."""
    import torch.distributed as dist

    from otamg_torch.dist import api, shard_class1

    def sig(prob, exit_every=8, make=apd.make_class1_step, opts=OPTS1):
        return make(prob, opts, exit_every=exit_every).regions.sig

    key = tr.PRNGKey(1)
    base = random_class1(key, 24, 20, device="cpu")
    two = random_class2(key, 24, 20, mu_frac=0.5, device="cpu")
    sigs = [sig(base), sig(random_class1(key, 20, 24, device="cpu")),
            sig(random_class1(key, 24, 20, dtype=torch.float32,
                              device="cpu")),
            sig(base, exit_every=3),
            sig(capacitated_problem(key, 24, 20, device="cpu")),
            sig(two, make=apd2.make_class2_step,
                opts=apd2.default_class2_options())]
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdv",
                            world_size=1, rank=0)
    try:
        mesh = api.make_mesh(device="cpu")
        sharded = sig(shard_class1(base, mesh))
    finally:
        dist.destroy_process_group()
    sigs.append(sharded)
    assert len(set(sigs)) == len(sigs)
    assert sig(random_class1(tr.PRNGKey(2), 24, 20, device="cpu")) == sigs[0]
    assert sharded[-1] == (mesh.group, 0, 1)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs the blocked "
                    "drivers there")
    return torch.device("cuda")


def start(cls, prob, opts):
    """The state a driver hands its first step, after the warm start."""
    dtype, dev = prob.C.dtype, prob.C.device
    bk = torch.ones((), dtype=dtype, device=dev)
    key = tr.PRNGKey(opts.seed)
    if cls == 1:
        X, lam, kx, kl, _ = apd._start(prob, opts, None)
        return [X, X, lam, bk, key, torch.maximum(kx, kl).to(dtype),
                torch.stack([kx, kl]).to(dtype)]
    X, us, lam, got = apd2._start2(prob, opts)
    kkt0 = got[:4].to(dtype)
    return [X, us, X, us, lam, bk, key, kkt0, kkt0]


def advance(cls, step, k, state):
    """``(next state, record)`` of ``step`` at ``k``."""
    out = step(k, *state, record=True)
    rec = out[-1]
    if cls == 1:
        return [*out[:6], state[6]], rec
    return [*out[:7], state[7], rec.rec[:4]], rec


@pytest.mark.cuda
@pytest.mark.parametrize("cls", [1, 2])
def test_captured_regions_replay_the_loop_step(card, cls):
    """Regions captured at k = 3 replay at k = 4 and give the loop step's
    outputs bit for bit from the same state."""
    prob, opts, _, _ = case("class1" if cls == 1 else "class2", card)
    make = apd.make_class1_step if cls == 1 else apd2.make_class2_step
    regions.step_graphs.clear()
    loop = make(prob, opts)
    blocked = make(prob, opts, exit_every=8)
    state = start(cls, prob, opts)
    for k in (1, 2):
        state, _ = advance(cls, loop, k, state)
    advance(cls, blocked, 3, state)
    captured = set(regions.step_graphs.blocks)
    replays = regions.step_graphs.replays
    assert captured and regions.step_graphs.captures == len(captured)
    state, _ = advance(cls, loop, 3, state)
    got, got_rec = advance(cls, blocked, 4, state)
    want, want_rec = advance(cls, loop, 4, state)
    assert regions.step_graphs.replays > replays
    assert captured <= set(regions.step_graphs.blocks)
    assert got_rec.ssn_it == want_rec.ssn_it
    assert torch.equal(got_rec.rec, want_rec.rec)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
