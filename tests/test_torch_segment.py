"""The port's segment sums (``otamg_torch.sparse.segment``) on the CPU:
the segment plan against numpy's stable sort, the plain sum over a plan
and the pair form bit for bit against ``index_add_``, the sums against
``jax.ops.segment_sum``, and the plans a hierarchy carries.  The CUDA
kernel runs only on a card (``cuda`` marker; ``chip_smoke.py`` runs the
same checks there)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import otamg.config as jcfg
import otamg_torch.config as tcfg
from otamg.amg import hierarchy as jh
from otamg_torch import interop
from otamg_torch import random as tr
from otamg_torch.amg import hierarchy as th
from otamg_torch.hybrid import solver as thyb
from otamg_torch.sparse.segment import (LANE_MAX, TILE, SegmentPlan,
                                        exact, segment_plan, segment_sum,
                                        segment_sum2,
                                        segment_sum_plain,
                                        segment_sum_plan_plain,
                                        tile_capacity)

DTYPES = {"f32": torch.float32, "f64": torch.float64, "i64": torch.int64}


def case(name: str, rng, L: int = 60):
    """(labels, nseg) of a named case: empty segments, one segment,
    random labels with some out of range, and the main path's one big
    component plus singletons."""
    if name == "empty_segments":
        return rng.choice([2, 5, 11], size=L), 14
    if name == "one_segment":
        return np.zeros(L, dtype=np.int64), 1
    if name == "random":
        return rng.integers(-3, 23, size=L), 20
    lab = np.zeros(L, dtype=np.int64)   # main path: big + singletons
    lab[L - 8:] = np.arange(L - 8, L)
    return lab, 2 * L


def data_of(rng, L, dtype):
    if dtype == torch.int64:
        return torch.as_tensor(rng.integers(-50, 50, size=L))
    return torch.as_tensor(rng.standard_normal(L)).to(dtype)


def numpy_plan(lab, nseg, split=None):
    valid = (lab >= 0) & (lab < nseg)
    half = (np.arange(lab.shape[0]) >= split) if split is not None else 0
    key = np.where(valid, 2 * lab + half, 2 * nseg)
    order = np.argsort(key, kind="stable")
    cuts = np.searchsorted(key[order], np.arange(2 * nseg + 1))
    return order, cuts[0::2], cuts[1::2]


@pytest.mark.parametrize("split", [None, 23])
@pytest.mark.parametrize("name", ["empty_segments", "one_segment", "random",
                                  "main"])
def test_segment_plan_matches_numpy(name, split):
    """``order`` and ``offsets`` (and a pair plan's ``mid``) are numpy's
    stable ``argsort`` and ``searchsorted``; out-of-range and negative
    labels are dropped (sorted last, past ``offsets[-1]``)."""
    lab, nseg = case(name, np.random.default_rng(1))
    plan = segment_plan(torch.as_tensor(lab), nseg, split)
    order, offsets, mid = numpy_plan(lab, nseg, split)
    assert plan.order.dtype == plan.offsets.dtype == torch.int32
    assert np.array_equal(plan.order.numpy(), order)
    assert np.array_equal(plan.offsets.numpy(), offsets)
    assert np.array_equal(plan.mid.numpy(),
                          mid if split is not None else np.zeros(0))
    kept = plan.order[:plan.offsets[-1]].long().numpy()
    assert set(kept) == set(np.flatnonzero((lab >= 0) & (lab < nseg)))
    assert plan.tiles.shape == (0, 7), "no tiles in an exact call"


@pytest.mark.parametrize("name", ["empty_segments", "one_segment", "random",
                                  "main"])
@pytest.mark.parametrize("dtype", ["f32", "f64", "i64"])
def test_plan_sum_plain_is_segment_sum_plain(dtype, name):
    """The plain sum over a plan equals ``segment_sum_plain`` (and
    ``segment_sum`` with the plan, which the CPU ignores) bit for bit."""
    rng = np.random.default_rng(2)
    lab, nseg = case(name, rng)
    labels = torch.as_tensor(lab)
    data = data_of(rng, lab.shape[0], DTYPES[dtype])
    valid = (labels >= 0) & (labels < nseg)
    want = segment_sum_plain(data[valid], labels[valid], nseg)
    plan = segment_plan(labels, nseg)
    assert torch.equal(segment_sum_plan_plain(data, plan), want)
    if name != "random":   # index_add_ raises on out-of-range labels
        assert torch.equal(segment_sum(data, labels, nseg, plan), want)


@pytest.mark.parametrize("name", ["empty_segments", "random", "main"])
@pytest.mark.parametrize("dtype", ["f32", "f64", "i64"])
def test_segment_sum2_is_two_sums(dtype, name):
    """The pair form equals the two sums and their add, bit for bit:
    ``segment_sum2`` on the CPU and the plain sum over a pair plan."""
    rng = np.random.default_rng(3)
    lab, nseg = case(name, rng)
    if name == "random":
        lab = np.clip(lab, 0, nseg - 1)
    labels = torch.as_tensor(lab)
    n = 23
    a = data_of(rng, n, DTYPES[dtype])
    b = data_of(rng, lab.shape[0] - n, DTYPES[dtype])
    want = (segment_sum_plain(a, labels[:n], nseg)
            + segment_sum_plain(b, labels[n:], nseg))
    plan = segment_plan(labels, nseg, split=n)
    assert torch.equal(segment_sum2(a, b, labels, nseg, plan), want)
    assert torch.equal(segment_sum_plan_plain(a, plan, b), want)


@pytest.mark.parametrize("name", ["empty_segments", "one_segment", "main"])
def test_sums_match_jax(name):
    """``segment_sum`` and the plain plan sum against
    ``jax.ops.segment_sum`` on the same numpy inputs, f64, to 1e-12 of
    the terms' absolute sum per slot (XLA's scatter-add order is its
    own)."""
    rng = np.random.default_rng(4)
    lab, nseg = case(name, rng, L=500)
    x = rng.standard_normal(lab.shape[0])
    want = np.asarray(jax.ops.segment_sum(jnp.asarray(x), jnp.asarray(lab),
                                          nseg))
    scale = np.asarray(jax.ops.segment_sum(jnp.abs(jnp.asarray(x)),
                                           jnp.asarray(lab), nseg))
    labels = torch.as_tensor(lab)
    plan = segment_plan(labels, nseg)
    for got in (segment_sum(torch.as_tensor(x), labels, nseg),
                segment_sum_plan_plain(torch.as_tensor(x), plan)):
        assert np.all(np.abs(got.numpy() - want) <= 1e-12 * scale)


@pytest.mark.parametrize("split", [None, 9000])
def test_tile_list_covers_long_runs(split):
    """A plan that is not exact (``nseg * L > SCAN_LIMIT``; with the split
    its first half is exact): the tiles of each long segment (one with a
    run longer than ``LANE_MAX``) cover its runs exactly, in order, an
    exact half's run in one tile summed in order and a tiled half's in
    tiles of at most ``TILE``; the used tiles come first; segments
    without a long run get none."""
    L, nseg = 30000, 1000
    rng = np.random.default_rng(5)
    lab = rng.integers(0, 150, size=L)     # runs of ~80, some cut in two
    lab[rng.uniform(size=L) < 0.5] = 3     # one segment of ~15k
    lab[rng.uniform(size=L) < 0.02] = 7    # one of ~600
    lab[rng.uniform(size=L) < 0.001] = 99  # one of ~30 in runs of ~30
    plan = segment_plan(torch.as_tensor(lab), nseg, split)
    assert not exact(nseg, L)
    assert plan.tiles.shape == (tile_capacity(L), 7)
    assert plan.partials.shape == plan.counts.shape == (tile_capacity(L),)
    seg = plan.tiles[:, 0].numpy()
    assert np.all(seg[:np.count_nonzero(seg >= 0)] >= 0), "used ones first"
    off = plan.offsets.long().numpy()
    mid = plan.mid.long().numpy() if split is not None else off[1:]
    ex = ([exact(nseg, split), exact(nseg, L - split)] if split is not None
          else [False])
    used = plan.tiles.numpy()
    used = used[used[:, 0] >= 0]
    for s in range(nseg):
        runs = [(off[s], mid[s]), (mid[s], off[s + 1])][:len(ex)]
        long_ = any(h - l > LANE_MAX for l, h in runs)
        mine = used[used[:, 0] == s]
        if not long_:
            assert mine.shape[0] == 0, s
            continue
        first, k_a, k = mine[0, 3], mine[0, 4], mine[0, 5]
        assert mine.shape[0] == k and np.all(mine[:, 3] == first)
        parts = [mine[:k_a], mine[k_a:]]
        for (l, h), e, tiles in zip(runs, ex, parts):
            if h == l:
                assert tiles.shape[0] == 0
                continue
            assert tiles[0, 1] == l and tiles[-1, 2] == h
            assert np.all(tiles[1:, 1] == tiles[:-1, 2])
            assert np.all(tiles[:, 6] == e)
            assert tiles.shape[0] == 1 if e else np.all(
                tiles[:, 2] - tiles[:, 1] <= TILE)


@pytest.mark.parametrize("split", [None, 700])
def test_exact_plan_scratch(split):
    """An exact plan (the main path's) has no tile list; a pair plan
    holds a scratch slot a run and a zeroed counter a segment, for the
    kernel's adds of a segment's two sums."""
    lab, nseg = case("main", np.random.default_rng(8), L=1000)
    plan = segment_plan(torch.as_tensor(lab), nseg, split)
    assert exact(nseg, lab.shape[0])
    assert plan.tiles.shape == (0, 7)
    pair = split is not None
    assert plan.partials.shape == (2 * nseg * pair,)
    assert plan.counts.shape == (nseg * pair,)
    assert plan.counts.dtype == torch.int32 and not plan.counts.any()


def small_system(seed: int = 6):
    """A 16x12 Newton system: ``E``, ``g``, ``1/tk``, labels, ``nsp``,
    ``gk`` as ``build_he_solver`` hands them to ``setup_hierarchy``."""
    rng = np.random.default_rng(seed)
    m, n = 12, 16
    S = torch.as_tensor((rng.uniform(size=(m, n)) < 0.3).astype(float))
    p = torch.as_tensor(rng.uniform(0.5, 1.5, size=m))
    q = torch.as_tensor(rng.uniform(0.5, 1.5, size=n))
    tvec = torch.as_tensor((rng.uniform(size=m + n) < 0.2).astype(float))
    bk1 = torch.tensor(1e-3, dtype=torch.float64)
    tk = torch.tensor(0.5, dtype=torch.float64)
    E, g, kdiag, _, _ = thyb._transform(S, tvec, bk1, tk,
                                        torch.zeros_like(tvec), p, q)
    labels, nsp, _, _ = thyb._component_info(E, kdiag)
    gk = bk1 * torch.cat([q * q, p * p]) + kdiag / tk
    return E, g, 1.0 / tk, labels, nsp, gk


def assert_plan_of(plan: SegmentPlan, labels, nseg, split=None):
    want = segment_plan(labels, nseg, split)
    for f in SegmentPlan._fields:
        assert torch.equal(getattr(plan, f), getattr(want, f)), f
    # every run holds exactly its segment's positions
    lab = labels.long()
    for s in range(nseg):
        run = plan.order[plan.offsets[s]:plan.offsets[s + 1]].long()
        assert torch.equal(run, torch.nonzero(lab == s)[:, 0])


AMG_T = tcfg.AMGOptions(cycle=tcfg.Cycle.F, fuse_deep=True, coarse_target=4)
AMG_J = jcfg.AMGOptions(cycle=jcfg.Cycle.F, fuse_deep=True, coarse_target=4)


def test_setup_hierarchy_plans():
    """Every level of ``setup_hierarchy`` on a 16x12 Newton system
    carries the plan of its labels into the fine level's N slots; the
    bipartite level's is the pair plan split at n."""
    E, g, inv_tk, labels, nsp, gk = small_system()
    m, n = E.shape
    lv1, dense = th.setup_hierarchy(E, g, inv_tk, labels, nsp, AMG_T,
                                    tr.PRNGKey(3), gk=gk)
    assert len(dense) >= 2 and int(labels.max()) > 0, "several components"
    assert_plan_of(lv1.plan, lv1.labels, n + m, split=n)
    for lv in dense:
        assert_plan_of(lv.plan, lv.labels, n + m)
    # the flattened level (as the captured CUDA graph holds it) round-trips
    back = th._from_leaves(th.DenseLevel, th._leaves(dense[0]))
    assert all(torch.equal(x, y) for x, y in zip(th._leaves(back),
                                                 th._leaves(dense[0])))


def test_interop_hierarchy_builds_plans():
    """``interop.hierarchy`` makes the plans from the JAX levels' labels;
    every JAX field carries across unchanged, and a cycle on the carried
    hierarchy equals the JAX cycle."""
    E, g, inv_tk, labels, nsp, gk = small_system()
    m, n = E.shape
    N = n + m
    j1, jd = jh.setup_hierarchy(*(jnp.asarray(t.numpy()) for t in
                                  (E, g, inv_tk, labels, nsp)), AMG_J,
                                jax.random.PRNGKey(3),
                                gk=jnp.asarray(gk.numpy()))
    t1, td = interop.hierarchy(
        {k: np.asarray(v) for k, v in j1._asdict().items()},
        [{k: np.asarray(v) for k, v in lv._asdict().items()} for lv in jd],
        device="cpu")
    assert_plan_of(t1.plan, t1.labels, N, split=n)
    for lt, lj in zip(td, jd):
        assert_plan_of(lt.plan, lt.labels, N)
        for f in lj._fields:
            assert np.array_equal(np.asarray(getattr(lt, f)),
                                  np.asarray(getattr(lj, f))), f
    r = np.random.default_rng(7).standard_normal(N)
    cj = jh.make_cycle(len(jd), 3, 3, N)
    ct = th.make_cycle(len(td), 3, 3, N)
    np.testing.assert_allclose(ct(t1, td, torch.as_tensor(r)).numpy(),
                               np.asarray(cj(j1, jd, jnp.asarray(r))),
                               rtol=1e-10, atol=1e-12)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs these checks")
    return torch.device("cuda")


@pytest.mark.cuda
def test_plan_kernel_on_card(card):
    """The plan kernel, the pair form and the no-plan path against the
    plain version: bit for bit where the call is exact, to 1e-12 of the
    terms' absolute sum where it is tiled; two calls equal; one captured
    replay; a plan made on the card equals the CPU's."""
    g = torch.Generator(device=card).manual_seed(0)
    # (L, nseg, labels drawn from [0, nlab)): exact with short runs and
    # with runs of a thousand; tiled with short runs, with runs of 1,600,
    # with one run over many tiles; the pair split's first half exact and
    # its second tiled; exact with one chain over many rounds.
    for L, nseg, nlab in ((700, 1000, 333), (3000, 2000, 3),
                          (1 << 16, 1 << 14, 5461), (1 << 16, 1 << 14, 40),
                          (1 << 20, 1 << 20, 1), (30000, 1000, 150),
                          (1 << 20, 4, 1)):
        labels = torch.randint(0, nlab, (L,), generator=g, device=card)
        data = torch.randn(L, generator=g, device=card, dtype=torch.float64)
        plan = segment_plan(labels, nseg)
        for split in (None, L // 3):
            built = segment_plan(labels, nseg, split)
            plain = segment_plan(labels.cpu(), nseg, split)
            for f in SegmentPlan._fields:
                assert torch.equal(getattr(built, f).cpu(),
                                   getattr(plain, f)), f
        want = segment_sum_plain(data.cpu(), labels.cpu(), nseg)
        scale = segment_sum_plain(data.abs().cpu(), labels.cpu(), nseg)
        for got in (segment_sum(data, labels, nseg, plan),
                    segment_sum(data, labels, nseg)):
            assert torch.equal(got, segment_sum(data, labels, nseg, plan))
            if exact(nseg, L):
                assert torch.equal(got.cpu(), want)
            else:
                assert torch.all((got.cpu() - want).abs() <= 1e-12 * scale)
        n = L // 3
        pair = segment_plan(labels, nseg, split=n)
        got2 = segment_sum2(data[:n], data[n:], labels, nseg, pair)
        want2 = (segment_sum_plain(data[:n].cpu(), labels[:n].cpu(), nseg)
                 + segment_sum_plain(data[n:].cpu(), labels[n:].cpu(), nseg))
        if exact(nseg, n) and exact(nseg, L - n):
            assert torch.equal(got2.cpu(), want2)
        else:
            assert torch.all((got2.cpu() - want2).abs() <= 1e-12 * scale)
    out = torch.empty(nseg, dtype=data.dtype, device=card)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        out.copy_(segment_sum(data, labels, nseg, plan))
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out.copy_(segment_sum(data, labels, nseg, plan))
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, segment_sum(data, labels, nseg, plan))
