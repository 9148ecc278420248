"""Label propagation and the Newton solve's front (``otamg_torch``):
``label_rounds_plain`` and ``connected_components_bipartite`` against the
JAX package's ``connected_components_bipartite`` (labels exactly, and the
round count), on random masks, an empty and a full one, isolated nodes
and a randomly permuted bipartite path that hits the round cap; the eager
``newton_front`` against the sequence it replaces (``_transform``,
``_component_info``, ``setup_solve``) bit for bit, in f64 and mixed; the
labels of a mask gathered from 2 gloo ranks against the unsharded ones.
The ``labels`` kernel and the front's CUDA graph run only on a card
(``cuda`` marker); JAX is imported only by the CPU tests, so on the
card ``python -m pytest --noconftest tests/test_torch_components.py -m
cuda`` runs them with torch alone."""

import numpy as np
import pytest
import torch

import otamg_torch.config as tcfg
import torch_dist_ranks as R
from otamg_torch import random as tr
from otamg_torch.amg import graph as tgraph
from otamg_torch.amg import hierarchy as th
from otamg_torch.amg import kernels as tk
from otamg_torch.dist import api
from otamg_torch.hybrid import solver as thyb

AMG_T = tcfg.AMGOptions(cycle=tcfg.Cycle.F, fuse_deep=True, coarse_target=6)


def random_mask(m, n, density, seed):
    rng = np.random.default_rng(seed)
    return rng.uniform(size=(m, n)) * (rng.uniform(size=(m, n)) < density)


def isolated_mask():
    """Rows 0, 5 and 9 and columns 2 and 11 with no edge."""
    E = random_mask(24, 18, 0.15, 5)
    E[[0, 5, 9], :] = 0.0
    E[:, [2, 11]] = 0.0
    return E


MASKS = {
    "sparse_40x40": lambda: random_mask(40, 40, 0.03, 1),
    "medium_16x48": lambda: random_mask(16, 48, 0.08, 2),
    "dense_64x24": lambda: random_mask(64, 24, 0.4, 3),
    "sparse_33x61": lambda: random_mask(33, 61, 0.02, 4),
    "empty_20x30": lambda: np.zeros((20, 30)),
    "full_17x9": lambda: np.ones((17, 9)),
    "isolated_24x18": isolated_mask,
}


def permuted_path(k, seed=0):
    """A bipartite path of ``k`` columns and ``k`` rows, column ``t`` -
    row ``t`` - column ``t + 1``, with the column and row indices
    randomly permuted (the columns' permutation drawn first)."""
    rng = np.random.default_rng(seed)
    pc, pr = rng.permutation(k), rng.permutation(k)
    E = np.zeros((k, k))
    E[pr, pc] = 1.0
    E[pr[:-1], pc[1:]] = 1.0
    return E


def jax_labels(E, max_rounds):
    import jax.numpy as jnp
    from otamg.amg import graph as jgraph

    return np.asarray(jgraph.connected_components_bipartite(
        jnp.asarray(E), max_rounds=max_rounds))


def jax_rounds(E, max_rounds):
    """The JAX loop's round count: it stops after the first round that
    leaves the labels as they were, or at ``max_rounds``."""
    prev = np.arange(sum(E.shape))
    for r in range(1, max_rounds + 1):
        L = jax_labels(E, r)
        if np.array_equal(L, prev):
            return r
        prev = L
    return max_rounds


CASES = [(name, 64) for name in sorted(MASKS)] + [("path_30", 3),
                                                  ("path_30", 64)]


def case_mask(name):
    return permuted_path(30) if name == "path_30" else MASKS[name]()


@pytest.mark.parametrize("name, max_rounds", CASES)
def test_labels_equal_jax(name, max_rounds):
    """Labels exactly JAX's from ``label_rounds_plain``,
    ``label_rounds`` (the plain version on the CPU) and
    ``connected_components_bipartite`` (every read interval), and the
    round count the JAX loop's."""
    E = case_mask(name)
    want = jax_labels(E, max_rounds)
    L, rounds = tk.label_rounds_plain(torch.as_tensor(E) != 0, max_rounds)
    assert L.dtype is torch.int64 and rounds.dtype is torch.int32
    assert np.array_equal(L.numpy(), want)
    assert int(rounds) == jax_rounds(E, max_rounds)
    got = tk.label_rounds(torch.as_tensor(E), max_rounds)
    assert torch.equal(got[0], L) and torch.equal(got[1], rounds)
    for k in (1, 3):
        cc = tgraph.connected_components_bipartite(
            torch.as_tensor(E), max_rounds=max_rounds, exit_every=k)
        assert np.array_equal(cc.numpy(), want)


def test_path_hits_the_cap():
    """The permuted path is not labelled at 3 rounds (nor the 500 + 500
    one at 64, where 3 labels are left), so the cap decides the labels;
    a cap of 0 leaves every node its own label."""
    L, rounds = tk.label_rounds_plain(torch.as_tensor(permuted_path(30)) != 0,
                                      3)
    assert int(rounds) == 3 and len(torch.unique(L)) > 1
    L, rounds = tk.label_rounds_plain(
        torch.as_tensor(permuted_path(500)) != 0, 64)
    assert int(rounds) == 64 and len(torch.unique(L)) == 3
    L, rounds = tk.label_rounds(torch.as_tensor(permuted_path(30)), 0)
    assert torch.equal(L, torch.arange(60)) and int(rounds) == 0


@pytest.mark.parametrize("m, n, layout, rows, cols", [
    (500, 500, 0, 32, 32), (1024, 1024, 0, 64, 64), (40, 36, 0, 32, 32),
    (2048, 2048, 0, 128, 128), (2896, 2896, 0, 192, 192),
    (2897, 2897, 1, 192, 192), (7000, 7000, 1, 448, 448)])
def test_label_layout(m, n, layout, rows, cols):
    got = tk.label_layout(m, n)
    assert got[:4] == (layout, tk.LABEL_BLOCKS, rows, cols)
    assert got[4] <= tk.SMEM_MAX
    Wn, Wm = -(-n // 32), -(-m // 32)
    assert got[5] == (m * Wn + n * Wm if layout else 0)


def test_label_layout_limit():
    tk.label_layout(7264, 7264)
    with pytest.raises(ValueError):
        tk.label_layout(7265, 7264)


# ---------------------------------------------------------------------------
# The Newton solve's front
# ---------------------------------------------------------------------------


def front_inputs(seed=9, device=None):
    """``torch_dist_ranks.front_arrays(seed)`` as f64 tensors, ``bk1``
    and ``tk`` 0-d as the drivers pass them."""
    return tuple(torch.as_tensor(a, dtype=torch.float64, device=device)
                 for a in R.front_arrays(seed))


def front_leaves(fr):
    """Every tensor of a :class:`Front`, the levels' leaves included."""
    out = list(fr[:9])
    if fr.lv1 is not None:
        out += [t for lv in (fr.lv1, *fr.dense) for t in th._leaves(lv)]
        out += [] if fr.deep is None else [fr.deep]
    return out


def sequence(S, tvec, bk1, tk, p, q, opts, key, lo, exit_every):
    """The front as ``build_he_solver`` ran it before ``newton_front``:
    the transform, the components, then ``setup_solve``."""
    E, g, kdiag, _, q0 = thyb._transform(S, tvec, bk1, tk,
                                         torch.zeros_like(tvec), p, q)
    pf = api.all_gather_rows(p)
    labels, nsp, ncomp, last = thyb._component_info(E, kdiag, exit_every)
    gk = bk1 * torch.cat([q * q, pf * pf]) + kdiag / tk
    lv1, dense, deep = th.setup_solve(E.to(lo), g.to(lo), 1.0 / tk, labels,
                                      nsp, opts, key, gk.to(lo),
                                      deflated=lo != S.dtype)
    return thyb.Front(E, g, kdiag, q0, pf, labels, nsp, ncomp, last, lv1,
                      dense, deep)


@pytest.mark.parametrize("exit_every", [1, 4])
@pytest.mark.parametrize("solve_dtype", [None, "float32"],
                         ids=["f64", "mixed"])
def test_front_equals_sequence(solve_dtype, exit_every):
    """``newton_front`` gives the transform's, the components' and the
    setup's tensors of the sequence it replaces, bit for bit, and counts
    one setup."""
    args = front_inputs()
    key = tr.PRNGKey(9)
    lo = torch.float64 if solve_dtype is None else torch.float32
    th.setup_stats.reset()
    got = thyb.newton_front(*args, AMG_T, key, solve_dtype, exit_every)
    assert th.setup_stats.setups == 1
    want = sequence(*args, AMG_T, key, lo, exit_every)
    assert len(got.dense) == len(want.dense) > 1
    a, b = front_leaves(got), front_leaves(want)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and torch.equal(x, y)
    assert got.lv1.E.dtype == lo and int(got.ncomp) > 1


def test_front_without_bigph():
    """With ``bigph`` off the front is the transform and the components;
    the generic hierarchy is built after it."""
    args = front_inputs(seed=3)
    opts = tcfg.AMGOptions(bigph=False)
    got = thyb.newton_front(*args, opts, tr.PRNGKey(3))
    assert got.lv1 is None and got.dense is None and got.deep is None
    want = sequence(*args, AMG_T, tr.PRNGKey(3), torch.float64, 1)
    for x, y in zip(got[:9], want[:9]):
        assert torch.equal(x, y)


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    """Two gloo ranks: the labels of the gathered mask and of the
    per-round sharded loop, and the sharded front's labels, ``ncomp``
    and ``last`` (``torch_dist_ranks.labels_rank``)."""
    ctx, outdir = R.spawn(R.labels_rank, 2,
                          str(tmp_path_factory.mktemp("labels")))
    return R.collect(ctx, outdir, 2)


def test_sharded_labels_equal_unsharded(sharded):
    """Every rank's labels, from the gathered mask (the card's form) and
    from the per-round minimum and gather (the CPU's), equal the
    unsharded ones, and so do the sharded front's."""
    E = R.labels_mask()
    want = tk.label_rounds_plain(torch.as_tensor(E) != 0)[0].numpy()
    fr = thyb.newton_front(*front_inputs(), AMG_T, tr.PRNGKey(9))
    for out in sharded:
        for name in ("gathered", "per_round"):
            assert not isinstance(out[name], str), out[name]
            assert np.array_equal(out[name], want), name
        assert not isinstance(out["front"], str), out["front"]
        labels, ncomp, last = out["front"]
        assert np.array_equal(labels, fr.labels.numpy())
        assert (ncomp, last) == (int(fr.ncomp), int(fr.last))


# ---------------------------------------------------------------------------
# On a card
# ---------------------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs these checks")
    return torch.device("cuda")


@pytest.mark.cuda
def test_label_kernel_equals_plain(card):
    """One ``labels`` launch gives the plain loop's labels and rounds on
    every mask above, in f32 and f64, on the 500 + 500 path at the
    64-round cap, and in layout 1 (3,072 a side)."""
    masks = [case_mask(name) for name, _ in CASES]
    masks += [permuted_path(500), random_mask(3072, 3072, 0.001, 6)]
    for E in masks:
        for dtype in (torch.float64, torch.float32):
            Ed = torch.as_tensor(E, device=card).to(dtype)
            for cap in (0, 3, 64):
                got = tk.label_rounds(Ed, cap)
                want = tk.label_rounds_plain(Ed != 0, cap)
                assert torch.equal(got[0], want[0])
                assert torch.equal(got[1], want[1])
    assert tk.label_layout(3072, 3072)[0] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("solve_dtype", [None, "float32"],
                         ids=["f64", "mixed"])
def test_front_capture_equals_eager(card, solve_dtype):
    """The captured front's tensors equal the eager front's bit for bit,
    at the capture and at a replay: one capture, two replays."""
    args = front_inputs(device=card)
    key = tr.PRNGKey(9)
    thyb.front_graphs.clear()
    eager = front_leaves(thyb.newton_front(*args, AMG_T, key, solve_dtype))
    for _ in range(2):
        got = front_leaves(thyb.newton_front(*args, AMG_T, key, solve_dtype,
                                             exit_every=4))
        assert len(got) == len(eager)
        for a, b in zip(got, eager):
            assert torch.equal(a, b)
    assert (thyb.front_graphs.captures, thyb.front_graphs.replays) == (1, 2)
