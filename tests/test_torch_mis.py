"""The method of ``otamg_torch/csrc/mis.cu`` on the CPU: its steps in
torch ops (``tests/mis_steps.py``: As packed into bits by the row panels
of a cluster's blocks, the go-test before any read, U rows only,
each block's words of the masks and its counts exchanged after each
pass) against ``mis_rounds_plain`` and, through ``mis_dense``, against
the JAX package's ``mis_dense``, bit for bit, on graphs shaped like the
path's levels; and ``mis_layout``'s shape arithmetic.  The kernel itself
runs only on a card (``tests/test_torch_setup_graph.py``,
``chip_smoke.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mis_steps import mis_rounds_steps_plain, pack, unpack
from otamg.amg import graph as jgraph
from otamg_torch import interop
from otamg_torch import random as tr
from otamg_torch.amg import graph as tgraph
from otamg_torch.amg import kernels as tk


def level1(c, seed=0):
    """Every node active, each pair strongly connected with probability
    0.2 (the first coarsening of a Class-1 plan)."""
    rng = np.random.default_rng(seed)
    up = np.triu(rng.uniform(size=(c, c)) < 0.2, 1)
    return up | up.T, np.ones(c, bool)


def deep(c, seed=0):
    """About 15% of the nodes active, each tied to one or two other
    active nodes (the deeper levels)."""
    rng = np.random.default_rng(seed)
    active = rng.uniform(size=c) < 0.15
    active[:3] = True
    idx = np.flatnonzero(active)
    As = np.zeros((c, c), bool)
    for i in idx:
        for j in rng.choice(idx[idx != i], size=rng.integers(1, 3)):
            As[i, j] = As[j, i] = True
    return As, active


def bail(c=500):
    """``chip_smoke.py``'s bail graph: two strong edges among 500 nodes,
    too few connected nodes, so the MIS bails out and runs no round."""
    As = np.zeros((c, c), bool)
    As[0, 1] = As[1, 0] = As[2, 3] = As[3, 2] = True
    return As, np.ones(c, bool)


def absorb(c=64):
    """Sparse enough that, with the ties of ``PRNGKey(ABSORB_SEED)``,
    round 3 leaves 4 undecided nodes, under N0 = 9: they are absorbed
    into C."""
    rng = np.random.default_rng(ABSORB_SEED)
    up = np.triu(rng.uniform(size=(c, c)) < 0.05, 1)
    return up | up.T, np.ones(c, bool)


ABSORB_SEED = 4
FAMILIES = {"level1": level1, "deep": deep, "bail": bail, "absorb": absorb}


def split_inputs(As, active, seed):
    """``(As, active, deg, Ncnt, N0)`` as ``mis_split`` hands them to
    ``mis_rounds``, the ties from ``mis_draws(PRNGKey(seed))``."""
    As, active = torch.as_tensor(As), torch.as_tensor(active)
    f32 = torch.float32
    Ncnt = active.sum().to(f32)
    N0 = torch.clamp_max(torch.floor(torch.sqrt(Ncnt)) + 1, 25.0)
    deg0 = torch.where(active, As.sum(dim=1).to(f32), 0.0)
    tie = tr.mis_draws(tr.PRNGKey(seed), As.shape[0])[0]
    return As, active, torch.where(deg0 > 0, deg0 + tie, 0.0), Ncnt, N0


def assert_steps_equal_plain(args, blocks):
    got = mis_rounds_steps_plain(*args, blocks)
    want = tk.mis_rounds_plain(*args)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    return int(want[3])


CASES = ([("level1", c, b) for c in (1, 31, 33, 64, 300)
          for b in (1, 2, 8, 16)]
         + [("deep", c, b) for c in (33, 64) for b in (1, 2, 8, 16)]
         + [("absorb", 64, b) for b in (1, 2, 8, 16)]
         + [("bail", 500, b) for b in (1, 16)])


@pytest.mark.parametrize("family, c, blocks", CASES)
def test_steps_equal_plain(family, c, blocks):
    """The kernel's method gives the plain loop's split and rounds bit
    for bit, with every block count, where c and the panels do not
    divide; on these inputs S stands for U (``deg > 0`` exactly where
    undecided) at the start of every round, and a call with no round
    reads no As."""
    maker = FAMILIES[family]
    As, active = maker(c) if family in ("level1", "deep") else maker()
    seed = ABSORB_SEED if family == "absorb" else c
    rounds = assert_steps_equal_plain(split_inputs(As, active, seed), blocks)
    assert all(mis_rounds_steps_plain.s_is_u)
    assert len(mis_rounds_steps_plain.s_is_u) == rounds
    assert mis_rounds_steps_plain.panel_reads == (rounds > 0)
    if family == "bail":
        assert rounds == 0
    if family in ("level1", "deep") and c >= 33:
        assert rounds > 0


def test_absorb_graph_absorbs():
    """The absorb graph's third round leaves 1..N0 undecided nodes (so
    the round absorbs them), and the rounds stop there."""
    As, active, deg, Ncnt, N0 = split_inputs(*absorb(), ABSORB_SEED)
    state = (torch.zeros_like(active), active & (deg == 0),
             active & (deg != 0), deg)
    never = torch.tensor(-1.0)
    for _ in range(3):
        state = tk.mis_round(As, active, *state, never)
    assert 0 < int(state[2].sum()) <= float(N0)
    assert int(tk.mis_rounds_plain(As, active, deg, Ncnt, N0)[3]) == 3


@pytest.mark.parametrize("blocks", [1, 8])
def test_steps_equal_plain_off_the_path(blocks):
    """Inputs ``mis_split`` does not make: positive degrees on inactive
    nodes, negative and zero degrees on active ones.  S (``deg > 0`` and
    undecided) then differs from U, and the method still follows the
    plain loop; ``max_rounds`` caps the rounds."""
    As, active = level1(64, seed=1)
    rng = np.random.default_rng(2)
    active[rng.choice(64, 10, replace=False)] = False
    deg = torch.as_tensor(rng.uniform(-2.0, 30.0, 64).astype(np.float32))
    deg[:4] = 0.0
    args = (torch.as_tensor(As), torch.as_tensor(active), deg,
            torch.tensor(64.0), torch.tensor(5.0))
    assert assert_steps_equal_plain(args, blocks) > 1
    assert not all(mis_rounds_steps_plain.s_is_u)
    for cap in (0, 1):
        got = mis_rounds_steps_plain(*args, blocks, max_rounds=cap)
        want = tk.mis_rounds_plain(*args, max_rounds=cap)
        assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("family, blocks", [
    ("level1", 2), ("deep", 16), ("absorb", 8), ("bail", 1)])
def test_steps_through_mis_dense_equal_jax(family, blocks, monkeypatch):
    """``mis_dense`` with the kernel's method in place of its rounds
    gives the JAX package's ``mis_dense`` split (bail-out included)."""
    maker = FAMILIES[family]
    As, active = maker(64) if family in ("level1", "deep") else (
        maker(100) if family == "bail" else maker())

    def steps(As, active, deg, Ncnt, N0, max_rounds=64):
        return mis_rounds_steps_plain(As, active, deg, Ncnt, N0, blocks,
                                      max_rounds)

    monkeypatch.setattr(tgraph, "mis_rounds", steps)
    key = jax.random.PRNGKey(ABSORB_SEED if family == "absorb" else 7)
    want = jgraph.mis_dense(jnp.asarray(As), jnp.asarray(active), key)
    got = tgraph.mis_dense(torch.as_tensor(As), torch.as_tensor(active),
                           interop.key(key))
    assert np.array_equal(got.isC.numpy(), np.asarray(want.isC))
    assert np.array_equal(got.isF.numpy(), np.asarray(want.isF))


def test_bits_round_trip():
    """``pack`` puts node j at bit j % 32 of word j // 32."""
    flags = torch.as_tensor(np.random.default_rng(0).uniform(size=(3, 70))
                            < 0.5)
    words = pack(flags, 3)
    assert words.shape == (3, 3) and int(words.max()) < 2 ** 32
    assert torch.equal(unpack(words, 70), flags)
    assert int(pack(torch.tensor([False, True]), 1)) == 2


@pytest.mark.parametrize("c, layout, rows", [
    (1, 0, 32), (31, 0, 32), (32, 0, 32), (33, 0, 32), (100, 0, 32),
    (128, 0, 32), (300, 0, 32), (512, 0, 32), (513, 0, 64),
    (1_024, 0, 64), (2_048, 0, 128), (4_096, 0, 256), (5_120, 0, 320),
    (5_121, 1, 352), (6_144, 1, 384), (8_192, 1, 512), (25_000, 1, 1_568),
    (50_176, 1, 3_136)])
def test_mis_layout(c, layout, rows):
    """One cluster of 16 blocks at every c; each holds its panel in its
    shared memory up to c = 5,120, then the panels move to the global
    workspace; the shared bytes are the state's 37 words a word of nodes
    and 66 more, plus the panel."""
    got = tk.mis_layout(c)
    W = -(-c // 32)
    assert got[:3] == (layout, tk.MIS_BLOCKS, rows) and tk.MIS_BLOCKS == 16
    assert rows == 32 * -(-c // (32 * 16))
    assert got[3] <= tk.SMEM_MAX
    assert got[3] == 4 * (37 * W + 66 + (rows * W if layout == 0 else 0))
    assert got[4] == (16 * rows * W if layout == 1 else 0)


def test_mis_layout_limit():
    """Past the state's room in one block's shared memory the kernel
    refuses the graph."""
    assert tk.mis_layout(50_176)[0] == 1
    with pytest.raises(ValueError, match="shared memory"):
        tk.mis_layout(50_177)
