"""The Newton solve's AMG setup with no host read (``otamg_torch.amg``):
the staged draws against ``jax.random``, the MIS rounds' plain loop
against the JAX package's ``mis_dense`` at every read interval, and the
read-free ``setup_hierarchy`` against the JAX package's and against the
port's previous read-driven setup (``tests/data/setup_read_driven.npz``:
its levels on the same two Newton systems, one that fires the defect
repair and one whose MIS bails out), with no ``fetch`` across the setup
and the deep matrix.  The CUDA graph of the setup (captured with the
Newton solve's front) and the ``mis`` and ``coarse_eigh`` kernels run
only on a card (``cuda`` marker)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import otamg.config as jcfg
import otamg_torch.config as tcfg
from otamg.amg import graph as jgraph
from otamg.amg import hierarchy as jh
from otamg_torch import interop
from otamg_torch import random as tr
from otamg_torch.amg import graph as tgraph
from otamg_torch.amg import hierarchy as th
from otamg_torch.amg import kernels as tk
from otamg_torch.device import fetch
from otamg_torch.hybrid import solver as thyb

AMG_J = jcfg.AMGOptions(cycle=jcfg.Cycle.F, fuse_deep=True, coarse_target=6)
AMG_T = tcfg.AMGOptions(cycle=tcfg.Cycle.F, fuse_deep=True, coarse_target=6)
# (seed, m, n, density of the active set): the first fires the defect
# repair on three levels (where the ideal level differs from the
# standard one), the second takes the MIS bail-out on three.
CASES = {"repair": (9, 40, 36, 0.05), "bail": (0, 40, 36, 0.05)}
READ_DRIVEN = os.path.join(os.path.dirname(__file__), "data",
                           "setup_read_driven.npz")


def newton_inputs(seed, m, n, density):
    """``(S, tvec, p, q)`` of a Class-1 Newton system (``tvec`` 0, so
    every component is near-singular) on a random active set."""
    rng = np.random.default_rng(seed)
    S = torch.as_tensor((rng.uniform(size=(m, n)) < density).astype(float))
    p = torch.as_tensor(rng.uniform(0.5, 1.5, m))
    q = torch.as_tensor(rng.uniform(0.5, 1.5, n))
    return S, torch.zeros(n + m, dtype=torch.float64), p, q


def newton_system(seed, m, n, density, bk1=1e-3, tk=0.5):
    """``(E, g, inv_tk, labels, nsp, gk)`` of :func:`newton_inputs`'
    system, as ``build_he_solver`` hands them to the setup."""
    S, tvec, p, q = newton_inputs(seed, m, n, density)
    E, g, kdiag, _, _ = thyb._transform(S, tvec, bk1, tk, tvec, p, q)
    labels, nsp, _, _ = thyb._component_info(E, kdiag)
    gk = bk1 * torch.cat([q * q, p * p]) + kdiag / tk
    return E, g, 1.0 / tk, labels, nsp, gk


def leaves(lv1, dense):
    return [t for lv in (lv1, *dense) for t in th._leaves(lv)]


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    seed = CASES[request.param][0]
    system = newton_system(*CASES[request.param])
    r0 = fetch.reads
    lv1, dense = th.setup_hierarchy(*system[:5], AMG_T, tr.PRNGKey(seed),
                                    gk=system[5])
    reads = fetch.reads - r0
    return request.param, seed, system, (lv1, dense), reads


def test_setup_stats_of_the_cases(case):
    """The repair case fires the defect repair, the bail case bails."""
    name, seed, system, _, _ = case
    E = system[0]
    m, n = E.shape
    caps = th.capacity_schedule(m, n + m, AMG_T)
    draws = tr.setup_draws(tr.PRNGKey(seed), caps[:-1])
    *_, stats = th._setup_levels(*system[:2], th._scalar(system[2], E),
                                 *system[3:5], AMG_T, draws, system[5])
    repairs, rounds, bails = stats.tolist()
    assert rounds > 0
    assert (repairs > 0) if name == "repair" else (bails > 0)


def test_setup_equals_read_driven(case):
    """Every leaf of every level equals the port's previous setup (one
    host read per MIS round and per level's defect): every shape and
    every integer and boolean leaf exactly, every float leaf to 4 ulps of
    its largest magnitude.  The fixture holds the float products of the
    CPU that wrote it (its BLAS's order of summation), and the
    read-driven setup is gone, so it cannot be rebuilt here; bit-for-bit
    equality on one machine is held where both sides run on it
    (``test_setup_reads_nothing``, and ``test_setup_capture_equals_eager``
    on a card)."""
    name, _, _, (lv1, dense), _ = case
    want = np.load(READ_DRIVEN)
    got = leaves(lv1, dense)
    assert int(want[f"{name}_count"]) == len(got)
    for i, t in enumerate(got):
        w = want[f"{name}_{i}"]
        assert t.shape == w.shape and t.numpy().dtype == w.dtype, (name, i)
        if np.issubdtype(w.dtype, np.floating) and w.size:
            tol = 4 * np.spacing(np.abs(w).max())
            assert np.abs(t.numpy() - w).max() <= tol, (name, i)
        else:
            assert np.array_equal(t.numpy(), w), (name, i)


def test_setup_equals_jax(case):
    """The JAX package's setup_hierarchy on the same system and key, to
    ``tests/test_torch_amg.py``'s tolerances."""
    name, seed, system, (t1, td), _ = case
    E, g, inv_tk, labels, nsp, gk = (t.numpy() if isinstance(t, torch.Tensor)
                                     else t for t in system)
    j1, jd = jh.setup_hierarchy(jnp.asarray(E), jnp.asarray(g), inv_tk,
                                jnp.asarray(labels), jnp.asarray(nsp), AMG_J,
                                jax.random.PRNGKey(seed), gk=jnp.asarray(gk))

    def close(got, want, rtol, what):
        want = np.asarray(want)
        scale = float(np.abs(want).max()) if want.size else 0.0
        np.testing.assert_allclose(got.numpy(), want, rtol=rtol,
                                   atol=rtol * scale, err_msg=what)

    for f in ("W", "Axi", "xx", "Exi1", "Etxi2"):
        close(getattr(t1, f), getattr(j1, f), 1e-9, f"level 1 {f}")
    assert len(td) == len(jd)
    for i, (lt, lj) in enumerate(zip(td, jd)):
        for f in ("active", "nsp", "labels"):
            assert np.array_equal(getattr(lt, f).numpy(),
                                  np.asarray(getattr(lj, f))), (name, i, f)
        close(lt.A, lj.A, 1e-9, f"{name} dense level {i} A")
        if i:
            close(lt.P, lj.P, 1e-9, f"{name} dense level {i} P")
    inv = lambda v, e: np.asarray(v) @ np.diag(np.asarray(e)) @ np.asarray(v).T
    close(torch.as_tensor(inv(td[-1].evecs, td[-1].einv)),
          inv(jd[-1].evecs, jd[-1].einv), 1e-8, "coarsest filtered inverse")


def test_setup_reads_nothing(case):
    """No host read in ``setup_hierarchy``, nor in ``setup_solve``, the
    setup and the deep matrix together, whose levels are the same."""
    name, seed, system, (lv1, dense), reads = case
    assert reads == 0
    r0 = fetch.reads
    s1, sd, deep = th.setup_solve(*system[:5], AMG_T, tr.PRNGKey(seed),
                                  system[5])
    assert fetch.reads == r0 and deep is not None
    for a, b in zip(leaves(s1, sd), leaves(lv1, dense)):
        assert torch.equal(a, b)
    cycle = th._make_solve_cycle(system[1].shape[0], len(sd), AMG_T, False)
    assert torch.equal(deep, cycle.build_deep(s1, sd, torch.float64))


@pytest.mark.parametrize("sizes", [[40], [36, 23, 15], [64, 40, 25, 16, 10]])
@pytest.mark.parametrize("seed", [0, 7, 2 ** 40 + 3])
def test_staged_draws_are_jax_draws(seed, sizes):
    """``setup_draws`` is the split chain of ``_build_dense_chain`` and
    each level's MIS draws (0.1 times the ties, the bail-out scores),
    bit for bit with ``jax.random``; ``mis_draws`` is one level's."""
    key = jax.random.PRNGKey(seed)
    want = []
    for n in sizes:
        key, sub = jax.random.split(key)
        kb, kt = jax.random.split(sub)
        want += [0.1 * jax.random.uniform(kt, (n,), jnp.float32),
                 jax.random.uniform(kb, (n,), jnp.float32)]
    got = tr.setup_draws(interop.key(jax.random.PRNGKey(seed)), sizes)
    assert got.dtype == torch.float32
    assert np.array_equal(got.numpy(), np.concatenate(want))
    one = tr.mis_draws(interop.key(sub), sizes[-1])
    assert np.array_equal(one.numpy(), np.stack(want[-2:]))


def strength_graph(density, N=40, seed=4):
    rng = np.random.default_rng(seed)
    As = rng.uniform(size=(N, N)) < density
    As = (As | As.T) & ~np.eye(N, dtype=bool)
    active = np.ones(N, bool)
    active[-3:] = False
    return As & active[:, None] & active[None, :], active


def bail_graph(N=100):
    """One strong edge among ``N`` nodes: 2 connected nodes, under
    ``0.25 sqrt(N)``, so the MIS bails out, and the random C set it
    picks decides the two connected nodes' split."""
    As = np.zeros((N, N), bool)
    As[3, 7] = As[7, 3] = True
    return As, np.ones(N, bool)


@pytest.mark.parametrize("graph", ["bail", "rounds", "dense"])
def test_mis_plain_loop_is_jax(graph):
    """The port's MIS (the plain rounds loop on the CPU) equals the JAX
    package's ``mis_dense`` on a graph that bails out and on graphs that
    run rounds, for several keys."""
    As, active = (bail_graph() if graph == "bail"
                  else strength_graph(0.08 if graph == "rounds" else 0.2))
    seeds = range(20 if graph == "bail" else 3)
    if graph == "bail":
        # Rounds would make every node C here; the bail-out's random C
        # set leaves a connected node F for some key.
        assert any(bool(tgraph.mis_dense(
            torch.as_tensor(As), torch.as_tensor(active),
            tr.PRNGKey(seed)).isF.any()) for seed in seeds)
    for seed in seeds:
        key = jax.random.PRNGKey(seed)
        cj = jgraph.mis_dense(jnp.asarray(As), jnp.asarray(active), key)
        ct = tgraph.mis_dense(torch.as_tensor(As), torch.as_tensor(active),
                              interop.key(key))
        assert np.array_equal(ct.isC.numpy(), np.asarray(cj.isC))
        assert np.array_equal(ct.isF.numpy(), np.asarray(cj.isF))


def test_mis_rounds_plain_counts_rounds():
    """``mis_rounds_plain`` counts the rounds it runs: ``mis_round``
    applied while ``mis_go`` holds gives its state and count."""
    As, active = strength_graph(0.08)
    As, active = torch.as_tensor(As), torch.as_tensor(active)
    f32 = torch.float32
    deg0 = torch.where(active, As.sum(dim=1).to(f32), 0.0)
    deg = torch.where(deg0 > 0, deg0 + tr.mis_draws(tr.PRNGKey(1), 40)[0],
                      0.0)
    Ncnt = active.sum().to(f32)
    N0 = torch.clamp_max(torch.floor(torch.sqrt(Ncnt)) + 1, 25.0)
    isC, isF, isU, rounds = tk.mis_rounds_plain(As, active, deg, Ncnt, N0)
    state = (torch.zeros_like(active), active & (deg == 0),
             active & (deg != 0), deg)
    count = 0
    while bool(tk.mis_go(state[0], state[2], Ncnt, N0)):
        state = tk.mis_round(As, active, *state, N0)
        count += 1
    assert count > 1 and int(rounds) == count
    assert all(torch.equal(a, b) for a, b in zip((isC, isF, isU), state))


@pytest.mark.parametrize("n, itemsize, layout", [
    (1, 8, 0), (128, 8, 0), (161, 8, 0), (162, 8, 1), (400, 8, 1),
    (1_659, 8, 1), (123, 4, 0), (231, 4, 0), (232, 4, 1), (2_904, 4, 1)])
def test_eigh_layout(n, itemsize, layout):
    """The eigh kernel keeps the matrix's lower triangle (rows of ``n |
    1`` values) in one block's shared memory where it fits beside T and
    the method's vectors, else in the global workspace, which always
    holds the inverse iteration's factors and iterates (6 n^2 values and
    n^2 bytes)."""
    got, smem, ws = tk.eigh_layout(n, itemsize)
    assert got == layout and smem <= tk.SMEM_MAX
    assert ws == (6 * n * n + -(-n * n // itemsize)
                  + (n * (n | 1) if layout else 0))


def test_eigh_layout_limit():
    """Past layout 1's reach (T, the eigenvalues, the shifts and the
    tridiagonalisation's partial sums in shared memory) the kernel
    refuses the matrix."""
    with pytest.raises(ValueError, match="shared memory"):
        tk.eigh_layout(1_660, 8)
    with pytest.raises(ValueError, match="shared memory"):
        tk.eigh_layout(2_905, 4)


def test_setup_stats_keep_a_copy():
    """``setup_stats`` keeps its own copy of a device's first stats: a
    captured setup's stats are the graph's output, which the next replay
    overwrites in place."""
    stats = th.SetupStats()
    out = torch.tensor([1, 2, 0])
    stats.add(out)
    out.copy_(torch.tensor([0, 3, 1]))  # the next replay
    stats.add(out)
    assert stats.read() == (2, 1, 5, 1)


# ---------------------------------------------------------------------------
# On a card
# ---------------------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs these checks")
    return torch.device("cuda")


@pytest.mark.cuda
def test_mis_kernel_equals_plain(card):
    """One ``mis`` launch gives the plain loop's split and rounds in
    each layout of ``mis_layout``: the bits in the cluster's shared
    memory (the whole ``mis_split`` at 100 nodes, where 12 of the 16
    blocks own no row, and at 300; a level-1 graph of 2,048) and in the
    global workspace (6,144)."""
    for c, layout in ((2048, 0), (6144, 1)):
        assert tk.mis_layout(c)[0] == layout
        rng = np.random.default_rng(c)
        up = np.triu(rng.random((c, c), dtype=np.float32) < 0.2, 1)
        As = torch.as_tensor(up | up.T, device=card)
        active = torch.ones(c, dtype=torch.bool, device=card)
        Ncnt = torch.tensor(float(c), device=card)
        N0 = torch.clamp_max(torch.floor(torch.sqrt(Ncnt)) + 1, 25.0)
        deg0 = As.sum(dim=1).to(torch.float32)
        tie = tr.to_device(tr.mis_draws(tr.PRNGKey(c), c), card)[0]
        args = (As, active, torch.where(deg0 > 0, deg0 + tie, 0.0), Ncnt,
                N0)
        got, want = tk.mis_rounds(*args), tk.mis_rounds_plain(*args)
        assert int(want[3]) > 0
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    for N, density in ((100, 0.08), (300, 0.005), (300, 0.08),
                       (300, 0.2)):
        assert tk.mis_layout(N)[0] == 0
        As, active = (torch.as_tensor(a, device=card)
                      for a in strength_graph(density, N=N))
        draws = tr.to_device(tr.mis_draws(tr.PRNGKey(3), N), card)
        got = tgraph.mis_split(As, active, draws)
        want = tgraph.mis_split(As.cpu(), active.cpu(), draws.cpu())
        for a, b in zip((*got[0], got[1], got[2]),
                        (*want[0], want[1], want[2])):
            assert torch.equal(a.cpu(), b)


def clustered(n, dtype, device=None, seed=0):
    """``Q diag(lam) Q^T`` with a random orthogonal ``Q``: eigenvalues
    spread over [1, 10], one of them six times (3.0) and a zero four
    times."""
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    lam = np.linspace(1.0, 10.0, n)
    lam[:4] = 0.0
    lam[10:16] = 3.0
    return torch.as_tensor((Q * lam) @ Q.T, dtype=dtype, device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_coarse_eigh_kernel(card, dtype):
    """The kernel against ``torch.linalg.eigh`` with ``chip_smoke.py``'s
    tolerances (1-norms, ``c = 30``, LAPACK's test threshold):
    eigenvalues to ``c n eps ||A||``, ``||A V - V diag(lam)|| <= c n eps
    ||A||``, ``||V^T V - I|| <= c n eps``, on random symmetric matrices
    and on the clustered one (a six-fold eigenvalue and a four-fold
    zero)."""
    eps = torch.finfo(dtype).eps
    cases = []
    # 191 on keep the matrix in global memory in f64; past 512 the
    # eigenvectors are back-transformed there too.
    for n in (8, 64, 99, 123, 128, 191, 256, 400, 600):
        g = torch.Generator(device=card).manual_seed(n)
        B = torch.randn(n, n, generator=g, device=card, dtype=torch.float64)
        cases.append((0.5 * (B + B.T)).to(dtype))
    cases += [clustered(n, dtype, card) for n in (64, 123, 400)]
    for A in cases:
        n = A.shape[0]
        lam, V, info = tk.coarse_eigh(A)
        want = torch.linalg.eigh(A)[0]
        A64, V64 = A.double(), V.double()
        nA = float(want.abs().max())
        n1 = float(torch.linalg.matrix_norm(A64, ord=1))
        tol = 30 * n * eps
        assert int(info) == 0
        assert float((lam - want).abs().max()) <= tol * nA
        res = torch.linalg.matrix_norm(A64 @ V64 - V64 * lam.double(), ord=1)
        assert float(res) <= tol * n1
        orth = torch.linalg.matrix_norm(
            V64.T @ V64 - torch.eye(n, dtype=torch.float64, device=card),
            ord=1)
        assert float(orth) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CASES))
def test_setup_capture_equals_eager(card, name):
    """The setup captured with the rest of the Newton solve's front
    (``newton_front``) gives the eager setup's levels and deep matrix bit
    for bit, at the capture and at a replay: one capture, two
    replays."""
    seed = CASES[name][0]
    S, tvec, p, q = (t.to(card) for t in newton_inputs(*CASES[name]))
    bk1, tk_ = (torch.tensor(v, dtype=torch.float64, device=card)
                for v in (1e-3, 0.5))
    args = (S, tvec, bk1, tk_, p, q, AMG_T, tr.PRNGKey(seed))
    thyb.front_graphs.clear()
    eager = thyb.newton_front(*args)
    for _ in range(2):
        got = thyb.newton_front(*args, exit_every=2)
        for a, b in zip(leaves(got.lv1, got.dense) + [got.deep],
                        leaves(eager.lv1, eager.dense) + [eager.deep]):
            assert torch.equal(a, b)
    assert (thyb.front_graphs.captures, thyb.front_graphs.replays) == (1, 2)
