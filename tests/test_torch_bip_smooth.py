"""The bipartite AMG smoother (``otamg_torch.amg.kernels.bip_smooth``
and its plain version ``bip_smooth_plain``; ``hierarchy.
_projected_smooth_bip`` dispatches between them) on synthetic Newton
systems whose components include near-singular ones (``nsp`` true
somewhere), made with numpy from a seed:

* ``bip_smooth_plain`` against JAX's ``_projected_smooth_bip`` for every
  argument the paths pass (deflated or not, either order, ``e`` zero or
  not, f32 and f64, 5 and 10 sweeps): to 1e-11 (f64) and 1e-5 (f32;
  1e-4 not deflated, see :func:`rtol`) of the result's 2-norm, the
  rounding of sums taken in another order;
* the kernel's method in torch ops (``tests/bip_smooth_steps.py``) against
  ``bip_smooth_plain`` at the sizes of each of the kernel's three
  layouts, with one component, with every node its own component, and
  with m != n, to the same tolerances;
* ``_projected_smooth_bip`` on the CPU against the body it had before it
  dispatched (copied below), bit for bit;
* on a card (``cuda`` marker; skip here): the kernel against the plain
  version, two calls and a captured replay inside a ``graphs.when`` body
  bit for bit against the eager call.  JAX is imported only by the CPU
  tests, so on the card ``python -m pytest --noconftest
  tests/test_torch_bip_smooth.py -m cuda`` runs them with torch alone."""

import numpy as np
import pytest
import torch

import bip_smooth_steps as steps
from otamg_torch import graphs
from otamg_torch.amg import graph as tgraph
from otamg_torch.amg import hierarchy as th
from otamg_torch.amg import kernels as tk
from otamg_torch.dist import api
from otamg_torch.sparse.segment import segment_plan, segment_sum2


def rtol(dtype, deflated: bool) -> float:
    """Of the result's 2-norm: sums in another order.  f64 1e-11; f32
    1e-5 deflated (the mixed path's cycle), 1e-4 not deflated, where the
    near-singular components' coefficient ``xig / xx`` divides fp32's
    rounding of ``xig`` by ``xx ~ bk1`` (1e-3 here) and the result's norm
    grows to ~1e3 with it (up to 5e-5 seen)."""
    if dtype is torch.float64:
        return 1e-11
    return 1e-5 if deflated else 1e-4

DTYPES = {"f64": torch.float64, "f32": torch.float32}


def newton_level(m, n, seed, kind="components", dtype=torch.float64,
                 device="cpu"):
    """A bipartite level as the setup makes it: ``E`` masked random
    (``kind``: three blocks of components with isolated rows and columns,
    ``empty`` or ``full``), ``g = bk1 qp2 + (kdiag + a0diag) / tk``,
    ``kdiag`` zero on the components with an even root label (the
    near-singular ones), ``Axi = A 1`` and ``xx`` its component sums.
    Returns the torch level and its arrays as f64 numpy."""
    rng = np.random.default_rng(seed)
    if kind == "empty":
        E = np.zeros((m, n))
    elif kind == "full":
        E = rng.uniform(0.5, 1.5, (m, n))
    else:
        gr, gc = rng.integers(0, 3, m), rng.integers(0, 3, n)
        E = rng.uniform(0.1, 1.0, (m, n)) * (
            (gr[:, None] == gc[None, :]) & (rng.uniform(size=(m, n)) < 0.3))
        E[m // 3, :] = 0.0
        E[:, n // 2] = 0.0
    N = n + m
    itk = 1.0 / 0.7
    labels = tgraph.connected_components_bipartite(torch.as_tensor(E))
    labels = labels.numpy()
    near = labels[labels] % 2 == 0   # a component by its root label
    qp2 = rng.uniform(0.5, 2.0, N)
    kdiag = np.where(near, 0.0, rng.uniform(0.1, 1.0, N))
    a0 = np.concatenate([E.sum(axis=0), E.sum(axis=1)])
    g = 1e-3 * qp2 + (kdiag + a0) * itk
    seg = np.zeros(N)
    np.add.at(seg, labels, kdiag)
    nsp = seg[labels] == 0
    A = np.diag(g)
    A[n:, :n] -= itk * E
    A[:n, n:] -= itk * E.T
    Axi = A @ np.ones(N)
    xxs = np.zeros(N)
    np.add.at(xxs, labels, Axi)
    xi = nsp.astype(float)
    arrays = dict(E=E, g=g, inv_tk=np.asarray(itk), W=np.zeros((n, m)),
                  labels=labels, nsp=nsp, Axi=Axi, xx=xxs[labels],
                  Exi1=E @ xi[:n], Etxi2=E.T @ xi[n:])
    T = lambda a: torch.as_tensor(a, device=device)
    fl = {k: T(v).to(dtype) for k, v in arrays.items()
          if k not in ("labels", "nsp")}
    lab = T(labels).long()
    lv = th.BipartiteLevel(fl["E"], fl["g"], fl["inv_tk"], fl["W"], lab,
                           T(nsp), fl["Axi"], fl["xx"], fl["Exi1"],
                           fl["Etxi2"], segment_plan(lab, N, split=n))
    return lv, arrays


def vectors(N, seed, dtype=torch.float64, device="cpu"):
    rng = np.random.default_rng(seed)
    return (torch.as_tensor(rng.standard_normal(N), device=device).to(dtype),
            torch.as_tensor(rng.standard_normal(N), device=device).to(dtype))


def close_norm(got, want, rtol, what):
    """Every entry within ``rtol`` of ``want``'s 2-norm."""
    host = lambda a: (a.detach().cpu() if isinstance(a, torch.Tensor)
                      else torch.as_tensor(np.array(a)))
    got, want = host(got).double(), host(want).double()
    assert got.shape == want.shape, f"{what}: shape"
    assert torch.isfinite(want).all(), f"{what}: reference not finite"
    err = float((got - want).abs().max())
    bound = rtol * float(torch.linalg.vector_norm(want))
    assert err <= bound, f"{what}: max err {err:.3e} above {rtol} of the norm"


# ---------------------------------------------------------------------------
# The plain version against JAX
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def system():
    lv, arrays = newton_level(28, 24, 0)
    assert arrays["nsp"].any() and not arrays["nsp"].all()
    return arrays


@pytest.mark.parametrize("dtype", ["f64", "f32"])
@pytest.mark.parametrize("smoth_it", [5, 10])
@pytest.mark.parametrize("deflated", [False, True])
@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("e_is_zero", [False, True])
def test_plain_matches_jax(system, dtype, smoth_it, deflated, transpose,
                           e_is_zero):
    """``bip_smooth_plain`` against JAX's ``_projected_smooth_bip`` on the
    same level and vectors, to :func:`rtol` of the norm."""
    import jax.numpy as jnp

    from otamg.amg import hierarchy as jh

    dt = DTYPES[dtype]
    a = system
    n = a["W"].shape[0]
    N = a["g"].shape[0]
    lv, _ = newton_level(28, 24, 0, dtype=dt)
    np_dt = np.float64 if dt is torch.float64 else np.float32
    jl = jh.BipartiteLevel(**{k: (jnp.asarray(v) if k in ("labels", "nsp")
                                  else jnp.asarray(v, np_dt))
                              for k, v in a.items()})
    e, r = vectors(N, 3 + smoth_it, dt)
    want = jh._projected_smooth_bip(jl, jnp.asarray(e.numpy()),
                                    jnp.asarray(r.numpy()), smoth_it,
                                    transpose, N, deflated, e_is_zero)
    got = tk.bip_smooth_plain(lv, e, r, smoth_it, transpose, N, deflated,
                              e_is_zero)
    assert got.dtype is dt and lv.W.shape[0] == n
    close_norm(got, np.asarray(want), rtol(dt, deflated),
               "bip_smooth_plain")


# ---------------------------------------------------------------------------
# The kernel's method against the plain version
# ---------------------------------------------------------------------------

STEP_CASES = {
    # (m, n, kind, dtype, layout the kernel takes)
    "layout0_f64": (40, 36, "components", torch.float64, 0),
    "layout0_f32": (33, 47, "components", torch.float32, 0),
    "layout1_f64": (600, 600, "components", torch.float64, 1),
    "layout2_f64": (40, 4000, "components", torch.float64, 2),
    "one_component": (30, 26, "full", torch.float64, 0),
    "every_node_alone": (30, 26, "empty", torch.float64, 0),
}


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_steps_match_plain(case):
    """``bip_smooth_steps_plain`` (the kernel's partition of rows and
    order of sums) against ``bip_smooth_plain`` in every mode, to
    :func:`rtol` of the norm; the case's sizes take the layout named."""
    m, n, kind, dt, layout = STEP_CASES[case]
    lv, arrays = newton_level(m, n, 7, kind, dt)
    N = n + m
    nseg = N
    if kind == "full":
        # One component, near-singular: labels all 0, one slot.
        nseg = 1
        assert not bool(lv.labels.any()) and bool(lv.nsp.all())
        lv = lv._replace(plan=segment_plan(lv.labels, 1, split=n))
    if kind == "empty":
        assert torch.equal(lv.labels, torch.arange(N))
    assert tk.bip_smooth_layout(m, n, nseg, lv.E.element_size())[0] == layout
    e, r = vectors(N, 11, dt)
    for deflated in (False, True):
        for transpose in (False, True):
            for e_is_zero in (False, True):
                want = tk.bip_smooth_plain(lv, e, r, 5, transpose, nseg,
                                           deflated, e_is_zero)
                got = steps.bip_smooth_steps_plain(lv, e, r, 5, transpose,
                                                   nseg, deflated, e_is_zero)
                close_norm(got, want, rtol(dt, deflated),
                           f"{case} deflated={deflated} "
                           f"transpose={transpose} e_is_zero={e_is_zero}")


def test_steps_segment_sums_match_plan():
    """The chunked segmented scan gives the plan's sums, with runs that
    cross chunks (K = 3 positions a thread) and empty segments."""
    rng = np.random.default_rng(5)
    N, nseg = 1300, 700
    lab = rng.integers(0, 40, N) * 17 % nseg
    lab[::7] = rng.integers(0, nseg, len(lab[::7]))
    lab = torch.as_tensor(lab)
    vals = torch.as_tensor(rng.standard_normal(N))
    plan = segment_plan(lab, nseg, split=600)
    got = steps.segment_sums(vals, plan.order, plan.offsets, nseg)
    want = segment_sum2(vals[:600], vals[600:], lab, nseg, plan)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-12)


# ---------------------------------------------------------------------------
# The CPU path keeps its bits
# ---------------------------------------------------------------------------


def _parent_smooth_bip(lv, e, r, smoth_it, transpose, nseg, deflated,
                       e_is_zero):
    """``hierarchy._projected_smooth_bip``'s body before it dispatched to
    the kernel, copied as it was."""
    n = lv.W.shape[0]
    m = lv.g.shape[0] - n
    itk = lv.inv_tk
    Emv = lambda x: api.row_matvec(lv.E, x)
    Etmv = lambda y: api.row_rmatvec(lv.E, y)
    g1d, g2d = lv.g[:n], lv.g[n:]
    r1, r2 = r[:n], r[n:]
    lab1, lab2 = lv.labels[:n], lv.labels[n:]
    nsp1, nsp2 = lv.nsp[:n], lv.nsp[n:]
    xi1 = nsp1.to(r.dtype)
    xi2 = nsp2.to(r.dtype)
    if e_is_zero:
        e1 = torch.zeros(n, dtype=r.dtype, device=r.device)
        e2 = torch.zeros(m, dtype=r.dtype, device=r.device)
        u = torch.zeros(m, dtype=r.dtype, device=r.device)
        w = torch.zeros(n, dtype=r.dtype, device=r.device)
    else:
        e1, e2 = e[:n], e[n:]
        w, u = api.row_rmatvec(lv.E, e2), api.row_matvec(lv.E, e1)

    def directed(gp1, gp2):
        if not transpose:
            d1 = gp1 / g1d
            t = Emv(d1)
            d2 = (gp2 + itk * t) / g2d
            tw = Etmv(d2)
        else:
            d2 = gp2 / g2d
            tw = Etmv(d2)
            d1 = (gp1 + itk * tw) / g1d
            t = Emv(d1)
        return d1, d2, t, tw

    if deflated:
        cnt = segment_sum2(xi1, xi2, lv.labels, nseg, lv.plan)
        safe_cnt = torch.where(cnt > 0, cnt, 1.0)
        for _ in range(smoth_it):
            d1, d2, t, tw = directed(r1 - g1d * e1 + itk * w,
                                     r2 - g2d * e2 + itk * u)
            e1, e2 = e1 + d1, e2 + d2
            mean = segment_sum2(e1 * xi1, e2 * xi2, lv.labels, nseg,
                                lv.plan) / safe_cnt
            m1 = torch.where(nsp1, mean[lab1], 0.0)
            m2 = torch.where(nsp2, mean[lab2], 0.0)
            e1, e2 = e1 - xi1 * m1, e2 - xi2 * m2
            u = u + t - m2 * lv.Exi1
            w = w + tw - m1 * lv.Etxi2
        return torch.cat([e1, e2])
    xx1, xx2 = lv.xx[:n], lv.xx[n:]
    sxx1 = torch.where(torch.abs(xx1) > 0, xx1, 1.0)
    sxx2 = torch.where(torch.abs(xx2) > 0, xx2, 1.0)
    Axi1, Axi2 = lv.Axi[:n], lv.Axi[n:]
    for _ in range(smoth_it):
        gg1 = r1 - g1d * e1 + itk * w
        gg2 = r2 - g2d * e2 + itk * u
        xig = segment_sum2(gg1 * xi1, gg2 * xi2, lv.labels, nseg, lv.plan)
        c1 = torch.where(nsp1, xig[lab1] / sxx1, 0.0)
        c2 = torch.where(nsp2, xig[lab2] / sxx2, 0.0)
        d1, d2, t, tw = directed(gg1 - Axi1 * c1, gg2 - Axi2 * c2)
        e1 = e1 + xi1 * c1 + d1
        e2 = e2 + xi2 * c2 + d2
        u = u + c2 * lv.Exi1 + t
        w = w + c1 * lv.Etxi2 + tw
    return torch.cat([e1, e2])


@pytest.mark.parametrize("dtype", ["f64", "f32"])
def test_cpu_path_keeps_its_bits(dtype):
    """``_projected_smooth_bip`` on CPU tensors launches nothing and gives
    the bits of its body before the kernel, in every mode."""
    dt = DTYPES[dtype]
    lv, _ = newton_level(31, 27, 3, dtype=dt)
    N = lv.g.shape[0]
    e, r = vectors(N, 4, dt)
    before = tk.bip_smooth.launches
    for smoth_it in (5, 10):
        for deflated in (False, True):
            for transpose in (False, True):
                for e_is_zero in (False, True):
                    args = (lv, e, r, smoth_it, transpose, N, deflated,
                            e_is_zero)
                    assert torch.equal(th._projected_smooth_bip(*args),
                                       _parent_smooth_bip(*args))
    assert tk.bip_smooth.launches == before


def test_layouts():
    """Where the main path's levels go: 500^2 in shared memory in f64 and
    f32, 1024^2 with ``E`` in global memory, 2048^2 f64 with the state
    in the workspace too."""
    lay = tk.bip_smooth_layout(500, 500, 1000, 8)
    assert lay[:2] == (0, 32) and lay[2] <= tk.SMEM_MAX
    assert tk.bip_smooth_layout(500, 500, 1000, 4)[0] == 0
    assert tk.bip_smooth_layout(1024, 1024, 2048, 8)[0] == 1
    assert tk.bip_smooth_layout(1024, 1024, 2048, 4)[0] == 1
    assert tk.bip_smooth_layout(2048, 2048, 4096, 8)[0] == 2
    lay = tk.bip_smooth_layout(2048, 2048, 4096, 8)
    assert lay[2] == 0 and lay[3] == tk.BIP_BLOCKS * lay[4]


# ---------------------------------------------------------------------------
# On a card
# ---------------------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs these checks")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(STEP_CASES))
def test_kernel_matches_plain(card, case):
    """One launch against ``bip_smooth_plain`` on the card, in every mode
    and 5 and 10 sweeps, to :func:`rtol` of the plain result's norm; two
    calls give equal bits."""
    m, n, kind, dt, _ = STEP_CASES[case]
    lv, _ = newton_level(m, n, 7, kind, dt, device=card)
    N = n + m
    e, r = vectors(N, 11, dt, device=card)
    for smoth_it in (5, 10):
        for deflated in (False, True):
            for transpose in (False, True):
                for e_is_zero in (False, True):
                    args = (lv, e, r, smoth_it, transpose, N, deflated,
                            e_is_zero)
                    want = tk.bip_smooth_plain(*args)
                    got = tk.bip_smooth(*args)
                    again = tk.bip_smooth(*args)
                    torch.cuda.synchronize()
                    assert torch.equal(got, again)
                    close_norm(got, want, rtol(dt, deflated),
                               f"{case} kernel")


@pytest.mark.cuda
def test_kernel_in_a_conditional_body(card):
    """The kernel captured inside a ``graphs.when`` body: a replay with
    the predicate true equals the eager call bit for bit, and one with it
    false leaves the output as it was."""
    lv, _ = newton_level(500, 500, 2, device=card)
    N = lv.g.shape[0]
    e, r = vectors(N, 1, device=card)
    want = tk.bip_smooth(lv, e, r, 5, False, N, False, True)
    out = torch.zeros_like(want)
    pred = torch.ones((), dtype=torch.bool, device=card)

    def body():
        out.copy_(tk.bip_smooth(lv, e, r, 5, False, N, False, True))

    graphs.prepare(card)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        graphs.when(pred, body, [out])
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with graphs.capture(g):
        graphs.when(pred, body, [out])
    out.zero_()
    g.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, want)
    pred.fill_(False)
    out.fill_(-1.0)
    g.replay()
    torch.cuda.synchronize()
    assert bool((out == -1.0).all())
